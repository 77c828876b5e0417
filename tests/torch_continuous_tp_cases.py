"""Shared harness and cases of the tensor-parallel ContinuousEngine parity
tests (tests/test_torch_continuous_tp.py at world 4,
tests/test_torch_continuous_tp2.py at world 2, each with its ``tp``
fixture over ``tp_results``): B9 (ring reduce-scatter), B7 (ring
all-gather) and TWO_SHOT per rank, the ContinuousEngine in modes xla (the
mega default) and triton_dist_AR under TWO_SHOT, and the paged Engine,
against the JAX package.

n gloo ranks (tests/torch_continuous_worker.py, a FileStore under the
test's tmp dir for the rendezvous) run the port on the CPU; the JAX side
runs in the test process while they do, on an n-device mesh with its
Pallas kernels (the ring kernels, B2) in interpret mode. Inputs are made
with numpy from seeds.
"""


import functools
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from torch_continuous_worker import (
    ENGINE_KW, LAYERS, MAX_LEN, SHORT, run_script,
)
from triton_dist_tpu.kernels.allgather import (
    AllGatherMethod as JAgMethod, all_gather_per_device as j_all_gather,
)
from triton_dist_tpu.kernels.allreduce import (
    AllReduceMethod as JArMethod, all_reduce_per_device as j_all_reduce,
)
from triton_dist_tpu.kernels.reduce_scatter import (
    ReduceScatterMethod as JRsMethod,
    reduce_scatter_per_device as j_reduce_scatter,
)
from triton_dist_tpu.layers import TPContext as JTPContext
from triton_dist_tpu.models import ContinuousEngine as JContinuousEngine
from triton_dist_tpu.models import Engine as JEngine
from triton_dist_tpu.models import Qwen3 as JQwen3
from triton_dist_tpu.models import init_random_params as jinit
from triton_dist_tpu.models import tiny_qwen3 as jtiny
from triton_dist_tpu.runtime import make_comm_mesh
from triton_dist_tpu.runtime.compat import td_shard_map

JOIN_TIMEOUT_S = 150
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_continuous_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 2                    # rows of each rank's chunk (B9) / shard (B7)



def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _per_device(mesh, fn, *args):
    """fn run on each device's slice of args (stacked (n, ...)); outputs
    stacked in rank order."""
    return np.asarray(td_shard_map(
        lambda *a: fn(*(x[0] for x in a))[None], mesh=mesh,
        in_specs=(P("tp"),) * len(args), out_specs=P("tp"))(
            *(jnp.asarray(a) for a in args)))


def _spawn(world, tmp, inputs):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(tmp / "store"),
         str(inputs), str(tmp)], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _join(procs, tmp, world):
    deadline = time.time() + JOIN_TIMEOUT_S
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            for r in range(world):
                path = tmp / f"rank{r}.json"
                if path.exists():
                    err = json.loads(path.read_text() or "{}").get("error")
                    if err:
                        failed = f"rank {r}: {err}"
            if failed or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is None and any(p.returncode for p in procs):
        failed = "worker exit codes " + str([p.returncode for p in procs])
    if failed is None and not all((tmp / f"rank{r}.json").exists()
                                  for r in range(world)):
        failed = f"the ranks did not finish within {JOIN_TIMEOUT_S} s"
    if failed:
        logs = "\n".join(p.stdout.read()[-2000:] for p in procs)
        pytest.fail(f"world-{world} gloo ranks failed: {failed}\n{logs}")
    return ([dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)],
            [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(world)])


def _jax_setup(world):
    mesh = make_comm_mesh(axes=[("tp", world)],
                          devices=jax.devices()[:world])
    arch = jtiny(num_layers=LAYERS, tp=world)
    params = jinit(jax.random.PRNGKey(5), arch, JTPContext(mesh, "tp"),
                   jnp.float32)
    return mesh, arch, params


def _jax_continuous(world, label, mesh=None, arch=None, params=None):
    """The JAX ContinuousEngine's run of SCRIPT at world n, in mode xla
    (label "xla") or triton_dist_AR under TWO_SHOT ("two_shot")."""
    if mesh is None:
        mesh, arch, params = _jax_setup(world)
    kw = {"ar_method": JArMethod.TWO_SHOT} if label == "two_shot" else {}
    ctx = JTPContext(mesh, "tp", interpret=True, **kw)
    model = JQwen3(arch, ctx, max_length=MAX_LEN, dtype=jnp.float32)
    eng = JContinuousEngine(
        model, params, temperature=0.0,
        mode="xla" if label == "xla" else "triton_dist_AR", **ENGINE_KW)
    return run_script(eng)


def _spawn_jax_continuous(world, label, tmp):
    """_jax_continuous in a process of its own (this file run as a
    script), so that it runs beside the rest of the JAX side."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(world), label,
         str(tmp / f"jax_{label}.json")], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _join_jax(proc, path):
    try:
        proc.wait(timeout=JOIN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    if proc.returncode or not path.exists():
        pytest.fail(f"the JAX engine's process failed "
                    f"(exit {proc.returncode}):\n{proc.stdout.read()[-3000:]}")
    return tuple(json.loads(path.read_text()))


def tp_results(world, tmp):
    """The n ranks' results and the JAX side's, at world n: the ranks and
    the JAX TWO_SHOT engine (the slowest JAX run: its ring kernels run in
    interpret mode) run in processes of their own while the rest of the
    JAX side computes here."""
    mesh, arch, params = _jax_setup(world)
    rng = np.random.default_rng(9 + world)
    inp = {"rs_x": rng.standard_normal((world, world * ROWS, 128),
                                       np.float32),
           "ag_x": rng.standard_normal((world, ROWS, 128), np.float32),
           "bad_x": rng.standard_normal((world, world // 2, 128),
                                        np.float32),
           "prompt": rng.integers(0, arch.vocab_size, (2, 5)).astype(
               np.int32)}
    inp.update({f"param/{k}": v for k, v in _flatten(
        jax.tree_util.tree_map(np.asarray, params)).items()})
    np.savez(tmp / "inputs.npz", **inp)
    procs = _spawn(world, tmp, tmp / "inputs.npz")
    two_shot = _spawn_jax_continuous(world, "two_shot", tmp)
    try:
        jax_side = _jax_side(world, mesh, arch, params, inp)
    except BaseException:
        for p in (*procs, two_shot):
            p.kill()
        raise
    jax_side["continuous/two_shot"] = _join_jax(
        two_shot, tmp / "jax_two_shot.json")
    ranks, checks = _join(procs, tmp, world)
    return {"world": world, "mesh": mesh, "inp": inp, "ranks": ranks,
            "checks": checks, "jax": jax_side}


def _jax_side(world, mesh, arch, params, inp):
    """The JAX kernels per device, the JAX engine's run in mode xla and
    the JAX paged Engine's serve."""
    out = {}
    for name, fn, x in (
            ("rs/ring", functools.partial(j_reduce_scatter, "tp", world,
                                          JRsMethod.RING_1D, True),
             inp["rs_x"]),
            ("ag/ring", functools.partial(j_all_gather, "tp", world,
                                          JAgMethod.RING_1D, True),
             inp["ag_x"]),
            ("ar/two_shot", functools.partial(j_all_reduce, "tp", world,
                                              JArMethod.TWO_SHOT, True),
             inp["rs_x"])):
        out[name] = _per_device(mesh, fn, x)
    try:
        _per_device(mesh, functools.partial(
            j_all_reduce, "tp", world, JArMethod.TWO_SHOT, True),
            inp["bad_x"])
        out["bad_fails"] = False
    except Exception:                  # the reference's body fails here
        out["bad_fails"] = True
    out["continuous/xla"] = _jax_continuous(world, "xla", mesh, arch,
                                            params)
    model = JQwen3(arch, JTPContext(mesh, "tp", interpret=True),
                   max_length=MAX_LEN, dtype=jnp.float32)
    out["paged_engine"] = np.asarray(JEngine(
        model, params, temperature=0.0, cache_mode="paged",
        page_size=8).serve(jnp.asarray(inp["prompt"]), 4))
    return out


@pytest.mark.parametrize("name", ["rs/ring", "ag/ring", "ar/two_shot"])
def test_ring_kernels_equal_jax_per_rank(tp, name):
    """B9, B7 and TWO_SHOT (their plain versions on the CPU) equal the JAX
    ring kernels on every rank, to the bit: the same adds in the same
    order, the same rows."""
    want = tp["jax"][name]
    for r in range(tp["world"]):
        np.testing.assert_array_equal(tp["ranks"][r][name], want[r],
                                      err_msg=f"rank {r}")
    if name == "ar/two_shot":
        for r in range(tp["world"]):
            np.testing.assert_array_equal(tp["ranks"][r][name],
                                          tp["ranks"][0][name])


def test_process_group_tiers_and_refusals(tp):
    """The NCCL-role tiers (AUTO on the CPU: the process group's
    reduce-scatter; XLA all-gather) equal the sums and the rows; rows the
    world does not divide raise a ValueError in the port, and the JAX
    per-device body fails on the same input; FULL_MESH (B8's plain
    version) gathers the XLA rows."""
    world, inp = tp["world"], tp["inp"]
    total = inp["rs_x"].sum(0)
    for r in range(world):
        got = tp["ranks"][r]
        np.testing.assert_allclose(got["rs/auto"],
                                   total[r * ROWS:(r + 1) * ROWS],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got["ag/xla"],
                                      inp["ag_x"].reshape(-1, 128))
        assert tp["checks"][r]["n_not_dividing_rows_raises"] is True
        assert tp["checks"][r]["full_mesh_equals_xla"] is True
    assert tp["jax"]["bad_fails"]


@pytest.mark.parametrize("label", ["xla", "two_shot"])
def test_continuous_equals_jax(tp, label):
    """Every rank's ContinuousEngine: the paged cache state, slots and
    counters after every step equal the JAX engine's, the greedy tokens
    too; a prefix page was adopted; no rank's own token differed from
    rank 0's; mode xla ran the mega graph's xla tier (AUTO on the
    CPU)."""
    jtrace, jdone = tp["jax"][f"continuous/{label}"]
    for r in range(tp["world"]):
        got = tp["checks"][r][f"continuous/{label}"]
        assert len(got["trace"]) == len(jtrace)
        for i, (a, b) in enumerate(zip(got["trace"], jtrace)):
            assert a == b, f"rank {r}: state after step {i} differs"
        assert got["done"] == [list(d) for d in jdone], f"rank {r}"
        assert got["own_token_differs"] == 0
        assert got["mega"] == "xla"
    assert any(d[2] > 0 for d in jdone)


def test_paged_engine_equals_jax(tp):
    """Engine(cache_mode="paged") at world n: greedy tokens equal the JAX
    paged Engine's on every rank; no rank's own token differed."""
    for r in range(tp["world"]):
        np.testing.assert_array_equal(tp["ranks"][r]["paged_engine"],
                                      tp["jax"]["paged_engine"],
                                      err_msg=f"rank {r}")
        assert not tp["ranks"][r]["paged_engine_differs"].any()


def test_two_shot_short_chunks_pad_to_the_world(tp):
    """Under TWO_SHOT a 1- or 2-token chunk (a short prompt, a prompt's
    1-token last chunk) is padded to a multiple of the world and serves:
    the paged cache state after every step and the greedy tokens equal
    those of the same engine in mode xla (held to the JAX engine by
    test_continuous_equals_jax; the reference's TWO_SHOT body fails on
    these chunks); an engine whose max_batch the world does not divide is
    refused at construction."""
    assert any(len(op[1]) <= 2 for op in SHORT if op[0] == "submit")
    for r in range(tp["world"]):
        want = tp["checks"][r]["continuous/xla_short"]
        jtrace, jdone = want["trace"], want["done"]
        got = tp["checks"][r]["continuous/two_shot_short"]
        assert len(got["trace"]) == len(jtrace)
        for i, (a, b) in enumerate(zip(got["trace"], jtrace)):
            assert a == b, f"rank {r}: state after step {i} differs"
        assert got["done"] == jdone, f"rank {r}"
        assert got["own_token_differs"] == 0
        assert tp["checks"][r]["two_shot_batch_refused"] is True


if __name__ == "__main__":
    # python tests/torch_continuous_tp_cases.py WORLD LABEL OUT.json
    _world, _label, _path = sys.argv[1:]
    with open(_path + ".tmp", "w") as _f:
        json.dump(_jax_continuous(int(_world), _label), _f)
    os.replace(_path + ".tmp", _path)
