"""The replicated tensor-parallel paths of the PyTorch port against the JAX
package, TP=4: B4 across ranks (``gemm_ar_per_device``), B5 and B6
(``all_reduce_per_device``), the triton_dist_AR mode and the mega decode
step at world 4.

Four gloo ranks (tests/torch_ar_worker.py, one spawn for the whole file, a
FileStore under tmp_path for the rendezvous) run the port on the CPU; the
JAX side runs here, in the test process, on the suite's 4-device ``mesh4``
with the Pallas kernels in interpret mode (as tests/test_collectives.py,
tests/test_gemm_ar.py and tests/test_mega.py run them). Inputs are made
with numpy from seeds.

Held here: ``gemm_ar_per_device(4, PALLAS)`` (whose plain version serves
CPU tensors) and the XLA tier equal the JAX PALLAS and XLA tiers exactly on
integer-valued f32 inputs and to rtol = atol = 1e-5 on random ones (the
products' own summation differs between BLAS and XLA), one M not divisible
by the world included, and every rank's output is the same bytes;
``all_reduce_per_device(4, ONE_SHOT)`` equals the JAX ``_one_shot_kernel``
on each rank exactly (its rank-dependent fold kept), RHD the JAX
``_rhd_kernel`` exactly with the same bytes on every rank, and both
bit-exact against their plain folds in bf16; ``tiny_qwen3(tp=4)`` logits
in mode triton_dist_AR (ONE_SHOT, RHD, gemm_ar PALLAS) within 1e-5 of the
JAX model's in that mode; the greedy tokens of the mega step (pallas_chain
and auto) and of ``Engine(backend="triton_dist_AR")`` equal the JAX
Engine's on mesh4; the world-4 mega graph's schedule equals the
reference's; and what waits raises naming its ROADMAP item.
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
import torch
from jax.sharding import PartitionSpec as P

from triton_dist_tpu.kernels.allreduce import (
    AllReduceMethod as JArMethod, all_reduce_per_device as j_all_reduce,
)
from triton_dist_tpu.kernels.gemm_allreduce import (
    GemmArMethod as JGarMethod, gemm_ar_per_device as j_gemm_ar,
)
from triton_dist_tpu.layers import TPContext as JTPContext
from triton_dist_tpu.mega.models.qwen3 import (
    build_qwen3_decode as j_build_qwen3_decode,
)
from triton_dist_tpu.mega.scheduler import schedule_tasks as j_schedule
from triton_dist_tpu.models import Engine as JEngine
from triton_dist_tpu.models import Qwen3 as JQwen3
from triton_dist_tpu.models import init_random_params as jinit
from triton_dist_tpu.models import tiny_qwen3 as jtiny
from triton_dist_tpu.runtime.compat import td_shard_map

from triton_dist_tpu_torch.kernels.plain import one_shot_fold, rhd_fold
from triton_dist_tpu_torch.mega.models.qwen3 import build_qwen3_decode
from triton_dist_tpu_torch.mega.scheduler import POLICIES, schedule_tasks
from triton_dist_tpu_torch.models import tiny_qwen3

WORLD = 4
LAYERS, MAX_LEN, GEN = 2, 32, 4       # as tests/torch_ar_worker.py
JOIN_TIMEOUT_S = 150
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_ar_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_AR_CTX = {"one_shot": {"ar_method": JArMethod.ONE_SHOT},
            "rhd": {"ar_method": JArMethod.RHD},
            "gemm_ar": {"gemm_ar_method": JGarMethod.PALLAS}}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _op_inputs(rng):
    """GEMM+AR: a (16, 256) and (6, 256), b (256, 128), K over 4 ranks;
    all-reduce: each rank's x (16, 128); integer-valued and random f32,
    and bf16-representable values for the bf16 folds."""
    inp = {}
    for kind in ("int", "rand"):
        def draw(shape):
            if kind == "int":
                return rng.integers(-3, 4, shape).astype(np.float32)
            return rng.standard_normal(shape).astype(np.float32)
        inp[f"gar_a16_{kind}"], inp[f"gar_a6_{kind}"] = draw((16, 256)), \
            draw((6, 256))
        inp[f"gar_b_{kind}"] = draw((256, 128))
        inp[f"ar_x_{kind}"] = draw((WORLD, 16, 128))
    inp["ar_x_bf16"] = torch.from_numpy(
        rng.standard_normal((WORLD, 16, 128)).astype(np.float32)).to(
            torch.bfloat16).float().numpy()
    return inp


@pytest.fixture(scope="module")
def ar(mesh4, tmp_path_factory):
    """The JAX model on mesh4 and the four ranks' results."""
    arch = jtiny(num_layers=LAYERS, tp=WORLD)
    ctx = JTPContext(mesh4, "tp")
    params = jinit(jax.random.PRNGKey(11), arch, ctx, jnp.float32)
    raw = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(6)
    inp = _op_inputs(rng)
    inp["ids"] = rng.integers(0, arch.vocab_size, (4, 6)).astype(np.int32)
    inp["prompt"] = rng.integers(0, arch.vocab_size, (4, 5)).astype(np.int32)
    inp.update({f"param/{k}": v for k, v in _flatten(raw).items()})

    tmp = tmp_path_factory.mktemp("ar4")
    np.savez(tmp / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(tmp / "store"),
         str(tmp / "inputs.npz"), str(tmp)], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    deadline = time.time() + JOIN_TIMEOUT_S
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            for r in range(WORLD):
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
                                  for r in range(WORLD)):
        failed = f"the ranks did not finish within {JOIN_TIMEOUT_S} s"
    if failed:
        logs = "\n".join(p.stdout.read()[-2000:] for p in procs)
        pytest.fail(f"TP=4 gloo ranks failed: {failed}\n{logs}")
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    checks = [json.loads((tmp / f"rank{r}.json").read_text())
              for r in range(WORLD)]
    return {"arch": arch, "ctx": ctx, "params": params, "inp": inp,
            "ranks": ranks, "checks": checks}


def _per_device(mesh4, fn, *args, in_specs):
    """fn run per device on mesh4; its outputs stacked in rank order,
    (WORLD, ...)."""
    return np.asarray(td_shard_map(
        lambda *a: fn(*a)[None], mesh=mesh4, in_specs=in_specs,
        out_specs=P("tp"))(*(jnp.asarray(a) for a in args)))


def _check(got, want, kind):
    if kind == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [16, 6])
@pytest.mark.parametrize("kind", ["int", "rand"])
@pytest.mark.parametrize("jax_method", [JGarMethod.XLA, JGarMethod.PALLAS])
def test_gemm_ar_tiers_equal_jax(ar, mesh4, m, kind, jax_method):
    """Both tiers on every rank against the JAX tier (the f32 partials
    folded slot 0 + ... + slot 3 in both PALLAS kernels); every rank's
    output the same bytes."""
    inp = ar["inp"]
    fn = functools.partial(j_gemm_ar, "tp", WORLD, jax_method, 8, 128, None)
    want = _per_device(mesh4, fn, inp[f"gar_a{m}_{kind}"],
                       inp[f"gar_b_{kind}"],
                       in_specs=(P(None, "tp"), P("tp", None)))
    for meth in ("xla", "pallas"):
        outs = [ar["ranks"][r][f"gar/{kind}/{m}/{meth}"]
                for r in range(WORLD)]
        for r in range(WORLD):
            _check(outs[r], want[r], kind)
            np.testing.assert_array_equal(outs[r], outs[0],
                                          err_msg=f"rank {r} {meth}")


@pytest.mark.parametrize("kind", ["int", "rand"])
@pytest.mark.parametrize("method", ["one_shot", "rhd"])
def test_all_reduce_equals_jax_kernel_per_rank(ar, mesh4, kind, method):
    """B5 and B6 (their plain versions on the CPU) equal the JAX kernels
    on every rank, to the bit: the same adds in the same order, per
    rank."""
    xs = ar["inp"][f"ar_x_{kind}"]
    jm = JArMethod.ONE_SHOT if method == "one_shot" else JArMethod.RHD
    fn = functools.partial(j_all_reduce, "tp", WORLD, jm, None)
    want = _per_device(mesh4, lambda x: fn(x[0]), xs, in_specs=(P("tp"),))
    for r in range(WORLD):
        np.testing.assert_array_equal(
            ar["ranks"][r][f"ar/{kind}/{method}"], want[r],
            err_msg=f"rank {r}")
    if method == "rhd":
        for r in range(WORLD):
            np.testing.assert_array_equal(ar["ranks"][r][f"ar/{kind}/rhd"],
                                          want[0])
    # the XLA tier (the process group's all-reduce) within f32 rounding
    for r in range(WORLD):
        np.testing.assert_allclose(ar["ranks"][r][f"ar/{kind}/xla"],
                                   xs.sum(0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["one_shot", "rhd"])
def test_all_reduce_bf16_folds(ar, method):
    """In bf16 each rank's sum is its plain fold, to the bit: B5 its own
    term first, then the others ascending, each add rounded to bf16; B6
    the halving tree, the same on every rank."""
    xs = [torch.from_numpy(x).to(torch.bfloat16)
          for x in ar["inp"]["ar_x_bf16"]]
    for r in range(WORLD):
        want = (one_shot_fold(xs, r) if method == "one_shot"
                else rhd_fold(xs)).float().numpy()
        np.testing.assert_array_equal(
            ar["ranks"][r][f"ar/bf16/{method}"], want, err_msg=f"rank {r}")


def test_builder_allreduce_sums_over_ranks(ar):
    """The mega builder's allreduce task (the reference's make_allreduce)
    sums over the builder's mesh: every rank gets the sum of the ranks'
    integer-valued inputs, exactly."""
    want = ar["inp"]["ar_x_int"].sum(0)
    for r in range(WORLD):
        np.testing.assert_array_equal(ar["ranks"][r]["builder_allreduce"],
                                      want)


@pytest.mark.parametrize("name", ["one_shot", "rhd", "gemm_ar"])
def test_triton_dist_ar_logits_match_jax(ar, mesh4, name):
    """f32 logits of the last position in mode triton_dist_AR (the whole
    batch on every rank) within 1e-5 of the JAX model in that mode, its
    Pallas kernels in interpret mode."""
    ctx = JTPContext(mesh4, "tp", interpret=True, **J_AR_CTX[name])
    model = JQwen3(ar["arch"], ctx, max_length=MAX_LEN, dtype=jnp.float32)
    want, _ = model.inference(ar["params"], model.create_kv_cache(4),
                              jnp.asarray(ar["inp"]["ids"]),
                              mode="triton_dist_AR")
    for r in range(WORLD):
        np.testing.assert_allclose(ar["ranks"][r][f"logits/{name}"],
                                   np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("path", ["mega_pallas_chain", "mega_auto",
                                  "ar_one_shot"])
def test_engine_greedy_tokens_equal_jax(ar, mesh4, path):
    """Engine.serve at TP=4 on every rank equals the JAX Engine on mesh4:
    the mega step on the pallas_chain tier and at mega="auto" (the xla
    tier on the CPU, on both sides), and backend triton_dist_AR under
    ONE_SHOT; the ranks took rank 0's tokens."""
    kw, backend, mega = {}, "xla", "auto"
    if path == "mega_pallas_chain":
        mega = "pallas_chain"
    elif path == "ar_one_shot":
        kw, backend = {"ar_method": JArMethod.ONE_SHOT}, "triton_dist_AR"
    ctx = JTPContext(mesh4, "tp", interpret=True, **kw)
    model = JQwen3(ar["arch"], ctx, max_length=MAX_LEN, dtype=jnp.float32)
    want = np.asarray(JEngine(model, ar["params"], temperature=0.0,
                              backend=backend, mega=mega).serve(
        jnp.asarray(ar["inp"]["prompt"]), GEN))
    for r in range(WORLD):
        np.testing.assert_array_equal(ar["ranks"][r][f"tokens/{path}"],
                                      want, err_msg=f"rank {r}")
    if path == "mega_auto":
        assert all(c["mega_auto_tier"] == "xla" for c in ar["checks"])
    if path == "ar_one_shot":
        for r in range(WORLD):
            differs = ar["ranks"][r]["differs/ar_one_shot"]
            assert differs.shape == (GEN,) and not differs[0]


@pytest.mark.parametrize("policy", POLICIES)
def test_world4_schedule_matches_jax(policy):
    """The world-4 dense decode graph (one rank's heads) has the
    reference's tasks and schedule order under every policy."""
    arch = tiny_qwen3(num_layers=LAYERS, tp=WORLD)
    ours = build_qwen3_decode(arch, WORLD, torch.float32)
    ref = j_build_qwen3_decode(jtiny(num_layers=LAYERS, tp=WORLD), "tp",
                               WORLD, jnp.float32)
    assert [(t.task_type, t.layer_id, t.inputs, t.outputs, t.is_comm)
            for t in ours.graph.tasks] == \
        [(t.task_type, t.layer_id, t.inputs, t.outputs, t.is_comm)
         for t in ref.graph.tasks]
    assert schedule_tasks(ours.graph, policy) == j_schedule(ref.graph,
                                                            policy)


def test_what_waits_raises(ar):
    """gemm_ar XLA_RING refuses an M the world does not divide (the
    reference's ValueError; its values are held in
    tests/test_torch_bidir.py); the int8 wires (gemm_ar XLA_QINT8, the
    QINT8 tiers) run within their contracts and QINT8 refuses an M the
    world does not divide (their values are held in
    tests/test_torch_quant_world.py); the MoE mega task
    builds at n > 1 (one per layer); RHD refuses an M the world does not
    divide and a world that is no power of two; AUTO is resolved above
    the per-device level;
    the paged Engine at world 4 serves the dense Engine's greedy tokens
    (TWO_SHOT and the paged cache at n > 1 are held to the JAX package in
    tests/test_torch_continuous_tp.py)."""
    for r, c in enumerate(ar["checks"]):
        for key in ("rhd_refusals", "waits_raise",
                    "moe_task_builds_at_world_n",
                    "paged_serves_at_world_n"):
            assert c[key] is True, (r, key)
