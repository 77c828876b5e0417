"""Tensor parallelism of the PyTorch port against the JAX package, TP=4.

Four gloo ranks (tests/torch_tp_worker.py, one spawn for the whole file,
a FileStore under tmp_path for the rendezvous) run the port on the CPU;
the JAX side runs here, in the test process, on the suite's 4-device
``mesh4`` with the Pallas kernels in interpret mode (as
tests/test_ag_gemm.py runs them). Inputs are made with numpy from seeds.

Held here: the parameter shards of ``params_from_numpy(rank, world=4)``
equal the JAX ``put_params`` shards exactly; ``ag_gemm_per_device`` and
``gemm_rs_per_device`` (XLA, XLA_RING, and PALLAS, whose plain version
serves CPU tensors) equal the JAX XLA and PALLAS tiers exactly on
integer-valued f32 inputs and to rtol = atol = 1e-5 on random ones (the
fold orders differ); ``tiny_qwen3(tp=4)`` logits in modes xla and
triton_dist within 1e-5 of the JAX model's; and the greedy tokens of
``Engine(backend="triton_dist")`` (and of the plain TP xla decode) equal
the JAX Engine's on mesh4.
"""

import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from triton_dist_tpu.kernels.allgather_gemm import (
    AgGemmMethod as JAgMethod, ag_gemm, create_ag_gemm_context,
)
from triton_dist_tpu.kernels.gemm_reduce_scatter import (
    GemmRsMethod as JRsMethod, create_gemm_rs_context, gemm_rs,
)
from triton_dist_tpu.layers import TPContext as JTPContext
from triton_dist_tpu.models import Engine as JEngine
from triton_dist_tpu.models import Qwen3 as JQwen3
from triton_dist_tpu.models import init_random_params as jinit
from triton_dist_tpu.models import tiny_qwen3 as jtiny
from triton_dist_tpu.models.weights import put_params as jput

WORLD = 4
LAYERS, MAX_LEN, GEN = 2, 32, 4       # as tests/torch_tp_worker.py
JOIN_TIMEOUT_S = 150
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_tp_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _op_inputs(rng):
    """AG: a (64, 128) rows over 4 ranks, b (128, 256) columns; RS: a
    (32, 256) and b (256, 128), K over 4 ranks (the shapes of
    tests/test_ag_gemm.py); integer-valued and random f32."""
    inp = {}
    for kind in ("int", "rand"):
        def draw(shape):
            if kind == "int":
                return rng.integers(-3, 4, shape).astype(np.float32)
            return rng.standard_normal(shape).astype(np.float32)
        inp[f"ag_a_{kind}"], inp[f"ag_b_{kind}"] = draw((64, 128)), \
            draw((128, 256))
        inp[f"rs_a_{kind}"], inp[f"rs_b_{kind}"] = draw((32, 256)), \
            draw((256, 128))
    return inp


@pytest.fixture(scope="module")
def tp(mesh4, tmp_path_factory):
    """The JAX model on mesh4 and the four ranks' results."""
    arch = jtiny(num_layers=LAYERS, tp=WORLD)
    ctx = JTPContext(mesh4, "tp")
    model = JQwen3(arch, ctx, max_length=MAX_LEN, dtype=jnp.float32)
    params = jinit(jax.random.PRNGKey(11), arch, ctx, jnp.float32)
    raw = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(4)
    inp = _op_inputs(rng)
    inp["ids"] = rng.integers(0, arch.vocab_size, (4, 6)).astype(np.int32)
    inp["prompt"] = rng.integers(0, arch.vocab_size, (4, 5)).astype(np.int32)
    inp.update({f"param/{k}": v for k, v in _flatten(raw).items()})

    tmp = tmp_path_factory.mktemp("tp4")
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
    return {"arch": arch, "ctx": ctx, "model": model, "params": params,
            "raw": raw, "inp": inp, "ranks": ranks, "checks": checks}


def _shards(arr):
    """Rank order of a mesh4 array's shards (device r is rank r)."""
    by_dev = {s.device.id: np.asarray(s.data) for s in
              arr.addressable_shards}
    return [by_dev[d.id] for d in jax.devices()[:WORLD]]


def test_param_shards_equal_jax_put_params(tp):
    put = jput(tp["raw"], tp["arch"], tp["ctx"])
    for name, leaf in [(k, put[k]) for k in put if k != "layers"] + \
            [(f"layers/{k}", v) for k, v in put["layers"].items()]:
        for r, want in enumerate(_shards(leaf)):
            got = tp["ranks"][r][f"shard/{name}"]
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)


def _jax_ag(mesh4, method, a, b):
    kw = {"bm": 16, "bn": 128} if method == JAgMethod.PALLAS else {}
    c, ag = ag_gemm(create_ag_gemm_context(mesh4, "tp", method=method, **kw),
                    jnp.asarray(a), jnp.asarray(b))
    return np.asarray(c), np.asarray(ag)


def _jax_rs(mesh4, method, a, b):
    kw = {"bn": 128} if method == JRsMethod.PALLAS else {}
    return np.asarray(gemm_rs(
        create_gemm_rs_context(mesh4, "tp", method=method, **kw),
        jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("kind", ["int", "rand"])
@pytest.mark.parametrize("jax_method", [JAgMethod.XLA, JAgMethod.PALLAS])
def test_ag_gemm_tiers_equal_jax(tp, mesh4, kind, jax_method):
    inp = tp["inp"]
    c, ag = _jax_ag(mesh4, jax_method, inp[f"ag_a_{kind}"],
                    inp[f"ag_b_{kind}"])
    nl = c.shape[1] // WORLD
    for r in range(WORLD):
        for meth in ("xla", "xla_ring", "pallas"):
            got = tp["ranks"][r][f"ag/{kind}/{meth}/out"]
            want = c[:, r * nl:(r + 1) * nl]
            np.testing.assert_array_equal(
                tp["ranks"][r][f"ag/{kind}/{meth}/ag"], ag)
            if kind == "int":
                np.testing.assert_array_equal(got, want, err_msg=meth)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                           err_msg=meth)


@pytest.mark.parametrize("kind", ["int", "rand"])
@pytest.mark.parametrize("jax_method", [JRsMethod.XLA, JRsMethod.PALLAS])
def test_gemm_rs_tiers_equal_jax(tp, mesh4, kind, jax_method):
    inp = tp["inp"]
    out = _jax_rs(mesh4, jax_method, inp[f"rs_a_{kind}"],
                  inp[f"rs_b_{kind}"])
    m = out.shape[0] // WORLD
    for r in range(WORLD):
        for meth in ("xla", "xla_ring", "pallas"):
            got = tp["ranks"][r][f"rs/{kind}/{meth}"]
            want = out[r * m:(r + 1) * m]
            if kind == "int":
                np.testing.assert_array_equal(got, want, err_msg=meth)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                           err_msg=meth)


@pytest.mark.parametrize("kind", ["int", "rand"])
def test_one_card_world_plain_versions_equal_jax(tp, mesh4, kind):
    """The plain versions that hold B10 / B13a in the one-card world
    (every rank's shards in one process): ``ag_gemm_ref_shards`` and
    ``gemm_rs_ref_shards`` equal the JAX XLA tiers on mesh4, exactly on
    integer-valued inputs, else within 1e-5."""
    import torch
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    inp = tp["inp"]

    def check(got, want):
        if kind == "int":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    a, b = inp[f"ag_a_{kind}"], inp[f"ag_b_{kind}"]
    c, ag = _jax_ag(mesh4, JAgMethod.XLA, a, b)
    a_shards = torch.from_numpy(a).chunk(WORLD, dim=0)
    nl = b.shape[1] // WORLD
    for r in range(WORLD):
        out, got_ag = agm.ag_gemm_ref_shards(
            a_shards, torch.from_numpy(b[:, r * nl:(r + 1) * nl].copy()))
        np.testing.assert_array_equal(got_ag.numpy(), ag)
        check(out.numpy(), c[:, r * nl:(r + 1) * nl])

    a, b = inp[f"rs_a_{kind}"], inp[f"rs_b_{kind}"]
    out = _jax_rs(mesh4, JRsMethod.XLA, a, b)
    kl, m = a.shape[1] // WORLD, out.shape[0] // WORLD
    got = grs.gemm_rs_ref_shards(
        [torch.from_numpy(a[:, s * kl:(s + 1) * kl].copy())
         for s in range(WORLD)],
        [torch.from_numpy(b[s * kl:(s + 1) * kl].copy())
         for s in range(WORLD)])
    assert len(got) == WORLD
    for r in range(WORLD):
        check(got[r].numpy(), out[r * m:(r + 1) * m])


@pytest.mark.parametrize("mode", ["xla", "triton_dist"])
def test_tp4_logits_match_jax(tp, mode):
    """f32 logits of the last position: xla (the whole batch on every
    rank) and triton_dist (each rank its rows), under the port's XLA_RING
    and PALLAS tiers, within 1e-5 of the JAX model on mesh4."""
    ids = jnp.asarray(tp["inp"]["ids"])
    model = tp["model"]
    want, _ = model.inference(tp["params"], model.create_kv_cache(4), ids,
                              mode=mode)
    want = np.asarray(want)
    b = want.shape[0] // WORLD
    for r in range(WORLD):
        for meth in ("xla_ring", "pallas"):
            got = tp["ranks"][r][f"logits/{meth}/{mode}"]
            ref = want if mode == "xla" else want[r * b:(r + 1) * b]
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {meth}")


@pytest.mark.parametrize("backend", ["triton_dist", "xla"])
def test_engine_greedy_tokens_equal_jax(tp, backend):
    """Engine.serve at TP=4 returns the whole batch's greedy tokens on
    every rank, equal to the JAX Engine's on mesh4 in the same backend
    (the xla decode with mega off on both sides)."""
    prompt = jnp.asarray(tp["inp"]["prompt"])
    want = np.asarray(JEngine(tp["model"], tp["params"], temperature=0.0,
                              backend=backend, mega="off").serve(prompt,
                                                                  GEN))
    for r in range(WORLD):
        for meth in ("xla_ring", "pallas"):
            np.testing.assert_array_equal(
                tp["ranks"][r][f"tokens/{meth}/{backend}"], want,
                err_msg=f"rank {r} {meth}")


def test_rank_init_is_the_world1_draw_cut(tp):
    """init_random_params(rank=r, world=4) hands rank r the TP cut of the
    world-1 weights of the same seed ([q_r | k_r | v_r] of wqkv, the r-th
    vocabulary block of lm_head), so TP=4 computes the world-1 model;
    AutoLLM.from_pretrained with a TP context returns that shard."""
    for c in tp["checks"]:
        assert c["init_wqkv_is_world1_cut"] and c["init_lm_head_is_world1_cut"]
        assert c["init_tp_logits_err_vs_world1"] < 1e-5
        assert c["autollm_rank_shard"] is True


def test_tp_refusals_and_cpu_runtime(tp):
    """The bidirectional rings run and equal the XLA tiers (the port of
    B11 / B13b; their parity with the JAX tiers is held in
    tests/test_torch_bidir.py), n > 1 without the mesh is
    refused, the default Engine builds the mega step at n > 1 (a MoE
    graph's moe task too), the paged Engine builds at n > 1, a batch the
    world does not divide is refused; on the CPU a symmetric buffer is a
    plain tensor and notify_wait is a broadcast from rank 0."""
    for r, c in enumerate(tp["checks"]):
        for key in ("bidir_equals_xla", "no_mesh_raises",
                    "mega_builds_at_world_n",
                    "paged_builds_at_world_n", "odd_batch_raises",
                    "cpu_symm_is_plain", "notify_wait_is_rank0"):
            assert c[key] is True, (r, key)
        assert c["rank_world"] == [r, WORLD, WORLD]
