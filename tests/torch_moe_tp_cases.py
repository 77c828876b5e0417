"""Shared set-up of the MoE tensor-parallel parity tests
(tests/test_torch_moe_tp.py, test_torch_moe_tp_rs.py,
test_torch_moe_tp_model.py): the numpy inputs, the four gloo ranks of
tests/torch_moe_tp_worker.py (a FileStore under the test's tmp dir, a
150 s join that kills the ranks) and the JAX side on the suite's 4-device
``mesh4``, its Pallas kernels in interpret mode (as tests/test_moe.py runs
them), each mesh-level call under ``jax.jit`` (eager, every op of the
interpret-mode kernels dispatches on its own: ~1.5x slower). The ranks run
while the JAX side computes in the test process.
"""

from __future__ import annotations

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

from triton_dist_tpu.kernels.allgather_group_gemm import (
    AgGroupGemmMethod as JAgMethod, ag_group_gemm,
    create_ag_group_gemm_context,
)
from triton_dist_tpu.kernels.moe_reduce_rs import (
    MoeReduceRsMethod as JRsMethod, create_moe_reduce_rs_context,
    moe_reduce_rs,
)

WORLD = 4
E, TOPK, BM = 8, 2, 8         # experts, top-k, tile rows (the worker's BM)
M_LOC, K, N = 4, 32, 64       # B14: tokens per rank, hidden, gate/up width
I_DIM, D = 32, 32             # B15: intermediate width, output width
JOIN_TIMEOUT_S = 150
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_moe_tp_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX tiers each port tier is held to: XLA, and PALLAS at comm_blocks
# 1 and 4 (the B14 ring's row blocks, B15's forwarded blocks)
JAX_TIERS = ("xla", "pallas_cb1", "pallas_cb4")
# the port's tiers: XLA, XLA_RING, and PALLAS (its plain version on the
# CPU) at comm_blocks 1 and 4
PORT_TIERS = ("xla/cb4", "xla_ring/cb4", "pallas/cb1", "pallas/cb4")


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def routing(rng, m, topk, e):
    """Distinct expert ids per token (what top-k gives)."""
    return np.stack([rng.permutation(e)[:topk]
                     for _ in range(m)]).astype(np.int32)


def ops_inputs(seed: int = 17) -> dict:
    """B14 and B15 inputs over the whole batch (M = 4 x 4 tokens), each
    integer-valued (every product and sum exact in f32, whatever the
    order) and random."""
    rng = np.random.default_rng(seed)
    m = WORLD * M_LOC
    inp = {"num_experts": np.int32(E), "ids": routing(rng, m, TOPK, E)}
    for kind in ("int", "rand"):
        def draw(shape, lo=-3, hi=4):
            if kind == "int":
                return rng.integers(lo, hi, shape).astype(np.float32)
            return rng.standard_normal(shape).astype(np.float32)
        inp[f"b14_tok_{kind}"] = draw((m, K))
        inp[f"b14_w_{kind}"] = draw((E, K, N))
        inp[f"b15_inter_{kind}"] = draw((m * TOPK, I_DIM))
        inp[f"b15_w_{kind}"] = draw((E, I_DIM, D))
        w = (rng.integers(1, 4, (m, TOPK)) if kind == "int"
             else rng.uniform(0.1, 1.0, (m, TOPK)))
        inp[f"topk_w_{kind}"] = w.astype(np.float32)
    return inp


def spawn(tmp, part: str, inputs: dict):
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(WORLD), str(tmp / "store"),
         str(tmp / "inputs.npz"), str(tmp), part], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]


def join(procs, tmp):
    """The ranks' (results, checks), or the test fails with their logs."""
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
    return ([dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)],
            [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(WORLD)])


def run(tmp, part: str, inputs: dict, jax_side):
    """Spawn the ranks on ``part``, compute jax_side() here meanwhile,
    join. Returns (jax results, rank results, rank checks)."""
    procs = spawn(tmp, part, inputs)
    try:
        want = jax_side()
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ranks, checks = join(procs, tmp)
    return want, ranks, checks


def _jax_tier(tier: str):
    if tier == "xla":
        return "xla", 4
    return "pallas", int(tier.rsplit("cb", 1)[1])


def jax_b14(mesh, inp: dict, kind: str, tier: str):
    """The JAX ag_group_gemm on mesh4: (out_flat (M*topk, N), ag)."""
    method, cb = _jax_tier(tier)
    ctx = create_ag_group_gemm_context(mesh, E, TOPK,
                                       method=JAgMethod(method), bm=BM,
                                       comm_blocks=cb)
    out, ag = jax.jit(functools.partial(ag_group_gemm, ctx))(
        jnp.asarray(inp[f"b14_tok_{kind}"]), jnp.asarray(inp["ids"]),
        jnp.asarray(inp[f"b14_w_{kind}"]))
    return np.asarray(out), np.asarray(ag)


def jax_b15(mesh, inp: dict, kind: str, tier: str):
    """The JAX moe_reduce_rs on mesh4: (M, d), rank r's rows its chunk."""
    method, cb = _jax_tier(tier)
    ctx = create_moe_reduce_rs_context(mesh, E, TOPK,
                                       method=JRsMethod(method), bm=BM,
                                       comm_blocks=cb)
    return np.asarray(jax.jit(functools.partial(moe_reduce_rs, ctx))(
        jnp.asarray(inp[f"b15_inter_{kind}"]), jnp.asarray(inp["ids"]),
        jnp.asarray(inp[f"topk_w_{kind}"]),
        jnp.asarray(inp[f"b15_w_{kind}"])))


def check(got, want, kind: str, msg: str = "") -> None:
    """Exact on integer-valued inputs, within 1e-5 on random ones."""
    if kind == "int":
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=msg)
