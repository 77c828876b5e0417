"""Shared set-up of the sequence-parallel parity tests
(tests/test_torch_sp_*.py): the numpy inputs, the gloo ranks of
tests/torch_sp_worker.py (a FileStore under the test's tmp dir, a 150 s
join that kills the ranks) and the JAX side on the suite's 4-device
``mesh4``, every mesh-level call under ``jax.jit`` (uncached, the JAX ring
tiers take ~10-20 s a call), its Pallas kernels in interpret mode. The
ranks run while the JAX side computes in the test process. The JAX PALLAS
ring kernel (B21) and combine kernel (B20) run at shapes whose puts stay
at most 8 KiB (the interpret-mode livelock boundary of tests/conftest.py).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

WORLD = 4
JOIN_TIMEOUT_S = 150
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_sp_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# prefill: every tier at a lane-aligned head (FLASH_RING / PALLAS need it)
PRE = dict(b=2, hq=4, hkv=2, d=128, t_loc=16)
PRE_METHODS = ("xla", "xla_ring", "flash_ring", "xla_block", "pallas")
ZIGZAG_METHODS = ("xla_ring", "flash_ring")
BLOCKS = (1, 4)             # comm_blocks of XLA_BLOCK / PALLAS
# varlen: 128 global rows, so the XLA tier takes B1's varlen form
VAR = dict(b=1, hq=4, hkv=2, d=128, t_loc=32)
VAR_CU = {"full": [0, 50, 97, 128], "padded": [0, 50, 97, 120]}
VAR_METHODS = ("xla", "xla_ring", "flash_ring")
VAR_SMALL = dict(b=2, hq=4, hkv=2, d=32, t_loc=8)   # the masked-fold path
# decode: S_loc % 128 != 0, the last shards empty at the offset
DEC = dict(b=2, hq=4, hkv=2, d=128, s_loc=160)
DEC_OFFSET = 301
DEC_CASES = (("xla", "xla", 1), ("xla", "pallas", 1), ("pallas", "xla", 1),
             ("pallas", "pallas", 1), ("pallas", "auto", 2),
             ("xla", "pallas", 3))   # (combine, local method, kv_splits)
PAGED = dict(b=2, hq=4, hkv=2, d=128, pages=8, ps=16, np_=4)
# the layer's prefill-then-decode consistency (the JAX test's shapes)
LAYER = dict(b=2, hq=8, hkv=4, d=16, t=16, pad=4)


def _qkv(rng, b, t, hq, hkv, d):
    return {"q": rng.standard_normal((b, t, hq, d)).astype(np.float32),
            "k": rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            "v": rng.standard_normal((b, t, hkv, d)).astype(np.float32)}


def prefill_inputs(seed: int = 41) -> dict:
    rng = np.random.default_rng(seed)
    p = PRE
    return _qkv(rng, p["b"], WORLD * p["t_loc"], p["hq"], p["hkv"], p["d"])


def zigzag_inputs() -> dict:
    """The prefill inputs and the varlen file's (big/...)."""
    return {**{f"pre/{k}": v for k, v in prefill_inputs().items()},
            **varlen_inputs()}


def varlen_inputs(seed: int = 43) -> dict:
    rng = np.random.default_rng(seed)
    out = {f"big/{k}": v for k, v in _qkv(
        rng, VAR["b"], WORLD * VAR["t_loc"], VAR["hq"], VAR["hkv"],
        VAR["d"]).items()}
    s = VAR_SMALL
    out.update({f"small/{k}": v for k, v in _qkv(
        rng, s["b"], WORLD * s["t_loc"], s["hq"], s["hkv"],
        s["d"]).items()})
    for name, cu in VAR_CU.items():
        out[f"cu/{name}"] = np.asarray(cu, np.int32)
    out["cu/small"] = np.asarray([0, 9, 20, 32], np.int32)
    return out


def decode_inputs(seed: int = 47) -> dict:
    rng = np.random.default_rng(seed)
    p, g = DEC, PAGED
    s = WORLD * p["s_loc"]
    out = {
        "q": rng.standard_normal((p["b"], p["hq"], p["d"])).astype(
            np.float32),
        "k": rng.standard_normal((p["b"], s, p["hkv"], p["d"])).astype(
            np.float32),
        "v": rng.standard_normal((p["b"], s, p["hkv"], p["d"])).astype(
            np.float32),
    }
    # paged: each rank its own pool, table into it and local lengths
    pool = (WORLD, g["hkv"], g["pages"], g["ps"], g["d"])
    out["pq"] = rng.standard_normal((g["b"], g["hq"], g["d"])).astype(
        np.float32)
    out["kp"] = rng.standard_normal(pool).astype(np.float32)
    out["vp"] = rng.standard_normal(pool).astype(np.float32)
    out["table"] = np.stack([np.stack([
        rng.permutation(g["pages"])[:g["np_"]] for _ in range(g["b"])])
        for _ in range(WORLD)]).astype(np.int32)
    out["lengths"] = np.asarray([[40, 7], [64, 1], [0, 33], [17, 0]],
                                np.int32)
    out["kp_i8"] = rng.integers(-127, 128, pool).astype(np.int8)
    out["vp_i8"] = rng.integers(-127, 128, pool).astype(np.int8)
    out["ks"] = rng.uniform(0.005, 0.02, pool[:4]).astype(np.float32)
    out["vs"] = rng.uniform(0.005, 0.02, pool[:4]).astype(np.float32)
    return out


def layer_inputs(seed: int = 53) -> dict:
    rng = np.random.default_rng(seed)
    p = LAYER
    out = _qkv(rng, p["b"], p["t"] + 1, p["hq"], p["hkv"], p["d"])
    z = np.zeros((p["b"], p["pad"] - 1, p["hkv"], p["d"]), np.float32)
    out["k_cache"] = np.concatenate([out["k"], z], axis=1)
    out["v_cache"] = np.concatenate([out["v"], z], axis=1)
    return out


def blocks(arr, world: int = WORLD, axis: int = 0):
    """Rank r's block of a global array sharded on ``axis``."""
    a = np.asarray(arr)
    n = a.shape[axis] // world
    return [np.take(a, range(r * n, (r + 1) * n), axis=axis)
            for r in range(world)]


def spawn(tmp, part: str, inputs: dict, world: int):
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(tmp / "store"),
         str(tmp / "inputs.npz"), str(tmp), part], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def join(procs, tmp, world: int):
    """The ranks' (results, checks), or the test fails with their logs."""
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
        pytest.fail(f"SP gloo ranks failed: {failed}\n{logs}")
    return ([dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)],
            [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(world)])


def run(tmp, part: str, inputs: dict, jax_side, world: int = WORLD):
    """Spawn the ranks on ``part``, compute jax_side() here meanwhile,
    join. Returns (jax results, rank results, rank checks)."""
    procs = spawn(tmp, part, inputs, world)
    try:
        want = jax_side()
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ranks, checks = join(procs, tmp, world)
    return want, ranks, checks


def jax_sp(mesh, inputs: dict, prefix: str, method: str, *, layout=None,
           comm_blocks: int = 4, cu=None):
    """The JAX sp_attention of ``method`` over the global q/k/v under
    ``inputs[prefix + 'q'|'k'|'v']`` (zigzag-sharded first for the
    zigzag layout, the output left in that order), as numpy."""
    import jax
    import jax.numpy as jnp
    from triton_dist_tpu.kernels import sp_ag_attention as sp
    q, k, v = (jnp.asarray(inputs[f"{prefix}{x}"]) for x in "qkv")
    kw = {"layout": layout} if layout else {}
    ctx = sp.create_sp_attn_context(mesh, axis="tp",
                                    method=sp.SpAttnMethod(method),
                                    comm_blocks=comm_blocks, **kw)
    cu_j = None if cu is None else jnp.asarray(cu, jnp.int32)
    if layout == "zigzag":
        q, k, v = (sp.zigzag_shard(x, WORLD) for x in (q, k, v))

    @jax.jit
    def f(q, k, v):
        return sp.sp_attention(ctx, q, k, v, cu_seqlens=cu_j)

    return np.asarray(f(q, k, v))
