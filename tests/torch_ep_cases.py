"""Shared set-up of the expert-parallel parity tests
(tests/test_torch_ep_a2a.py, test_torch_ep_model.py,
test_torch_ep_continuous.py): the numpy inputs, the gloo ranks of
tests/torch_ep_worker.py (a FileStore under the test's tmp dir, a 150 s
join that kills the ranks) and the JAX side on the suite's 4-device
``mesh4`` (or a 2-device mesh), its Pallas kernels in interpret mode (as
tests/test_moe.py runs them). The ranks run while the JAX side computes in
the test process. Slots stay at most 8 KiB: the interpret-mode kernels
simulate every DMA. The JAX PALLAS_FUSED kernel does not run here: in
interpret mode it did not finish when a second configuration of it ran in
one process, or while other JAX interpret work ran in another process
(one run alone takes ~20 s), and the suite runs files side by side; B16
is held to the reference's definition of it instead (ROADMAP queue C).
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
E, TOPK = 8, 2                # experts, top-k (2 local experts a rank)
M_LOC, K, NI = 4, 32, 32      # tokens a rank, hidden, gate/up width
MAX_M = M_LOC * TOPK          # the routing's worst case: never drops
SMALL_M = 2                   # below it: over-capacity pairs drop
EP_LAYERS, EP_MAX_LEN, EP_GEN = 1, 32, 4   # the EP model and its serves
METHODS = ("xla", "pallas")
JOIN_TIMEOUT_S = 150
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_ep_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def ops_inputs(seed: int = 31) -> dict:
    """The dispatch / combine / B16 / fp8 inputs over the whole batch
    (M = 4 x 4 tokens): random and integer-valued tokens, the routing and
    its weights, every rank's expert outputs for combine ((n, max_m, K) a
    rank at both capacities), the gate/up weights of all 8 experts, and
    the slots of the quantized all-to-all."""
    rng = np.random.default_rng(seed)
    m = WORLD * M_LOC
    return {
        "tok": rng.standard_normal((m, K)).astype(np.float32),
        "tok_int": rng.integers(-3, 4, (m, K)).astype(np.float32),
        "ids": routing(rng, m, TOPK, E),
        "topk_w": rng.uniform(0.1, 1.0, (m, TOPK)).astype(np.float32),
        **{f"expert_out_m{mm}": rng.standard_normal(
            (WORLD * WORLD, mm, K)).astype(np.float32)
           for mm in (MAX_M, SMALL_M)},
        "w_gate_up_int": rng.integers(-3, 4, (E, K, NI)).astype(np.float32),
        "q_slots": (rng.standard_normal((WORLD * WORLD, MAX_M, K))
                    * rng.uniform(0.01, 30, (WORLD * WORLD, MAX_M, 1))
                    ).astype(np.float32),
    }


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
        pytest.fail(f"EP gloo ranks failed: {failed}\n{logs}")
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


def jax_ep_model(mesh, inp: dict, world: int = WORLD):
    """The JAX EP model of the model / engine tests and its parameters,
    f32, from the numpy parameters in ``inp`` ("param/...")."""
    import dataclasses
    import jax.numpy as jnp
    from triton_dist_tpu.layers import TPContext
    from triton_dist_tpu.models import Qwen3MoE, tiny_qwen3_moe
    from triton_dist_tpu.models.weights import put_params
    arch = dataclasses.replace(
        tiny_qwen3_moe(num_layers=EP_LAYERS, tp=world, num_experts=E,
                       topk=TOPK), moe_parallel="ep")
    ctx = TPContext(mesh, "tp", interpret=True)
    raw = {}
    for key, val in inp.items():
        if key.startswith("param/"):
            node = raw
            parts = key[len("param/"):].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = jnp.asarray(val)
    params = put_params(raw, arch, ctx)
    return arch, ctx, Qwen3MoE(arch, ctx, max_length=EP_MAX_LEN,
                               dtype=jnp.float32), params


def blocks(arr, world: int = WORLD):
    """Rank r's block of a global array sharded on its leading dim."""
    a = np.asarray(arr)
    n = a.shape[0] // world
    return [a[r * n:(r + 1) * n] for r in range(world)]

