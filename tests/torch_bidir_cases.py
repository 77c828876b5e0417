"""Shared set-up of the slice's parity tests (tests/test_torch_bidir.py,
test_torch_mesh_ops.py, test_torch_native_sched.py): the numpy inputs, the
gloo ranks of tests/torch_bidir_worker.py (a FileStore under the test's
tmp dir, a 150 s join that kills the ranks). The ranks run while the JAX
side computes in the test process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

JOIN_TIMEOUT_S = 150
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_bidir_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def op_inputs(rng, world: int = 4) -> dict:
    """AG + GEMM: a (16 world, 128) rows over the ranks, b (128, 64 world)
    columns; GEMM + RS: a (8 world, 64 world) and b (64 world, 128), K
    over the ranks; GEMM + AR: a (4 world, 64 world), b (64 world, 64);
    integer-valued (every product and sum exact in f32, whatever the
    order) and random f32. Shards of at most 8 KiB, as the interpret-mode
    ring kernels of the JAX side need."""
    inp = {}
    for kind in ("int", "rand"):
        def draw(shape):
            if kind == "int":
                return rng.integers(-3, 4, shape).astype(np.float32)
            return rng.standard_normal(shape).astype(np.float32)
        inp[f"ag_a_{kind}"] = draw((16 * world, 128))
        inp[f"ag_b_{kind}"] = draw((128, 64 * world))
        inp[f"rs_a_{kind}"] = draw((8 * world, 64 * world))
        inp[f"rs_b_{kind}"] = draw((64 * world, 128))
        inp[f"ar_a_{kind}"] = draw((4 * world, 64 * world))
        inp[f"ar_b_{kind}"] = draw((64 * world, 64))
    return inp


def spawn(tmp, part: str, inputs: dict, world: int):
    """The ``world`` ranks of ``part``, started on the inputs."""
    tmp.mkdir(parents=True, exist_ok=True)
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), str(tmp / "store"),
         str(tmp / "inputs.npz"), str(tmp), part], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def join(procs, tmp):
    """The ranks' (results, checks), or the test fails with their logs."""
    world = len(procs)
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
        pytest.fail(f"gloo ranks failed: {failed}\n{logs}")
    return ([dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)],
            [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(world)])


def check(got, want, kind: str, msg: str = "") -> None:
    """Exact on integer-valued inputs, else within rtol = atol = 1e-5."""
    if kind == "int":
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=msg)
