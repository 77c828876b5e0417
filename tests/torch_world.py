"""The ending that every gloo rank worker of the port's tests shares, and
a launcher of such workers.

A rank writes its results (``rank{r}.npz``, ``rank{r}.json`` with
``"error"`` None, or the traceback) and then ends its process at once,
with ``os._exit(0)``, without tearing the gloo process group down in the
process. Tearing it down (``dist.destroy_process_group()`` and the
interpreter's shutdown after it) destroys gloo's transport loop and
worker threads while peers close their sockets at their own times; a rank
now and then aborted there with SIGABRT (``terminate called without an
active exception``: a std::thread destroyed while still joinable, which
gloo's ``tcp::Loop`` and ``ProcessGroupGloo`` destructors do when their
threads race the teardown). The worker's last collective is the barrier
before its results, so nothing is in flight when it ends, and the fixture
still fails on any nonzero exit code, missing rank file or error.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 150


def finish(rank: int, outdir: str, out: dict, checks: dict) -> None:
    """Write this rank's results into outdir and end the process (exit
    code 0); never returns."""
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(checks, f)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


def run_world(worker: str, tmp, world: int, inputs: dict, side=None):
    """Spawn ``world`` ranks of tests/``worker`` (args: rank, world, a
    FileStore path, the inputs' npz, tmp), run side() here meanwhile,
    and join them. Returns (side's result, the ranks' npz dicts, their
    json checks); the test fails on any nonzero exit code, missing rank
    file, rank error or a join past JOIN_TIMEOUT_S (the ranks are then
    killed)."""
    import pytest
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", worker), str(r),
         str(world), str(tmp / "store"), str(tmp / "inputs.npz"), str(tmp)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    deadline = time.time() + JOIN_TIMEOUT_S
    failed, want = None, None
    try:
        if side is not None:
            want = side()
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
        pytest.fail(f"gloo ranks of {worker} failed: {failed}\n{logs}")
    return (want,
            [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)],
            [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(world)])
