"""One gloo rank of the small collectives and pipeline point-to-point at
world n (tests/test_torch_ll_comm.py).

    python tests/torch_ll_comm_worker.py RANK WORLD STORE INPUTS OUTDIR

Every rank joins a gloo group (FileStore rendezvous at STORE), takes its
row shard of each input in INPUTS (rows r*m .. (r+1)*m; bf16 arrives as
its uint16 bits) and runs the port's entry points on it:
``fast_allgather`` under every method, ``LowLatencyAllGatherLayer``,
``p2p_put_op``, ``CommOp`` (on a "pp" mesh), ``ring_shift_op`` and
``barrier_all_op``. It saves each output ("ag/..." the gathered rows,
the others its output shard) in OUTDIR/rank{r}.npz, bf16 as uint16 bits,
and the launch counts and any error in rank{r}.json.
"""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from torch_world import finish  # noqa: E402
from triton_dist_tpu_torch.kernels import (  # noqa: E402
    LLAllGatherMethod,
    barrier_all_op,
    create_fast_allgather_context,
    fast_allgather,
    launch_counts,
    p2p_put_op,
    ring_shift_op,
)
from triton_dist_tpu_torch.layers import (  # noqa: E402
    CommOp,
    LowLatencyAllGatherLayer,
)
from triton_dist_tpu_torch.runtime import mesh as tp_mesh  # noqa: E402

AG_METHODS = ("xla", "full_mesh", "bidir_ring", "ring_2d", "auto")
P2P_PAIRS = ((2, 3), (0, 3), (3, 0), (1, 1))
SHIFTS = (1, 3, 0, 5)
COMM_SHIFTS = (1, 3)
SEND_RECV = (0, 2)


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy input as a torch tensor; uint16 arrays are bf16 bits."""
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A torch output as numpy; bf16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def shard(a: np.ndarray, rank: int, world: int) -> torch.Tensor:
    m = a.shape[0] // world
    return to_torch(a[rank * m:(rank + 1) * m])


def run_ops(inp, mesh, pp, out: dict) -> None:
    """Every entry point of the slice on this rank's shards."""
    r, n = mesh.rank, mesh.world
    for key in (k for k in inp.files if k.startswith("ag_in/")):
        x = shard(inp[key], r, n)
        for name in AG_METHODS:
            ctx = create_fast_allgather_context(
                mesh, "tp", method=LLAllGatherMethod(name),
                nx=2 if name == "ring_2d" else None)
            out[f"ag/{name}/{key[6:]}"] = to_numpy(fast_allgather(ctx, x))
    x = shard(inp["x"], r, n)
    out["layer"] = to_numpy(LowLatencyAllGatherLayer.create(mesh)(x))
    for src, dst in P2P_PAIRS:
        out[f"p2p/{src}_{dst}"] = to_numpy(p2p_put_op(mesh, "tp", x, src,
                                                      dst))
    comm = CommOp(pp)
    out["comm/send_recv"] = to_numpy(comm.send_recv(x, *SEND_RECV))
    for by in COMM_SHIFTS:
        out[f"comm/shift{by}"] = to_numpy(comm.shift(x, by=by))
    for s in SHIFTS:
        out[f"shift/{s}"] = to_numpy(ring_shift_op(mesh, "tp", x, shift=s))
    out["barrier"] = to_numpy(barrier_all_op(mesh, "tp", x))


def main(rank: str, world: str, store: str, inputs: str, outdir: str):
    rank, world = int(rank), int(world)
    checks: dict = {}
    out: dict = {}
    try:
        tp_mesh.initialize_distributed(f"file://{store}", world, rank,
                                       device="cpu")
        mesh = tp_mesh.make_comm_mesh()
        pp = tp_mesh.make_comm_mesh(axes=[("pp", world)])
        run_ops(np.load(inputs), mesh, pp, out)
        checks["launches"] = launch_counts()
        dist.barrier()
        checks["error"] = None
    except BaseException:
        checks["error"] = traceback.format_exc()
    finish(rank, outdir, out, checks)


if __name__ == "__main__":
    main(*sys.argv[1:])
