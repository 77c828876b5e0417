"""The distributed language (the reference's language/__init__.py).

Device side: ``csrc/td_dist.cuh``, shared by the port's kernels that cross
ranks: ``rank``/``num_ranks`` of a Team (the rank, the world and the table
of every rank's symmetric buffer), ``notify`` (a release store or release
add of a 64-bit flag at system scope), ``wait`` (an acquire spin on a flag,
bounded: after a fixed, very large number of polls it prints the flag and
traps), ``put`` (16-byte stores into any rank's buffer) and
``barrier_all``/``barrier_neighbors`` (arrival flags). Flags carry a
per-call epoch kept on the device (see td_dist.cuh).

Host side, here: ``rank``, ``num_ranks``, ``barrier_all`` (a process-group
barrier) and ``notify_wait``, the semantics of
tutorials/01-distributed-notify-wait.py: rank 0's tensor lands in every
rank's output through a put and a flag. On the card it launches the
tutorial kernel of ``csrc/td_dist.cu``; on the CPU its plain version is a
broadcast from rank 0.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.symm import op_workspace


def rank(mesh) -> int:
    return mesh.rank


def num_ranks(mesh) -> int:
    return mesh.world


def barrier_all(mesh) -> None:
    """Every rank of the mesh reaches this point before any leaves it."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


def notify_wait_ref(mesh, x: torch.Tensor) -> torch.Tensor:
    """Plain version: rank 0's ``x`` on every rank (a broadcast)."""
    out = x.clone()
    if mesh.world > 1:
        dist.broadcast(out, src=dist.get_global_rank(mesh.group, 0),
                       group=mesh.group)
    return out


def notify_wait(mesh, x: torch.Tensor) -> torch.Tensor:
    """Tutorial 01 on this rank: after a barrier, rank 0 puts ``x`` into
    every rank's symmetric buffer and raises a flag there; each rank waits
    on its flag and returns what landed (rank 0's ``x``). CUDA tensors
    launch the kernel (counted in ``notify_wait.launches``); CPU tensors
    run ``notify_wait_ref``. Every rank calls it with x of one shape."""
    if x.device.type == "cpu":
        return notify_wait_ref(mesh, x)
    if x.dtype != torch.float32 or not x.is_contiguous() or \
            x.numel() % 4:
        raise ValueError("notify_wait: a contiguous f32 tensor of a "
                         "multiple of 4 elements")
    ws = op_workspace(mesh, ("notify_wait", tuple(x.shape)), x.shape,
                      torch.float32)
    out = torch.empty_like(x)
    fn = build.function("td_dist", "td_notify_wait", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p))
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), mesh.rank, mesh.world,
                 ws.buf.table.data_ptr(), ws.buf.sig_off, ws.ctl.data_ptr(),
                 x.numel() * 4, build.stream_of(x))
    build.check(err, "notify_wait")
    notify_wait.launches += 1
    return out


notify_wait.launches = 0
