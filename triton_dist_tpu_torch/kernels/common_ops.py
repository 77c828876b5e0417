"""Shared device ops (the reference's kernels/common_ops.py): the device
barrier and the ring shift, and the launcher that the small collectives
B22-B26 share (one CUDA source, ``csrc/ll_collectives.cu``).

Every rank calls an op with its shard x (any shape, any dtype: the kernels
move bytes) and gets its output shard. At world n > 1 (``mesh`` is the
ranks' Mesh):

  * B25, ``barrier_all_per_device``: a barrier across the ranks, then x
    copied to a fresh output, which so depends on every rank having
    arrived (the hand-written kernel for CUDA tensors; for CPU tensors
    ``plain.barrier_ref``, the process group's barrier and a copy);
  * B26, ``ring_shift_per_device``: the shard of rank (me - shift) mod n,
    one put of the own shard ``shift`` hops right and no barrier (the
    kernel for CUDA tensors; ``plain.ring_shift_ref``, a send / receive
    pair, for CPU tensors).

At world 1 both are the identity. The mesh-level ``barrier_all_op`` and
``ring_shift_op`` have no fault preamble (ROADMAP A8) and no fallback: a
kernel that fails raises.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels.plain import barrier_ref, ring_shift_ref
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.mesh import comm_axis_size
from triton_dist_tpu_torch.runtime.symm import op_workspace

_OPS = {"bidir": 0, "ring2d": 1, "p2p": 2, "barrier": 3, "shift": 4}
# (landing slots, halves) of each kernel's symmetric buffer: a slot per
# rank for the all-gathers, one for the put and the shift; halves by the
# epoch's parity where no barrier orders the calls
_SLOTS = {"bidir": (None, 2), "ring2d": (None, 2), "p2p": (1, 1),
          "barrier": (0, 1), "shift": (1, 2)}
_BLOCK_BYTES = 8192     # bytes of a shard each block aims to own
_ALIGN = 256


def _round_up(x: int, a: int = _ALIGN) -> int:
    return -(-x // a) * a


def ll_plan(mesh, shard_bytes: int) -> tuple[int, int]:
    """(16-byte units a piece, pieces = blocks) for a shard: about
    _BLOCK_BYTES a block, at most one block an SM for each rank sharing
    the card, so that all of them are resident at once (in the one-card
    world B22 hung at 80 blocks a rank, 320 of the 396 its occupancy
    query allowed; at one an SM every rank's blocks ran)."""
    units = -(-shard_bytes // 16)
    sms = torch.cuda.get_device_properties(mesh.device).multi_processor_count
    cap = max(1, sms // mesh.ranks_per_device)
    blocks = max(1, min(-(-shard_bytes // _BLOCK_BYTES), units, cap))
    rb = -(-units // blocks)
    return rb, -(-units // rb)


def ll_launch(kind: str, mesh, x: torch.Tensor, out: torch.Tensor,
              a: int = 0, b: int = 0) -> torch.Tensor:
    """Launch kernel ``kind`` of csrc/ll_collectives.cu ("bidir" B22,
    "ring2d" B23 with a = nx, "p2p" B24 with a = src and b = dst,
    "barrier" B25, "shift" B26 with a = shift) on this rank's contiguous
    x into out; returns out. Every rank calls it with the same kind and
    shard bytes, in the same order."""
    shard = x.numel() * x.element_size()
    if not x.is_contiguous() or shard == 0:
        raise ValueError(f"{kind}: x must be a non-empty contiguous "
                         f"tensor; got {tuple(x.shape)}")
    n = mesh.world
    rb, grid = ll_plan(mesh, shard)
    slots, halves = _SLOTS[kind]
    slots = n if slots is None else slots
    flag_off = _round_up(halves * slots * _round_up(shard, 16))
    ack_off = flag_off + 8 * grid
    flags = max(slots, 1) * grid + (grid if kind == "shift" else 0)
    # B26's acknowledgements order the calls of one shift: a workspace per
    # shift
    key = ("ll_" + kind, shard) + ((a,) if kind == "shift" else ())
    ws = op_workspace(mesh, key, (flag_off + 8 * flags,), torch.uint8)
    fn = build.function("ll_collectives", "td_ll_collective", (
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p))
    with torch.cuda.device(x.device):
        err = fn(_OPS[kind], x.data_ptr(), out.data_ptr(), mesh.rank, n,
                 ws.buf.table.data_ptr(), ws.buf.sig_off, ws.ctl.data_ptr(),
                 shard, rb, flag_off, ack_off, a, b, grid,
                 mesh.ranks_per_device, build.stream_of(x))
    build.check(err, kind)
    return out


def contiguous_cuda(x: torch.Tensor, what: str) -> torch.Tensor:
    """x as the kernels take it: contiguous, on a card (else raises)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.contiguous()


def barrier_all_per_device(mesh, x: torch.Tensor) -> torch.Tensor:
    """B25 on this rank: x, copied to a fresh tensor once every rank of
    the mesh has arrived. CUDA tensors launch the kernel (counted in
    ``barrier_all_per_device.launches``); CPU tensors run
    ``plain.barrier_ref``. Every rank calls it with the same shard bytes,
    in the same order."""
    if mesh is None or mesh.world == 1:
        return x
    if x.device.type == "cpu":
        return barrier_ref(mesh, x)
    x = contiguous_cuda(x, "barrier_all")
    out = ll_launch("barrier", mesh, x, torch.empty_like(x))
    barrier_all_per_device.launches += 1
    return out


barrier_all_per_device.launches = 0


def ring_shift_per_device(mesh, x: torch.Tensor,
                          shift: int = 1) -> torch.Tensor:
    """B26 on this rank: the shard of rank (me - shift) mod n, a fresh
    tensor (shift 0 is a put to oneself). CUDA tensors launch the kernel
    (counted in ``ring_shift_per_device.launches``); CPU tensors run
    ``plain.ring_shift_ref``. Every rank calls it with the same shape and
    shift, in the same order."""
    if mesh is None or mesh.world == 1:
        return x
    if x.device.type == "cpu":
        return ring_shift_ref(mesh, x, shift)
    x = contiguous_cuda(x, "ring_shift")
    out = ll_launch("shift", mesh, x, torch.empty_like(x),
                    a=shift % mesh.world)
    ring_shift_per_device.launches += 1
    return out


ring_shift_per_device.launches = 0


def barrier_all_op(mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """Pass this rank's x through a device-side barrier along ``axis``
    (the reference's ``barrier_all_op``): the output is x, and depends on
    the barrier."""
    comm_axis_size(mesh, axis)
    return barrier_all_per_device(mesh, x)


def ring_shift_op(mesh, axis: str, x: torch.Tensor,
                  shift: int = 1) -> torch.Tensor:
    """Rotate the shards around the ring (the reference's
    ``ring_shift_op``): rank i returns the shard of rank (i - shift) mod
    n."""
    comm_axis_size(mesh, axis)
    return ring_shift_per_device(mesh, x, shift)
