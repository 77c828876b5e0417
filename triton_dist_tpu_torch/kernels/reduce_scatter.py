"""ReduceScatter across ranks (the reference's kernels/reduce_scatter.py).

Every rank holds x (n*m, K); rank r returns rows [r*m, (r+1)*m) of the
sum over the ranks. Methods at world n > 1 (``mesh`` is the ranks' Mesh):

  * XLA — ``dist.reduce_scatter_tensor`` (NCCL on the card), the
    reference's ``psum_scatter``;
  * RING_1D — B9, ``ring_reduce_scatter``: the hand-written CUDA kernel
    ``csrc/ring_collectives.cu`` for CUDA tensors, ``ring_rs_ref`` for CPU
    tensors. The reference's ring fold: chunk c starts raw at rank c+1 and
    every hop adds the next rank's rows (incoming + local, in x's dtype),
    so rank c's chunk is x_{c+1} + x_{c+2} + ... + x_c; every chunk has
    one value, whichever rank computes it. On the card the ring's hops
    become one (an NVSwitch full mesh): every rank stores each chunk
    straight into its owner's slot for that term, and the owner folds the
    slots in the ring's order (``ring_plan``);
  * AUTO — RING_1D on CUDA at n > 1, XLA elsewhere (the reference's
    ``_resolve_auto``, with "on a TPU" read as "on CUDA").

At world 1 the reduce-scatter is the identity. n must divide the rows:
anything else raises a ValueError (the reference's per-device body
divides by ``full_m // n`` and fails). No fallback: a CUDA call the
kernel does not take raises. The mesh-level ``reduce_scatter_op`` (with
the reference's fault preamble) waits for ROADMAP A8.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum
import functools

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels.allreduce import _DTYPE_CODE
from triton_dist_tpu_torch.kernels.plain import all_gather_list, ring_rs_fold
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.symm import op_workspace

_ALIGN = 256


class ReduceScatterMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    RING_1D = "ring_1d"


def resolve_reduce_scatter_method(method: ReduceScatterMethod, n: int,
                                  cuda: bool) -> ReduceScatterMethod:
    """AUTO -> RING_1D on CUDA at n > 1, XLA elsewhere."""
    if method != ReduceScatterMethod.AUTO:
        return method
    return (ReduceScatterMethod.RING_1D if cuda and n > 1
            else ReduceScatterMethod.XLA)


def rows_per_rank(n: int, x: torch.Tensor, what: str) -> int:
    """x's rows per rank; raises unless n divides them."""
    if x.ndim != 2 or x.shape[0] % n:
        raise ValueError(f"{what} needs 2-D x with rows divisible by the "
                         f"world {n}; got {tuple(x.shape)}")
    return x.shape[0] // n


def ring_rs_ref(mesh, x: torch.Tensor) -> torch.Tensor:
    """Plain version of B9 over the process group: every rank's x, this
    rank's chunk folded in the ring's order, in x's dtype."""
    rows_per_rank(mesh.world, x, "reduce_scatter")
    return ring_rs_fold(all_gather_list(mesh, x), mesh.rank)


def ring_rs_ref_shards(xs) -> list[torch.Tensor]:
    """Plain version of B9 over every rank's x in one process (the
    one-card world): the ranks' outputs in rank order."""
    rows_per_rank(len(xs), xs[0], "reduce_scatter")
    return [ring_rs_fold(xs, r) for r in range(len(xs))]


def _round_up(x: int, a: int = _ALIGN) -> int:
    return -(-x // a) * a


# Threads a block of B9 / B7 (csrc/ring_collectives.cu NT).
_NT = 256
# B9 / B7 protocol: LL (the epoch inside each 16-byte line) while a slot
# (one rank's m rows for one owner) holds at most this many bytes, flags
# above. Four H100s (chip_smoke.py tp4_ring, rows of 5120 bf16, the
# slowest rank): up to 8 rows (80 KiB) LL takes B9 0.0069-0.0095 ms and
# B7 0.0060-0.0081 against flags' 0.0092-0.0096 and 0.0103-0.0105; at
# 16 rows (160 KiB) B9 under flags 0.0101 against 0.0122 (B7 0.0110
# against 0.0104), and the gap grows with the bytes (64 rows: 0.019
# against 0.031). The grid grows with the rows, so a block's bytes stay
# ~4 KiB and cannot tell the sizes apart; a grid fixed at one block an
# SM, under which they can, was 0.3-2.4 us slower at 1-32 rows.
LL_MAX_SLOT_BYTES = 128 * 1024


@dataclasses.dataclass(frozen=True)
class RingPlan:
    """What a launch of B9 or B7 passes besides its tensors, the same on
    every rank of a world (one plan for both: each moves n - 1 slots of m
    rows of kv 16-byte vectors into every rank). grid: blocks, block b
    owning vectors [b kv / grid, (b + 1) kv / grid) of every row. ll: the
    LL protocol (each vector as two 16-byte lines that carry the epoch; no
    flags) or flags. slot_bytes: one slot; the kernel finds slot j of
    parity P at byte (P (n - 1) + j) slot_bytes of the op's symmetric
    buffer, and rank r's rows for owner p in slot (r - p - 1) mod n.
    flag_off: the u64 flags, (grid, n - 1) (none under LL). nbytes: the
    buffer's size."""
    m: int
    kv: int
    grid: int
    ll: bool
    slot_bytes: int
    flag_off: int
    nbytes: int


def ring_layout(world: int, m: int, kv: int, grid: int, ll: bool) -> RingPlan:
    """The plan of B9 / B7 at m rows of kv vectors a rank chunk, on `grid`
    blocks, under the protocol ``ll``: the slots (2 parities x world - 1,
    from byte 0), then the flags."""
    slot_bytes = m * kv * 16 * (2 if ll else 1)
    data = 2 * (world - 1) * slot_bytes
    flag_off = _round_up(data)
    nbytes = data if ll else flag_off + 8 * grid * (world - 1)
    return RingPlan(m, kv, grid, ll, slot_bytes, flag_off, nbytes)


@functools.lru_cache(maxsize=None)
def ring_plan(world: int, m: int, k: int, itemsize: int, sm_count: int,
              ranks_per_device: int) -> RingPlan:
    """The plan of B9 / B7 at m rows a rank chunk of K columns: the grid
    (a vector a thread per slot, so the stores and waits spread over as
    many SMs as the rows need, at most one block an SM per rank that
    shares the card and one a column vector) and the protocol (LL while a
    slot holds at most LL_MAX_SLOT_BYTES)."""
    kv = k * itemsize // 16
    grid = max(1, min(kv, -(-m * kv // _NT), sm_count // ranks_per_device))
    return ring_layout(world, m, kv, grid, m * kv * 16 <= LL_MAX_SLOT_BYTES)


def _workspace(kind: str, mesh, plan: RingPlan, dtype: torch.dtype):
    """The symmetric buffer of B9 (kind "ring_rs") or B7 ("ring_ag") under
    ``plan``, made at the first call (a collective allocation; never under
    capture), with a control block of an epoch word a block."""
    return op_workspace(mesh, (kind, dtype, plan), (plan.nbytes,),
                        torch.uint8, ctl_words=plan.grid)


def ring_workspace(kind: str, mesh, m: int, k: int, dtype: torch.dtype):
    """(workspace, plan) of B9 (kind "ring_rs") or B7 ("ring_ag") at m
    rows a rank chunk of K columns."""
    sms = torch.cuda.get_device_properties(mesh.device).multi_processor_count
    plan = ring_plan(mesh.world, m, k, dtype.itemsize, sms,
                     mesh.ranks_per_device)
    return _workspace(kind, mesh, plan, dtype), plan


# td_ring_rs / td_ring_ag's arguments up to ranks_per_device (B9 then
# takes its dtype; both end with the stream)
_RING_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_int)


def ring_launch(kind: str, mesh, x: torch.Tensor, m: int) -> torch.Tensor:
    """Launch B9 (kind "ring_rs": x (n*m, K) -> (m, K)) or B7 ("ring_ag":
    x (m, K) -> (n*m, K)) on this rank's x, under its plan."""
    what = "ring_reduce_scatter" if kind == "ring_rs" else "ring_all_gather"
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: dtype {x.dtype} not in "
                         f"{list(_DTYPE_CODE)}")
    if x.ndim != 2 or not x.is_contiguous() or x.data_ptr() % 16 or \
            (x.shape[1] * x.element_size()) % 16 or x.numel() == 0:
        raise ValueError(f"{what}: x must be a non-empty contiguous 2-D "
                         "tensor, 16-byte aligned, rows a multiple of 16 "
                         f"bytes; got {tuple(x.shape)}")
    _, plan = ring_workspace(kind, mesh, m, x.shape[1], x.dtype)
    return _launch(kind, mesh, x, plan)


def _launch(kind: str, mesh, x: torch.Tensor, plan: RingPlan) -> torch.Tensor:
    """ring_launch's launch under a given plan (chip_smoke.py's protocol
    sweep forces one through ``ring_layout``)."""
    what = "ring_reduce_scatter" if kind == "ring_rs" else "ring_all_gather"
    n, k = mesh.world, x.shape[1]
    ws = _workspace(kind, mesh, plan, x.dtype)
    out = x.new_empty((plan.m, k) if kind == "ring_rs" else (n * plan.m, k))
    args = (x.data_ptr(), out.data_ptr(), mesh.rank, n,
            ws.buf.table.data_ptr(), ws.ctl.data_ptr(), plan.m, plan.kv,
            plan.slot_bytes, plan.flag_off, plan.grid, int(plan.ll),
            mesh.ranks_per_device)
    types = _RING_ARGTYPES
    if kind == "ring_rs":
        args += (_DTYPE_CODE[x.dtype],)
        types += (ctypes.c_int,)
    with torch.cuda.device(x.device):
        fn = build.function("ring_collectives", f"td_{kind}",
                            types + (ctypes.c_void_p,))
        err = fn(*args, build.stream_of(x))
    build.check(err, what)
    return out


# Round trips a flag_round_trip call makes (csrc/ring_collectives.cu
# kRoundTrips).
ROUND_TRIPS = 2000


def flag_round_trip(mesh):
    """Launch the flag ping-pong of ``csrc/ring_collectives.cu`` on this
    rank: ranks 0 and 1 bounce one flag ROUND_TRIPS times (the others
    return at once), so its device time over ROUND_TRIPS is one round trip
    between them, the latency floor of a one-hop kernel such as B9 or B7.
    No TPU kernel and no plain version: a measurement, on the card only.
    Every rank of the world calls it, in the same order."""
    if mesh.device.type != "cuda":
        raise ValueError("flag_round_trip: a measurement of the card")
    ws = op_workspace(mesh, ("ring_pingpong",), (16,), torch.uint8,
                      ctl_words=1)
    with torch.cuda.device(mesh.device):
        fn = build.function("ring_collectives", "td_ring_pingpong", (
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p))
        err = fn(mesh.rank, mesh.world, ws.buf.table.data_ptr(),
                 ws.ctl.data_ptr(),
                 torch.cuda.current_stream(mesh.device).cuda_stream)
    build.check(err, "flag_round_trip")


def ring_reduce_scatter(mesh, x: torch.Tensor) -> torch.Tensor:
    """B9 on this rank: row chunk ``mesh.rank`` of the sum over the ranks
    of x (n*m, K), folded in the ring's order in x's dtype; a fresh (m, K)
    tensor. CUDA tensors launch the kernel (counted in
    ``ring_reduce_scatter.launches``); CPU tensors run ``ring_rs_ref``.
    Every rank calls it with the same shape, in the same order."""
    if x.device.type == "cpu":
        return ring_rs_ref(mesh, x)
    if x.device.type != "cuda":
        raise ValueError(f"ring_reduce_scatter: unsupported device "
                         f"{x.device}")
    m = rows_per_rank(mesh.world, x, "reduce_scatter")
    out = ring_launch("ring_rs", mesh, x, m)
    ring_reduce_scatter.launches += 1
    return out


ring_reduce_scatter.launches = 0


def reduce_scatter_per_device(n: int, method: ReduceScatterMethod,
                              x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The reference's per-device entry: this rank's x (n*m, K) -> its
    (m, K) chunk of the sum over the n ranks. ``mesh`` (the ranks' Mesh)
    is needed at n > 1."""
    if n == 1:
        return x
    rows_per_rank(n, x, "reduce_scatter")
    if mesh is None or mesh.world != n:
        raise ValueError(f"reduce_scatter at world {n} needs the mesh of "
                         f"its {n} ranks; got {mesh}")
    method = resolve_reduce_scatter_method(method, n, x.is_cuda)
    if method == ReduceScatterMethod.XLA:
        out = x.new_empty((x.shape[0] // n, x.shape[1]))
        dist.reduce_scatter_tensor(out, x.contiguous(), group=mesh.group)
        return out
    if method == ReduceScatterMethod.RING_1D:
        return ring_reduce_scatter(mesh, x)
    raise ValueError(f"unresolved method {method}")
