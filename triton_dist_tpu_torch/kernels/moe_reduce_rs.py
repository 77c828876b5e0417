"""MoE down projection + top-k reduce + ReduceScatter (the reference's
kernels/moe_reduce_rs.py), at world 1, where the reduce-scatter is the
identity: y (M, d) = the weighted top-k sum of each token's expert outputs.

  * XLA, XLA_RING — sort by expert, one grouped product in f32, unsort,
    weighted top-k reduce, cast (a ring of one step is the one chunk's
    partial).
  * PALLAS — B15 over the block-aligned schedule: ``moe_rs`` launches the
    hand-written CUDA kernel ``csrc/moe_group_gemm.cu`` for CUDA tensors
    and runs ``moe_rs_ref``, its plain PyTorch version, for CPU tensors.
    No fallback: a CUDA tensor the kernel does not take raises. As in the
    reference, chunks over 1024 tokens raise.

World > 1 (the ring reduce-scatter of the partials) waits for ROADMAP A10.
"""

from __future__ import annotations

import ctypes
import enum

import torch

from triton_dist_tpu_torch.kernels import moe_utils
from triton_dist_tpu_torch.kernels.allgather_group_gemm import (
    check_moe_world, check_schedule, k_split,
)
from triton_dist_tpu_torch.kernels.plain import dot_f32
from triton_dist_tpu_torch.runtime import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
PALLAS_MAX_CHUNK = 1024   # the reference's limit on the PALLAS chunk


class MoeReduceRsMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    XLA_RING = "xla_ring"
    PALLAS = "pallas"


def resolve_moe_reduce_rs_method(method: MoeReduceRsMethod, m: int, n: int,
                                 cuda: bool = False) -> MoeReduceRsMethod:
    """The port's AUTO rule at world 1: PALLAS (the kernel) on CUDA when
    the chunk holds at most 1024 tokens, XLA otherwise and on the CPU.
    The reference's rule sizes chunks for its ring, which world 1 does not
    have (queue C)."""
    if method != MoeReduceRsMethod.AUTO:
        return method
    check_moe_world(n, "moe_reduce_rs")
    return (MoeReduceRsMethod.PALLAS if cuda and m // n <= PALLAS_MAX_CHUNK
            else MoeReduceRsMethod.XLA)


def _chunk_moe_partial(inter_c, ids_c, w_c, experts_w, num_experts):
    """Grouped GEMM + top-k reduce of one token chunk -> (m_c, d) f32."""
    st = moe_utils.sort_by_expert(ids_c, num_experts)
    lhs = inter_c[st.sort_idx.long()]
    out_sorted = moe_utils.grouped_gemm(lhs, experts_w, st.group_sizes,
                                        out_dtype=torch.float32)
    flat = moe_utils.unsort(out_sorted, st)
    return moe_utils.reduce_topk(flat, w_c)


def moe_rs_ref(inter: torch.Tensor, experts_w: torch.Tensor,
               topk_ids: torch.Tensor, topk_weights: torch.Tensor,
               sched: moe_utils.AlignedSchedule) -> torch.Tensor:
    """Plain version of B15 at one chunk: tile by tile, the tile's rows
    of ``inter`` (row_flat, the sentinel clamped) times its expert's
    weight in f32, each live slot's row times its top-k weight added to
    its token's f32 accumulator (tile order: ascending expert), one cast.
    Reads used_tiles on the host."""
    m, topk = topk_ids.shape
    nf = m * topk
    t_tiles = sched.tile_expert.shape[1]
    bm = sched.row_flat.shape[1] // t_tiles
    acc = torch.zeros((m, experts_w.shape[-1]), dtype=torch.float32,
                      device=inter.device)
    w_flat = topk_weights.reshape(-1).float()
    for t in range(int(sched.used_tiles[0])):
        slots = sched.row_flat[0, t * bm:(t + 1) * bm]
        o = dot_f32(inter[slots.clamp(max=nf - 1).long()],
                    experts_w[int(sched.tile_expert[0, t])])
        f = slots[slots < nf].long()
        acc.index_add_(0, f // topk, w_flat[f, None] * o[slots < nf])
    return acc.to(torch.result_type(inter, experts_w))


def moe_rs(inter: torch.Tensor, experts_w: torch.Tensor,
           topk_ids: torch.Tensor, topk_weights: torch.Tensor,
           sched: moe_utils.AlignedSchedule) -> torch.Tensor:
    """B15 at one chunk: y (M, d) = cast(sum over each token's choices of
    w * (inter row @ its expert's weight), f32 accumulation). CUDA tensors
    launch the kernel (counted in ``moe_rs.launches``); CPU tensors run
    ``moe_rs_ref``."""
    if inter.device.type == "cpu":
        return moe_rs_ref(inter, experts_w, topk_ids, topk_weights, sched)
    if inter.device.type != "cuda":
        raise ValueError(f"moe_rs: unsupported device {inter.device}")
    return _launch(inter.contiguous(), experts_w, topk_ids, topk_weights,
                   sched)


moe_rs.launches = 0


def _pallas_moe_rs_per_device(n, num_experts, topk, bm, inter, topk_ids,
                              topk_weights, experts_w, sched=None):
    m = topk_ids.shape[0]
    mc = m // n
    if mc > PALLAS_MAX_CHUNK:
        raise ValueError(
            f"PALLAS moe_reduce_rs supports chunks up to "
            f"{PALLAS_MAX_CHUNK} tokens (got {mc}); use XLA_RING for large "
            "prefill batches")
    bm = min(bm, max(8, mc * topk))
    if sched is None:
        sched = moe_utils.aligned_chunk_schedule(topk_ids, n, num_experts,
                                                 bm)
    t_tiles = sched.tile_expert.shape[1]
    if sched.row_token.shape[1] != t_tiles * bm:
        raise ValueError(
            f"schedule row length {sched.row_token.shape[1]} != "
            f"t_tiles*bm = {t_tiles}*{bm}; the schedule was built with a "
            "different block size than the kernel is running")
    return moe_rs(inter, experts_w, topk_ids, topk_weights, sched)


def moe_reduce_rs_per_device(n: int, num_experts: int, topk: int,
                             method: MoeReduceRsMethod, inter: torch.Tensor,
                             topk_ids: torch.Tensor,
                             topk_weights: torch.Tensor,
                             experts_w: torch.Tensor, bm: int = 128,
                             sched=None, comm_blocks: int = 4):
    """The reference's per-device body at world n = 1. inter (M*topk, I)
    token-major; topk_ids / topk_weights (M, topk); experts_w (E, I, d).
    Returns (M, d). comm_blocks sizes the ring's blocks, of which world 1
    has none."""
    check_moe_world(n, "moe_reduce_rs")
    out_dtype = torch.result_type(inter, experts_w)
    if method in (MoeReduceRsMethod.XLA, MoeReduceRsMethod.XLA_RING):
        return _chunk_moe_partial(inter, topk_ids, topk_weights, experts_w,
                                  num_experts).to(out_dtype)
    if method == MoeReduceRsMethod.PALLAS:
        return _pallas_moe_rs_per_device(n, num_experts, topk, bm, inter,
                                         topk_ids, topk_weights, experts_w,
                                         sched=sched)
    raise ValueError(f"unresolved method {method}")


def _launch(inter, experts_w, topk_ids, topk_weights, sched):
    dev = inter.device
    m, topk = topk_ids.shape
    nf = m * topk
    if inter.ndim != 2 or inter.shape[0] != nf or experts_w.ndim != 3 or \
            experts_w.shape[1] != inter.shape[1]:
        raise ValueError(f"moe_rs: inter {tuple(inter.shape)}, experts_w "
                         f"{tuple(experts_w.shape)}, topk_ids "
                         f"{tuple(topk_ids.shape)}")
    k, d = inter.shape[1], experts_w.shape[2]
    if inter.dtype not in _DTYPE_CODE or experts_w.dtype != inter.dtype:
        raise ValueError("moe_rs: inter/experts_w must share one dtype of "
                         f"{list(_DTYPE_CODE)}; got {inter.dtype}/"
                         f"{experts_w.dtype}")
    vec = 16 // inter.element_size()
    if d % vec or not experts_w.is_contiguous() or \
            experts_w.device != dev or experts_w.data_ptr() % 16:
        raise ValueError(f"moe_rs: experts_w must be contiguous, 16-byte "
                         f"aligned, on {dev}, d={d} a multiple of {vec}")
    if topk_ids.dtype != torch.int32 or topk_weights.dtype != torch.float32 \
            or topk_weights.shape != topk_ids.shape \
            or not (topk_ids.is_contiguous()
                    and topk_weights.is_contiguous()) \
            or topk_ids.device != dev or topk_weights.device != dev:
        raise ValueError(f"moe_rs: topk_ids int32 and topk_weights f32, "
                         f"contiguous (M, topk) on {dev}")
    t_tiles, bm = check_schedule(sched, dev, "moe_rs")
    k_chunk, splits = k_split(
        min(t_tiles, nf), -(-d // (32 * vec)), k,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    part = torch.empty((splits, nf, d), dtype=torch.float32, device=dev)
    out = torch.empty((m, d), dtype=inter.dtype, device=dev)
    fn = build.function("moe_group_gemm", "td_moe_rs", (
        ctypes.c_void_p, ctypes.c_int, *(ctypes.c_void_p,) * 8,
        *(ctypes.c_int,) * 10, ctypes.c_void_p))
    with torch.cuda.device(dev):
        err = fn(inter.data_ptr(), nf, sched.row_flat.data_ptr(),
                 sched.tile_expert.data_ptr(), sched.used_tiles.data_ptr(),
                 experts_w.data_ptr(), topk_ids.data_ptr(),
                 topk_weights.data_ptr(), part.data_ptr(), out.data_ptr(),
                 t_tiles, bm, k, d, k_chunk, splits, m, topk, min(bm, m),
                 _DTYPE_CODE[inter.dtype], build.stream_of(inter))
    build.check(err, "moe_rs")
    moe_rs.launches += 1
    return out
