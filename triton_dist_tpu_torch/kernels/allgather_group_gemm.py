"""AllGather + MoE grouped GEMM (the reference's
kernels/allgather_group_gemm.py), at world 1: the gate/up projection of the
tensor-parallel MoE layer.

Both methods return (out_flat, ag_tokens): out_flat (M*topk, N) token-major
(row t*topk + j = choice j of token t, kernels/moe_utils.py), ag_tokens the
gathered tokens, which at world 1 are the tokens themselves.

  * XLA, XLA_RING — sort by expert, one grouped product, unsort (a ring of
    one step is the one shard's grouped GEMM).
  * PALLAS — B14 over the block-aligned schedule: ``group_gemm`` launches
    the hand-written CUDA kernel ``csrc/moe_group_gemm.cu`` for CUDA
    tensors and runs ``group_gemm_ref``, its plain PyTorch version, for
    CPU tensors. No fallback: a CUDA tensor the kernel does not take
    raises.

World > 1 (the token ring, its arrival-ordered tile release) waits for
ROADMAP A10.
"""

from __future__ import annotations

import ctypes
import enum

import torch

from triton_dist_tpu_torch.kernels import moe_utils
from triton_dist_tpu_torch.kernels.plain import dot_f32
from triton_dist_tpu_torch.runtime import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BM_MAX = 128           # the kernel's largest tile (moe_group_gemm.cu)
_BLOCKS_PER_SM = 4      # blocks the K split aims for over the live tiles
_K_ROW_STEP = 64        # k_chunk granule: 8 warps x 8 rows per pass


class AgGroupGemmMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    XLA_RING = "xla_ring"
    PALLAS = "pallas"


def check_moe_world(n: int, what: str) -> None:
    """The MoE ops run at world 1 here; their rings wait for A10."""
    if n != 1:
        raise NotImplementedError(
            f"{what} at world {n} (the overlapped ring) waits for "
            "ROADMAP A10")


def resolve_ag_group_gemm_method(method: AgGroupGemmMethod, m_local: int,
                                 topk: int,
                                 cuda: bool = False) -> AgGroupGemmMethod:
    """The port's AUTO rule at world 1: PALLAS (the kernel) on CUDA, XLA
    on the CPU. The reference's size rule weighs ring latency against one
    fused product, and at world 1 there is no ring (queue C)."""
    if method != AgGroupGemmMethod.AUTO:
        return method
    return AgGroupGemmMethod.PALLAS if cuda else AgGroupGemmMethod.XLA


def _shard_group_gemm(tokens, topk_ids, experts_w, num_experts):
    """Grouped GEMM for one token shard; returns token-major flat rows."""
    st = moe_utils.sort_by_expert(topk_ids, num_experts)
    lhs = moe_utils.gather_sorted(tokens, st)
    out_sorted = moe_utils.grouped_gemm(lhs, experts_w, st.group_sizes)
    return moe_utils.unsort(out_sorted, st)


def k_split(live_tiles: int, col_tiles: int, k: int,
            sm_count: int) -> tuple[int, int]:
    """(k_chunk, splits): cut K so that about _BLOCKS_PER_SM blocks per SM
    run over the live tiles' column tiles."""
    target = _BLOCKS_PER_SM * sm_count
    splits = max(1, min(-(-target // (live_tiles * col_tiles)),
                        k // _K_ROW_STEP))
    k_chunk = -(-k // splits)
    k_chunk = -(-k_chunk // _K_ROW_STEP) * _K_ROW_STEP
    return k_chunk, -(-k // k_chunk)


def group_gemm_ref(tokens: torch.Tensor, experts_w: torch.Tensor,
                   sched: moe_utils.AlignedSchedule,
                   topk: int) -> torch.Tensor:
    """Plain version of B14 at one chunk: tile by tile, the tile's rows
    (row_token, the sentinel clamped to the last token) times its
    expert's weight with f32 accumulation, cast, written to the live
    slots' flat rows. Reads used_tiles on the host."""
    m = tokens.shape[0]
    nf = m * topk
    t_tiles = sched.tile_expert.shape[1]
    bm = sched.row_token.shape[1] // t_tiles
    dtype = torch.result_type(tokens, experts_w)
    out = torch.zeros((nf, experts_w.shape[-1]), dtype=dtype,
                      device=tokens.device)
    for t in range(int(sched.used_tiles[0])):
        rows = sched.row_token[0, t * bm:(t + 1) * bm].clamp(max=m - 1)
        o = dot_f32(tokens[rows.long()],
                    experts_w[int(sched.tile_expert[0, t])]).to(dtype)
        dst = sched.row_flat[0, t * bm:(t + 1) * bm]
        live = dst < nf
        out[dst[live].long()] = o[live]
    return out


def group_gemm(tokens: torch.Tensor, experts_w: torch.Tensor,
               sched: moe_utils.AlignedSchedule, topk: int) -> torch.Tensor:
    """B14 at one chunk: (M*topk, N) token-major rows, row f =
    cast(tokens[f // topk] @ experts_w[expert of f]) with f32
    accumulation. CUDA tensors launch the kernel (counted in
    ``group_gemm.launches``); CPU tensors run ``group_gemm_ref``."""
    if tokens.device.type == "cpu":
        return group_gemm_ref(tokens, experts_w, sched, topk)
    if tokens.device.type != "cuda":
        raise ValueError(f"group_gemm: unsupported device {tokens.device}")
    return _launch(tokens.contiguous(), experts_w, sched, topk)


group_gemm.launches = 0


def _pallas_per_device(n, num_experts, bm, tokens, topk_ids_full, experts_w,
                       sched=None):
    m = tokens.shape[0]
    topk = topk_ids_full.shape[-1]
    bm = min(bm, max(8, m * topk))
    if sched is None:
        sched = moe_utils.aligned_chunk_schedule(topk_ids_full, n,
                                                 num_experts, bm)
    t_tiles = sched.tile_expert.shape[1]
    if sched.row_token.shape[1] != t_tiles * bm:
        raise ValueError(
            f"schedule row length {sched.row_token.shape[1]} != "
            f"t_tiles*bm = {t_tiles}*{bm}; the schedule was built with a "
            "different block size than the kernel is running")
    # one chunk in one block: the arrival order is the identity, every
    # live tile is released at once (moe_utils.arrival_ordered_schedule)
    return group_gemm(tokens, experts_w, sched, topk), tokens


def ag_group_gemm_per_device(n: int, num_experts: int,
                             method: AgGroupGemmMethod, tokens: torch.Tensor,
                             topk_ids_full: torch.Tensor,
                             experts_w: torch.Tensor, bm: int = 128,
                             comm_blocks: int = 4, sched=None):
    """The reference's per-device body at world n = 1. tokens (M, K);
    topk_ids_full (M, topk); experts_w (E, K, N). sched: optional
    precomputed AlignedSchedule for PALLAS. comm_blocks sizes the ring's
    blocks, of which world 1 has none."""
    check_moe_world(n, "ag_group_gemm")
    if method in (AgGroupGemmMethod.XLA, AgGroupGemmMethod.XLA_RING):
        return _shard_group_gemm(tokens, topk_ids_full, experts_w,
                                 num_experts), tokens
    if method == AgGroupGemmMethod.PALLAS:
        return _pallas_per_device(n, num_experts, bm, tokens, topk_ids_full,
                                  experts_w, sched=sched)
    raise ValueError(f"unresolved method {method}")


def check_schedule(sched: moe_utils.AlignedSchedule, dev: torch.device,
                   what: str) -> tuple[int, int]:
    """(t_tiles, bm) of a one-chunk schedule the kernels can read: int32,
    contiguous, on ``dev``, bm <= 128. Raises otherwise."""
    n_chunks, r = sched.row_token.shape
    t_tiles = sched.tile_expert.shape[1]
    if n_chunks != 1 or r % t_tiles or r // t_tiles > _BM_MAX:
        raise ValueError(f"{what}: one chunk with bm <= {_BM_MAX} expected; "
                         f"schedule rows {tuple(sched.row_token.shape)}, "
                         f"tiles {t_tiles}")
    for name, f in zip(sched._fields, sched):
        if f.dtype != torch.int32 or f.device != dev or \
                not f.is_contiguous():
            raise ValueError(f"{what}: schedule field {name} must be "
                             f"contiguous int32 on {dev}")
    return t_tiles, r // t_tiles


def _launch(tokens, experts_w, sched, topk):
    dev = tokens.device
    if tokens.ndim != 2 or experts_w.ndim != 3 or \
            experts_w.shape[1] != tokens.shape[1]:
        raise ValueError(f"group_gemm: tokens {tuple(tokens.shape)}, "
                         f"experts_w {tuple(experts_w.shape)}")
    m, k = tokens.shape
    nn = experts_w.shape[2]
    if tokens.dtype not in _DTYPE_CODE or experts_w.dtype != tokens.dtype:
        raise ValueError("group_gemm: tokens/experts_w must share one dtype "
                         f"of {list(_DTYPE_CODE)}; got {tokens.dtype}/"
                         f"{experts_w.dtype}")
    vec = 16 // tokens.element_size()
    if nn % vec or not experts_w.is_contiguous() or \
            experts_w.device != dev or experts_w.data_ptr() % 16:
        raise ValueError(f"group_gemm: experts_w must be contiguous, 16-byte "
                         f"aligned, on {dev}, N={nn} a multiple of {vec}")
    t_tiles, bm = check_schedule(sched, dev, "group_gemm")
    nf = m * topk
    k_chunk, splits = k_split(
        min(t_tiles, nf), -(-nn // (32 * vec)), k,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    part = torch.empty((splits, nf, nn), dtype=torch.float32, device=dev)
    out = torch.empty((nf, nn), dtype=tokens.dtype, device=dev)
    fn = build.function("moe_group_gemm", "td_group_gemm", (
        ctypes.c_void_p, ctypes.c_int, *(ctypes.c_void_p,) * 7,
        *(ctypes.c_int,) * 9, ctypes.c_void_p))
    with torch.cuda.device(dev):
        err = fn(tokens.data_ptr(), m, sched.row_token.data_ptr(),
                 sched.row_flat.data_ptr(), sched.tile_expert.data_ptr(),
                 sched.used_tiles.data_ptr(), experts_w.data_ptr(),
                 part.data_ptr(), out.data_ptr(), t_tiles, bm, k, nn,
                 k_chunk, splits, nf, min(bm, m), _DTYPE_CODE[tokens.dtype],
                 build.stream_of(tokens))
    build.check(err, "group_gemm")
    group_gemm.launches += 1
    return out
