"""B1 and B19: causal GQA flash attention (the reference's
kernels/flash_attention.py over its Pallas _prefill_kernel and
_decode_kernel).

B1, ``csrc/flash_prefill.cu`` (bf16: the Hopper kernel of
``csrc/attn_tile_sm90.cuh``'s tiles, packed by ``flash_plan``; f32: the
FMA body), in its three forms:

  * ``flash_prefill``: normalized causal attention over a cache, the
    prefill and the dense decode step (counted in
    ``flash_prefill.launches``);
  * ``flash_prefill(..., cu_seqlens=)``: the packed-varlen form, causal
    within each segment (``flash_prefill_varlen.launches``);
  * ``flash_fold_partial``: the emit_stats form, one sequence-parallel
    chunk fold returning the unnormalized (acc, m, l) triple, the key
    chunk's global origin shifted by ``k_start``
    (``flash_fold_partial.launches``).

B19, ``csrc/flash_decode.cu``: ``flash_decode_partial``, the split-KV
partial of one decode step over a dense key shard, cut by ``decode_plan``
(bf16: a Hopper kernel that streams K/V tiles by TMA into tensor-core
products; f32: the FMA body) (``flash_decode_partial.launches``).

CUDA tensors launch the kernels; CPU tensors run the plain PyTorch
versions (``*_ref``). There is no fallback between the two: a CUDA tensor
a kernel does not take raises.

Positions (``offset`` / ``q_start``, ``k_start``, ``start_pos``,
``q_pos``) are ints or 0-d int32 tensors on q's device. A CUDA launch
with a tensor hands the kernel its device address and never reads it on
the host, so a step whose positions live on the device can be captured
in a CUDA graph and replayed as they advance. ``cu_seqlens`` is an int32
(n_seq + 1,) tensor of packed boundaries in the global position
coordinate (first entry 0); the kernel reads it on the device too.

The plain versions repeat the TPU kernels' folds: key blocks of
``min(128, S)`` keys, an online softmax with finite NEG_INF masking,
probabilities rounded to bf16 before P.V only when V is bf16, and (for
the normalized form) a final division by max(l, 1e-30). A position's
segment is the number of boundaries cu_seqlens[1:] at or below it.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from triton_dist_tpu_torch.kernels.plain import NEG_INF
from triton_dist_tpu_torch.runtime import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_DECODE_GROUPS = (1, 2, 4, 8)   # Hq/Hkv values B19 is built for
_REF_BK = 128     # the TPU kernels' key block, min(128, S)
_DECODE_TILE = 128              # splits of B19 are multiples of it (and
                                # the f32 form's keys a step)
_DECODE_BLOCKS_PER_SM = 4       # B19's f32 form: blocks to aim for, per SM
_DECODE_KEYS = 64               # B19's bf16 form: keys a TMA tile
_DECODE_STAGES = 4              # B19's bf16 form: tiles in flight a block
_DECODE_GROUPS_A_TILE = 4       # B19's bf16 form: consumer warps, each
                                # folding its 16 keys of every tile


def p_cast(p: torch.Tensor, v_dtype: torch.dtype) -> torch.Tensor:
    """Probabilities enter P.V in V's dtype: rounded to bf16 when V is
    bf16, exact otherwise (returned as f32 for the f32 product)."""
    if v_dtype == torch.bfloat16:
        return p.to(torch.bfloat16).float()
    return p


def segment_ids(cu_seqlens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The segment of each position: the count of boundaries
    cu_seqlens[1:] at or below it (past the last boundary: n_seq, a
    segment of padding no real position shares)."""
    return (pos[:, None] >= cu_seqlens[None, 1:].to(pos.device)).sum(-1)


def _fold_ref(q, k, v, q_start, k_start, cu_seqlens):
    """The TPU kernel's fold of q (B, T, Hq, D) at positions q_start + i
    against the keys (B, S, Hkv, D) at k_start + j: (acc (B, Hkv, g, T,
    D), m, l (B, Hkv, g, T, 1)), all f32, unnormalized."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    bk = min(_REF_BK, s)
    dev = q.device
    qf = q.float().reshape(b, t, hkv, g, d).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]   # (B, Hkv, 1, S, D)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    q_pos = q_start + torch.arange(t, device=dev)
    q_seg = None if cu_seqlens is None else segment_ids(cu_seqlens, q_pos)
    m = torch.full((b, hkv, g, t, 1), NEG_INF, device=dev)
    l = torch.zeros((b, hkv, g, t, 1), device=dev)
    acc = torch.zeros((b, hkv, g, t, d), device=dev)
    scale = d ** -0.5
    for k0 in range(0, s, bk):
        kb = kf[..., k0:k0 + bk, :]
        vb = vf[..., k0:k0 + bk, :]
        sc = torch.matmul(qf, kb.transpose(-1, -2)) * scale   # (.., T, bk)
        k_pos = k_start + k0 + torch.arange(kb.shape[-2], device=dev)
        valid = k_pos[None, :] <= q_pos[:, None]               # (T, bk)
        if q_seg is not None:
            valid = valid & (q_seg[:, None]
                             == segment_ids(cu_seqlens, k_pos)[None, :])
        sc = torch.where(valid, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(sc - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
        acc = acc * alpha + torch.matmul(p_cast(p, v.dtype), vb)
    return acc, m, l


# -- B1's packing: GQA rows of one kv head in a block --------------------------

@dataclass(frozen=True)
class FlashPlan:
    """How B1's bf16 kernel packs one launch. A block holds ``rows`` (64:
    one consumer warpgroup, 128: two) (query, head) pairs of ONE kv head:
    row r is query ``q_tile * q_per_tile + r // h_per_tile`` and group
    head ``h_tile * h_per_tile + r % h_per_tile``; rows past the tile's
    pairs, past T or past the group are padding, computed and never
    stored. The grid is (q_tiles * h_tiles, Hkv, B): block x is
    ``q_tile * h_tiles + h_tile``. It depends only on T and the group g,
    never on the offsets, which the kernel reads on the device (and with
    them its own live key steps)."""
    rows: int
    q_per_tile: int
    h_per_tile: int
    h_tiles: int
    grid: tuple[int, int, int]


def flash_plan(b: int, t: int, hq: int, hkv: int) -> FlashPlan:
    """B1's bf16 packing for q (b, t, hq, D) against hkv kv heads: one
    warpgroup's 64 rows when the t * g pairs of a kv head fit (the decode
    step: g live rows), else two warpgroups' 128; rows // g queries a tile
    with all g heads, or, when g exceeds the rows, one query a tile and
    the group cut into tiles of ``rows`` heads."""
    if b <= 0 or t <= 0 or hkv <= 0 or hq % hkv:
        raise ValueError(f"flash_plan: B={b}, T={t}, Hq={hq}, Hkv={hkv}")
    g = hq // hkv
    rows = 64 if t * g <= 64 else 128
    if g <= rows:
        q_per_tile, h_per_tile, h_tiles = rows // g, g, 1
    else:
        q_per_tile, h_per_tile, h_tiles = 1, rows, -(-g // rows)
    return FlashPlan(rows, q_per_tile, h_per_tile, h_tiles,
                     (-(-t // q_per_tile) * h_tiles, hkv, b))


_F32_PLAN = FlashPlan(0, 0, 0, 0, (0, 0, 0))   # the f32 body takes no plan


def flash_prefill_ref(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, offset,
                      cu_seqlens: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Plain PyTorch causal GQA attention in the TPU kernel's fold order.

    q: (B, T, Hq, D); k_cache/v_cache: (B, S, Hkv, D); query i sits at
    position offset + i and attends keys [0, offset + i] (of its own
    segment when ``cu_seqlens`` is given). Returns (B, T, Hq, D) in
    q.dtype."""
    b, t, hq, d = q.shape
    acc, _, l = _fold_ref(q, k_cache, v_cache, offset, 0, cu_seqlens)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, d).to(q.dtype)


def flash_fold_partial_ref(q, k_chunk, v_chunk, q_start, k_start,
                           cu_seqlens=None):
    """Plain version of B1's fold form: (acc (B, T, Hq, D) f32, m (B, T,
    Hq), l (B, T, Hq)) of q at global rows [q_start, q_start + T) against
    one key chunk at global rows [k_start, k_start + Tk), unnormalized."""
    b, t, hq, d = q.shape
    acc, m, l = _fold_ref(q, k_chunk, v_chunk, q_start, k_start, cu_seqlens)
    return (acc.permute(0, 3, 1, 2, 4).reshape(b, t, hq, d),
            m[..., 0].permute(0, 3, 1, 2).reshape(b, t, hq),
            l[..., 0].permute(0, 3, 1, 2).reshape(b, t, hq))


def flash_prefill(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, offset,
                  cu_seqlens: torch.Tensor | None = None) -> torch.Tensor:
    """Causal GQA attention over the cache, no score materialization.

    q: (B, T, Hq, D); k_cache/v_cache: (B, S, Hkv, D) with valid keys in
    [0, offset + T); query i attends keys [0, offset + i], of its own
    segment when ``cu_seqlens`` is given. Returns (B, T, Hq, D) in
    q.dtype. CUDA tensors launch the kernel (counted in
    ``flash_prefill.launches``, or ``flash_prefill_varlen.launches`` with
    cu_seqlens); CPU tensors run ``flash_prefill_ref``."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k_cache, v_cache, offset, cu_seqlens)
    _check_cuda(q, "flash_prefill")
    if cu_seqlens is not None:
        return flash_prefill_varlen(q, k_cache, v_cache, offset, cu_seqlens)
    out, _, _ = _launch(q, k_cache, v_cache, offset, 0, None, False)
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


def flash_prefill_varlen(q, k_cache, v_cache, offset,
                         cu_seqlens: torch.Tensor) -> torch.Tensor:
    """B1's packed-varlen form on CUDA tensors (``flash_prefill`` with
    cu_seqlens; CPU tensors go there)."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k_cache, v_cache, offset, cu_seqlens)
    _check_cuda(q, "flash_prefill_varlen")
    out, _, _ = _launch(q, k_cache, v_cache, offset, 0, cu_seqlens, False)
    flash_prefill_varlen.launches += 1
    return out


flash_prefill_varlen.launches = 0


def flash_fold_partial(q: torch.Tensor, k_chunk: torch.Tensor,
                       v_chunk: torch.Tensor, q_start, k_start, *,
                       cu_seqlens: torch.Tensor | None = None):
    """One sequence-parallel chunk fold: causal GQA attention of q (B, T,
    Hq, D) at global rows [q_start, q_start + T) against ONE key chunk
    (B, Tk, Hkv, D) at global rows [k_start, k_start + Tk), returning the
    UNNORMALIZED triple (acc (B, T, Hq, D) f32, m (B, T, Hq), l (B, T,
    Hq)) for the cross-chunk LSE merge. A chunk wholly in the future
    gives (0, NEG_INF, 0), the merge's identity. CUDA tensors launch B1's
    emit_stats form (counted in ``flash_fold_partial.launches``); CPU
    tensors run ``flash_fold_partial_ref``."""
    if q.device.type == "cpu":
        return flash_fold_partial_ref(q, k_chunk, v_chunk, q_start, k_start,
                                      cu_seqlens)
    _check_cuda(q, "flash_fold_partial")
    out = _launch(q, k_chunk, v_chunk, q_start, k_start, cu_seqlens, True)
    flash_fold_partial.launches += 1
    return out


flash_fold_partial.launches = 0


def _check_cuda(q: torch.Tensor, what: str) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")


def _position_args(pos, q: torch.Tensor, what: str):
    """(device pointer or None, int) for the C entry points: a tensor
    position is passed by address and never read here."""
    if not isinstance(pos, torch.Tensor):
        return None, int(pos)
    if pos.ndim != 0 or pos.dtype != torch.int32 or pos.device != q.device:
        raise ValueError(f"{what}: a tensor position must be a 0-d int32 "
                         f"tensor on {q.device}; got {tuple(pos.shape)} "
                         f"{pos.dtype} on {pos.device}")
    return pos.data_ptr(), 0


def _check_qkv(q, k, v, what: str) -> None:
    b, _, hq, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"{what}: Hq={hq} not a multiple of "
                         f"Hkv={k.shape[2]}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{what}: q/k/v must share one dtype of "
                         f"{list(_DTYPE_CODE)}; got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} not in {_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: q/k/v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: q/k/v on different devices")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{what}: q/k/v must be 16-byte aligned")


def _cu_args(cu_seqlens, q: torch.Tensor, what: str):
    """(device pointer or None, n_seq) of a cu_seqlens tensor."""
    if cu_seqlens is None:
        return None, 0
    if cu_seqlens.ndim != 1 or cu_seqlens.dtype != torch.int32 \
            or cu_seqlens.device != q.device or cu_seqlens.shape[0] < 2 \
            or not cu_seqlens.is_contiguous():
        raise ValueError(f"{what}: cu_seqlens must be a contiguous int32 "
                         f"(n_seq + 1,) tensor on {q.device}; got "
                         f"{tuple(cu_seqlens.shape)} {cu_seqlens.dtype} on "
                         f"{cu_seqlens.device}")
    return cu_seqlens.data_ptr(), cu_seqlens.shape[0] - 1


def _launch(q, k, v, q_start, k_start, cu_seqlens, emit_stats: bool):
    """B1 in any of its forms: (out, None, None), or the f32 (acc, m, l)
    triple when emit_stats."""
    what = "flash_fold_partial" if emit_stats else "flash_prefill"
    _check_qkv(q, k, v, what)
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    q_ptr, q_val = _position_args(q_start, q, what)
    k_ptr, k_val = _position_args(k_start, q, what)
    cu_ptr, n_seq = _cu_args(cu_seqlens, q, what)
    dev = q.device
    if emit_stats:
        out = None
        acc = torch.empty((b, t, hq, d), dtype=torch.float32, device=dev)
        m = torch.empty((b, t, hq), dtype=torch.float32, device=dev)
        l = torch.empty((b, t, hq), dtype=torch.float32, device=dev)
    else:
        out = torch.empty_like(q)
        acc = m = l = None
    plan = (flash_plan(b, t, hq, hkv) if q.dtype == torch.bfloat16
            else _F32_PLAN)
    fn = build.function("flash_prefill", "td_flash_attn", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    ptr = (lambda x: None if x is None else x.data_ptr())
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(out),
                 ptr(acc), ptr(m), ptr(l), b, t, s, hq, hkv, d, q_ptr,
                 q_val, k_ptr, k_val, cu_ptr, n_seq, d ** -0.5,
                 _DTYPE_CODE[q.dtype], plan.rows, plan.q_per_tile,
                 plan.h_per_tile, plan.h_tiles, build.stream_of(q))
    build.check(err, what)
    return (acc, m, l) if emit_stats else (out, None, None)


# -- B19: split-KV decode partial over a dense shard ------------------------

def _head_major(k_shard: torch.Tensor, head_major: bool) -> torch.Tensor:
    """k/v as (B, Hkv, S_loc, D)."""
    return k_shard if head_major else k_shard.permute(0, 2, 1, 3)


def flash_decode_partial_ref(q, k_shard, v_shard, start_pos, q_pos, *,
                             head_major: bool = False):
    """Plain version of B19 in the TPU kernel's fold order: key blocks of
    min(128, S_loc), keys at global positions start_pos + j valid when
    at or before q_pos (and inside the shard, j < S_loc: the TPU kernel's
    zeroed V tail rows), probabilities cast to V's dtype before P.V.
    Returns (acc (B, Hq, D) f32 unnormalized, m (B, Hq), l (B, Hq))."""
    b, hq, d = q.shape
    kf = _head_major(k_shard, head_major).float()        # (B, Hkv, S, D)
    vf = _head_major(v_shard, head_major).float()
    hkv, s_loc = kf.shape[1], kf.shape[2]
    g = hq // hkv
    bk = min(_REF_BK, s_loc)
    dev = q.device
    qf = q.float().reshape(b, hkv, g, d)
    m = torch.full((b, hkv, g, 1), NEG_INF, device=dev)
    l = torch.zeros((b, hkv, g, 1), device=dev)
    acc = torch.zeros((b, hkv, g, d), device=dev)
    scale = d ** -0.5
    for k0 in range(0, s_loc, bk):
        kb, vb = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        sc = torch.matmul(qf, kb.transpose(-1, -2)) * scale  # (B,Hkv,g,bk)
        local = k0 + torch.arange(kb.shape[2], device=dev)
        valid = (start_pos + local) <= q_pos                  # (bk,)
        sc = torch.where(valid, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(sc - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
        acc = acc * alpha + torch.matmul(p_cast(p, v_shard.dtype), vb)
    return acc.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)


def flash_decode_partial(q: torch.Tensor, k_shard: torch.Tensor,
                         v_shard: torch.Tensor, start_pos, q_pos, *,
                         head_major: bool = False):
    """Split-KV partial attention of one decode step over a dense shard.

    q: (B, Hq, D); k_shard/v_shard: (B, S_loc, Hkv, D), or (B, Hkv,
    S_loc, D) with head_major=True, holding global key positions
    [start_pos, start_pos + S_loc); keys at or before q_pos are attended.
    Returns (acc (B, Hq, D) f32 UNNORMALIZED, m (B, Hq) f32 rowmax, l (B,
    Hq) f32 sumexp) for the cross-rank LSE merge. CUDA tensors launch B19
    (counted in ``flash_decode_partial.launches``): S_loc is split across
    blocks and the splits merged by exact LSE in the same call, so its
    floats differ from the plain version's sequential fold by rounding;
    CPU tensors run ``flash_decode_partial_ref``."""
    if q.device.type == "cpu":
        return flash_decode_partial_ref(q, k_shard, v_shard, start_pos,
                                        q_pos, head_major=head_major)
    _check_cuda(q, "flash_decode_partial")
    out = _decode_launch(q, k_shard, v_shard, start_pos, q_pos, head_major)
    flash_decode_partial.launches += 1
    return out


flash_decode_partial.launches = 0


def decode_splits(s_loc: int, rows: int, sms: int) -> tuple[int, int]:
    """(keys per split, splits) of B19's f32 form: about
    _DECODE_BLOCKS_PER_SM blocks per SM over the rows = B * Hkv (batch, kv
    head) pairs, each split a multiple of the kernel's 128-key step."""
    want = max(1, -(-_DECODE_BLOCKS_PER_SM * sms // max(rows, 1)))
    return _split(s_loc, want)


def _split(s_loc: int, want: int) -> tuple[int, int]:
    """(keys per split, splits): s_loc cut into at most `want` splits of a
    multiple of _DECODE_TILE keys, none empty."""
    chunk = -(-s_loc // want)
    chunk = max(_DECODE_TILE, -(-chunk // _DECODE_TILE) * _DECODE_TILE)
    return chunk, -(-s_loc // chunk)


@dataclass(frozen=True)
class DecodePlan:
    """How B19 cuts one launch: block (split, kv head, batch) folds keys
    [split * chunk, min((split + 1) * chunk, S_loc, q_pos - start + 1))
    of the shard, ``tile`` keys at a time (the bf16 form: TMA tiles,
    ``stages`` of them in flight, each tile's keys dealt in ``groups``
    runs of tile / groups to warps that fold their runs apart and merge by
    exact LSE, warp 0 first, at the split's end; the f32 form: 128-key
    steps, one group), and the splits are merged in ascending order by
    exact LSE."""
    chunk: int
    splits: int
    tile: int
    stages: int
    groups: int


@functools.lru_cache(maxsize=None)
def decode_plan(s_loc: int, rows: int, sms: int,
                dtype: torch.dtype) -> DecodePlan:
    """B19's plan for a shard of S_loc keys and rows = B * Hkv (batch, kv
    head) pairs on a card of ``sms`` SMs. bf16: one block an SM at a time
    (each keeps up to _DECODE_STAGES tiles of K and V in flight: 128 KB at
    D 128, enough bytes to stream HBM), the splits chosen among 1 ..
    2 sms / rows to fill the waves of blocks best (fewest splits on a
    tie); f32: ``decode_splits``."""
    if dtype != torch.bfloat16:
        chunk, splits = decode_splits(s_loc, rows, sms)
        return DecodePlan(chunk, splits, _DECODE_TILE, 1, 1)
    rows = max(rows, 1)
    best = None
    for want in range(1, max(1, 2 * sms // rows) + 1):
        chunk, splits = _split(s_loc, want)
        blocks = splits * rows
        fill = blocks / (-(-blocks // sms) * sms)
        if best is None or fill > best[0] + 1e-9:
            best = (fill, chunk, splits)
    return DecodePlan(best[1], best[2], _DECODE_KEYS, _DECODE_STAGES,
                      _DECODE_GROUPS_A_TILE)


def _decode_launch(q, k, v, start_pos, q_pos, head_major: bool):
    what = "flash_decode_partial"
    b, hq, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    hkv, s_loc = (k.shape[1], k.shape[2]) if head_major else \
        (k.shape[2], k.shape[1])
    if hq % hkv or hq // hkv not in _DECODE_GROUPS:
        raise ValueError(f"{what}: Hq={hq}, Hkv={hkv}: need Hkv | Hq and "
                         f"Hq/Hkv in {_DECODE_GROUPS}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{what}: q/k/v must share one dtype of "
                         f"{list(_DTYPE_CODE)}")
    # strides in elements: batch, kv head, key (a key-range view of a
    # shard is taken as it is, without a copy)
    if head_major:
        strides = (k.stride(0), k.stride(1), k.stride(2))
    else:
        strides = (k.stride(0), k.stride(2), k.stride(1))
    if not q.is_contiguous() or k.stride() != v.stride() or \
            k.stride(3) != 1 or any(st * k.element_size() % 16
                                    for st in strides):
        raise ValueError(f"{what}: q must be contiguous, k/v of one stride "
                         "with contiguous 16-byte aligned rows; got "
                         f"{k.stride()} / {v.stride()}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: q/k/v on different devices")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{what}: q/k/v must be 16-byte aligned")
    s_ptr, s_val = _position_args(start_pos, q, what)
    p_ptr, p_val = _position_args(q_pos, q, what)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = decode_plan(s_loc, b * hkv, sms, q.dtype)
    chunk, splits = plan.chunk, plan.splits
    dev = q.device
    acc = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, hq), dtype=torch.float32, device=dev)
    l = torch.empty((b, hq), dtype=torch.float32, device=dev)
    part = torch.empty((splits, b, hq, d + 2), dtype=torch.float32,
                       device=dev)
    fn = build.function("flash_decode", "td_flash_decode_partial", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p))
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), acc.data_ptr(),
                 m.data_ptr(), l.data_ptr(), part.data_ptr(), b, hq, hkv,
                 s_loc, d, *strides, s_ptr, s_val, p_ptr, p_val, chunk,
                 splits, d ** -0.5, _DTYPE_CODE[q.dtype],
                 build.stream_of(q))
    build.check(err, what)
    return acc, m, l
