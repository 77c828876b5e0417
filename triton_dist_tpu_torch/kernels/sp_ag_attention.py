"""Sequence-parallel attention for long-context prefill (the reference's
kernels/sp_ag_attention.py).

Q, K and V are all sequence-sharded: rank r holds positions [r T_loc,
(r + 1) T_loc) of (B, T, H, D), and ``sp_attention`` is called by every
rank on its shards, as the port's other mesh-level ops are. The tiers:

  * XLA: the process group's all-gather of K and V, then the attention
    core ``gqa_attend`` at offset rank * T_loc (B1 for lane-aligned heads;
    with cu_seqlens B1's varlen form, else the masked fold);
  * XLA_RING: ring attention, the K/V shards sent round the ring with
    ``dist.batch_isend_irecv`` while each rank folds the one it holds into
    an online-softmax state (``_chunk_scores`` + ``_online_fold``); its
    zigzag form skips the half-pairs that are dead by construction;
  * FLASH_RING: the same ring with B1's fold form (``flash_fold_partial``)
    as the chunk consumer and ``lse_partial_merge`` between chunks; zigzag
    too;
  * XLA_BLOCK: the block-granular fold order of the fused kernel spelled
    in torch (step s folds the shard of rank (me - s) mod n, its
    comm_blocks row blocks in ascending order, one online-softmax rescale
    per block);
  * PALLAS: B21, ``pallas_ring_attn_per_device``, the hand-written kernel
    of ``csrc/sp_attention.cu`` for CUDA tensors and its plain version
    ``plain.ring_attn_ref`` (the all-gather, then XLA_BLOCK's fold) for
    CPU tensors.

AUTO resolves to XLA_RING, as the reference's. The zigzag layout (rank r
holds blocks r and 2n-1-r of size T_loc/2: ``zigzag_shard`` /
``zigzag_unshard``) balances the causal work across ranks; it is taken by
the ring methods only. No fallback: a PALLAS call the kernel cannot take
raises (the reference degrades to XLA_BLOCK), and there is no fault
preamble (ROADMAP A8). The 2-D (``dcn_axis``) ring variants wait for
ROADMAP A9 (tail).

The torch folds materialize (B, Hkv, g, Tq, Tk) f32 scores per chunk; to
stay inside a card's memory at long context they fold q in row chunks of
at most ``SCORE_BYTES`` of scores (rows are independent: the same
values as one pass).
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels.flash_attention import (
    flash_fold_partial, flash_prefill,
)
from triton_dist_tpu_torch.kernels.flash_decode import check_not_2d
from triton_dist_tpu_torch.kernels.moe_utils import legal_comm_blocks
from triton_dist_tpu_torch.kernels.plain import (
    NEG_INF, SCORE_BYTES, all_gather_list, lse_partial_merge, ring_attn_ref,
    ring_block_fold,
)
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.mesh import comm_axis_size
from triton_dist_tpu_torch.runtime.symm import op_workspace

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_BLOCKS = 64         # B21's comm blocks at most (csrc/sp_attention.cu)
_ALIGN = 256


class SpAttnMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    XLA_RING = "xla_ring"
    FLASH_RING = "flash_ring"  # ring + B1's fold form as the consumer
    XLA_BLOCK = "xla_block"    # block-granular ring fold, torch spelling
    PALLAS = "pallas"          # B21, the fused block-granular ring kernel


@dataclasses.dataclass
class SpAttnContext:
    """The reference's SpAttnContext: the ranks' Mesh, its axis, the
    method, the ring blocks per KV shard of XLA_BLOCK / PALLAS (clamped to
    a divisor of T_loc) and the layout ("contiguous" or "zigzag").
    dcn_axis raises: ROADMAP A9 (tail)."""
    mesh: object
    axis: str
    method: SpAttnMethod = SpAttnMethod.AUTO
    dcn_axis: str | None = None
    comm_blocks: int = 4
    layout: str = "contiguous"

    def __post_init__(self):
        check_not_2d(self.dcn_axis, "sp_attention")

    def resolve(self) -> SpAttnMethod:
        if self.method != SpAttnMethod.AUTO:
            return self.method
        return SpAttnMethod.XLA_RING


def create_sp_attn_context(mesh, axis: str = "sp", **kw) -> SpAttnContext:
    return SpAttnContext(mesh, axis, **kw)


# -- the torch fold ------------------------------------------------------------

def _seq_of(cu_seqlens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Sequence id of each global position in a packed varlen batch;
    padding past the last boundary gets an id no real position has."""
    return torch.searchsorted(cu_seqlens.to(pos.device, torch.int64),
                              pos.to(torch.int64), right=True)


def _positions(start, n: int, device) -> torch.Tensor:
    """A chunk's global positions: start + [0, n), or start itself when it
    is already a (n,) vector."""
    if isinstance(start, torch.Tensor) and start.ndim == 1:
        return start
    return start + torch.arange(n, device=device)


def _chunk_scores(q, k, q_start, k_start, cu_seqlens=None):
    """Masked scores for one (q-chunk, kv-chunk) pair: q (B, Tq, Hq, D), k
    (B, Tk, Hkv, D) -> ((B, Hkv, g, Tq, Tk) f32 with NEG_INF where masked,
    the (1, 1, 1, Tq, Tk) mask). q_start / k_start: scalar chunk origins
    or (Tq,) / (Tk,) position vectors."""
    b, tq, hq, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float() * (d ** -0.5)
    scores = torch.einsum("bthgd,bshd->bhgts", qf.reshape(b, tq, hkv, g, d),
                          k.float())
    q_pos = _positions(q_start, tq, q.device)
    k_pos = _positions(k_start, tk, q.device)
    mask = k_pos[None, :] <= q_pos[:, None]             # (Tq, Tk)
    if cu_seqlens is not None:
        mask = mask & (_seq_of(cu_seqlens, q_pos)[:, None]
                       == _seq_of(cu_seqlens, k_pos)[None, :])
    mask = mask[None, None, None]
    return torch.where(mask, scores, NEG_INF), mask


def _online_fold(state, scores, mask, v):
    """Fold one chunk into the online-softmax state (m, l, acc):
    (B, Hkv, g, Tq), the same, (B, Hkv, g, Tq, D); f32."""
    m, l, acc = state
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.where(mask, torch.exp(scores - m_new[..., None]), 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhgts,bshd->bhgtd", p, v.float())
    acc = acc * corr[..., None] + pv
    return m_new, l, acc


def _fold(state, q, k, v, q_start, k_start, cu_seqlens=None):
    """``_online_fold`` of ``_chunk_scores``, over row chunks of q of at
    most SCORE_BYTES of scores each."""
    b, tq, hq, _ = q.shape
    rows = max(1, SCORE_BYTES // (b * hq * k.shape[1] * 4))
    if rows >= tq:
        return _online_fold(state, *_chunk_scores(q, k, q_start, k_start,
                                                  cu_seqlens), v)
    q_pos = _positions(q_start, tq, q.device)
    parts = []
    for r0 in range(0, tq, rows):
        sl = slice(r0, r0 + rows)
        m, l, acc = state
        parts.append(_online_fold(
            (m[..., sl], l[..., sl], acc[..., sl, :]),
            *_chunk_scores(q[:, sl], k, q_pos[sl], k_start, cu_seqlens), v))
    return tuple(torch.cat([p[i] for p in parts], dim=3) for i in range(3))


def _init_state(b, hkv, g, t, d, device):
    return (torch.full((b, hkv, g, t), NEG_INF, device=device),
            torch.zeros((b, hkv, g, t), device=device),
            torch.zeros((b, hkv, g, t, d), device=device))


def _finish(state, out_shape, dtype):
    _, l, acc = state
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(out_shape).to(dtype)


# -- the ring ------------------------------------------------------------------

def _ring(mesh, tensors):
    """The ring schedule: yields (src, tensors of rank src) for s = 0 ..
    n-1, src = (me - s) mod n, starting with this rank's own; the next
    shards are sent right and received from the left while the caller
    folds the current ones."""
    n, me = mesh.world, mesh.rank
    cur = [x.contiguous() for x in tensors]
    for s in range(n):
        reqs, nxt = [], None
        if s < n - 1:
            right = dist.get_global_rank(mesh.group, (me + 1) % n)
            left = dist.get_global_rank(mesh.group, (me - 1) % n)
            nxt = [torch.empty_like(x) for x in cur]
            ops = []
            for x, y in zip(cur, nxt):
                ops += [dist.P2POp(dist.isend, x, right, mesh.group),
                        dist.P2POp(dist.irecv, y, left, mesh.group)]
            reqs = dist.batch_isend_irecv(ops)
        yield (me - s) % n, cur
        for r in reqs:
            r.wait()
        if s < n - 1:
            cur = nxt


def _gather_seq(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's shard concatenated on the sequence dim (dim 1)."""
    if mesh.world == 1:
        return x
    return torch.cat(all_gather_list(mesh, x), dim=1)


# -- zigzag layout -------------------------------------------------------------

def _zigzag_order(n: int) -> list[int]:
    order = []
    for r in range(n):
        order += [r, 2 * n - 1 - r]
    return order


def zigzag_shard(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Permute a contiguous sequence dim into zigzag block order, so that
    the contiguous shard of the result gives rank r blocks (r, 2n-1-r).
    Inverse: zigzag_unshard."""
    t = x.shape[axis]
    if t % (2 * n):
        raise ValueError(f"zigzag needs T ({t}) divisible by 2*n ({2 * n})")
    half = t // (2 * n)
    idx = torch.cat([torch.arange(half) + b * half
                     for b in _zigzag_order(n)]).to(x.device)
    return torch.index_select(x, axis, idx)


def zigzag_unshard(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    t = x.shape[axis]
    if t % (2 * n):
        raise ValueError(f"zigzag needs T ({t}) divisible by 2*n ({2 * n})")
    half = t // (2 * n)
    inv = [0] * (2 * n)
    for pos, b in enumerate(_zigzag_order(n)):
        inv[b] = pos
    idx = torch.cat([torch.arange(half) + p * half for p in inv]).to(x.device)
    return torch.index_select(x, axis, idx)


# -- the tiers -----------------------------------------------------------------

def _ag_attn_per_device(mesh, n, q, k, v, cu_seqlens=None):
    """XLA: all-gather + one masked fold at offset me * T_loc."""
    from triton_dist_tpu_torch.layers.attention_core import gqa_attend
    b, t_loc, hq, d = q.shape
    k_all, v_all = _gather_seq(mesh, k), _gather_seq(mesh, v)
    if cu_seqlens is None:
        return gqa_attend(q, k_all, v_all, mesh.rank * t_loc, t_loc)
    if d % 128 == 0 and k_all.shape[1] >= 128:
        # lane-aligned heads take B1's varlen form
        return flash_prefill(q, k_all, v_all, mesh.rank * t_loc,
                             cu_seqlens=cu_seqlens)
    state = _init_state(b, k.shape[2], hq // k.shape[2], t_loc, d, q.device)
    state = _fold(state, q, k_all, v_all, mesh.rank * t_loc, 0, cu_seqlens)
    return _finish(state, (b, t_loc, hq, d), q.dtype)


def _ring_attn_per_device(mesh, n, q, k, v, cu_seqlens=None):
    """XLA_RING (contiguous): at step s fold the shard of rank (me - s)
    mod n."""
    b, t_loc, hq, d = q.shape
    hkv = k.shape[2]
    state = _init_state(b, hkv, hq // hkv, t_loc, d, q.device)
    for src, (k_cur, v_cur) in _ring(mesh, (k, v)):
        state = _fold(state, q, k_cur, v_cur, mesh.rank * t_loc,
                      src * t_loc, cu_seqlens)
    return _finish(state, (b, t_loc, hq, d), q.dtype)


def _ring_attn_zigzag_per_device(mesh, n, q, k, v, cu_seqlens=None):
    """XLA_RING over the zigzag layout: of the four (q-half, k-half)
    pairs a step, (q0, k1) is never live, (q1, k0) always, (q0, k0) iff
    src <= me and (q1, k1) iff src >= me; dead pairs are not folded."""
    me = mesh.rank
    b, t_loc, hq, d = q.shape
    hkv = k.shape[2]
    half = t_loc // 2
    q0, q1 = q[:, :half], q[:, half:]
    q0_start, q1_start = me * half, (2 * n - 1 - me) * half
    st0 = _init_state(b, hkv, hq // hkv, half, d, q.device)
    st1 = _init_state(b, hkv, hq // hkv, half, d, q.device)
    for src, (k_cur, v_cur) in _ring(mesh, (k, v)):
        k0, v0 = k_cur[:, :half], v_cur[:, :half]
        k1, v1 = k_cur[:, half:], v_cur[:, half:]
        k0_start, k1_start = src * half, (2 * n - 1 - src) * half
        st1 = _fold(st1, q1, k0, v0, q1_start, k0_start, cu_seqlens)
        if src <= me:
            st0 = _fold(st0, q0, k0, v0, q0_start, k0_start, cu_seqlens)
        if src >= me:
            st1 = _fold(st1, q1, k1, v1, q1_start, k1_start, cu_seqlens)
    return torch.cat([_finish(st0, (b, half, hq, d), q.dtype),
                      _finish(st1, (b, half, hq, d), q.dtype)], dim=1)


def _merge2(state, part):
    return lse_partial_merge(*(torch.stack([a, b_])
                               for a, b_ in zip(state, part)))


def _norm(state, dtype):
    acc, _, l = state
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(dtype)


def _flash_state(b, t, hq, d, device):
    return (torch.zeros((b, t, hq, d), device=device),
            torch.full((b, t, hq), NEG_INF, device=device),
            torch.zeros((b, t, hq), device=device))


def _ring_attn_flash_per_device(mesh, n, q, k, v, cu_seqlens=None):
    """FLASH_RING: each arriving shard folded by B1's fold form, the
    per-chunk triples merged by LSE."""
    b, t_loc, hq, d = q.shape
    q = q.contiguous()
    state = _flash_state(b, t_loc, hq, d, q.device)
    for src, (k_cur, v_cur) in _ring(mesh, (k, v)):
        state = _merge2(state, flash_fold_partial(
            q, k_cur, v_cur, mesh.rank * t_loc, src * t_loc,
            cu_seqlens=cu_seqlens))
    return _norm(state, q.dtype)


def _ring_attn_zigzag_flash_per_device(mesh, n, q, k, v, cu_seqlens=None):
    """FLASH_RING over the zigzag layout: every (q-half, k-half) pair is a
    contiguous global range, so each is one B1 fold; the never-live pair
    is not launched, the two rank-dependent pairs are, and B1's causal
    skip makes a dead one the merge's identity, (0, NEG_INF, 0)."""
    me = mesh.rank
    b, t_loc, hq, d = q.shape
    half = t_loc // 2
    q0, q1 = q[:, :half].contiguous(), q[:, half:].contiguous()
    q0_start, q1_start = me * half, (2 * n - 1 - me) * half
    st0 = _flash_state(b, half, hq, d, q.device)
    st1 = _flash_state(b, half, hq, d, q.device)
    for src, (k_cur, v_cur) in _ring(mesh, (k, v)):
        k0, v0 = k_cur[:, :half].contiguous(), v_cur[:, :half].contiguous()
        k1, v1 = k_cur[:, half:].contiguous(), v_cur[:, half:].contiguous()
        k0_start, k1_start = src * half, (2 * n - 1 - src) * half
        st1 = _merge2(st1, flash_fold_partial(q1, k0, v0, q1_start, k0_start,
                                              cu_seqlens=cu_seqlens))
        st0 = _merge2(st0, flash_fold_partial(q0, k0, v0, q0_start, k0_start,
                                              cu_seqlens=cu_seqlens))
        st1 = _merge2(st1, flash_fold_partial(q1, k1, v1, q1_start, k1_start,
                                              cu_seqlens=cu_seqlens))
    return torch.cat([_norm(st0, q.dtype), _norm(st1, q.dtype)], dim=1)


def legal_attn_blocks(t_loc: int, comm_blocks: int, n: int) -> int:
    """The ring blocks per shard: a divisor of T_loc at most comm_blocks
    (1 at world 1)."""
    return legal_comm_blocks(t_loc, comm_blocks) if n > 1 else 1


def _ring_attn_block_per_device(mesh, n, comm_blocks, q, k, v):
    """XLA_BLOCK: B21's fold order (``plain.ring_block_fold``) over the
    ring."""
    return ring_block_fold(q, _ring(mesh, (k, v)), mesh.rank, n,
                           legal_attn_blocks(q.shape[1], comm_blocks, n))


def _ring_workspace(mesh, b, t_loc, hkv, d, dtype, nblk):
    """B21's workspace: K then V landing slots (2, n, B, T_loc, Hkv, D),
    then flags (n, nblk) u64; nblk push counters in the control block.
    Returns (ws, land_v, flag_off)."""
    n = mesh.world
    nbytes = 2 * n * b * t_loc * hkv * d * torch.empty(
        (), dtype=dtype).element_size()
    land_v = -(-nbytes // _ALIGN) * _ALIGN
    flag_off = 2 * land_v
    ws = op_workspace(mesh, ("sp_ring", b, t_loc, hkv, d, dtype, nblk),
                      (flag_off + n * nblk * 8,), torch.uint8,
                      ctl_words=nblk)
    return ws, land_v, flag_off


def pallas_ring_attn_per_device(mesh, q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                comm_blocks: int = 4) -> torch.Tensor:
    """B21 on this rank: q (B, T_loc, Hq, D), k/v (B, T_loc, Hkv, D) of
    global positions [rank T_loc, (rank + 1) T_loc) -> (B, T_loc, Hq, D)
    causal GQA attention over every rank's shards. CUDA tensors launch
    the kernel (counted in ``pallas_ring_attn_per_device.launches``); CPU
    tensors run ``plain.ring_attn_ref``. Every rank calls it with the same
    shapes, in the same order."""
    if q.device.type == "cpu":
        return ring_attn_ref(mesh, q, k, v, legal_attn_blocks(
            q.shape[1], comm_blocks, mesh.world))
    if q.device.type != "cuda":
        raise ValueError(f"pallas_ring_attn: unsupported device {q.device}")
    b, t_loc, hq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, t_loc) or k.shape[3] != d \
            or hq % k.shape[2]:
        raise ValueError(f"pallas_ring_attn: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype or d not in _HEAD_DIMS:
        raise ValueError(f"pallas_ring_attn: q/k/v of one dtype in "
                         f"{list(_DTYPE_CODE)}, head_dim in {_HEAD_DIMS}; "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}, {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    n = mesh.world
    nblk = legal_attn_blocks(t_loc, comm_blocks, n)
    if nblk > _MAX_BLOCKS:
        raise ValueError(f"pallas_ring_attn: {nblk} comm blocks > "
                         f"{_MAX_BLOCKS}")
    ws, land_v, flag_off = _ring_workspace(mesh, b, t_loc, k.shape[2], d,
                                           k.dtype, nblk)
    out = torch.empty_like(q)
    fn = build.function("sp_attention", "td_ring_attn", (
        *(ctypes.c_void_p,) * 4, *(ctypes.c_int,) * 8, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, t_loc, hq, k.shape[2], d, nblk, mesh.rank, n,
                 ws.buf.table.data_ptr(), ws.ctl.data_ptr(), land_v,
                 flag_off, d ** -0.5, mesh.ranks_per_device,
                 _DTYPE_CODE[q.dtype], build.stream_of(q))
    build.check(err, "pallas_ring_attn")
    pallas_ring_attn_per_device.launches += 1
    return out


pallas_ring_attn_per_device.launches = 0


# -- entry points --------------------------------------------------------------

def sp_attn_per_device(mesh, n: int, method: SpAttnMethod, q, k, v,
                       cu_seqlens=None, comm_blocks: int = 4):
    """One rank's contiguous-layout SP attention under ``method``."""
    if method == SpAttnMethod.XLA:
        return _ag_attn_per_device(mesh, n, q, k, v, cu_seqlens)
    if method == SpAttnMethod.XLA_RING:
        return _ring_attn_per_device(mesh, n, q, k, v, cu_seqlens)
    if method == SpAttnMethod.FLASH_RING:
        return _ring_attn_flash_per_device(mesh, n, q, k, v, cu_seqlens)
    if method == SpAttnMethod.XLA_BLOCK:
        if cu_seqlens is not None:
            raise ValueError("XLA_BLOCK does not take cu_seqlens; use "
                             "XLA_RING for packed varlen batches")
        return _ring_attn_block_per_device(mesh, n, comm_blocks, q, k, v)
    if method == SpAttnMethod.PALLAS:
        if cu_seqlens is not None:
            raise ValueError("PALLAS does not take cu_seqlens; use "
                             "XLA_RING for packed varlen batches")
        return pallas_ring_attn_per_device(mesh, q, k, v, comm_blocks)
    raise ValueError(f"unresolved method {method}")


def sp_attention(ctx: SpAttnContext, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor,
                 cu_seqlens: torch.Tensor | None = None) -> torch.Tensor:
    """Causal GQA attention over sequence-sharded Q/K/V, called by every
    rank on its shards: q (B, T_loc, Hq, D), k/v (B, T_loc, Hkv, D) of
    global positions [rank T_loc, (rank + 1) T_loc) (of the zigzag order
    with layout "zigzag"). Returns this rank's (B, T_loc, Hq, D).

    cu_seqlens: optional (num_seqs+1,) int32 packed varlen boundaries in
    the global position coordinate (first 0, total tokens last): attention
    is then causal WITHIN each sequence; positions past the last boundary
    are padding."""
    n = comm_axis_size(ctx.mesh, ctx.axis)
    method = ctx.resolve()
    if ctx.layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {ctx.layout!r}; expected "
                         "'contiguous' or 'zigzag'")
    if method in (SpAttnMethod.FLASH_RING, SpAttnMethod.PALLAS) \
            and q.shape[-1] % 128:
        raise ValueError(
            f"{method.name} needs head_dim % 128 == 0, got {q.shape[-1]}; "
            "use XLA_RING (or XLA_BLOCK) for unaligned heads")
    if method == SpAttnMethod.PALLAS and (
            ctx.layout != "contiguous" or cu_seqlens is not None):
        raise ValueError(
            "PALLAS sp attention supports the contiguous single-slice "
            "dense layout only; use XLA_BLOCK / XLA_RING for zigzag, "
            "dcn_axis or cu_seqlens")
    if ctx.layout == "zigzag":
        if method not in (SpAttnMethod.XLA_RING, SpAttnMethod.FLASH_RING):
            raise ValueError("zigzag layout requires a ring method "
                             "(XLA_RING or FLASH_RING)")
        if q.shape[1] % 2:
            raise ValueError("zigzag needs an even per-rank row count")
        zz = (_ring_attn_zigzag_flash_per_device
              if method == SpAttnMethod.FLASH_RING
              else _ring_attn_zigzag_per_device)
        return zz(ctx.mesh, n, q, k, v, cu_seqlens)
    return sp_attn_per_device(ctx.mesh, n, method, q, k, v, cu_seqlens,
                              comm_blocks=ctx.comm_blocks)
