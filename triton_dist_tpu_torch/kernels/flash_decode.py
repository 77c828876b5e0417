"""Distributed flash-decode (the reference's kernels/flash_decode.py):
split-KV GQA decode over a sequence-sharded KV cache with a cross-rank LSE
merge.

Rank r holds key positions [r S_loc, (r + 1) S_loc) of every sequence. Its
local pass returns an UNNORMALIZED accumulator with its (m, l) statistics,
and the ranks' triples merge by exact log-sum-exp:

    m = max_i m_i;   out = sum_i e^(m_i - m) acc_i  /  sum_i e^(m_i - m) l_i

The local pass (``local_decode_partial``): "pallas" is B19,
``flash_attention.flash_decode_partial`` (its plain version on CPU
tensors); "xla" the masked einsum; "auto" B19 when head_dim % 128 == 0,
as the reference decides. ``kv_splits`` > 1 splits it into independent
passes merged in ascending order (``local_decode_partial_split``).

The combine tiers:
  * XLA: the process group's all-gather of the (acc, m, l) triple, then
    ``lse_merge`` over the stack in rank order;
  * PALLAS: B20, ``pallas_combine_per_device``, the hand-written kernel of
    ``csrc/flash_decode.cu`` for CUDA tensors (every rank stores its rows
    into slot `rank` of every peer's landing buffer in comm_blocks row
    blocks, a flag per (block, sender), each block merged across sources
    in slot order when its n - 1 flags land; landing slots double-buffered
    by the epoch's parity) and its plain version for CPU tensors: the
    all-gather, then ``lse_partial_merge`` over the stack in rank order
    (``plain.combine_ref``; the merges live in ``kernels/plain.py``).

``flash_decode`` and ``paged_flash_decode_dist`` are called by every rank
on its own shard, as the port's other mesh-level ops are. The paged form
runs B2 (``paged_flash_decode.paged_flash_decode_partial``, its int8 pool
too) over the rank's own page pool, then the same combine. Nothing on the
decode path reads a device value on the host, so a step can be captured
in one CUDA graph; B19 reads the query position on the device and B20's
epochs advance there. No fallback: a PALLAS combine the kernel cannot
take raises (ROADMAP queue C); there is no fault preamble (ROADMAP A8).
The 2-D (``dcn_axis``) combine waits for ROADMAP A9 (tail): one H100 node
has no second network tier and the port's meshes have one axis.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum

import torch

from triton_dist_tpu_torch.kernels.flash_attention import (
    flash_decode_partial,
)
from triton_dist_tpu_torch.kernels.moe_utils import legal_comm_blocks
from triton_dist_tpu_torch.kernels.plain import (
    NEG_INF, combine_ref, gather_triple, lse_merge, lse_partial_merge,
)
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.mesh import comm_axis_size
from triton_dist_tpu_torch.runtime.symm import op_workspace

_ALIGN = 256


class FlashDecodeCombine(enum.Enum):
    XLA = "xla"
    PALLAS = "pallas"


def check_not_2d(dcn_axis, what: str) -> None:
    """The hierarchical (slice-then-DCN) paths need a second network tier
    and a multi-axis mesh."""
    if dcn_axis is not None:
        raise ValueError(
            f"{what} over a factored (dcn_axis x axis) mesh waits for "
            "ROADMAP A9 (tail): one H100 node has no second network tier "
            "and the port's meshes have one axis")


@dataclasses.dataclass
class FlashDecodeContext:
    """The reference's FlashDecodeContext: the ranks' Mesh, its axis, the
    combine tier, the local method ("pallas", "xla" or "auto"), the PALLAS
    combine's row blocks (clamped to a divisor of B * Hq) and the local
    split-KV passes (clamped to a divisor of S_loc). dcn_axis raises:
    ROADMAP A9 (tail)."""
    mesh: object
    axis: str = "tp"
    combine: FlashDecodeCombine = FlashDecodeCombine.XLA
    local_method: str = "auto"
    dcn_axis: str | None = None
    comm_blocks: int = 4
    kv_splits: int = 1

    def __post_init__(self):
        check_not_2d(self.dcn_axis, "flash_decode")


def create_flash_decode_context(mesh, axis: str = "tp",
                                **kw) -> FlashDecodeContext:
    return FlashDecodeContext(mesh, axis, **kw)


def local_decode_partial(q: torch.Tensor, k_shard: torch.Tensor,
                         v_shard: torch.Tensor, start_pos, q_pos, *,
                         method: str = "xla"):
    """Masked partial attention over one KV shard (one decode step).

    q: (B, Hq, D); k_shard/v_shard: (B, S_loc, Hkv, D) holding global key
    positions [start_pos, start_pos + S_loc); q_pos: the query's absolute
    position (keys <= q_pos are valid), an int or a 0-d int32 tensor.
    Returns (acc (B, Hq, D) f32 UNNORMALIZED, m (B, Hq) f32 rowmax, l (B,
    Hq) f32 sumexp). method "pallas" runs B19; "xla" the masked einsum;
    "auto" B19 when head_dim % 128 == 0."""
    if method not in ("pallas", "xla", "auto"):
        raise ValueError(f"unknown local decode method {method!r}")
    if method == "pallas" or (method == "auto" and q.shape[-1] % 128 == 0):
        return flash_decode_partial(q, k_shard, v_shard, start_pos, q_pos)
    b, hq, d = q.shape
    s_loc, hkv = k_shard.shape[1], k_shard.shape[2]
    g = hq // hkv
    qf = q.float() * (d ** -0.5)
    scores = torch.einsum("bhgd,bshd->bhgs", qf.reshape(b, hkv, g, d),
                          k_shard.float())              # (B, Hkv, g, S_loc)
    key_pos = start_pos + torch.arange(s_loc, device=q.device)
    valid = key_pos <= q_pos
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(dim=-1)                              # (B, Hkv, g)
    p = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v_shard.float())
    return acc.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)


def local_decode_partial_split(q, k_shard, v_shard, start_pos, q_pos, *,
                               method: str = "xla", kv_splits: int = 1):
    """``local_decode_partial`` over kv_splits independent key sub-ranges
    (views of the shard, no copies), merged by exact LSE in ascending
    order. kv_splits is clamped to a divisor of S_loc; 1 = one pass."""
    s_loc = k_shard.shape[1]
    splits = legal_comm_blocks(s_loc, kv_splits)
    if splits == 1:
        return local_decode_partial(q, k_shard, v_shard, start_pos, q_pos,
                                    method=method)
    sr = s_loc // splits
    state = None
    for j in range(splits):
        part = local_decode_partial(
            q, k_shard[:, j * sr:(j + 1) * sr],
            v_shard[:, j * sr:(j + 1) * sr], start_pos + j * sr, q_pos,
            method=method)
        state = part if state is None else lse_partial_merge(
            torch.stack([state[0], part[0]]), torch.stack([state[1], part[1]]),
            torch.stack([state[2], part[2]]))
    return state


def tree_lse_partial_merge(*args, **kw):
    """The reference's pairwise merge over the DCN axis."""
    check_not_2d("dcn", "tree_lse_partial_merge")


# -- B20: the cross-rank combine kernel ---------------------------------------

def _combine_workspace(mesh, rows: int, d: int, nblk: int):
    """B20's workspace: landing slots (2, n, rows, d + 4) f32, then flags
    (nblk, n) u64. Returns (ws, flag_off)."""
    n = mesh.world
    flag_off = -(-2 * n * rows * (d + 4) * 4 // _ALIGN) * _ALIGN
    ws = op_workspace(mesh, ("fd_combine", rows, d, nblk),
                      (flag_off + nblk * n * 8,), torch.uint8)
    return ws, flag_off


def pallas_combine_per_device(mesh, acc: torch.Tensor, m: torch.Tensor,
                              l: torch.Tensor, *, partial: bool = False,
                              comm_blocks: int = 4):
    """B20 on this rank: acc (B, Hq, D), m, l (B, Hq) f32 of every rank
    merged by exact LSE in rank order; normalized (B, Hq, D) f32, or the
    merged (acc, m, l) triple when ``partial``. The rows travel in
    ``legal_comm_blocks(B * Hq, comm_blocks)`` row blocks. CUDA tensors
    launch the kernel (counted in ``pallas_combine_per_device.launches``);
    CPU tensors run ``plain.combine_ref``. Every rank calls it with the same
    shapes, in the same order."""
    if acc.device.type == "cpu":
        return combine_ref(mesh, acc, m, l, partial)
    if acc.device.type != "cuda":
        raise ValueError(f"pallas_combine: unsupported device {acc.device}")
    b, hq, d = acc.shape
    rows = b * hq
    if acc.dtype != torch.float32 or m.dtype != torch.float32 or \
            l.dtype != torch.float32 or m.shape != (b, hq) or \
            l.shape != (b, hq) or d % 4:
        raise ValueError("pallas_combine: want f32 acc (B, Hq, D) with D % "
                         f"4 == 0 and m, l (B, Hq); got {tuple(acc.shape)} "
                         f"{acc.dtype}, {tuple(m.shape)} {m.dtype}, "
                         f"{tuple(l.shape)} {l.dtype}")
    n = mesh.world
    nblk = legal_comm_blocks(rows, comm_blocks) if n > 1 else 1
    ws, flag_off = _combine_workspace(mesh, rows, d, nblk)
    acc, m, l = acc.contiguous(), m.contiguous(), l.contiguous()
    if partial:
        out = None
        acc_o, m_o, l_o = torch.empty_like(acc), torch.empty_like(m), \
            torch.empty_like(l)
    else:
        out = torch.empty_like(acc)
        acc_o = m_o = l_o = None
    ptr = (lambda x: None if x is None else x.data_ptr())
    fn = build.function("flash_decode", "td_decode_combine", (
        *(ctypes.c_void_p,) * 7, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p))
    with torch.cuda.device(acc.device):
        err = fn(acc.data_ptr(), m.data_ptr(), l.data_ptr(), ptr(out),
                 ptr(acc_o), ptr(m_o), ptr(l_o), rows, d, nblk, mesh.rank, n,
                 ws.buf.table.data_ptr(), ws.ctl.data_ptr(), flag_off,
                 build.stream_of(acc))
    build.check(err, "pallas_combine")
    pallas_combine_per_device.launches += 1
    return (acc_o, m_o, l_o) if partial else out


pallas_combine_per_device.launches = 0


def _combine_levels(mesh, n, combine, acc, m, l, comm_blocks: int = 4):
    """The flat cross-rank combine: normalized (B, Hq, D) f32."""
    if combine == FlashDecodeCombine.PALLAS:
        return pallas_combine_per_device(mesh, acc, m, l,
                                         comm_blocks=comm_blocks)
    if combine != FlashDecodeCombine.XLA:
        raise ValueError(f"unknown combine {combine}")
    return lse_merge(*gather_triple(mesh, acc, m, l))


# -- the per-device bodies and the mesh-level ops ----------------------------

def paged_flash_decode_dist_per_device(mesh, n, combine, q, k_pages,
                                       v_pages, block_table, lengths, *,
                                       comm_blocks: int = 4, k_scales=None,
                                       v_scales=None) -> torch.Tensor:
    """This rank's paged split-KV partial (B2 over its own pool: (Hkv, P,
    page_size, D), int8 with ``k_scales``/``v_scales``; block_table (B,
    NP) and lengths (B,) the keys it holds per sequence), then the
    cross-rank combine. Returns (B, Hq, D) in q.dtype."""
    from triton_dist_tpu_torch.kernels.paged_flash_decode import (
        paged_flash_decode_partial,
    )
    acc, m, l = paged_flash_decode_partial(
        q, k_pages, v_pages, block_table, lengths, k_scales=k_scales,
        v_scales=v_scales)
    out = _combine_levels(mesh, n, combine, acc, m, l,
                          comm_blocks=comm_blocks)
    return out.to(q.dtype)


def paged_flash_decode_dist(ctx: FlashDecodeContext, q: torch.Tensor,
                            k_pages: torch.Tensor, v_pages: torch.Tensor,
                            block_table: torch.Tensor, lengths: torch.Tensor,
                            k_scales: torch.Tensor | None = None,
                            v_scales: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """One decode step over RANK-SHARDED paged KV (the reference's
    paged_flash_decode_dist), called by every rank: q (B, Hq, D)
    replicated; this rank's pool k_pages/v_pages (Hkv, P, page_size, D),
    its block_table (B, NP) into that pool and its lengths (B,). Returns
    (B, Hq, D) replicated."""
    n = comm_axis_size(ctx.mesh, ctx.axis)
    return paged_flash_decode_dist_per_device(
        ctx.mesh, n, ctx.combine, q, k_pages, v_pages, block_table, lengths,
        comm_blocks=ctx.comm_blocks, k_scales=k_scales, v_scales=v_scales)


def flash_decode_per_device(mesh, n: int, combine: FlashDecodeCombine, q,
                            k_shard, v_shard, offset,
                            local_method: str = "xla",
                            comm_blocks: int = 4,
                            kv_splits: int = 1) -> torch.Tensor:
    """q: (B, Hq, D) replicated; k/v_shard: (B, S_loc, Hkv, D) this rank's
    sequence shard; offset: the query's absolute position (an int or a 0-d
    int32 tensor) — its own K/V already written at cache index `offset`;
    keys [0, offset] are attended. Returns (B, Hq, D) in q.dtype."""
    s_loc = k_shard.shape[1]
    start = mesh.rank * s_loc
    acc, m, l = local_decode_partial_split(q, k_shard, v_shard, start,
                                           offset, method=local_method,
                                           kv_splits=kv_splits)
    out = _combine_levels(mesh, n, combine, acc, m, l,
                          comm_blocks=comm_blocks)
    return out.to(q.dtype)


def flash_decode_2d_per_device(*args, **kw):
    """The reference's hierarchical (dcn x ici) decode."""
    check_not_2d("dcn", "flash_decode_2d_per_device")


def flash_decode(ctx: FlashDecodeContext, q: torch.Tensor,
                 k_shard: torch.Tensor, v_shard: torch.Tensor,
                 offset) -> torch.Tensor:
    """One decode step over a sequence-sharded KV cache (the reference's
    flash_decode), called by every rank on its shard (B, S_loc, Hkv, D)
    of the cache's global positions [rank S_loc, (rank + 1) S_loc); q (B,
    Hq, D) replicated; offset the query's absolute position. Returns (B,
    Hq, D) replicated."""
    n = comm_axis_size(ctx.mesh, ctx.axis)
    return flash_decode_per_device(
        ctx.mesh, n, ctx.combine, q, k_shard, v_shard, offset,
        local_method=ctx.local_method, comm_blocks=ctx.comm_blocks,
        kv_splits=ctx.kv_splits)
