"""MoE routing and tile schedules (the reference's kernels/moe_utils.py).

Everything here runs on the routing's device and never reads a device
value on the host, so the decode step that calls it can be captured as a
CUDA graph: the stable argsort, the one-hot histogram, cumsum,
``searchsorted(right=True)`` and scatters to unique positions are all
device ops. The one exception is ``grouped_gemm``'s large-batch form,
which reads the per-expert counts once per call outside a capture.

Layout contract (the reference's): a "flat" tensor has M * topk rows, row
f belonging to token f // topk, choice f % topk (token-major). Sorted
tensors are flat tensors permuted by ``sort_idx``; ``inv_idx`` undoes it.

``AlignedSchedule`` is the block-aligned tile schedule the grouped-GEMM
kernels (B14, B15) consume: every bm-row tile touches one expert. Two
providers build it: ``aligned_chunk_schedule`` in the graph (the model
path's, and "auto"), and ``native_chunk_schedule`` on the host from the
port's C++ tile swizzle and block-aligned sort (runtime/native.py,
``make_chunk_schedule(provider="native")``), which the mesh-level
``ag_group_gemm`` / ``moe_reduce_rs`` take through their context's
``schedule``. It reads the routing on the host, so a captured decode step
never uses it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from triton_dist_tpu_torch.kernels.plain import bmm_f32, dot_f32

_I32 = torch.int32


class SortedTokens(NamedTuple):
    """Routing metadata for one grouped-GEMM call."""
    sort_idx: torch.Tensor     # (M*topk,) i32: sorted pos -> flat row
    inv_idx: torch.Tensor      # (M*topk,) i32: flat row -> sorted pos
    group_sizes: torch.Tensor  # (E,) i32: rows per expert in sorted order
    token_idx: torch.Tensor    # (M*topk,) i32: sorted pos -> source token


def expert_histogram(expert_ids: torch.Tensor,
                     num_experts: int) -> torch.Tensor:
    """Per-expert counts of a flat expert-id tensor (any shape), as a
    one-hot sum (no atomics, no host read)."""
    flat = expert_ids.reshape(-1)
    experts = torch.arange(num_experts, device=flat.device)
    return (flat[:, None] == experts[None, :]).sum(dim=0, dtype=_I32)


def _inverse_perm(perm: torch.Tensor) -> torch.Tensor:
    """The inverse of a permutation along its last axis (the reference's
    argsort of it, as a scatter)."""
    ar = torch.arange(perm.shape[-1], device=perm.device,
                      dtype=_I32).expand_as(perm)
    return torch.empty_like(ar).scatter_(-1, perm.long(), ar)


def sort_by_expert(topk_ids: torch.Tensor, num_experts: int) -> SortedTokens:
    """Stable sort of flat (M, topk) expert assignments by expert id;
    stability keeps token order within an expert."""
    flat = topk_ids.reshape(-1).to(_I32)
    sort_idx = torch.argsort(flat, stable=True).to(_I32)
    inv_idx = _inverse_perm(sort_idx)
    group_sizes = expert_histogram(flat, num_experts)
    topk = topk_ids.shape[-1]
    return SortedTokens(sort_idx, inv_idx, group_sizes, sort_idx // topk)


def gather_sorted(tokens: torch.Tensor, st: SortedTokens) -> torch.Tensor:
    """(M, K) tokens expanded to (M*topk, K) rows in expert-sorted order."""
    return tokens[st.token_idx.long()]


def unsort(sorted_rows: torch.Tensor, st: SortedTokens) -> torch.Tensor:
    """Sorted (M*topk, N) rows back to token-major flat order."""
    return sorted_rows[st.inv_idx.long()]


def grouped_gemm(lhs_sorted: torch.Tensor, experts_w: torch.Tensor,
                 group_sizes: torch.Tensor,
                 out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Per-expert GEMM over expert-sorted rows (the reference's
    ``ragged_dot``): lhs_sorted (G, K), experts_w (E, K, N), group_sizes
    (E,); f32 accumulation, cast to ``out_dtype`` (default: the inputs'
    result dtype).

    Up to E rows (the decode shape), or inside a CUDA-graph capture, each
    row is multiplied by its own expert's weight, gathered on the device
    (each row's expert is a searchsorted of the cumulated counts). Above
    that (prefill) it loops over the experts and reads the counts once on
    the host, which reads each expert's weight once."""
    g, num_experts = lhs_sorted.shape[0], experts_w.shape[0]
    if out_dtype is None:
        out_dtype = torch.result_type(lhs_sorted, experts_w)
    if g <= num_experts or (lhs_sorted.is_cuda
                            and torch.cuda.is_current_stream_capturing()):
        ends = torch.cumsum(group_sizes, 0)
        rows = torch.arange(g, device=lhs_sorted.device, dtype=ends.dtype)
        row_e = torch.searchsorted(ends, rows, right=True).clamp_(
            max=num_experts - 1)
        out = bmm_f32(lhs_sorted[:, None, :], experts_w[row_e])[:, 0]
        return out.to(out_dtype)
    out = torch.empty((g, experts_w.shape[-1]), dtype=out_dtype,
                      device=lhs_sorted.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        if size:
            out[start:start + size] = dot_f32(
                lhs_sorted[start:start + size], experts_w[e]).to(out_dtype)
        start += size
    return out


def reduce_topk(flat_out: torch.Tensor,
                topk_weights: torch.Tensor) -> torch.Tensor:
    """Weighted f32 sum of each token's topk rows: flat_out (M*topk, N)
    token-major, topk_weights (M, topk) -> (M, N) f32."""
    m, topk = topk_weights.shape
    per_tok = flat_out.reshape(m, topk, -1).float()
    return (per_tok * topk_weights.float()[:, :, None]).sum(dim=1)


class AlignedSchedule(NamedTuple):
    """Block-aligned per-chunk tile schedule of the grouped-GEMM kernels:
    every bm-row tile touches exactly one expert, tiles in (chunk, expert)
    order. n_chunks chunks of mc tokens; R = T * bm aligned slots per
    chunk."""
    row_token: torch.Tensor    # (n, R) i32 slot -> token row in the chunk
    #                            (sentinel mc: padding)
    row_flat: torch.Tensor     # (n, R) i32 slot -> flat row in the chunk
    #                            (sentinel mc * topk)
    tile_expert: torch.Tensor  # (n, T) i32 expert of each tile
    used_tiles: torch.Tensor   # (n,) i32 live tiles per chunk
    aligned_pos: torch.Tensor  # (n, mc * topk) i32 flat row -> slot


def aligned_tiles(mc: int, topk: int, num_experts: int, bm: int) -> int:
    """Static tile count per chunk: worst case every expert pads bm - 1."""
    return -(-(mc * topk + num_experts * (bm - 1)) // bm)


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0) - x


def aligned_chunk_schedule(topk_ids: torch.Tensor, n_chunks: int,
                           num_experts: int, bm: int) -> AlignedSchedule:
    """topk_ids: (M, topk) routing; the chunks split M evenly. The
    reference's per-chunk computation, chunk by chunk."""
    m, topk = topk_ids.shape
    mc = m // n_chunks
    nf = mc * topk
    t_tiles = aligned_tiles(mc, topk, num_experts, bm)
    r = t_tiles * bm
    dev = topk_ids.device
    ids = topk_ids.reshape(n_chunks, nf).to(_I32)
    fields = []
    for flat in ids:
        sort_idx = torch.argsort(flat, stable=True)
        gs = expert_histogram(flat, num_experts).long()
        ag = (gs + bm - 1) // bm * bm                      # aligned sizes
        off = _exclusive_cumsum(ag)
        shift = off - _exclusive_cumsum(gs)
        pos_sorted = (torch.arange(nf, device=dev)
                      + shift[flat[sort_idx].long()])
        row_token = torch.full((r,), mc, dtype=_I32, device=dev).scatter_(
            0, pos_sorted, (sort_idx // topk).to(_I32))
        row_flat = torch.full((r,), nf, dtype=_I32, device=dev).scatter_(
            0, pos_sorted, sort_idx.to(_I32))
        aligned_pos = torch.zeros((nf,), dtype=_I32, device=dev).scatter_(
            0, sort_idx, pos_sorted.to(_I32))
        used = ag.sum() // bm
        starts = torch.arange(t_tiles, device=dev) * bm
        tile_e = (torch.searchsorted(off, starts, right=True) - 1).clamp_(
            0, num_experts - 1)
        fields.append((row_token, row_flat, tile_e.to(_I32),
                       used.to(_I32), aligned_pos))
    return AlignedSchedule(*(torch.stack(f) for f in zip(*fields)))


def live_tile_schedule(ids: torch.Tensor, n_chunks: int, num_live: int,
                       bm: int) -> AlignedSchedule:
    """The aligned schedule of an expert-parallel rank's slots: ids (R, 1)
    local expert per slot, the pad sentinel ``num_live`` (E_loc) binned
    last in each chunk, and used_tiles cut to the tiles of real experts,
    so a pad slot is in no live tile and costs no work. In the graph."""
    sched = aligned_chunk_schedule(ids, n_chunks, num_live + 1, bm)
    t_tiles = sched.tile_expert.shape[1]
    t_idx = torch.arange(t_tiles, device=ids.device)[None, :]
    live = (t_idx < sched.used_tiles[:, None]) & (sched.tile_expert
                                                  < num_live)
    return sched._replace(used_tiles=live.sum(dim=1, dtype=_I32))


def native_chunk_schedule(topk_ids: torch.Tensor, n_chunks: int,
                          num_experts: int, bm: int) -> AlignedSchedule:
    """The AlignedSchedule from the host C++ schedulers (runtime/native.py):
    the tile order from the rank-rotated tile swizzle of rank 0 (its stage
    s delivers chunk -s mod n, so each chunk's tiles are read back in
    expert-major order) and the rows from the block-aligned stable sort.
    Equal to ``aligned_chunk_schedule`` on every field the kernels read;
    tile_expert past used_tiles (dead tiles, never read) is 0 here. Reads
    the routing on the host; returns int32 tensors on its device."""
    import numpy as np
    from triton_dist_tpu_torch.runtime import native

    ids = np.ascontiguousarray(topk_ids.detach().cpu().numpy(), np.int32)
    m, topk = ids.shape
    mc = m // n_chunks
    nf = mc * topk
    t_tiles = aligned_tiles(mc, topk, num_experts, bm)
    r = t_tiles * bm
    flat_all = ids.reshape(n_chunks, nf)
    row_token = np.full((n_chunks, r), mc, np.int32)
    row_flat = np.full((n_chunks, r), nf, np.int32)
    tile_e = np.zeros((n_chunks, t_tiles), np.int32)
    used = np.zeros((n_chunks,), np.int32)
    aligned_pos = np.zeros((n_chunks, nf), np.int32)
    counts = np.stack([native.expert_histogram(flat_all[c], num_experts)
                       for c in range(n_chunks)])
    stage, expert, _ = native.ag_moe_tile_schedule(
        counts.reshape(-1), n_chunks, num_experts, bm, 0)
    chunk = (n_chunks - stage) % n_chunks
    for c in range(n_chunks):
        te = expert[chunk == c]
        tile_e[c, :te.size] = te
        used[c] = te.size
        sorted_ids, block_e, total = native.moe_align_block_size(
            flat_all[c], num_experts, bm)
        if total // bm != used[c] or not np.array_equal(
                block_e, tile_e[c, :used[c]]):
            raise AssertionError("the native tile swizzle and block-aligned "
                                 f"sort disagree on chunk {c}")
        row_flat[c, :total] = sorted_ids
        row_token[c, :total] = np.where(sorted_ids < nf, sorted_ids // topk,
                                        mc)
        slots = np.nonzero(sorted_ids < nf)[0]
        aligned_pos[c, sorted_ids[slots]] = slots.astype(np.int32)
    return AlignedSchedule(*(torch.from_numpy(f).to(topk_ids.device)
                             for f in (row_token, row_flat, tile_e, used,
                                       aligned_pos)))


def make_chunk_schedule(topk_ids: torch.Tensor, n_chunks: int,
                        num_experts: int, bm: int,
                        provider="auto") -> AlignedSchedule:
    """Chunk/tile schedule of the grouped-GEMM kernels, by provider: an
    AlignedSchedule passes through untouched (a precomputed plan);
    "auto" and "device" build it in-graph (aligned_chunk_schedule), with
    no host read, so a captured step can call it; "native" on the host
    from the C++ schedulers (native_chunk_schedule)."""
    if isinstance(provider, AlignedSchedule):
        return provider
    if provider in ("auto", "device"):
        return aligned_chunk_schedule(topk_ids, n_chunks, num_experts, bm)
    if provider == "native":
        return native_chunk_schedule(topk_ids, n_chunks, num_experts, bm)
    raise ValueError(f"unknown schedule provider {provider!r}")


def arrival_ordered_schedule(sched: AlignedSchedule, mc: int, bm: int,
                             comm_blocks: int):
    """Each chunk's tiles reordered by the LAST token block they gather
    (the ring's arrival order), with tiles_ready[c, b] = the count of
    reordered tiles runnable once blocks 0..b of chunk c have arrived.
    Sentinel rows gather the clamped row mc - 1, so a tile with padding
    needs the last block; dead tiles (t >= used) sort after every live
    one. At one block (world 1) the order is the identity. B14 across
    ranks (csrc/moe_group_gemm.cu) runs a remote chunk's tiles in this
    order, tile t once blocks 0..b with t < tiles_ready[c, b] have
    landed. Returns (sched', tiles_ready)."""
    n, t_tiles = sched.tile_expert.shape
    r = t_tiles * bm
    if mc % comm_blocks:
        raise ValueError(
            f"comm_blocks ({comm_blocks}) must divide the chunk's token "
            f"rows ({mc})")
    bb = mc // comm_blocks
    dev = sched.row_token.device
    rt = sched.row_token.reshape(n, t_tiles, bm)
    need = torch.clamp(rt, max=mc - 1).amax(dim=2) // bb           # (n, T)
    live = (torch.arange(t_tiles, device=dev)[None, :]
            < sched.used_tiles[:, None])
    key = torch.where(live, need, torch.full_like(need, comm_blocks))
    perm = torch.argsort(key, dim=1, stable=True)
    inv = _inverse_perm(perm)
    tile_rows = perm[:, :, None].expand(n, t_tiles, bm)
    rt2 = torch.gather(rt, 1, tile_rows).reshape(n, r)
    rf2 = torch.gather(sched.row_flat.reshape(n, t_tiles, bm), 1,
                       tile_rows).reshape(n, r)
    te2 = torch.gather(sched.tile_expert, 1, perm)
    ap = sched.aligned_pos
    ap2 = torch.gather(inv, 1, (ap // bm).long()) * bm + ap % bm
    key_sorted = torch.gather(key, 1, perm).contiguous()
    blocks = torch.arange(comm_blocks, device=dev,
                          dtype=key.dtype).expand(n, comm_blocks)
    ready = torch.searchsorted(key_sorted, blocks.contiguous(), right=True)
    return (AlignedSchedule(rt2, rf2, te2, sched.used_tiles, ap2.to(_I32)),
            ready.to(_I32))


def legal_comm_blocks(mc: int, comm_blocks: int) -> int:
    """Largest block count <= the requested knob that divides the chunk's
    mc token rows (1 = shard-granular)."""
    nblk = max(1, min(int(comm_blocks), mc))
    while mc % nblk:
        nblk -= 1
    return nblk


def combine_matrix(topk_weights: torch.Tensor, sched: AlignedSchedule,
                   n_chunks: int) -> torch.Tensor:
    """(n, mc, R) f32: G[c] @ sorted expert outputs = the weighted top-k
    reduce of chunk c (one nonzero per live slot: its token's weight);
    sentinel slots get zero columns."""
    m, topk = topk_weights.shape
    mc = m // n_chunks
    r = sched.row_token.shape[1]
    w = topk_weights.reshape(n_chunks, mc * topk).float()
    tok = torch.arange(mc * topk, device=w.device) // topk
    g = torch.zeros((n_chunks, mc * r), dtype=torch.float32, device=w.device)
    g.scatter_add_(1, tok[None, :] * r + sched.aligned_pos.long(), w)
    return g.reshape(n_chunks, mc, r)


def route_topk(logits: torch.Tensor, topk: int, *,
               norm_topk_prob: bool = True):
    """Router: softmax over experts in f32, then top-k. logits (M, E).
    Returns (topk_weights (M, topk) f32, topk_ids (M, topk) i32)."""
    probs = torch.softmax(logits.float(), dim=-1)
    topk_weights, topk_ids = torch.topk(probs, topk, dim=-1)
    if norm_topk_prob:
        topk_weights = topk_weights / topk_weights.sum(dim=-1, keepdim=True)
    return topk_weights, topk_ids.to(_I32)
