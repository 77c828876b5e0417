"""KV caches (the reference's models/kv_cache.py: the dense KVCache, the
PagedKVCache and paged_write_layer), on one device.

``KVCache`` is the dense max-length cache: (L, B, S, Hkv, D) slabs and an
``offset`` that is a 0-d int32 tensor ON THE DEVICE. The slabs are written
in place at ``offset`` by the dense attention (layers/tp_attn.py attn_fwd)
and ``advance`` adds to the offset in place, so a decode step reads and
moves the offset without a host read and can be captured once in a CUDA
graph and replayed.

Unlike the reference's functional pytree, this cache is MUTABLE: the page
pools are written in place by ``paged_write_layer`` and the allocator
methods (``clear``, ``allocate``, ``advance``, ``release``,
``adopt_prefix``, ``pin_pages``, ``unpin_pages``) update the cache's
tensors in place and return the cache itself, so ``cache =
cache.allocate(...)`` reads as it does in the reference. The allocator
arithmetic is the reference's, step for step, so block tables, lengths,
free stacks, refcounts and the overflow count stay exactly equal to it.
None of them reads a device value on the host: the reference's
out-of-range (dropped) scatters become scatters into a spare lane past the
end, so every method can be captured in a CUDA graph. ``rewind`` (the
speculative-decode reclaim) waits for ROADMAP A12.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.quant.codec import kv_row_encode

_I32 = torch.int32


@dataclasses.dataclass
class KVCache:
    """Dense KV cache: k/v (L, B, S, Hkv, D) slabs; offset () int32 on the
    slabs' device, the tokens already cached (one offset for the whole
    batch, as in the reference). Mutable: ``clear``, ``rewind`` and
    ``advance`` update the offset in place and return the cache."""
    k: torch.Tensor
    v: torch.Tensor
    offset: torch.Tensor

    @staticmethod
    def create(num_layers: int, batch: int, max_length: int,
               local_kv_heads: int, head_dim: int,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cpu") -> "KVCache":
        shape = (num_layers, batch, max_length, local_kv_heads, head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            offset=torch.zeros((), dtype=_I32, device=device),
        )

    @property
    def max_length(self) -> int:
        return self.k.shape[2]

    @property
    def batch(self) -> int:
        return self.k.shape[1]

    def clear(self) -> "KVCache":
        """Offset back to 0 (slab bytes untouched: attention reads only
        below the offset, and writes land at it)."""
        self.offset.zero_()
        return self

    def rewind(self, extra) -> "KVCache":
        """Walk the offset back by ``extra`` tokens (speculative decode:
        positions past the accepted prefix hold rejected-draft KV, dead
        until the next step overwrites them). Slabs untouched."""
        self.offset -= torch.as_tensor(extra, dtype=_I32,
                                       device=self.offset.device)
        return self

    def advance(self, new_tokens: int) -> "KVCache":
        """offset += new_tokens, on the device."""
        self.offset += new_tokens
        return self


@dataclasses.dataclass
class PagedKVCache:
    """Block-table paged KV cache with an on-device allocator.

    k_pages/v_pages: (L, Hkv, P, page_size, D) head-major pools; int8 with
    (L, Hkv, P, page_size) f32 k_scales/v_scales when int8-resident.
    block_table (B, NP) i32 physical page of each logical page; lengths
    (B,) i32 tokens cached per sequence; free_stack (P,) i32 with free ids
    at positions [next_free:]; next_free () i32; overflow () i32 pages
    requested beyond the pool (nonzero means the results are garbage);
    ref_count (P,) i32 sharers per page."""
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    block_table: torch.Tensor
    lengths: torch.Tensor
    free_stack: torch.Tensor
    next_free: torch.Tensor
    overflow: torch.Tensor
    ref_count: torch.Tensor
    k_scales: torch.Tensor | None = None
    v_scales: torch.Tensor | None = None

    @staticmethod
    def create(num_layers: int, batch: int, max_length: int,
               local_kv_heads: int, head_dim: int, page_size: int = 128,
               num_pages: int | None = None,
               dtype: torch.dtype = torch.bfloat16,
               device: torch.device | str = "cpu",
               resident: str | None = None,
               hbm_budget_bytes: int | None = None) -> "PagedKVCache":
        """resident: None (``dtype`` pools) or "kv_int8_row" (int8 pools +
        f32 row scales). hbm_budget_bytes sizes the pool from a byte
        budget at this residence's per-token cost when num_pages is not
        given, never below one max_length sequence; with neither, the
        pool holds ``batch`` full sequences."""
        if resident is not None and resident != "kv_int8_row":
            raise ValueError(
                f"resident={resident!r}: the only resident codec is "
                "'kv_int8_row' (None = full-width pools)")
        np_per_seq = -(-max_length // page_size)
        if num_pages is None:
            if hbm_budget_bytes is not None:
                itemsize = 1 if resident is not None else dtype.itemsize
                per_row = head_dim * itemsize
                if resident is not None:
                    per_row += 4               # one f32 scale per row
                per_token = 2 * num_layers * local_kv_heads * per_row
                num_pages = max(
                    int(hbm_budget_bytes) // (per_token * page_size),
                    np_per_seq)
            else:
                num_pages = batch * np_per_seq
        shape = (num_layers, local_kv_heads, num_pages, page_size, head_dim)
        k_scales = v_scales = None
        if resident is not None:
            dtype = torch.int8
            k_scales = torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device)
            v_scales = torch.zeros(shape[:-1], dtype=torch.float32,
                                   device=device)
        return PagedKVCache(
            k_pages=torch.zeros(shape, dtype=dtype, device=device),
            v_pages=torch.zeros(shape, dtype=dtype, device=device),
            block_table=torch.zeros((batch, np_per_seq), dtype=_I32,
                                    device=device),
            lengths=torch.zeros((batch,), dtype=_I32, device=device),
            free_stack=torch.arange(num_pages, dtype=_I32, device=device),
            next_free=torch.zeros((), dtype=_I32, device=device),
            overflow=torch.zeros((), dtype=_I32, device=device),
            ref_count=torch.zeros((num_pages,), dtype=_I32, device=device),
            k_scales=k_scales,
            v_scales=v_scales,
        )

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[2]

    @property
    def resident_codec(self) -> str | None:
        """The codec the pool bytes are encoded with (None = full width)."""
        return "kv_int8_row" if self.k_scales is not None else None

    @property
    def batch(self) -> int:
        return self.lengths.shape[0]

    @property
    def max_tokens_per_alloc(self) -> int:
        """Bound for per-row allocations given as a tensor: one full
        sequence."""
        return self.block_table.shape[1] * self.page_size

    def hbm_bytes_per_token(self) -> int:
        """Device bytes ONE cached token costs across all layers and kv
        heads (k + v payload + scale sidecar)."""
        num_l, hkv, _, _, d = self.k_pages.shape
        per_row = d * self.k_pages.dtype.itemsize
        if self.k_scales is not None:
            per_row += 4
        return 2 * num_l * hkv * per_row

    def clear(self) -> "PagedKVCache":
        """Free every page and empty every row (pool bytes untouched)."""
        self.block_table.zero_()
        self.lengths.zero_()
        self.free_stack.copy_(torch.arange(self.num_pages, dtype=_I32,
                                           device=self.free_stack.device))
        self.next_free.zero_()
        self.overflow.zero_()
        self.ref_count.zero_()
        return self

    def allocate(self, new_tokens, max_tokens: int | None = None
                 ) -> "PagedKVCache":
        """Grow sequences by ``new_tokens`` slots (int: every row; (B,)
        tensor: per row, 0 rows untouched): pop free-stack pages for every
        logical page the growth touches. Updates block_table, next_free,
        overflow and ref_count in place; lengths advance in ``advance``.
        Past the pool the stack position clamps at P-1 and ``overflow``
        counts the missing pages, exactly as the reference does.

        max_tokens: bound on any row's growth when new_tokens is a tensor
        (bounds the per-page loop; defaults to a full sequence)."""
        ps = self.page_size
        b = self.lengths.shape[0]
        num_pages = self.num_pages
        dev = self.lengths.device
        if isinstance(new_tokens, int):      # no host-to-device copy
            per_row = torch.full((b,), new_tokens, dtype=_I32, device=dev)
        else:
            per_row = torch.as_tensor(new_tokens, dtype=_I32,
                                      device=dev).expand(b)
        if max_tokens is not None:
            max_tok = max_tokens
        elif isinstance(new_tokens, int):
            max_tok = new_tokens
        else:
            max_tok = self.max_tokens_per_alloc
        cur_pages = -(-self.lengths // ps)                    # ceil
        new_pages = -(-(self.lengths + per_row) // ps)
        need = new_pages - cur_pages                          # (B,)
        start = self.next_free + torch.cumsum(need, 0, dtype=_I32) - need
        table = self.block_table
        np_ = table.shape[1]
        rows = torch.arange(b, device=dev)
        for j in range(-(-max_tok // ps) + 1):
            logical = cur_pages + j
            pos = torch.clamp_max(start + j, num_pages - 1)
            phys = self.free_stack[pos.long()]
            # rows with no page to add at step j, or past the table, write
            # nothing (the reference's out-of-bounds dropped scatter)
            keep = (j < need) & (logical < np_)
            idx = torch.where(keep, logical, 0).long()
            table[rows, idx] = torch.where(keep, phys, table[rows, idx])
        total = self.next_free + need.sum(dtype=_I32)
        self.overflow += torch.clamp_min(total - num_pages, 0)
        # freshly popped pages start at refcount 1; only the popped lanes
        # [next_free, total) of the stack are live (unique) ids, the rest
        # land on a spare slot past the pool
        pos = torch.arange(num_pages, device=dev)
        popped = (pos >= self.next_free) & (pos < total)
        idx = torch.where(popped, self.free_stack.long(), num_pages)
        refs = torch.cat([self.ref_count, self.ref_count.new_zeros(1)])
        refs.index_fill_(0, idx, 1)
        self.ref_count.copy_(refs[:num_pages])
        self.next_free.copy_(torch.clamp_max(total, num_pages))
        return self

    def advance(self, new_tokens) -> "PagedKVCache":
        """lengths += new_tokens (int: every row; (B,) tensor: per row)."""
        self.lengths += new_tokens
        return self

    def _add_refs(self, ids: torch.Tensor, valid: torch.Tensor,
                  delta: int) -> torch.Tensor:
        """ref_count + delta at ``ids`` where ``valid`` (duplicates
        accumulate), as a new (P,) tensor."""
        p = self.num_pages
        idx = torch.where(valid, ids.long(), p)
        refs = torch.cat([self.ref_count, self.ref_count.new_zeros(1)])
        refs.index_add_(0, idx, torch.full_like(idx, delta, dtype=_I32))
        return refs[:p]

    def _dec_and_free(self, ids: torch.Tensor, valid: torch.Tensor) -> None:
        """Decrement the refcounts of ``ids`` where ``valid`` (ids unique
        among the valid lanes) and push the pages that reach zero back
        onto the free stack, in lane order, in place."""
        p = self.num_pages
        refs = self._add_refs(ids, valid, -1)
        gathered = refs[torch.clamp_max(ids.long(), p - 1)]
        freed = valid & (gathered == 0)
        k = freed.sum(dtype=_I32)
        # stable-compact the freed ids to the front, push at [nf, nf + k)
        order = torch.argsort((~freed).to(_I32), stable=True)
        freed_ids = ids[order].to(_I32)
        nf = self.next_free - k
        lane = torch.arange(ids.shape[0], dtype=_I32, device=ids.device)
        dst = torch.where(lane < k, nf + lane, p).long()
        stack = torch.cat([self.free_stack, self.free_stack.new_zeros(1)])
        stack[dst] = freed_ids
        self.free_stack.copy_(stack[:p])
        self.ref_count.copy_(refs)
        self.next_free.copy_(nf)

    def _slot_index(self, slot) -> torch.Tensor:
        return torch.as_tensor(slot, device=self.lengths.device).reshape(
            1).long()

    def release(self, slot) -> "PagedKVCache":
        """Drop ``slot``'s references and zero its row (the
        continuous-batching reclaim). Pages return to the free stack only
        when their refcount reaches zero (they may be shared as cached
        prefixes). ``slot``: int or a one-element tensor."""
        ps = self.page_size
        np_ = self.block_table.shape[1]
        si = self._slot_index(slot)
        row = self.block_table.index_select(0, si)[0]          # (NP,)
        cnt = -(-self.lengths.index_select(0, si) // ps)       # pages held
        idx = torch.arange(np_, dtype=_I32, device=row.device)
        self._dec_and_free(row, idx < cnt)
        self.lengths.index_fill_(0, si, 0)
        self.block_table.index_fill_(0, si, 0)
        return self

    def rewind(self, extra, max_tokens: int | None = None):
        """The speculative-decode reclaim waits for ROADMAP A12."""
        raise NotImplementedError(
            "PagedKVCache.rewind (the speculative-decode reclaim) waits for "
            "ROADMAP A12")

    def adopt_prefix(self, slot, page_ids: torch.Tensor,
                     n_pages) -> "PagedKVCache":
        """Point ``slot``'s first n_pages logical pages at existing
        physical pages (a cached prompt prefix) and take a reference on
        each. page_ids: (NP,) int32, the first n_pages valid. The slot must
        be empty; lengths[slot] becomes n_pages * page_size, so every later
        write lands in freshly allocated pages."""
        np_ = self.block_table.shape[1]
        si = self._slot_index(slot)
        page_ids = page_ids.to(_I32)
        n = torch.as_tensor(n_pages, dtype=_I32, device=page_ids.device)
        valid = torch.arange(np_, dtype=_I32, device=page_ids.device) < n
        row = self.block_table.index_select(0, si)[0]
        self.block_table.index_copy_(
            0, si, torch.where(valid, page_ids, row)[None])
        self.ref_count.copy_(self._add_refs(page_ids, valid, 1))
        self.lengths.index_copy_(0, si, (n * self.page_size).reshape(1))
        return self

    def pin_pages(self, page_ids: torch.Tensor, n) -> "PagedKVCache":
        """Take a reference on the first n of page_ids (a prefix-cache
        index pinning entries so that they outlive their writer)."""
        lane = torch.arange(page_ids.shape[0], device=page_ids.device)
        self.ref_count.copy_(self._add_refs(page_ids, lane < n, 1))
        return self

    def unpin_pages(self, page_ids: torch.Tensor, n) -> "PagedKVCache":
        """Drop the pin on the first n of page_ids, freeing any page whose
        refcount reaches zero (prefix-cache eviction)."""
        lane = torch.arange(page_ids.shape[0], device=page_ids.device)
        self._dec_and_free(page_ids.to(_I32), lane < n)
        return self


def paged_write_layer(block_table: torch.Tensor, lengths: torch.Tensor,
                      page_size: int, layer_k_pages: torch.Tensor,
                      layer_v_pages: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor,
                      active: torch.Tensor | None = None,
                      layer_k_scales: torch.Tensor | None = None,
                      layer_v_scales: torch.Tensor | None = None) -> None:
    """Write (B, T, Hkv, D) new keys/values of ONE layer IN PLACE into that
    layer's (Hkv, P, page_size, D) pool slabs (pages already allocated,
    lengths pre-advance).

    layer_k_scales/layer_v_scales: the (Hkv, P, page_size) f32 slabs of an
    int8-resident pool; each new row is encoded with kv_row_encode here,
    the only quantization event of its lifetime.

    active: optional (B,) or (B, T) bool. False entries write nothing (the
    reference pushes their index out of range and drops the scatter).
    Here each False entry repeats the write of the first True entry (or,
    with none True, writes the first entry's current bytes back), so the
    scatter keeps a fixed size, its duplicates write identical bytes, and
    no device value is read on the host: the write can be captured in a
    CUDA graph."""
    b, t = k_new.shape[0], k_new.shape[1]
    dev = k_new.device
    pos = lengths[:, None].long() + torch.arange(t, device=dev)[None]
    logical = torch.clamp_max(pos // page_size, block_table.shape[1] - 1)
    row = (pos % page_size).reshape(-1)
    phys = torch.gather(block_table.long(), 1, logical).reshape(-1)
    hkv = k_new.shape[2]
    kf = k_new.reshape(b * t, hkv, -1).transpose(0, 1)    # (Hkv, B*T, D)
    vf = v_new.reshape(b * t, hkv, -1).transpose(0, 1)
    ksf = vsf = None
    if layer_k_scales is not None:
        kq, ks = kv_row_encode(kf)                         # (Hkv,B*T,D) i8
        vq, vs = kv_row_encode(vf)
        kf, vf, ksf, vsf = kq, vq, ks[..., 0], vs[..., 0]
    kf = kf.to(layer_k_pages.dtype)
    vf = vf.to(layer_v_pages.dtype)
    if active is not None:
        act = active if active.ndim == 2 else active[:, None]
        keep = act.expand(b, t).reshape(-1)
        first = keep.to(_I32).argmax().reshape(1)     # first True, else 0
        some = keep.any()
        p0, r0 = phys.index_select(0, first), row.index_select(0, first)

        def masked(new, pool):
            old = pool[:, p0, r0]                     # (Hkv, 1[, D])
            fill = torch.where(some, new.index_select(1, first), old)
            shape = (1, -1) + (1,) * (new.ndim - 2)
            return torch.where(keep.view(shape), new, fill)

        kf, vf = masked(kf, layer_k_pages), masked(vf, layer_v_pages)
        if ksf is not None:
            ksf = masked(ksf, layer_k_scales)
            vsf = masked(vsf, layer_v_scales)
        phys = torch.where(keep, phys, p0)
        row = torch.where(keep, row, r0)
    layer_k_pages[:, phys, row] = kf
    layer_v_pages[:, phys, row] = vf
    if ksf is not None:
        layer_k_scales[:, phys, row] = ksf
        layer_v_scales[:, phys, row] = vsf
