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
methods (``clear``, ``allocate``, ``advance``) update the cache's tensors
in place and return the cache itself, so ``cache = cache.allocate(...)``
reads as it does in the reference. The allocator arithmetic is the
reference's, step for step, so block tables, lengths, free stacks,
refcounts and the overflow count stay exactly equal to it.

The paged cache's ``release``, ``rewind``, ``adopt_prefix`` and
``pin_pages``/``unpin_pages`` wait for the ContinuousEngine slice (ROADMAP
A7).
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
        self.lengths += torch.as_tensor(new_tokens, dtype=_I32,
                                        device=self.lengths.device)
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
    reference pushes their index out of range and drops the scatter;
    PyTorch indexing raises on that, so they are masked out here)."""
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
    if active is not None:
        act = active if active.ndim == 2 else active[:, None]
        keep = act.expand(b, t).reshape(-1)
        phys, row = phys[keep], row[keep]
        kf, vf = kf[:, keep], vf[:, keep]
        if ksf is not None:
            ksf, vsf = ksf[:, keep], vsf[:, keep]
    layer_k_pages[:, phys, row] = kf.to(layer_k_pages.dtype)
    layer_v_pages[:, phys, row] = vf.to(layer_v_pages.dtype)
    if ksf is not None:
        layer_k_scales[:, phys, row] = ksf
        layer_v_scales[:, phys, row] = vsf
