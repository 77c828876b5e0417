"""Attention blocks (the reference's layers/tp_attn.py): QKV projection,
per-head QK norm, rope, the cache write, causal GQA attention, the output
projection, at world n (``ctx.world``): each rank holds hq/n query and
hkv/n kv heads (its columns of wqkv, its rows of wo).

Mode "xla": x is the whole batch on every rank; local matmuls, and the o
projection's f32-accumulated product, cast, is all-reduced (the
reference's psum). Mode "triton_dist_AR": as xla, the sum through
``ctx.ar_method`` (ONE_SHOT = B5, RHD = B6, QINT8_OS = B28), or, with
``ctx.gemm_ar_method`` set, the product and sum as one fused GEMM +
all-reduce (PALLAS = B4). Mode "triton_dist": x is this rank's rows of
the batch; AG + GEMM gathers the batch into the QKV projection and GEMM +
RS hands each rank its rows back after the o projection
(``ctx.ag_method`` / ``ctx.rs_method``; PALLAS runs B10 / B13a at n > 1,
B12 at world 1).

``attn_fwd`` runs over the dense cache: the K/V write at the on-device
offset and B1 (or the einsum, by the reference's ``_use_flash`` rule) over
the slabs. ``paged_attn_fwd`` runs over the paged cache (each rank its
hkv/n heads of the pool): page write, then flash prefill (B1, T > 1; a
continuation chunk attends the row's earlier pages too) or paged flash
decode (B2, T == 1)."""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.allgather_gemm import ag_gemm_per_device
from triton_dist_tpu_torch.kernels.allreduce import all_reduce_per_device
from triton_dist_tpu_torch.kernels.flash_decode import lse_merge
from triton_dist_tpu_torch.kernels.gemm_allreduce import gemm_ar_per_device
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (
    gemm_rs_per_device,
)
from triton_dist_tpu_torch.kernels.paged_flash_decode import (
    paged_flash_decode_partial,
)
from triton_dist_tpu_torch.layers.attention_core import gqa_attend
from triton_dist_tpu_torch.layers.common import (
    TPContext, apply_rope, check_mode, psum, rms_norm,
)


def _qkv_project(mode: str, ctx: TPContext, arch, w: dict, x: torch.Tensor,
                 positions: torch.Tensor, cos_sin: torch.Tensor):
    """QKV projection, split, per-head QK norm, rope. Returns
    (q, k, v, b_full) with q (B_full, T, Hq/n, D) and k/v (B_full, T,
    Hkv/n, D), contiguous; B_full is the whole batch (gathered in
    triton_dist mode)."""
    check_mode(mode)
    n = ctx.world
    t = x.shape[1]
    hq, hkv, hd = arch.num_heads // n, arch.num_kv_heads // n, arch.head_dim
    if mode == "triton_dist":
        qkv2d, _ = ag_gemm_per_device(n, ctx.ag_method,
                                      x.reshape(-1, x.shape[-1]), w["wqkv"],
                                      mesh=ctx.mesh)
        qkv = qkv2d.reshape(qkv2d.shape[0] // t, t, -1)
    else:
        qkv = torch.matmul(x, w["wqkv"])
    b = qkv.shape[0]
    q, k, v = torch.split(qkv, [hq * hd, hkv * hd, hkv * hd], dim=-1)
    q = q.reshape(b, t, hq, hd)
    k = k.reshape(b, t, hkv, hd)
    v = v.reshape(b, t, hkv, hd).contiguous()
    q = rms_norm(q, w["q_norm"], arch.rms_eps)
    k = rms_norm(k, w["k_norm"], arch.rms_eps)
    q, k = apply_rope(q, k, cos_sin, positions)
    return q, k, v, b


def _o_project(mode: str, ctx: TPContext, w: dict, out: torch.Tensor,
               dtype: torch.dtype, d_model: int) -> torch.Tensor:
    """Output projection. triton_dist: GEMM + RS back to this rank's rows
    of the batch; xla: the f32-accumulated product, cast, all-reduced over
    the ranks (the reference's psum: its product is cast before the
    sum); triton_dist_AR: the fused GEMM + all-reduce when
    ``ctx.gemm_ar_method`` is set, else the cast product through
    ``ctx.ar_method``."""
    check_mode(mode)
    b, t = out.shape[0], out.shape[1]
    out2d = out.reshape(b * t, -1)
    if mode == "triton_dist":
        y2d = gemm_rs_per_device(ctx.world, ctx.rs_method, out2d, w["wo"],
                                 mesh=ctx.mesh)
        return y2d.reshape(-1, t, d_model)
    if mode == "triton_dist_AR" and ctx.gemm_ar_method is not None:
        y2d = gemm_ar_per_device(ctx.world, ctx.gemm_ar_method, out2d,
                                 w["wo"], mesh=ctx.mesh)
        return y2d.reshape(b, t, d_model)
    y2d = torch.matmul(out2d, w["wo"]).to(dtype)
    if mode == "triton_dist_AR":
        y2d = all_reduce_per_device(ctx.world, ctx.ar_method, y2d,
                                    mesh=ctx.mesh)
        return y2d.reshape(b, t, d_model)
    return psum(ctx, y2d).reshape(b, t, d_model)


def attn_fwd(mode: str, ctx: TPContext, arch, w: dict, x: torch.Tensor,
             positions: torch.Tensor, cos_sin: torch.Tensor,
             layer_k: torch.Tensor, layer_v: torch.Tensor,
             offset: torch.Tensor) -> torch.Tensor:
    """One attention block over the dense cache; returns y (B, T, hidden).

    layer_k/layer_v: this layer's (B, S, Hkv, D) slabs, written IN PLACE
    at [offset, offset + T) (the reference's dynamic_update_slice, with
    the indices made on the device: no host read of ``offset``)."""
    t = x.shape[1]
    q, k, v, _ = _qkv_project(mode, ctx, arch, w, x, positions, cos_sin)
    write_kv_slabs(layer_k, layer_v, k, v, offset)
    out = gqa_attend(q, layer_k, layer_v, offset, t, method=ctx.attn_method)
    return _o_project(mode, ctx, w, out, x.dtype, x.shape[-1])


def write_kv_slabs(layer_k: torch.Tensor, layer_v: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor,
                   offset: torch.Tensor) -> None:
    """Write (B, T, Hkv, D) k/v into (B, S, Hkv, D) slabs at rows
    offset + arange(T), in place."""
    idx = offset + torch.arange(k.shape[1], device=k.device)
    layer_k.index_copy_(1, idx, k.to(layer_k.dtype))
    layer_v.index_copy_(1, idx, v.to(layer_v.dtype))


def paged_attn_fwd(mode: str, ctx: TPContext, arch, w: dict,
                   x: torch.Tensor, positions: torch.Tensor,
                   cos_sin: torch.Tensor, lk_pages: torch.Tensor,
                   lv_pages: torch.Tensor, block_table: torch.Tensor,
                   lengths: torch.Tensor, page_size: int,
                   active: torch.Tensor | None = None,
                   continuation: bool = False,
                   lk_scales: torch.Tensor | None = None,
                   lv_scales: torch.Tensor | None = None) -> torch.Tensor:
    """One attention block over the paged cache; returns y (B, T, hidden).

    lk_pages/lv_pages (and lk_scales/lv_scales when int8-resident) are
    this layer's pool slabs, written IN PLACE; block_table/lengths are the
    allocated, pre-advance cache state. T > 1 is prefill into an empty
    cache (attention within the chunk) or, with ``continuation``, a chunk
    that continues a single row's sequence (B == 1): it attends the row's
    pages in logical order, this chunk's keys included, from offset
    lengths[0]; T == 1 is paged flash decode over lengths + 1 keys."""
    # imported here: models/ imports this module (the reference does the same)
    from triton_dist_tpu_torch.models.kv_cache import paged_write_layer

    t = x.shape[1]
    q, k, v, _ = _qkv_project(mode, ctx, arch, w, x, positions, cos_sin)
    paged_write_layer(block_table, lengths, page_size, lk_pages, lv_pages,
                      k, v, active=active, layer_k_scales=lk_scales,
                      layer_v_scales=lv_scales)
    if t == 1:
        acc, m, l = paged_flash_decode_partial(
            q[:, 0].contiguous(), lk_pages, lv_pages, block_table,
            lengths + 1, k_scales=lk_scales, v_scales=lv_scales)
        out = lse_merge(acc[None], m[None], l[None])[:, None].to(x.dtype)
    elif continuation:
        # the chunk's KV was just written, so this row's pages in logical
        # order hold prior + chunk as one buffer; keys past lengths + t are
        # causally masked (they lie beyond every query position)
        if q.shape[0] != 1:
            raise ValueError("continuation prefill is the single-slot "
                             f"path; got batch {q.shape[0]}")
        pages = block_table[0].long()
        hkv_l, d = lk_pages.shape[0], lk_pages.shape[-1]
        k_all, v_all = lk_pages[:, pages], lv_pages[:, pages]
        if lk_scales is not None:
            # dequantize the gathered pages only, never the whole pool
            k_all = k_all.float() * lk_scales[:, pages][..., None]
            v_all = v_all.float() * lv_scales[:, pages][..., None]

        def dense(pool):                               # (1, NP*ps, Hkv, D)
            return pool.to(x.dtype).reshape(hkv_l, -1, d).transpose(
                0, 1)[None].contiguous()

        out = gqa_attend(q, dense(k_all), dense(v_all), lengths[0], t,
                         method=ctx.attn_method)
    else:
        # prefill from empty: every key is in the current chunk
        out = gqa_attend(q, k, v, 0, t, method=ctx.attn_method)
    return _o_project(mode, ctx, w, out, x.dtype, x.shape[-1])
