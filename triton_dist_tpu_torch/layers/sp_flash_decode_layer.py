"""Sequence-parallel GQA flash-decode attention layer (the reference's
layers/sp_flash_decode_layer.py, SpGQAFlashDecodeAttention).

A KV-sequence-sharded attention: ``prefill`` runs ``sp_attention`` over
every rank's shards of q, k and v, ``decode`` runs ``flash_decode`` over
its shard of the dense cache and ``decode_paged`` runs
``paged_flash_decode_dist`` over its own page pool. Every rank calls them
on its own shards. ``decode`` and ``decode_paged`` read no device value
on the host (B19 reads the query position on the device, B20's epochs
advance there), so one decode step can be captured in one CUDA graph and
replayed as the position advances: the reference's "AOT variants for
CUDA-graph capture". The 2-D (``dcn_axis``) layout waits for ROADMAP A9
(tail).
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.kernels.flash_decode import (
    FlashDecodeCombine, FlashDecodeContext, flash_decode,
    flash_decode_per_device, paged_flash_decode_dist,
    paged_flash_decode_dist_per_device,
)
from triton_dist_tpu_torch.kernels.sp_ag_attention import (
    SpAttnContext, SpAttnMethod, sp_attention, sp_attn_per_device,
)


@dataclasses.dataclass
class SpGQAFlashDecodeAttention:
    """KV sequence-sharded attention: ring / all-gather prefill and
    LSE-merge decode."""
    fd_ctx: FlashDecodeContext
    sp_ctx: SpAttnContext

    @classmethod
    def create(cls, mesh, axis: str = "sp",
               combine: FlashDecodeCombine = FlashDecodeCombine.XLA,
               prefill: SpAttnMethod = SpAttnMethod.AUTO,
               local_method: str = "auto",
               dcn_axis: str | None = None,
               layout: str = "contiguous",
               comm_blocks: int = 4,
               kv_splits: int = 1):
        """layout "zigzag" balances causal prefill work; comm_blocks is
        the signaling granularity of both fused kernels (ring blocks per
        KV shard of XLA_BLOCK / PALLAS prefill, row blocks per push of the
        PALLAS decode combine); kv_splits the local split-KV passes per
        decode step. dcn_axis raises: ROADMAP A9 (tail)."""
        return cls(
            FlashDecodeContext(mesh, axis, combine=combine,
                               local_method=local_method, dcn_axis=dcn_axis,
                               comm_blocks=comm_blocks, kv_splits=kv_splits),
            SpAttnContext(mesh, axis, method=prefill, dcn_axis=dcn_axis,
                          layout=layout, comm_blocks=comm_blocks),
        )

    def prefill(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cu_seqlens: torch.Tensor | None = None) -> torch.Tensor:
        """This rank's q/k/v shards (B, T_loc, H*, D); cu_seqlens packs
        variable-length sequences into the global T."""
        return sp_attention(self.sp_ctx, q, k, v, cu_seqlens=cu_seqlens)

    def decode(self, q: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, offset) -> torch.Tensor:
        """q: (B, Hq, D) replicated; this rank's cache shard (B, S_loc,
        Hkv, D); offset the query's position (a 0-d int32 tensor on the
        card, or an int)."""
        return flash_decode(self.fd_ctx, q, k_cache, v_cache, offset)

    def decode_paged(self, q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, block_table: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
        """Paged + sequence-parallel decode over this rank's page pool
        (Hkv, P, page_size, D), its table (B, NP) and its lengths (B,)."""
        return paged_flash_decode_dist(self.fd_ctx, q, k_pages, v_pages,
                                       block_table, lengths)

    # per-device twins: the same on an explicit (mesh, n)
    def prefill_per_device(self, q, k, v):
        ctx = self.sp_ctx
        return sp_attn_per_device(ctx.mesh, ctx.mesh.world, ctx.resolve(),
                                  q, k, v, comm_blocks=ctx.comm_blocks)

    def decode_per_device(self, q, k_shard, v_shard, offset):
        ctx = self.fd_ctx
        return flash_decode_per_device(
            ctx.mesh, ctx.mesh.world, ctx.combine, q, k_shard, v_shard,
            offset, local_method=ctx.local_method,
            comm_blocks=ctx.comm_blocks, kv_splits=ctx.kv_splits)

    def decode_paged_per_device(self, q, k_pages, v_pages, block_table,
                                lengths):
        ctx = self.fd_ctx
        return paged_flash_decode_dist_per_device(
            ctx.mesh, ctx.mesh.world, ctx.combine, q, k_pages, v_pages,
            block_table, lengths, comm_blocks=ctx.comm_blocks)
