"""Qwen3 dense model (the reference's models/qwen.py), modes "xla",
"triton_dist_AR" and "triton_dist", on the dense KVCache or the
PagedKVCache (each rank its hkv/n heads of the pool; block table,
lengths, refcounts and free stack the same on every rank).

Tensor parallelism: one process per rank, each holding its shard of the
parameters (``param_specs``: the reference's PartitionSpecs, as tuples) and
its hkv/n heads of the dense cache. In the replicated modes "xla" and
"triton_dist_AR" every rank runs the whole batch and the logits are
gathered along the vocabulary; in mode
"triton_dist" ``inference`` takes this rank's rows of the batch
(batch-sharded ids, the reference's ``P("tp", None)``) and returns their
logits over the whole vocabulary.

Parameters are a plain dict with the reference's layout: layer weights
stay STACKED along a leading num_layers axis and are indexed per layer (as
views, never copies); the reference's decoder ``lax.scan`` is a Python
loop over layers. Both caches are updated in place; the dense cache's
offset never leaves the device. The per-layer ``mlp`` hook is the dense
MLP here; Qwen3MoE (models/qwen_moe.py) overrides it with the MoE layer.
``prefill_slot`` prefills one row of a paged cache (the ContinuousEngine's
admission), whole or in chunks that continue the row's sequence.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.layers.common import (
    MODES, TPContext, check_mode, dot_f32, gather_vocab, make_cos_sin_cache,
    rms_norm,
)
from triton_dist_tpu_torch.layers.tp_attn import attn_fwd, paged_attn_fwd
from triton_dist_tpu_torch.layers.tp_mlp import mlp_fwd
from triton_dist_tpu_torch.models.config import Qwen3Arch, Qwen3MoEArch
from triton_dist_tpu_torch.models.kv_cache import KVCache, PagedKVCache
from triton_dist_tpu_torch.quant.policy import resolve_kv_resident
from triton_dist_tpu_torch.runtime.device import resolve_device


def param_specs(arch: Qwen3Arch) -> dict:
    """The sharding of every parameter over the TP axis "tp", as tuples in
    the place of the reference's PartitionSpecs (``None``: replicated along
    that dimension). models/weights.py slices by it."""
    tp = "tp"
    if isinstance(arch, Qwen3MoEArch) and arch.moe_parallel == "ep":
        # expert-parallel: the experts sharded on E at full width
        mlp = {"w_router": (), "w_gate_up": (None, tp, None, None),
               "w_down": (None, tp, None, None)}
    elif isinstance(arch, Qwen3MoEArch):
        mlp = {"w_router": (), "w_gate_up": (None, None, None, tp),
               "w_down": (None, None, tp, None)}
    else:
        mlp = {"w_gate_up": (None, None, tp), "w_down": (None, tp, None)}
    return {
        "embed": (),
        "lm_head": (None, tp),
        "final_norm": (),
        "layers": {
            "wqkv": (None, None, tp),
            "wo": (None, tp, None),
            "q_norm": (),
            "k_norm": (),
            "in_norm": (),
            "post_norm": (),
            **mlp,
        },
    }


class Qwen3:
    """Model: architecture, TP context and device; parameters live in an
    explicit dict (models/weights.py)."""

    model_type = "dense"

    def __init__(self, arch: Qwen3Arch, ctx: TPContext | None = None,
                 max_length: int = 4096, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda"):
        self.ctx = ctx if ctx is not None else TPContext()
        n = self.ctx.world
        if arch.num_heads % n or arch.num_kv_heads % n:
            raise ValueError(
                f"heads {arch.num_heads}/{arch.num_kv_heads} not divisible "
                f"by tp={n}")
        self.device = resolve_device(device)
        if n > 1 and self.device != self.ctx.mesh.device:
            raise ValueError(f"model on {self.device}, its rank's mesh on "
                             f"{self.ctx.mesh.device}")
        self.arch = arch
        self.max_length = max_length
        self.dtype = dtype
        self.cos_sin = make_cos_sin_cache(arch.head_dim, max_length,
                                          arch.rope_theta, self.device)

    # -- cache ------------------------------------------------------------

    def create_kv_cache(self, batch: int) -> KVCache:
        """Dense max-length cache on the model's device: this rank's
        hkv/n heads of the whole batch."""
        arch = self.arch
        return KVCache.create(arch.num_layers, batch, self.max_length,
                              arch.num_kv_heads // self.ctx.world,
                              arch.head_dim,
                              dtype=self.dtype, device=self.device)

    def create_paged_kv_cache(self, batch: int, page_size: int = 128,
                              num_pages: int | None = None,
                              kv_resident: str | None = None,
                              kv_hbm_budget: int | None = None
                              ) -> PagedKVCache:
        """Paged cache on the model's device. kv_resident: "auto" (ask the
        TD_QUANT policy) | "int8" | "off"/None; kv_hbm_budget sizes
        num_pages from a pool byte budget (PagedKVCache.create). At world
        n the pools hold this rank's hkv/n heads."""
        arch = self.arch
        return PagedKVCache.create(
            arch.num_layers, batch, self.max_length,
            arch.num_kv_heads // self.ctx.world, arch.head_dim, page_size=page_size, num_pages=num_pages,
            dtype=self.dtype, device=self.device,
            resident=resolve_kv_resident(kv_resident),
            hbm_budget_bytes=kv_hbm_budget)

    # -- forward ----------------------------------------------------------

    def mlp(self, mode: str, lw: dict, x: torch.Tensor) -> torch.Tensor:
        """Per-layer MLP hook; Qwen3MoE overrides it with the MoE layer."""
        return mlp_fwd(mode, self.ctx, lw, x)

    def _decoder_stack(self, mode: str, input_ids: torch.Tensor,
                       params: dict, attn_call) -> torch.Tensor:
        """embed -> L x (norm, attn, norm, mlp) -> final norm.
        attn_call(layer, lw, hn) -> attention output of that layer."""
        arch = self.arch
        h = params["embed"][input_ids].to(self.dtype)
        layers = params["layers"]
        for i in range(arch.num_layers):
            lw = {name: w[i] for name, w in layers.items()}
            hn = rms_norm(h, lw["in_norm"], arch.rms_eps)
            h = h + attn_call(i, lw, hn)
            hn = rms_norm(h, lw["post_norm"], arch.rms_eps)
            h = h + self.mlp(mode, lw, hn)
        return rms_norm(h, params["final_norm"], arch.rms_eps)

    def _logits_tail(self, mode: str, h: torch.Tensor, params: dict,
                     last_idx=None) -> torch.Tensor:
        """(B, V) f32 logits of the last position (or of position
        ``last_idx``, an int or 0-d tensor); lm_head is this rank's
        vocabulary columns. triton_dist: gather the batch-sharded last
        rows, take the vocab-sharded product, then all-to-all it into this
        rank's rows over the whole vocabulary; xla and triton_dist_AR:
        gather the product along the vocabulary."""
        check_mode(mode)
        if last_idx is None:
            last = h[:, -1]
        else:
            idx = torch.as_tensor(last_idx, device=h.device).reshape(1)
            last = h.index_select(1, idx.long())[:, 0]
        n = self.ctx.world
        if n == 1 or mode != "triton_dist":
            return gather_vocab(self.ctx, dot_f32(last, params["lm_head"]))
        group = self.ctx.mesh.group
        full = torch.empty((n * last.shape[0], last.shape[1]),
                           dtype=last.dtype, device=last.device)
        dist.all_gather_into_tensor(full, last.contiguous(), group=group)
        logits = dot_f32(full, params["lm_head"])        # (B, V/n)
        recv = torch.empty_like(logits)
        dist.all_to_all_single(recv, logits, group=group)
        # (n, b, V/n) blocks of vocabulary shards -> (b, V)
        return recv.view(n, last.shape[0], -1).transpose(0, 1).reshape(
            last.shape[0], -1)

    def _forward_paged(self, params: dict, cache: PagedKVCache,
                       input_ids: torch.Tensor, mode: str,
                       table: torch.Tensor, lengths: torch.Tensor,
                       active: torch.Tensor | None = None,
                       continuation: bool = False, emit_logits: bool = True,
                       last_idx=None) -> torch.Tensor:
        """The reference's _fwd_per_device_paged: the decoder over the
        pools of ``cache`` with the rows' ``table`` (B, NP) and pre-advance
        ``lengths`` (B,), positions per row. active: (B,) or (B, T) bool,
        False entries write no KV; continuation: T > 1 chunks attend the
        row's earlier pages too; emit_logits=False (a non-final prefill
        chunk) skips the head and returns zeros (B, 1)."""
        t = input_ids.shape[1]
        positions = lengths[:, None] + torch.arange(t, device=self.device)
        resident = cache.k_scales is not None

        def attn_call(i, lw, hn):
            return paged_attn_fwd(
                mode, self.ctx, self.arch, lw, hn, positions, self.cos_sin,
                cache.k_pages[i], cache.v_pages[i], table, lengths,
                cache.page_size, active=active, continuation=continuation,
                lk_scales=cache.k_scales[i] if resident else None,
                lv_scales=cache.v_scales[i] if resident else None)

        h = self._decoder_stack(mode, input_ids, params, attn_call)
        if not emit_logits:
            return torch.zeros((input_ids.shape[0], 1), dtype=torch.float32,
                               device=self.device)
        return self._logits_tail(mode, h, params, last_idx=last_idx)

    def _inference_paged(self, params: dict, cache: PagedKVCache,
                         input_ids: torch.Tensor, mode: str,
                         active: torch.Tensor | None = None):
        t = input_ids.shape[1]
        if active is not None and t != 1:
            raise ValueError("active masking is decode-only (T == 1)")
        if t > 1 and bool((cache.lengths != 0).any()):
            # paged prefill attends only within the chunk: a non-empty
            # cache would be silently ignored, so reject it loudly
            raise ValueError(
                "full-batch paged prefill (T>1) requires an empty "
                "cache; to continue an existing sequence use "
                "prefill_slot(..., continuation=True) (chunked "
                "prefill), clear() the cache, or decode "
                "token-by-token")
        grow = t if active is None else torch.where(active, t, 0).to(
            torch.int32)
        cache.allocate(grow, max_tokens=t)
        # pre-advance lengths: advance() follows every use
        logits = self._forward_paged(params, cache, input_ids, mode,
                                     cache.block_table, cache.lengths,
                                     active=active)
        return logits, cache.advance(grow)

    def prefill_slot(self, params: dict, cache: PagedKVCache, slot,
                     input_ids: torch.Tensor, valid_len=None,
                     mode: str = "xla", continuation: bool = False,
                     emit_logits: bool = True):
        """Prefill ONE row (``slot``, an int) of a multi-row paged cache
        without touching the others: the continuous-batching admission.

        input_ids: (1, T); valid_len: the real length of a bucket-padded
        prompt (pad tails write no KV, and the logits are taken at
        valid_len - 1). continuation=False: the row is empty and
        attention is within the chunk; continuation=True: the chunk
        continues the row's sequence (earlier chunks, or adopted prefix
        pages) and attends its earlier pages too (chunked prefill).
        emit_logits=False (non-final chunks) skips the head and returns
        zeros. Returns (logits (1, V), cache) with only ``slot``'s table
        and length advanced by valid_len."""
        check_mode(mode)
        t = input_ids.shape[1]
        if input_ids.shape[0] != 1:
            raise ValueError("prefill_slot takes a single (1, T) prompt")
        if t > self.max_length:
            raise ValueError(f"chunk {t} exceeds max_length "
                             f"{self.max_length}")
        b = cache.lengths.shape[0]
        dev = self.device
        vl = t if valid_len is None else int(valid_len)
        grow = torch.where(torch.arange(b, device=dev) == slot, vl,
                           0).to(torch.int32)
        cache.allocate(grow, max_tokens=t)
        si = torch.tensor([slot], device=dev)
        table1 = cache.block_table.index_select(0, si)
        lengths1 = cache.lengths.index_select(0, si)
        token_mask = torch.arange(t, device=dev)[None] < vl     # (1, T)
        last = vl - 1 if (valid_len is not None and emit_logits) else None
        logits = self._forward_paged(
            params, cache, input_ids, mode, table1, lengths1,
            active=token_mask, continuation=continuation,
            emit_logits=emit_logits, last_idx=last)
        return logits, cache.advance(grow)

    def _inference_dense(self, params: dict, cache: KVCache,
                         input_ids: torch.Tensor, mode: str):
        t = input_ids.shape[1]
        offset = cache.offset
        positions = offset + torch.arange(t, device=self.device)

        def attn_call(i, lw, hn):
            return attn_fwd(mode, self.ctx, self.arch, lw, hn, positions,
                            self.cos_sin, cache.k[i], cache.v[i], offset)

        h = self._decoder_stack(mode, input_ids, params, attn_call)
        logits = self._logits_tail(mode, h, params)
        return logits, cache.advance(t)

    def inference(self, params: dict, cache, input_ids: torch.Tensor,
                  mode: str = "xla", active: torch.Tensor | None = None):
        """Full forward; returns (logits (B, V) f32 of the LAST position,
        cache). ``cache`` is the dense KVCache or a PagedKVCache, updated
        in place. ``active`` ((B,) bool, paged decode only): False rows
        neither grow nor write KV. In mode "triton_dist" at world n,
        ``input_ids`` and the logits are this rank's B/n rows of the
        batch."""
        if mode not in MODES:
            raise ValueError(f"mode {mode} not in {MODES}")
        if input_ids.shape[1] > self.max_length:
            raise ValueError(
                f"sequence {input_ids.shape[1]} exceeds max_length "
                f"{self.max_length}")
        if isinstance(cache, PagedKVCache):
            return self._inference_paged(params, cache, input_ids, mode,
                                         active=active)
        if active is not None:
            raise ValueError("active masking requires the paged cache")
        return self._inference_dense(params, cache, input_ids, mode)
