"""Mega decode runtime: one decode step as the compiled task graph, per
method tier (the reference's mega/runtime.py).

  * ``MegaMethod.XLA`` — every task runs its plain PyTorch function: the
    ops of the layer-by-layer path, bit-identical to ``Qwen3.inference``.
  * ``MegaMethod.PALLAS_CHAIN`` — the o/down projections run B4 (the
    GEMM+AR kernel: its world-1 body, or at world n its push of f32
    partials to the peers) and the attention→MLP boundary runs B3 (the
    fused add+RMSNorm kernel); attention runs B1 in both tiers.

At world n (``model.ctx.world``, one runtime per rank) the graph is one
rank's step over its shard of the weights and cache, on the model's mesh:
the xla tier sums the o/down products with the process group's
all-reduce, both tiers gather the logits along the vocabulary. For an
expert-parallel MoE model the pallas_chain tier's moe task dispatches
its rows over ``ep_a2a_method`` (None: the process group's all-to-all;
PALLAS: B17; PALLAS_FUSED: B16 + B17).

AUTO resolves to PALLAS_CHAIN on CUDA and to XLA on the CPU, the same
platform choice the reference makes. ``dense_step_fn(tier)`` returns the
step ``(params, KVCache, input_ids) -> (logits, KVCache)`` and
``step_fn(tier)`` the paged one ``(params, PagedKVCache, input_ids,
active) -> (logits, PagedKVCache)`` (the ContinuousEngine's): Qwen3-family
models in xla mode run the per-layer paged graph, every other model and
mode (triton_dist_AR) its ``inference`` directly (the reference records
it as a one-task graph, which adds nothing to one call). Neither reads a
device value on the host, so the engines capture calls of them as CUDA graphs and replay them
(models/engine.py, models/continuous.py).

``dispatch`` counts a launch and runs it. Unlike the reference it has no
fallback from the fused tier to the XLA tier: on the card a tier that
fails raises. The fault guard and observability of the reference's
dispatch preamble wait for ROADMAP A8.
"""

from __future__ import annotations

import enum
import functools

import torch

from triton_dist_tpu_torch.mega.builder import ModelBuilder

POLICY = "comm_aware"   # the schedule policy of the compiled step


class MegaMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"                    # the plain-op tier
    PALLAS_CHAIN = "pallas_chain"  # the fused-kernel tier


def resolve_mega_method(method, device: torch.device | str) -> MegaMethod:
    """AUTO -> PALLAS_CHAIN on a CUDA device, XLA elsewhere."""
    if isinstance(method, str):
        method = MegaMethod(method)
    if method != MegaMethod.AUTO:
        return method
    return (MegaMethod.PALLAS_CHAIN if torch.device(device).type == "cuda"
            else MegaMethod.XLA)


class MegaDecodeRuntime:
    """One model's mega decode step, tiered by MegaMethod."""

    def __init__(self, model, mode: str = "xla",
                 method: MegaMethod | str = MegaMethod.AUTO,
                 gemm_ar_method=None, ep_a2a_method=None):
        self.model = model
        self.mode = mode
        self.method = resolve_mega_method(method, model.device)
        if gemm_ar_method is None:
            # the TD_QUANT policy may put the o/down projections on the
            # int8 wire (XLA_QINT8: the f32 product, then the int8 ring
            # with B27 at every hop); OFF keeps AUTO
            from triton_dist_tpu_torch.quant.policy import (
                serving_gemm_ar_method,
            )
            gemm_ar_method = serving_gemm_ar_method(model.ctx.world)
        self.gemm_ar_method = gemm_ar_method
        # the expert-parallel moe task's transport in the pallas_chain
        # tier (None: the process group's all-to-all), as in the reference
        self.ep_a2a_method = ep_a2a_method
        self.launches = 0
        self._dense: ModelBuilder | None = None
        self._paged: dict[tuple[int, bool], ModelBuilder] = {}
        self._compiled: dict[tuple, object] = {}
        # Qwen3-family models (dense and MoE) in xla mode get the
        # per-layer task graph
        self.kind = "generic"
        if (mode == "xla" and getattr(model, "model_type", None)
                in ("dense", "moe") and hasattr(model, "ctx")):
            self.kind = "qwen3"

    def dense_builder(self) -> ModelBuilder:
        if self._dense is None:
            from triton_dist_tpu_torch.mega.models.qwen3 import (
                build_qwen3_decode,
            )
            model = self.model
            self._dense = build_qwen3_decode(
                model.arch, model.ctx.world, dtype=model.dtype,
                mesh=model.ctx.mesh, gemm_ar_method=self.gemm_ar_method,
                **self._ep_kw())
        return self._dense

    def paged_builder(self, page_size: int,
                      resident: bool = False) -> ModelBuilder:
        b = self._paged.get((page_size, resident))
        if b is None:
            from triton_dist_tpu_torch.mega.models.qwen3 import (
                build_qwen3_paged_decode,
            )
            model = self.model
            b = build_qwen3_paged_decode(
                model.arch, model.ctx.world, page_size, dtype=model.dtype,
                mesh=model.ctx.mesh, gemm_ar_method=self.gemm_ar_method,
                resident=resident, **self._ep_kw())
            self._paged[(page_size, resident)] = b
        return b

    def _ep_kw(self) -> dict:
        ctx = self.model.ctx
        return {"ep_a2a_method": self.ep_a2a_method,
                "ep_max_m": ctx.ep_max_m, "comm_blocks": ctx.comm_blocks}

    def graph_tasks(self) -> int:
        for b in (*self._paged.values(), self._dense):
            if b is not None:
                return len(b.graph.tasks)
        return 0

    def step_fn(self, tier: str):
        """(params, PagedKVCache, input_ids (B, 1), active (B,) bool) ->
        (logits (B, V) f32, PagedKVCache): one paged decode step on
        ``tier``; False rows neither grow nor write KV. Outside the
        Qwen3 xla graph the step is the model's ``inference`` itself."""
        if self.kind == "qwen3":
            return functools.partial(self._qwen3_paged_step, tier)
        return self._inference_step

    def dense_step_fn(self, tier: str):
        """(params, KVCache, input_ids (B, T)) -> (logits (B, V) f32,
        KVCache): the task graph on ``tier``; the cache slabs are written
        in place and the offset advanced on the device."""
        if self.kind != "qwen3":
            raise ValueError(
                "dense mega program needs a Qwen3-family model in xla "
                f"mode (got kind={self.kind!r})")
        return functools.partial(self._qwen3_dense_step, tier)

    def _step(self, tier: str, builder: ModelBuilder | None = None,
              policy: str = POLICY):
        builder = builder or self.dense_builder()
        key = (id(builder), tier)
        step = self._compiled.get(key)
        if step is None:
            step = builder.compile(policy=policy, tier=tier)
            self._compiled[key] = step
        return step

    def _qwen3_dense_step(self, tier, params, cache, input_ids):
        model = self.model
        t = input_ids.shape[1]
        builder = self.dense_builder()
        env = {
            "input_ids": input_ids,
            "positions": cache.offset + torch.arange(t, device=model.device),
            "offset": cache.offset,
            "cos_sin": model.cos_sin, "embed": params["embed"],
            "lm_head": params["lm_head"],
            "final_norm": params["final_norm"],
        }
        for key, stacked in params["layers"].items():
            for i in range(model.arch.num_layers):
                env[f"{key}_{i}"] = stacked[i]          # views, no copies
        for i in range(model.arch.num_layers):
            env[f"k_cache_{i}"] = cache.k[i]
            env[f"v_cache_{i}"] = cache.v[i]
        out = self._step(tier)(env)
        return out[builder.logits_name], cache.advance(t)

    def _inference_step(self, params, cache, input_ids, active):
        return self.model.inference(params, cache, input_ids,
                                    mode=self.mode, active=active)

    def _qwen3_paged_step(self, tier, params, cache, input_ids, active):
        """The task-graph twin of Qwen3._inference_paged at T == 1:
        allocate, the compiled graph, advance, op for op the layer path's,
        so the xla tier equals it bit for bit."""
        model = self.model
        t = input_ids.shape[1]
        if t != 1:
            raise ValueError("the mega paged program is decode-only "
                             f"(T == 1); got T={t}")
        if active is None:
            active = torch.ones((cache.lengths.shape[0],), dtype=torch.bool,
                                device=model.device)
        grow = torch.where(active, t, 0).to(torch.int32)
        cache.allocate(grow, max_tokens=t)
        resident = cache.k_scales is not None
        builder = self.paged_builder(cache.page_size, resident)
        env = {
            "input_ids": input_ids, "block_table": cache.block_table,
            "lengths": cache.lengths, "active": active,
            "cos_sin": model.cos_sin, "embed": params["embed"],
            "lm_head": params["lm_head"],
            "final_norm": params["final_norm"],
        }
        for key, stacked in params["layers"].items():
            for i in range(model.arch.num_layers):
                env[f"{key}_{i}"] = stacked[i]          # views, no copies
        for i in range(model.arch.num_layers):
            env[f"k_pages_{i}"] = cache.k_pages[i]
            env[f"v_pages_{i}"] = cache.v_pages[i]
            if resident:
                env[f"k_scales_{i}"] = cache.k_scales[i]
                env[f"v_scales_{i}"] = cache.v_scales[i]
        out = self._step(tier, builder)(env)
        return out[builder.logits_name], cache.advance(grow)

    def dispatch(self, primary):
        """Run one launch of the compiled step and count it. No fallback
        tier: a failure raises."""
        self.launches += 1
        return primary()
