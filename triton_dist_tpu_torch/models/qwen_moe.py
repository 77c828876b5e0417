"""Qwen3 MoE model (the reference's models/qwen_moe.py), at world 1 or
over n ranks.

The decoder of models/qwen.py with the dense MLP replaced, through the
``mlp`` hook, by the MoE layer. ``moe_parallel="tp"``: the
tensor-parallel layer (layers/tp_moe.py): top-k router -> gate/up grouped
GEMM -> silu * up -> down grouped GEMM + top-k reduce, the experts
sharded on their intermediate width. ``moe_parallel="ep"``: the
expert-parallel layer (layers/ep_a2a_layer.py), each rank E / n experts
at full width, the tokens dispatched to them and combined back.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.layers.common import TPContext
from triton_dist_tpu_torch.layers.ep_a2a_layer import ep_moe_layer_fwd
from triton_dist_tpu_torch.layers.tp_moe import moe_fwd
from triton_dist_tpu_torch.models.config import Qwen3MoEArch
from triton_dist_tpu_torch.models.qwen import Qwen3


class Qwen3MoE(Qwen3):

    model_type = "moe"

    def __init__(self, arch: Qwen3MoEArch, ctx: TPContext | None = None,
                 max_length: int = 4096, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda"):
        world = ctx.world if ctx is not None else 1
        if arch.moe_parallel not in ("tp", "ep"):
            raise ValueError(f"moe_parallel {arch.moe_parallel!r}: want "
                             "'tp' or 'ep'")
        if arch.moe_parallel == "ep":
            if arch.num_experts % world:
                raise ValueError(
                    f"num_experts {arch.num_experts} not divisible by "
                    f"ep world {world}")
        elif arch.moe_intermediate_size % world:
            raise ValueError(
                f"moe_intermediate_size {arch.moe_intermediate_size} not "
                f"divisible by tp={world}")
        super().__init__(arch, ctx, max_length=max_length, dtype=dtype,
                         device=device)

    def mlp(self, mode: str, lw: dict, x: torch.Tensor) -> torch.Tensor:
        arch = self.arch
        if arch.moe_parallel == "ep":
            return ep_moe_layer_fwd(
                mode, self.ctx, arch.num_experts, arch.num_experts_per_tok,
                arch.norm_topk_prob, lw, x)
        return moe_fwd(mode, self.ctx, arch.num_experts,
                       arch.num_experts_per_tok, arch.norm_topk_prob, lw, x)
