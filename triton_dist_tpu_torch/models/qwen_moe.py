"""Qwen3 MoE model (the reference's models/qwen_moe.py), at world 1 or
tensor-parallel over n ranks.

The decoder of models/qwen.py with the dense MLP replaced, through the
``mlp`` hook, by the tensor-parallel MoE layer (layers/tp_moe.py): top-k
router -> gate/up grouped GEMM -> silu * up -> down grouped GEMM + top-k
reduce, the experts sharded on their intermediate width. The
expert-parallel layout (``moe_parallel="ep"``) waits for ROADMAP A10's
EP half.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.layers.common import TPContext
from triton_dist_tpu_torch.layers.tp_moe import moe_fwd
from triton_dist_tpu_torch.models.config import Qwen3MoEArch
from triton_dist_tpu_torch.models.qwen import Qwen3


class Qwen3MoE(Qwen3):

    model_type = "moe"

    def __init__(self, arch: Qwen3MoEArch, ctx: TPContext | None = None,
                 max_length: int = 4096, dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda"):
        if arch.moe_parallel == "ep":
            raise NotImplementedError(
                "the expert-parallel MoE layout (moe_parallel='ep') waits "
                "for ROADMAP A10 (EP half)")
        world = ctx.world if ctx is not None else 1
        if arch.moe_intermediate_size % world:
            raise ValueError(
                f"moe_intermediate_size {arch.moe_intermediate_size} not "
                f"divisible by tp={world}")
        super().__init__(arch, ctx, max_length=max_length, dtype=dtype,
                         device=device)

    def mlp(self, mode: str, lw: dict, x: torch.Tensor) -> torch.Tensor:
        arch = self.arch
        return moe_fwd(mode, self.ctx, arch.num_experts,
                       arch.num_experts_per_tok, arch.norm_topk_prob, lw, x)
