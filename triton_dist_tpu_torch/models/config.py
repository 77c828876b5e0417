"""Model configuration: the port's copy of the reference's models/config.py.

The dense Qwen3 family and the Qwen3 MoE family (``Qwen3MoEArch``), whose
experts are tensor-parallel (``moe_parallel="tp"``) or expert-parallel
(``"ep"``).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ModelConfig:
    """Engine-level configuration."""
    model_name: str = "Qwen/Qwen3-32B"
    max_length: int = 4096
    dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class Qwen3Arch:
    """Qwen3 architecture hyperparameters (HF Qwen3Config names)."""
    vocab_size: int = 151936
    hidden_size: int = 4096
    intermediate_size: int = 12288
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    tie_word_embeddings: bool = False

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class Qwen3MoEArch(Qwen3Arch):
    """Qwen3 MoE architecture (HF Qwen3MoeConfig names). intermediate_size
    is unused by the MoE layers; moe_intermediate_size is the per-expert
    width."""
    num_experts: int = 128
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 768
    norm_topk_prob: bool = True
    # "tp": experts sharded on the intermediate width (AG + grouped GEMM,
    # grouped GEMM + top-k reduce + RS); "ep": each device owns
    # E / world experts at full width (dispatch, expert MLP, combine)
    moe_parallel: str = "tp"


def tiny_qwen3(num_layers: int = 2, tp: int = 8) -> Qwen3Arch:
    """A CPU-testable architecture: real structure, toy sizes."""
    return Qwen3Arch(
        vocab_size=256,
        hidden_size=128,
        intermediate_size=256,
        num_layers=num_layers,
        num_heads=2 * tp,
        num_kv_heads=tp,
        head_dim=32,
        rope_theta=10_000.0,
    )


def tiny_qwen3_moe(num_layers: int = 2, tp: int = 8,
                   num_experts: int = 16, topk: int = 2) -> Qwen3MoEArch:
    """A CPU-testable MoE architecture."""
    return Qwen3MoEArch(
        vocab_size=256,
        hidden_size=128,
        intermediate_size=256,
        num_layers=num_layers,
        num_heads=2 * tp,
        num_kv_heads=tp,
        head_dim=32,
        rope_theta=10_000.0,
        num_experts=num_experts,
        num_experts_per_tok=topk,
        moe_intermediate_size=64,
    )


# Published Qwen3 configs (the values of each model's HF config.json)
QWEN3_ARCHS = {
    "Qwen/Qwen3-0.6B": Qwen3Arch(hidden_size=1024, intermediate_size=3072,
                                 num_layers=28, num_heads=16, num_kv_heads=8,
                                 tie_word_embeddings=True),
    "Qwen/Qwen3-8B": Qwen3Arch(hidden_size=4096, intermediate_size=12288,
                               num_layers=36, num_heads=32, num_kv_heads=8),
    "Qwen/Qwen3-32B": Qwen3Arch(hidden_size=5120, intermediate_size=25600,
                                num_layers=64, num_heads=64, num_kv_heads=8),
    "Qwen/Qwen3-30B-A3B": Qwen3MoEArch(
        hidden_size=2048, intermediate_size=6144, num_layers=48,
        num_heads=32, num_kv_heads=4, num_experts=128,
        num_experts_per_tok=8, moe_intermediate_size=768),
    "Qwen/Qwen3-235B-A22B": Qwen3MoEArch(
        hidden_size=4096, intermediate_size=12288, num_layers=94,
        num_heads=64, num_kv_heads=4, num_experts=128,
        num_experts_per_tok=8, moe_intermediate_size=1536),
}
