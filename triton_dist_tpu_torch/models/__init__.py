"""Models and the inference engine (the reference's models/).

``AutoLLM`` maps a model name to its architecture and builds the model and
random parameters on the device."""

import torch

from triton_dist_tpu_torch.models.config import (  # noqa: F401
    ModelConfig,
    Qwen3Arch,
    Qwen3MoEArch,
    QWEN3_ARCHS,
    tiny_qwen3,
    tiny_qwen3_moe,
)
from triton_dist_tpu_torch.models.kv_cache import (  # noqa: F401
    KVCache,
    PagedKVCache,
    paged_write_layer,
)
from triton_dist_tpu_torch.models.qwen import Qwen3  # noqa: F401
from triton_dist_tpu_torch.models.qwen_moe import Qwen3MoE  # noqa: F401
from triton_dist_tpu_torch.models.weights import (  # noqa: F401
    init_random_params,
    params_from_numpy,
)
from triton_dist_tpu_torch.models.engine import Engine  # noqa: F401
from triton_dist_tpu_torch.models.continuous import (  # noqa: F401
    ContinuousEngine,
    Request,
)
from triton_dist_tpu_torch.models.utils import (  # noqa: F401
    logger,
    sample_token,
    sample_token_rows,
)
from triton_dist_tpu_torch.runtime.device import resolve_device


class AutoLLM:
    """Name -> (model, params) factory: Qwen3 for the dense archs, Qwen3MoE
    for the MoE ones."""

    @staticmethod
    def from_pretrained(config: "ModelConfig | str", ctx=None,
                        checkpoint_dir: str | None = None, *,
                        device: "torch.device | str" = "cuda",
                        generator: torch.Generator | None = None):
        """Build (model, params) from a ModelConfig (or bare model name)
        with random weights drawn from ``generator`` (default: seed 0 on
        the device). Raises without a card unless device="cpu". With a
        ``ctx`` over a mesh of n ranks, the model and this rank's shard of
        the parameters live on the rank's device (the mesh's), and the
        shards are those of the world-1 weights from the same seed.
        checkpoint_dir raises until HF checkpoints can be read on the card
        (load_hf_qwen3, ROADMAP A2)."""
        if isinstance(config, str):
            config = ModelConfig(model_name=config)
        if config.model_name not in QWEN3_ARCHS:
            raise ValueError(
                f"unknown model {config.model_name}; known: "
                f"{list(QWEN3_ARCHS)}")
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpoint loading (load_hf_qwen3) waits for ROADMAP A2; "
                "pass checkpoint_dir=None for random weights")
        mesh = ctx.mesh if ctx is not None else None
        dev = mesh.device if mesh is not None else resolve_device(device)
        arch = QWEN3_ARCHS[config.model_name]
        cls = Qwen3MoE if isinstance(arch, Qwen3MoEArch) else Qwen3
        model = cls(arch, ctx, max_length=config.max_length,
                    dtype=config.dtype, device=dev)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        params = init_random_params(
            generator, arch, dev, config.dtype,
            rank=mesh.rank if mesh is not None else 0,
            world=mesh.world if mesh is not None else 1)
        return model, params
