"""Parameters: random init on the device, and the numpy bridge from the
reference (the reference's models/weights.py).

The dict layout is the reference's parameter pytree at TP=1, where its
rank-contiguous ``_shard_concat`` is a plain concat, so the layouts match
one to one: x @ W everywhere, wqkv columns [q | k | v], w_gate_up columns
[gate | up], layer weights stacked on a leading num_layers axis. For the
MoE family the MLP weights are w_router (L, d, E), w_gate_up (L, E, d, 2I)
with the columns [gate | up] per expert, and w_down (L, E, I, d).
Reading HF checkpoints (load_hf_qwen3) waits until checkpoint files can
be read on the card (ROADMAP A2).
"""

from __future__ import annotations

import numpy as np
import torch

from triton_dist_tpu_torch.models.config import Qwen3Arch, Qwen3MoEArch
from triton_dist_tpu_torch.runtime.device import resolve_device

_RANDN_CHUNK = 1 << 24     # f32 elements drawn at a time


def param_shapes(arch: Qwen3Arch) -> dict:
    """The parameter dict's shapes (nested like the parameters)."""
    L, d, inter = arch.num_layers, arch.hidden_size, arch.intermediate_size
    if isinstance(arch, Qwen3MoEArch):
        e, im = arch.num_experts, arch.moe_intermediate_size
        mlp = {"w_router": (L, d, e), "w_gate_up": (L, e, d, 2 * im),
               "w_down": (L, e, im, d)}
    else:
        mlp = {"w_gate_up": (L, d, 2 * inter), "w_down": (L, inter, d)}
    return {
        "embed": (arch.vocab_size, d),
        "lm_head": (d, arch.vocab_size),
        "final_norm": (d,),
        "layers": {
            "wqkv": (L, d, arch.q_size + 2 * arch.kv_size),
            "wo": (L, arch.q_size, d),
            "q_norm": (L, arch.head_dim),
            "k_norm": (L, arch.head_dim),
            "in_norm": (L, d),
            "post_norm": (L, d),
            **mlp,
        },
    }


_NORMS = ("final_norm", "q_norm", "k_norm", "in_norm", "post_norm")


def init_random_params(generator: torch.Generator, arch: Qwen3Arch,
                       device: torch.device | str = "cuda",
                       dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random parameters (tests, benchmarks): matrices ~ N(0, 1/hidden),
    norms 1. Each weight is materialized directly in ``dtype`` on the
    device, drawn in chunks of 16M f32 values, so no f32 copy of the
    model ever exists. ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    scale = arch.hidden_size ** -0.5

    def rnd(shape):
        out = torch.empty(shape, dtype=dtype, device=dev)
        flat = out.view(-1)
        for s in range(0, flat.numel(), _RANDN_CHUNK):
            n = min(_RANDN_CHUNK, flat.numel() - s)
            draw = torch.randn(n, generator=generator, device=dev,
                               dtype=torch.float32)
            flat[s:s + n] = (draw * scale).to(dtype)
        return out

    def make(name, shape):
        if name in _NORMS:
            return torch.ones(shape, dtype=dtype, device=dev)
        return rnd(shape)

    shapes = param_shapes(arch)
    params = {k: make(k, s) for k, s in shapes.items() if k != "layers"}
    params["layers"] = {k: make(k, s) for k, s in shapes["layers"].items()}
    return params


def _to_tensor(a, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 has torch.bfloat16's bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(raw: dict, arch: Qwen3Arch,
                      device: torch.device | str = "cuda",
                      dtype: torch.dtype = torch.bfloat16) -> dict:
    """The reference's parameter pytree exported as numpy arrays (Qwen3
    dense or MoE, TP=1) -> the port's parameter dict on ``device`` in ``dtype``.
    Shapes are checked against ``arch``."""
    dev = resolve_device(device)
    shapes = param_shapes(arch)

    def conv(name, a, shape):
        if tuple(np.shape(a)) != tuple(shape):
            raise ValueError(f"param {name}: shape {np.shape(a)}, want "
                             f"{shape}")
        return _to_tensor(a, dev, dtype)

    missing = set(shapes) - set(raw)
    missing |= {f"layers/{k}" for k in shapes["layers"]
                if k not in raw.get("layers", {})}
    if missing:
        raise ValueError(f"params missing {sorted(missing)}")
    params = {k: conv(k, raw[k], s) for k, s in shapes.items()
              if k != "layers"}
    params["layers"] = {k: conv(f"layers/{k}", raw["layers"][k], s)
                        for k, s in shapes["layers"].items()}
    return params
