"""Parameters: random init on the device, and the numpy bridge from the
reference (the reference's models/weights.py).

The dict layout is the reference's parameter pytree: x @ W everywhere,
layer weights stacked on a leading num_layers axis. At world 1 wqkv's
columns are [q | k | v] and w_gate_up's [gate | up]. For the MoE family
the MLP weights are w_router (L, d, E), w_gate_up (L, E, d, 2I) with the
columns [gate | up] per expert, and w_down (L, E, I, d); expert-parallel
(``moe_parallel="ep"``) they are cut on E, rank r holding experts
[r E / n, (r + 1) E / n) at full width, the world-1 weights' own.

Tensor parallelism: each rank holds its shard of every parameter, cut by
``models/qwen.py::param_specs`` into contiguous equal blocks along the
sharded dimension, exactly as the reference's NamedSharding cuts its
global arrays. The reference lays wqkv and w_gate_up out rank by rank
(its ``_shard_concat``: [q_0|k_0|v_0 | q_1|k_1|v_1 | ...]), so rank r's
block is [q_r | k_r | v_r]. ``params_from_numpy`` takes the reference's
global pytree in that layout; ``init_random_params`` draws the world-1
parameters from the seed and hands rank r the same [q_r | k_r | v_r]
cut, so TP=n and world 1 compute one model from one seed.
Reading HF checkpoints (load_hf_qwen3) waits until checkpoint files can
be read on the card (ROADMAP A2).
"""

from __future__ import annotations

import numpy as np
import torch

from triton_dist_tpu_torch.models.config import Qwen3Arch, Qwen3MoEArch
from triton_dist_tpu_torch.models.qwen import param_specs
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


def _shard(a, spec: tuple, rank: int, world: int):
    """Rank ``rank``'s contiguous block of ``a`` along the dimension that
    ``spec`` shards over "tp" (all of ``a`` when replicated or at world
    1): what the reference's NamedSharding gives that rank. A view."""
    if world == 1 or "tp" not in spec:
        return a
    d = spec.index("tp")
    size = a.shape[d] // world
    if size * world != a.shape[d]:
        raise ValueError(f"dim {d} of {tuple(a.shape)} not divisible by "
                         f"tp={world}")
    return a[(slice(None),) * d + (slice(rank * size, (rank + 1) * size),)]


def put_params(raw: dict, arch: Qwen3Arch, rank: int = 0,
               world: int = 1) -> dict:
    """Rank ``rank``'s shards (views) of a host pytree (numpy arrays or
    tensors) of global parameters, cut per ``param_specs``."""
    specs = param_specs(arch)
    out = {k: _shard(raw[k], specs[k], rank, world)
           for k in specs if k != "layers"}
    out["layers"] = {k: _shard(raw["layers"][k], spec, rank, world)
                     for k, spec in specs["layers"].items()}
    return out


def _split_cols(name: str, arch: Qwen3Arch):
    """The column groups of a fused weight at world 1 ([q | k | v],
    [gate | up]); None for the others."""
    if name == "wqkv":
        return [arch.q_size, arch.kv_size, arch.kv_size]
    if name == "w_gate_up":
        i = (arch.moe_intermediate_size if isinstance(arch, Qwen3MoEArch)
             else arch.intermediate_size)
        return [i, i]
    return None


def init_random_params(generator: torch.Generator, arch: Qwen3Arch,
                       device: torch.device | str = "cuda",
                       dtype: torch.dtype = torch.bfloat16, *,
                       rank: int = 0, world: int = 1) -> dict:
    """Random parameters (tests, benchmarks): matrices ~ N(0, 1/hidden),
    norms 1. Each weight is materialized directly in ``dtype`` on the
    device, drawn in chunks of 16M f32 values, so no f32 copy of the
    model ever exists. ``generator`` must live on ``device``.

    At world n every rank draws each global weight as world 1 does (one
    at a time, from the same seed) and keeps only its shard: rank r of
    wqkv gets [q_r | k_r | v_r] and of w_gate_up [gate_r | up_r] (the
    reference's TP layout), the rest its contiguous block per
    ``param_specs``. No rank ever holds the whole model: at most its
    shards plus one global weight."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    scale = arch.hidden_size ** -0.5
    specs = param_specs(arch)

    def rnd(shape):
        out = torch.empty(shape, dtype=dtype, device=dev)
        flat = out.view(-1)
        for s in range(0, flat.numel(), _RANDN_CHUNK):
            n = min(_RANDN_CHUNK, flat.numel() - s)
            draw = torch.randn(n, generator=generator, device=dev,
                               dtype=torch.float32)
            flat[s:s + n] = (draw * scale).to(dtype)
        return out

    def make(name, shape, spec):
        if name in _NORMS:
            return torch.ones(shape, dtype=dtype, device=dev)
        full = rnd(shape)
        if world == 1 or "tp" not in spec:
            return full
        # a fused weight cut along its columns goes group by group
        groups = _split_cols(name, arch) if spec[-1] == "tp" else None
        if groups is None:
            return _shard(full, spec, rank, world).clone()
        return torch.cat([_shard(g, spec, rank, world)
                          for g in torch.split(full, groups, dim=-1)],
                         dim=-1)

    shapes = param_shapes(arch)
    params = {k: make(k, s, specs[k]) for k, s in shapes.items()
              if k != "layers"}
    params["layers"] = {k: make(k, s, specs["layers"][k])
                        for k, s in shapes["layers"].items()}
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
                      dtype: torch.dtype = torch.bfloat16, *,
                      rank: int = 0, world: int = 1) -> dict:
    """The reference's global parameter pytree exported as numpy arrays
    (Qwen3 dense or MoE; at TP=n in its rank-by-rank layout) -> rank
    ``rank``'s parameter dict on ``device`` in ``dtype``: its shard of
    every weight, cut as the reference's NamedSharding cuts it
    (``put_params``). Global shapes are checked against ``arch``."""
    dev = resolve_device(device)
    shapes = param_shapes(arch)

    def check(name, a, shape):
        if tuple(np.shape(a)) != tuple(shape):
            raise ValueError(f"param {name}: shape {np.shape(a)}, want "
                             f"{shape}")

    missing = set(shapes) - set(raw)
    missing |= {f"layers/{k}" for k in shapes["layers"]
                if k not in raw.get("layers", {})}
    if missing:
        raise ValueError(f"params missing {sorted(missing)}")
    for k, s in shapes.items():
        if k != "layers":
            check(k, raw[k], s)
    for k, s in shapes["layers"].items():
        check(f"layers/{k}", raw["layers"][k], s)
    local = put_params(raw, arch, rank, world)
    params = {k: _to_tensor(v, dev, dtype) for k, v in local.items()
              if k != "layers"}
    params["layers"] = {k: _to_tensor(v, dev, dtype)
                        for k, v in local["layers"].items()}
    return params
