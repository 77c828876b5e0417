"""MLP block (the reference's layers/tp_mlp.py), mode "xla" at world 1:
gate/up projection, silu(gate) * up in f32, down projection. The psum is
the identity at world 1."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.layers.common import TPContext, check_mode


def _silu_mul(gate_up: torch.Tensor) -> torch.Tensor:
    gate, up = gate_up.chunk(2, dim=-1)
    return (F.silu(gate.float()) * up.float()).to(gate_up.dtype)


def mlp_fwd(mode: str, ctx: TPContext, w: dict,
            x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, hidden) -> (B, T, hidden)."""
    check_mode(mode)
    h = _silu_mul(torch.matmul(x, w["w_gate_up"]))
    return torch.matmul(h, w["w_down"])
