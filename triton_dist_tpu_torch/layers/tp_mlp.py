"""MLP block (the reference's layers/tp_mlp.py) at world n: gate/up
projection (each rank its columns [gate_r | up_r]), silu(gate) * up in f32,
down projection (its rows). Mode "xla": local matmuls on the whole batch,
the down projection all-reduced (the reference's psum); mode
"triton_dist_AR": as xla, the sum through ``ctx.ar_method`` (ONE_SHOT =
B5, RHD = B6, QINT8_OS = B28) or, with ``ctx.gemm_ar_method`` set, the down product and
sum as one fused GEMM + all-reduce (PALLAS = B4); mode "triton_dist":
this rank's rows through AG + GEMM and GEMM + RS (``ctx.ag_method`` /
``ctx.rs_method``; PALLAS runs B10 / B13a at n > 1, B12 at world 1)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from triton_dist_tpu_torch.kernels.allgather_gemm import ag_gemm_per_device
from triton_dist_tpu_torch.kernels.allreduce import all_reduce_per_device
from triton_dist_tpu_torch.kernels.gemm_allreduce import gemm_ar_per_device
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (
    gemm_rs_per_device,
)
from triton_dist_tpu_torch.layers.common import TPContext, check_mode, psum


def _silu_mul(gate_up: torch.Tensor) -> torch.Tensor:
    gate, up = gate_up.chunk(2, dim=-1)
    return (F.silu(gate.float()) * up.float()).to(gate_up.dtype)


def mlp_fwd(mode: str, ctx: TPContext, w: dict,
            x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, hidden) -> (B, T, hidden)."""
    check_mode(mode)
    if mode == "triton_dist":
        d_model, t = x.shape[-1], x.shape[1]
        h2d, _ = ag_gemm_per_device(ctx.world, ctx.ag_method,
                                    x.reshape(-1, d_model), w["w_gate_up"],
                                    mesh=ctx.mesh)
        y2d = gemm_rs_per_device(ctx.world, ctx.rs_method, _silu_mul(h2d),
                                 w["w_down"], mesh=ctx.mesh)
        return y2d.reshape(-1, t, d_model)
    h = _silu_mul(torch.matmul(x, w["w_gate_up"]))
    if mode == "xla":
        return psum(ctx, torch.matmul(h, w["w_down"]))
    b, t = x.shape[0], x.shape[1]
    h2d = h.reshape(b * t, -1)
    if ctx.gemm_ar_method is not None:
        y2d = gemm_ar_per_device(ctx.world, ctx.gemm_ar_method, h2d,
                                 w["w_down"], mesh=ctx.mesh)
    else:
        y2d = all_reduce_per_device(ctx.world, ctx.ar_method,
                                    torch.matmul(h2d, w["w_down"]),
                                    mesh=ctx.mesh)
    return y2d.reshape(b, t, -1)
