"""Tensor-parallel MoE layer (the reference's layers/tp_moe.py) at world 1:
top-k router -> gate/up grouped GEMM -> silu * up -> down grouped GEMM +
weighted top-k reduce.

Mode "triton_dist" runs the fused ops: AG + grouped GEMM
(``ctx.moe_ag_method``; PALLAS = B14) and grouped GEMM + top-k reduce +
RS (``ctx.moe_rs_method``; PALLAS = B15); their gathers and the
reduce-scatter are the identity at world 1, and AUTO takes the kernels on
CUDA. Mode "xla" runs ``dense_grouped_moe``, the plain pipeline.

Weight layout (the reference's at TP=1): w_router (d, E), w_gate_up
(E, d, 2I) with the columns [gate | up] per expert, w_down (E, I, d).
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels import moe_utils
from triton_dist_tpu_torch.kernels.allgather_group_gemm import (
    ag_group_gemm_per_device, resolve_ag_group_gemm_method,
)
from triton_dist_tpu_torch.kernels.moe_reduce_rs import (
    moe_reduce_rs_per_device, resolve_moe_reduce_rs_method,
)
from triton_dist_tpu_torch.kernels.plain import dot_f32
from triton_dist_tpu_torch.layers.common import TPContext, check_mode
from triton_dist_tpu_torch.layers.tp_mlp import _silu_mul


def moe_fwd(mode: str, ctx: TPContext, num_experts: int, topk: int,
            norm_topk_prob: bool, w: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, T, d) -> (B, T, d)."""
    check_mode(mode)
    n = ctx.world
    d_model, t = x.shape[-1], x.shape[1]
    tokens = x.reshape(-1, d_model)                       # (m, d)
    logits = dot_f32(tokens, w["w_router"])               # (m, E) f32
    topk_w, topk_ids = moe_utils.route_topk(
        logits, topk, norm_topk_prob=norm_topk_prob)

    if mode == "triton_dist":
        # the routing's all-gather is the identity at world 1
        cuda = tokens.is_cuda
        ag_method = resolve_ag_group_gemm_method(
            ctx.moe_ag_method, tokens.shape[0], topk, cuda=cuda)
        inter, _ = ag_group_gemm_per_device(
            n, num_experts, ag_method, tokens, topk_ids, w["w_gate_up"],
            comm_blocks=ctx.comm_blocks)                  # (m*topk, 2I)
        inter = _silu_mul(inter)
        rs_method = resolve_moe_reduce_rs_method(
            ctx.moe_rs_method, topk_ids.shape[0], n, cuda=cuda)
        y = moe_reduce_rs_per_device(
            n, num_experts, topk, rs_method, inter, topk_ids, topk_w,
            w["w_down"], comm_blocks=ctx.comm_blocks)     # (m, d)
        return y.reshape(-1, t, d_model)

    y = dense_grouped_moe(tokens, topk_ids, topk_w, w["w_gate_up"],
                          w["w_down"], num_experts)
    return y.to(x.dtype).reshape(x.shape)


def dense_grouped_moe(tokens, topk_ids, topk_w, w_gate_up, w_down,
                      num_experts: int) -> torch.Tensor:
    """Single-device grouped-MoE pipeline: sort -> gate/up grouped product
    -> silu * up -> down grouped product (f32) -> unsort -> top-k reduce.
    Returns (m, d) f32 (the full result at world 1)."""
    st = moe_utils.sort_by_expert(topk_ids, num_experts)
    lhs = moe_utils.gather_sorted(tokens, st)
    inter = _silu_mul(moe_utils.grouped_gemm(lhs, w_gate_up,
                                             st.group_sizes))
    out_sorted = moe_utils.grouped_gemm(inter, w_down, st.group_sizes,
                                        out_dtype=torch.float32)
    return moe_utils.reduce_topk(moe_utils.unsort(out_sorted, st), topk_w)
