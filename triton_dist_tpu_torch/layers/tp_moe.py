"""Tensor-parallel MoE layer (the reference's layers/tp_moe.py): top-k
router -> gate/up grouped GEMM -> silu * up -> down grouped GEMM +
weighted top-k reduce, at world n (one process per rank, each holding its
I/n columns of every expert).

Mode "triton_dist" takes this rank's rows of the batch: the routing's ids
and weights are all-gathered over the process group, then AG + grouped
GEMM (``ctx.moe_ag_method``; PALLAS = B14: its token all-gather across
ranks, the identity at world 1) and grouped GEMM + top-k reduce + RS
(``ctx.moe_rs_method``; PALLAS = B15) return this rank's rows; AUTO takes
the kernels on CUDA. Modes "xla" and "triton_dist_AR" run
``dense_grouped_moe`` on the whole batch, then the process group's f32
all-reduce (the reference's psum), then the cast.

Weight layout (the reference's): w_router (d, E) replicated, w_gate_up
(E, d, 2I/n) with this rank's columns [gate_r | up_r] per expert, w_down
(E, I/n, d).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels import moe_utils
from triton_dist_tpu_torch.kernels.allgather_group_gemm import (
    ag_group_gemm_per_device, resolve_ag_group_gemm_method,
)
from triton_dist_tpu_torch.kernels.moe_reduce_rs import (
    moe_reduce_rs_per_device, resolve_moe_reduce_rs_method,
)
from triton_dist_tpu_torch.kernels.plain import dot_f32
from triton_dist_tpu_torch.layers.common import TPContext, check_mode, psum
from triton_dist_tpu_torch.layers.tp_mlp import _silu_mul


def _all_gather_rows(ctx: TPContext, x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of x, in rank order (the identity at world 1)."""
    if ctx.world == 1:
        return x
    out = torch.empty((ctx.world * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=ctx.mesh.group)
    return out


def moe_fwd(mode: str, ctx: TPContext, num_experts: int, topk: int,
            norm_topk_prob: bool, w: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B/n, T, d) in triton_dist (this rank's rows), (B, T, d)
    otherwise -> the same shape."""
    check_mode(mode)
    n = ctx.world
    d_model, t = x.shape[-1], x.shape[1]
    tokens = x.reshape(-1, d_model)                       # (m, d)
    logits = dot_f32(tokens, w["w_router"])               # (m, E) f32
    topk_w, topk_ids = moe_utils.route_topk(
        logits, topk, norm_topk_prob=norm_topk_prob)

    if mode == "triton_dist":
        # the routing is tiny: every rank sees the whole batch's schedule
        ids_full = _all_gather_rows(ctx, topk_ids)        # (n*m, topk)
        w_full = _all_gather_rows(ctx, topk_w)
        cuda = tokens.is_cuda
        ag_method = resolve_ag_group_gemm_method(
            ctx.moe_ag_method, tokens.shape[0], topk, cuda=cuda)
        inter, _ = ag_group_gemm_per_device(
            n, num_experts, ag_method, tokens, ids_full, w["w_gate_up"],
            comm_blocks=ctx.comm_blocks, mesh=ctx.mesh)  # (n*m*topk, 2I/n)
        inter = _silu_mul(inter)
        rs_method = resolve_moe_reduce_rs_method(
            ctx.moe_rs_method, ids_full.shape[0], n, cuda=cuda)
        y = moe_reduce_rs_per_device(
            n, num_experts, topk, rs_method, inter, ids_full, w_full,
            w["w_down"], comm_blocks=ctx.comm_blocks,
            mesh=ctx.mesh)                                # (m, d)
        return y.reshape(-1, t, d_model)

    y = dense_grouped_moe(tokens, topk_ids, topk_w, w["w_gate_up"],
                          w["w_down"], num_experts)
    y = psum(ctx, y)                                      # I is TP-sharded
    return y.to(x.dtype).reshape(x.shape)


def dense_grouped_moe(tokens, topk_ids, topk_w, w_gate_up, w_down,
                      num_experts: int) -> torch.Tensor:
    """Single-device grouped-MoE pipeline: sort -> gate/up grouped product
    -> silu * up -> down grouped product (f32) -> unsort -> top-k reduce.
    Returns (m, d) f32: a partial sum when the weights are this rank's
    shards (the caller all-reduces it), the result at world 1."""
    st = moe_utils.sort_by_expert(topk_ids, num_experts)
    lhs = moe_utils.gather_sorted(tokens, st)
    inter = _silu_mul(moe_utils.grouped_gemm(lhs, w_gate_up,
                                             st.group_sizes))
    out_sorted = moe_utils.grouped_gemm(inter, w_down, st.group_sizes,
                                        out_dtype=torch.float32)
    return moe_utils.reduce_topk(moe_utils.unsort(out_sorted, st), topk_w)
