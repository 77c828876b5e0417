"""Expert-parallel MoE layer (the reference's layers/ep_a2a_layer.py):
dispatch -> expert MLP -> combine.

Each rank owns E / n experts at full width: w_gate_up (E_loc, d, 2I) with
the columns [gate | up], w_down (E_loc, I, d); the router (d, E) is
replicated. Dispatch moves tokens to the experts instead of gathering
weights.

Mode "triton_dist" takes this rank's rows of the batch: the router's
top-k, the dispatch over ``TPContext.ep_a2a_method`` (kernels/ep_a2a.py:
XLA the process group's all-to-all, PALLAS B17 or B18, PALLAS_FUSED B16
with the gate/up product fused in) with ``ep_max_m`` slots a (src, dst)
pair, the expert MLP over the n * max_m received slots
(``slot_products``), the combine back to this rank's rows. The replicated
modes ("xla", "triton_dist_AR") all-gather the expert slabs over the
process group at every call and run ``dense_grouped_moe`` on the whole
batch: the reference's baseline, which re-sends the whole expert stack
every step.

Capacity: a (src, dst) pair with more than max_m choices drops the rest
and counts them (``Dispatched.overflow``). Unless TD_EP_CHECK_OVERFLOW=0
the count is checked: at once (a host read) when the step runs eagerly;
inside a CUDA-graph capture it is added on the device to a per-device
counter, which the engines read after their replays (``check_overflow``
at the end of ``Engine.serve``; the ContinuousEngine's one read per
harvest), warning and clearing it. The warning names TPContext.ep_max_m.
"""

from __future__ import annotations

import dataclasses
import os
import warnings

import torch

from triton_dist_tpu_torch.kernels import moe_utils
from triton_dist_tpu_torch.kernels.allgather_group_gemm import group_gemm
from triton_dist_tpu_torch.kernels.ep_a2a import (
    EpA2AContext, EpA2AMethod, combine_per_device, dispatch_gg_per_device,
    dispatch_per_device, expert_ids_flat,
)
from triton_dist_tpu_torch.kernels.plain import dot_f32
from triton_dist_tpu_torch.layers.common import TPContext, check_mode
from triton_dist_tpu_torch.layers.tp_mlp import _silu_mul
from triton_dist_tpu_torch.layers.tp_moe import (
    _all_gather_rows, dense_grouped_moe,
)

_PENDING: dict = {}     # device -> (1,) int64: pairs dropped in captures


def _warn(n: int) -> None:
    warnings.warn(f"EP dispatch dropped {n} (token, expert) pairs: raise "
                  "TPContext.ep_max_m", RuntimeWarning, stacklevel=3)


def _note_overflow(overflow: torch.Tensor) -> None:
    if os.environ.get("TD_EP_CHECK_OVERFLOW", "1") == "0":
        return
    dev = overflow.device
    if overflow.is_cuda and torch.cuda.is_current_stream_capturing():
        acc = _PENDING.get(dev)
        if acc is None:
            acc = _PENDING[dev] = torch.zeros(1, dtype=torch.int64,
                                              device=dev)
        acc.add_(overflow.sum())
        return
    if dev.type == "cuda" and dev not in _PENDING:
        # made here, outside any capture, for the captures that follow
        _PENDING[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
    n = int(overflow.sum())
    if n:
        _warn(n)


def pending_overflow(device) -> torch.Tensor | None:
    """The device counter of pairs the captured EP steps on ``device``
    dropped (None when no EP step ran there), for a caller that reads it
    with its own device read and hands the value to ``report_overflow``."""
    return _PENDING.get(torch.device(device))


def report_overflow(device, n: int) -> None:
    """Warn about ``n`` dropped pairs read from ``pending_overflow``, and
    clear the counter."""
    if n:
        _PENDING[torch.device(device)].zero_()
        _warn(n)


def check_overflow(device) -> int:
    """The (token, expert) pairs the captured EP steps on ``device``
    dropped since the last check; warns when there were any, and clears
    the count. A host read; 0 when no EP step ran there."""
    acc = pending_overflow(device)
    n = 0 if acc is None else int(acc.item())
    report_overflow(device, n)
    return n


def slot_products(rows: torch.Tensor, ids: torch.Tensor, num_live: int,
                  w_gate_up: torch.Tensor, w_down: torch.Tensor,
                  inter: torch.Tensor | None = None) -> torch.Tensor:
    """The expert MLP over an expert-parallel rank's received slots: rows
    (R, d), ids (R,) local expert per slot (pad: ``num_live``) ->
    (R, d) f32 in slot order: silu(gate) * up of the gate/up product (the
    rows' dtype, f32 accumulation; ``inter`` when B16 computed it), then
    the down product with f32 output. Both are B14's world-1 kernel
    (``group_gemm``) over ``moe_utils.live_tile_schedule``, so each live
    expert's slab is read once a product and the pad slots are in no tile
    (their rows come out 0); on the CPU its plain version. In the
    graph."""
    r = rows.shape[0]
    bm = min(128, max(8, r))
    sched = moe_utils.live_tile_schedule(ids.reshape(r, 1).to(torch.int32),
                                         1, num_live, bm)
    if inter is None:
        inter = group_gemm(rows, w_gate_up, sched, 1)
    return group_gemm(_silu_mul(inter), w_down, sched, 1,
                      out_dtype=torch.float32)


def ep_moe_fwd(ctx: EpA2AContext, w: dict, tokens: torch.Tensor,
               topk_ids: torch.Tensor,
               topk_weights: torch.Tensor) -> torch.Tensor:
    """tokens (M_local, d); topk_ids / topk_weights (M_local, topk) with
    GLOBAL expert ids; w: w_gate_up (E_loc, d, 2I), w_down (E_loc, I, d).
    Returns (M_local, d) f32. Under PALLAS_FUSED the dispatch and the
    gate/up product are one kernel (B16); otherwise the dispatch payload's
    wire dtype is the quant policy's (fp8 under TD_QUANT=always, unless
    ctx.payload_dtype is set), as in the reference, whose fused tier has
    no quantized payload."""
    inter = None
    if ctx.method == EpA2AMethod.PALLAS_FUSED:
        disp, inter = dispatch_gg_per_device(ctx, tokens, topk_ids,
                                             w["w_gate_up"])
    else:
        from triton_dist_tpu_torch.quant.policy import (
            resolve_ep_payload_dtype,
        )
        eff = resolve_ep_payload_dtype(ctx.payload_dtype)
        if eff is not ctx.payload_dtype:
            ctx = dataclasses.replace(ctx, payload_dtype=eff)
        disp = dispatch_per_device(ctx, tokens, topk_ids)
    _note_overflow(disp.overflow)
    rows, ids = expert_ids_flat(ctx, disp)
    out = slot_products(rows, ids, ctx.experts_per_rank, w["w_gate_up"],
                        w["w_down"], inter)
    out = out.reshape(ctx.world, ctx.max_m, -1).to(tokens.dtype)
    return combine_per_device(ctx, out, disp, topk_weights)


def ep_moe_layer_fwd(mode: str, tp_ctx: TPContext, num_experts: int,
                     topk: int, norm_topk_prob: bool, w: dict,
                     x: torch.Tensor) -> torch.Tensor:
    """The model-facing EP MoE block: x (B/n, T, d) this rank's rows in
    triton_dist, (B, T, d) otherwise -> the same shape."""
    check_mode(mode)
    tokens = x.reshape(-1, x.shape[-1])
    topk_w, topk_ids = moe_utils.route_topk(
        dot_f32(tokens, w["w_router"]), topk, norm_topk_prob=norm_topk_prob)
    if mode == "triton_dist":
        worst = tokens.shape[0] * topk
        max_m = (worst if tp_ctx.ep_max_m is None
                 else min(tp_ctx.ep_max_m, worst))
        ctx = EpA2AContext(tp_ctx.mesh, tp_ctx.axis, num_experts, topk,
                           max_m=max_m, method=tp_ctx.ep_a2a_method,
                           comm_blocks=tp_ctx.comm_blocks)
        y = ep_moe_fwd(ctx, w, tokens, topk_ids, topk_w)
        return y.to(x.dtype).reshape(x.shape)
    wgu = _all_gather_rows(tp_ctx, w["w_gate_up"])
    wd = _all_gather_rows(tp_ctx, w["w_down"])
    y = dense_grouped_moe(tokens, topk_ids, topk_w, wgu, wd, num_experts)
    return y.to(x.dtype).reshape(x.shape)
