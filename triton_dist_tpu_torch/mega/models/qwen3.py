"""Qwen3 decode steps as mega task graphs (the reference's
mega/models/qwen3.py).

``build_qwen3_decode`` records the dense max-length-cache decode step of
one rank of an n_tp-way tensor-parallel model: every layer's
rms/qkv/rope/kv-write/attention/o-projection over the rank's hq/n and
hkv/n heads, the fused add+RMSNorm boundary, the MLP with its down
projection, and the logits tail with its vocabulary gather, with the
reference's task names and order, so a schedule policy gives the same
order on the same graph. The o/down projections are ``linear_allreduce``
tasks (B4 in the pallas_chain tier, the process group's all-reduce in the
xla tier), the boundary a ``fused_chain`` task (B3). For the MoE family
the MLP half is one ``moe`` task: the layer library's xla-mode math
(router, ``dense_grouped_moe``, the process group's f32 all-reduce at
n_tp > 1, the cast; for expert-parallel archs the expert slabs
all-gathered instead), with no fused tier for tensor-parallel experts, as
in the reference. Expert-parallel archs at n_tp > 1 get a fused tier: the
replicated token rows cut over the ranks, dispatched over the transport
``ep_a2a_method`` names (None: the process group's all-to-all; PALLAS:
B17; PALLAS_FUSED: B16 + B17) to the experts' owners, combined back, and
all-gathered.
``build_qwen3_paged_decode`` records the paged-cache T = 1 step with the
continuous-batching ``active`` mask (``paged_kv_write`` and
``paged_attend``, B2, in place of the dense cache's write and
attention), the step the ContinuousEngine replays.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.layers.common import (
    TPContext, dot_f32, gather_vocab,
)
from triton_dist_tpu_torch.mega.builder import ModelBuilder
from triton_dist_tpu_torch.models.config import Qwen3Arch, Qwen3MoEArch


def _moe_task(b: ModelBuilder, arch, n_tp: int, hn: str, wr: str, wgu: str,
              wd: str, *, layer_id: int, ep_a2a_method=None,
              ep_max_m: int | None = None, comm_blocks: int = 4) -> str:
    """One MoE expert block as a task. The xla tier is the layer
    library's xla-mode math (layers/tp_moe.moe_fwd "xla" /
    layers/ep_a2a_layer.ep_moe_layer_fwd "xla", op for op, so the tier is
    bit-identical to the layer-by-layer path): router, for
    expert-parallel archs the expert slabs all-gathered over the builder's
    mesh, ``dense_grouped_moe``, for tensor-parallel ones the f32 partial
    all-reduced (the identity at world 1), the cast. Expert-parallel archs
    on a mesh get a pallas_chain tier: this rank's 1/n of the replicated
    rows routed and dispatched through ``ep_moe_fwd`` over
    ``ep_a2a_method`` (None: XLA), combined, all-gathered back. Rows that
    n_tp does not divide take the xla tier (a shape rule, as in the
    reference)."""
    from triton_dist_tpu_torch.kernels import moe_utils
    from triton_dist_tpu_torch.layers.tp_moe import (
        _all_gather_rows, dense_grouped_moe,
    )

    topk, num_experts = arch.num_experts_per_tok, arch.num_experts
    ep = arch.moe_parallel == "ep"

    def _route(tokens, wr_):
        return moe_utils.route_topk(dot_f32(tokens, wr_), topk,
                                    norm_topk_prob=arch.norm_topk_prob)

    def xla_fn(x_, wr_, wgu_, wd_):
        tokens = x_.reshape(-1, x_.shape[-1])
        topk_w, topk_ids = _route(tokens, wr_)
        if ep:
            ctx = TPContext(b.mesh_of(n_tp))
            y = dense_grouped_moe(tokens, topk_ids, topk_w,
                                  _all_gather_rows(ctx, wgu_),
                                  _all_gather_rows(ctx, wd_), num_experts)
            return y.to(x_.dtype).reshape(x_.shape)
        y = dense_grouped_moe(tokens, topk_ids, topk_w, wgu_, wd_,
                              num_experts)
        y = b.psum(y, n_tp)                    # I is TP-sharded
        return y.to(x_.dtype).reshape(x_.shape)

    tier_fns = None
    if ep and n_tp > 1 and b.mesh is not None:
        from triton_dist_tpu_torch.kernels.ep_a2a import (
            EpA2AContext, EpA2AMethod,
        )
        from triton_dist_tpu_torch.layers.ep_a2a_layer import ep_moe_fwd

        def fused_fn(x_, wr_, wgu_, wd_):
            tokens = x_.reshape(-1, x_.shape[-1])
            m = tokens.shape[0]
            if m % n_tp:
                # replicated rows that do not split over the ranks stay on
                # the xla tier rather than dispatch ragged shards
                return xla_fn(x_, wr_, wgu_, wd_)
            mesh = b.mesh_of(n_tp)
            m_loc = m // n_tp
            tok_l = tokens[mesh.rank * m_loc:(mesh.rank + 1) * m_loc]
            topk_w, topk_ids = _route(tok_l, wr_)
            worst = m_loc * topk
            max_m = worst if ep_max_m is None else min(ep_max_m, worst)
            ctx = EpA2AContext(mesh, mesh.axis, num_experts, topk,
                               max_m=max_m,
                               method=ep_a2a_method or EpA2AMethod.XLA,
                               comm_blocks=comm_blocks)
            y_l = ep_moe_fwd(ctx, {"w_gate_up": wgu_, "w_down": wd_},
                             tok_l, topk_ids, topk_w)
            y = _all_gather_rows(TPContext(mesh), y_l.to(x_.dtype))
            return y.reshape(x_.shape)

        tier_fns = {"pallas_chain": fused_fn}

    return b.make_custom("moe", (hn, wr, wgu, wd), xla_fn, layer_id=layer_id,
                         tier_fns=tier_fns, is_comm=True)


def _layer_tail_tasks(b: ModelBuilder, arch, n_tp: int, h: str, a: str,
                      i: int, postn: str, mlp_inputs, *,
                      gemm_ar_method=None, ep_a2a_method=None,
                      ep_max_m=None, comm_blocks=4) -> str:
    """Attention→MLP boundary + the MLP/MoE half of layer i. Returns the
    layer's output h name."""
    h, hn = b.make_fused_chain(h, a, postn, arch.rms_eps, layer_id=i)
    if isinstance(arch, Qwen3MoEArch):
        wr, wgu, wd = mlp_inputs
        dn = _moe_task(b, arch, n_tp, hn, wr, wgu, wd, layer_id=i,
                       ep_a2a_method=ep_a2a_method, ep_max_m=ep_max_m,
                       comm_blocks=comm_blocks)
    else:
        wgu, wd = mlp_inputs
        gu = b.make_linear(hn, wgu, layer_id=i)
        act = b.make_silu_mul(gu, layer_id=i)
        dn = b.make_linear_allreduce(act, wd, layer_id=i, world=n_tp,
                                     gemm_ar_method=gemm_ar_method)
    return b.make_add(h, dn, layer_id=i)


def _mlp_layer_inputs(b: ModelBuilder, arch, i: int):
    if isinstance(arch, Qwen3MoEArch):
        return (b.add_input(f"w_router_{i}"), b.add_input(f"w_gate_up_{i}"),
                b.add_input(f"w_down_{i}"))
    return (b.add_input(f"w_gate_up_{i}"), b.add_input(f"w_down_{i}"))


def _logits_tail_tasks(b: ModelBuilder, n_tp: int, h: str,
                       final_norm: str, lm_head: str, eps: float) -> str:
    """Final norm + last-position vocab projection (f32) + the gather
    along the vocabulary over the builder's mesh (the identity at world
    1) — the task mirror of Qwen3._logits_tail in the replicated modes."""
    h = b.make_rms_norm(h, final_norm, eps, layer_id=-2)
    last = b.make_custom("last_tok", (h,), lambda h_: h_[:, -1],
                         layer_id=-2)
    logits_l = b.make_custom("lm_head", (last, lm_head), dot_f32,
                             layer_id=-2)
    return b.make_custom(
        "vocab_gather", (logits_l,),
        lambda x_: gather_vocab(TPContext(b.mesh_of(n_tp)), x_),
        layer_id=-2, is_comm=True)


def build_qwen3_decode(arch: Qwen3Arch, n_tp: int = 1,
                       dtype: torch.dtype = torch.bfloat16, *, mesh=None,
                       gemm_ar_method=None, ep_a2a_method=None,
                       ep_max_m: int | None = None,
                       comm_blocks: int = 4) -> ModelBuilder:
    """Record one rank's dense-cache decode step of an n_tp-way
    tensor-parallel Qwen3 dense or MoE model (``mesh``: the ranks' Mesh,
    needed to run the step at n_tp > 1; ep_a2a_method, ep_max_m and
    comm_blocks: the expert-parallel moe task's fused tier).

    Step inputs (env keys): input_ids (B, T), positions (T,), offset ()
    on the device, cos_sin, embed, lm_head (d, V/n), final_norm, and per
    layer i: wqkv_i (d, qkv/n), wo_i (q/n, d), q_norm_i, k_norm_i,
    in_norm_i, post_norm_i, w_gate_up_i (d, 2I/n), w_down_i (I/n, d) (and
    w_router_i for MoE) and k_cache_i / v_cache_i (B, S, Hkv/n, D) — the
    cache slabs, written in place. Outputs: logits (B, V) f32
    (``builder.logits_name``) and each layer's slabs
    (``builder.kv_outputs``)."""
    hq, hkv = arch.num_heads // n_tp, arch.num_kv_heads // n_tp
    hd = arch.head_dim
    q_l, kv_l = hq * hd, hkv * hd

    b = ModelBuilder(mesh)
    ids = b.add_input("input_ids")
    positions = b.add_input("positions")
    offset = b.add_input("offset")
    cos_sin = b.add_input("cos_sin")
    embed = b.add_input("embed")
    lm_head = b.add_input("lm_head")
    final_norm = b.add_input("final_norm")

    h = b.make_embedding(ids, embed, dtype=dtype)
    b.kv_outputs = []
    for i in range(arch.num_layers):
        wqkv = b.add_input(f"wqkv_{i}")
        wo = b.add_input(f"wo_{i}")
        qn = b.add_input(f"q_norm_{i}")
        kn = b.add_input(f"k_norm_{i}")
        inn = b.add_input(f"in_norm_{i}")
        postn = b.add_input(f"post_norm_{i}")
        mlp_inputs = _mlp_layer_inputs(b, arch, i)
        kc = b.add_input(f"k_cache_{i}")
        vc = b.add_input(f"v_cache_{i}")

        hn = b.make_rms_norm(h, inn, arch.rms_eps, layer_id=i)
        q, k, v = b.make_qkv_proj(hn, wqkv, q_l, kv_l, layer_id=i)
        q, k = b.make_qk_norm_rope(q, k, qn, kn, cos_sin, positions,
                                   hq, hkv, hd, arch.rms_eps, layer_id=i)
        v = b.make_custom(
            "reshape_v", (v,),
            lambda v_: v_.reshape(v_.shape[0], v_.shape[1], hkv, hd),
            layer_id=i)
        nk, nv = b.make_kv_update(k, v, kc, vc, offset, layer_id=i)
        a = b.make_attn(q, nk, nv, offset, layer_id=i)
        a = b.make_linear_allreduce(a, wo, layer_id=i, world=n_tp,
                                    gemm_ar_method=gemm_ar_method)
        h = _layer_tail_tasks(b, arch, n_tp, h, a, i, postn, mlp_inputs,
                              gemm_ar_method=gemm_ar_method,
                              ep_a2a_method=ep_a2a_method,
                              ep_max_m=ep_max_m, comm_blocks=comm_blocks)
        b.mark_output(nk, nv)
        b.kv_outputs.append((nk, nv))

    logits = _logits_tail_tasks(b, n_tp, h, final_norm, lm_head,
                                arch.rms_eps)
    b.mark_output(logits)
    b.logits_name = logits
    return b


def build_qwen3_paged_decode(arch: Qwen3Arch, n_tp: int, page_size: int,
                             dtype: torch.dtype = torch.bfloat16, *,
                             mesh=None, gemm_ar_method=None,
                             resident: bool = False, ep_a2a_method=None,
                             ep_max_m: int | None = None,
                             comm_blocks: int = 4) -> ModelBuilder:
    """Record one rank's T = 1 paged-cache decode step with the
    continuous-batching ``active`` mask: the task mirror of the layer
    path's paged decode (Qwen3._forward_paged at T == 1), so the xla tier
    equals it bit for bit.

    Step inputs (env keys): input_ids (B, 1), block_table (B, NP),
    lengths (B,) (pre-advance, post-allocate), active (B,) bool, cos_sin,
    embed, lm_head, final_norm, and per layer i the layer weights plus
    k_pages_i / v_pages_i (Hkv/n, P, page_size, D) pool slabs, written in
    place. Outputs: logits (B, V) f32 and every layer's pool slabs
    (``builder.paged_kv_outputs``). ``resident=True`` records the
    int8-resident variant: per layer also k_scales_i / v_scales_i
    (Hkv/n, P, page_size) f32 slabs (``builder.paged_scale_outputs``)."""
    hq, hkv = arch.num_heads // n_tp, arch.num_kv_heads // n_tp
    hd = arch.head_dim
    q_l, kv_l = hq * hd, hkv * hd

    b = ModelBuilder(mesh)
    ids = b.add_input("input_ids")
    table = b.add_input("block_table")
    lengths = b.add_input("lengths")
    active = b.add_input("active")
    cos_sin = b.add_input("cos_sin")
    embed = b.add_input("embed")
    lm_head = b.add_input("lm_head")
    final_norm = b.add_input("final_norm")

    # per-row decode positions: each row's next slot (a ragged batch)
    positions = b.make_custom("positions", (lengths,),
                              lambda ln: ln[:, None] + 0, layer_id=-1)

    h = b.make_embedding(ids, embed, dtype=dtype)
    b.paged_kv_outputs = []
    b.paged_scale_outputs = []
    for i in range(arch.num_layers):
        wqkv = b.add_input(f"wqkv_{i}")
        wo = b.add_input(f"wo_{i}")
        qn = b.add_input(f"q_norm_{i}")
        kn = b.add_input(f"k_norm_{i}")
        inn = b.add_input(f"in_norm_{i}")
        postn = b.add_input(f"post_norm_{i}")
        mlp_inputs = _mlp_layer_inputs(b, arch, i)
        kp = b.add_input(f"k_pages_{i}")
        vp = b.add_input(f"v_pages_{i}")
        kps = b.add_input(f"k_scales_{i}") if resident else None
        vps = b.add_input(f"v_scales_{i}") if resident else None

        hn = b.make_rms_norm(h, inn, arch.rms_eps, layer_id=i)
        q, k, v = b.make_qkv_proj(hn, wqkv, q_l, kv_l, layer_id=i)
        q, k = b.make_qk_norm_rope(q, k, qn, kn, cos_sin, positions,
                                   hq, hkv, hd, arch.rms_eps, layer_id=i)
        v = b.make_custom(
            "reshape_v", (v,),
            lambda v_: v_.reshape(v_.shape[0], v_.shape[1], hkv, hd),
            layer_id=i)
        if resident:
            nk, nv, nks, nvs = b.make_paged_kv_write(
                k, v, kp, vp, table, lengths, active, page_size,
                layer_id=i, k_scales=kps, v_scales=vps)
            a = b.make_paged_attend(q, nk, nv, table, lengths, dtype,
                                    layer_id=i, k_scales=nks, v_scales=nvs)
        else:
            nk, nv = b.make_paged_kv_write(k, v, kp, vp, table, lengths,
                                           active, page_size, layer_id=i)
            a = b.make_paged_attend(q, nk, nv, table, lengths, dtype,
                                    layer_id=i)
        a = b.make_custom(
            "flatten_heads", (a,),
            lambda a_: a_.reshape(a_.shape[0], a_.shape[1], -1),
            layer_id=i)
        a = b.make_linear_allreduce(a, wo, layer_id=i, world=n_tp,
                                    gemm_ar_method=gemm_ar_method)
        h = _layer_tail_tasks(b, arch, n_tp, h, a, i, postn, mlp_inputs,
                              gemm_ar_method=gemm_ar_method,
                              ep_a2a_method=ep_a2a_method,
                              ep_max_m=ep_max_m, comm_blocks=comm_blocks)
        b.mark_output(nk, nv)
        b.paged_kv_outputs.append((nk, nv))
        if resident:
            b.mark_output(nks, nvs)
            b.paged_scale_outputs.append((nks, nvs))

    logits = _logits_tail_tasks(b, n_tp, h, final_norm, lm_head,
                                arch.rms_eps)
    b.mark_output(logits)
    b.logits_name = logits
    return b
