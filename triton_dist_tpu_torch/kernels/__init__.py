"""Hand-written Hopper kernels (csrc/) with their plain PyTorch versions.

B1 ``flash_attention.flash_prefill`` (prefill, and the dense decode step at
T = 1), B2 ``paged_flash_decode.paged_flash_decode_partial`` (the paged
decode step), B3 ``fused_chain.fused_add_rms`` and B4
``gemm_allreduce.gemm_ar`` (the mega decode step's pallas_chain tier at
world 1; ``gemm_allreduce.pallas_gemm_ar`` across ranks), B5
``allreduce.one_shot_all_reduce`` and B6 ``allreduce.rhd_all_reduce``
(the triton_dist_AR mode's sums after the o and down projections), B9
``reduce_scatter.ring_reduce_scatter`` and B7
``allgather.ring_all_gather`` (TWO_SHOT: the ring reduce-scatter, then
the ring all-gather), and
the triton_dist forward's B12 ``allgather_gemm.pallas_matmul`` (the QKV and
o projections at world 1), B10 ``allgather_gemm.pallas_ag_gemm`` and B13a
``gemm_reduce_scatter.pallas_gemm_rs`` (the QKV and gate/up, and the o and
down projections across ranks), B14 ``allgather_group_gemm.group_gemm``
(the MoE gate/up) and B15 ``moe_reduce_rs.moe_rs`` (the MoE down + top-k
combine) at world 1, and across ranks B14
``allgather_group_gemm.pallas_ag_group_gemm`` and B15
``moe_reduce_rs.pallas_moe_reduce_rs``;
``flash_decode`` holds the LSE merge B2 feeds. Across ranks also B8
``allgather.full_mesh_all_gather`` (the full-mesh all-gather), B11
``allgather_gemm.pallas_ag_gemm_bidir`` and B13b
``gemm_reduce_scatter.pallas_gemm_rs_bidir`` (the bidirectional-ring
AllGather + GEMM and GEMM + ReduceScatter, the PALLAS_BIDIR tiers). The
expert-parallel MoE layer's: B17
``low_latency_all_to_all.fast_all_to_all_per_device`` (the padded-slot
all-to-all of dispatch and combine), B18
``low_latency_all_to_all.fast_all_to_all_q_per_device`` (its fp8 form)
and B16 ``ep_a2a.pallas_dispatch_gg`` (the dispatch fused with the gate/up
grouped GEMM). The sequence-parallel slice's: B1's varlen and fold forms
``flash_attention.flash_prefill_varlen`` / ``flash_fold_partial``, B19
``flash_attention.flash_decode_partial`` (the split-KV decode partial),
B20 ``flash_decode.pallas_combine_per_device`` (the cross-rank LSE
combine) and B21 ``sp_ag_attention.pallas_ring_attn_per_device`` (the
fused ring attention). The small collectives and pipeline
point-to-point: B22 ``low_latency_allgather.bidir_ring_ag_per_device``
and B23 ``low_latency_allgather.ring2d_ag_per_device`` (the
bidirectional-ring and 2-D ring all-gathers), B24
``p2p.p2p_put_per_device`` (the point-to-point put), B25
``common_ops.barrier_all_per_device`` (the device barrier) and B26
``common_ops.ring_shift_per_device`` (the ring shift). The quantized
wire: B27 ``quant_wire.quantize_stage_per_device`` (the int8 staging
encode; each hop of the int8 ring), B28
``quant_wire.qint8_one_shot_per_device`` (the int8 one-shot all-reduce),
B29 ``kv_handoff.kv_handoff_per_device`` (the KV page handoff) and B30
``kv_handoff.kv_handoff_fanout_per_device`` (its fan-out). Each wrapper
counts its kernel launches in a ``launches`` attribute.

The mesh-level ops and their contexts are exported here, as the
reference's package exports them: ``all_gather_op``, ``ag_gemm``,
``gemm_rs``, ``ag_group_gemm`` with their contexts, the expert-parallel
``dispatch``, ``dispatch_gg`` and ``combine`` with ``EpA2AContext``, and
``fast_all_to_all`` / ``fast_all_to_all_quantized``, ``sp_attention``,
``flash_decode`` and ``paged_flash_decode_dist`` with their contexts,
``barrier_all_op``, ``ring_shift_op``, ``p2p_put_op``,
``fast_allgather`` with its context, and ``kv_handoff``,
``kv_handoff_fanout`` and ``kv_handoff_quantized``; the
MoE
ReduceScatter op is ``moe_reduce_rs.moe_reduce_rs`` (its name is the
module's).
"""

from triton_dist_tpu_torch.kernels.common_ops import (  # noqa: F401
    barrier_all_op,
    ring_shift_op,
)
from triton_dist_tpu_torch.kernels.p2p import p2p_put_op  # noqa: F401
from triton_dist_tpu_torch.kernels.kv_handoff import (  # noqa: F401
    KVHandoffMethod,
    kv_handoff,
    kv_handoff_fanout,
    kv_handoff_quantized,
)
from triton_dist_tpu_torch.kernels.allgather import (  # noqa: F401
    AllGatherMethod,
    all_gather_op,
    get_auto_all_gather_method,
)
from triton_dist_tpu_torch.kernels.allgather_gemm import (  # noqa: F401
    AgGemmContext,
    AgGemmMethod,
    ag_gemm,
    create_ag_gemm_context,
)
from triton_dist_tpu_torch.kernels.allgather_group_gemm import (  # noqa: F401
    AgGroupGemmContext,
    AgGroupGemmMethod,
    ag_group_gemm,
    create_ag_group_gemm_context,
)
from triton_dist_tpu_torch.kernels.ep_a2a import (  # noqa: F401
    EpA2AContext,
    EpA2AMethod,
    combine,
    create_ep_a2a_context,
    dispatch,
    dispatch_gg,
)
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (  # noqa: F401
    GemmRsContext,
    GemmRsMethod,
    create_gemm_rs_context,
    gemm_rs,
)
from triton_dist_tpu_torch.kernels.moe_reduce_rs import (  # noqa: F401
    MoeReduceRsContext,
    MoeReduceRsMethod,
    create_moe_reduce_rs_context,
)
from triton_dist_tpu_torch.kernels.low_latency_all_to_all import (  # noqa: F401,E501
    fast_all_to_all,
    fast_all_to_all_quantized,
)
from triton_dist_tpu_torch.kernels.low_latency_allgather import (  # noqa: F401,E501
    FastAllGatherContext,
    LLAllGatherMethod,
    create_fast_allgather_context,
    fast_allgather,
    get_auto_ll_allgather_method,
    ll_allgather_per_device,
)
from triton_dist_tpu_torch.kernels.moe_utils import (  # noqa: F401
    make_chunk_schedule,
    native_chunk_schedule,
)
from triton_dist_tpu_torch.kernels.sp_ag_attention import (  # noqa: F401
    SpAttnContext,
    SpAttnMethod,
    create_sp_attn_context,
    sp_attention,
)
from triton_dist_tpu_torch.kernels.flash_decode import (  # noqa: F401
    FlashDecodeCombine,
    FlashDecodeContext,
    create_flash_decode_context,
    flash_decode,
    paged_flash_decode_dist,
)


def launch_wrappers() -> dict:
    """{kernel name: its wrapper}; each wrapper's ``launches`` counts the
    kernel launches it made (or recorded into a CUDA graph)."""
    from triton_dist_tpu_torch.kernels.allgather import (
        full_mesh_all_gather, ring_all_gather,
    )
    from triton_dist_tpu_torch.kernels.allgather_gemm import (
        pallas_ag_gemm, pallas_ag_gemm_bidir, pallas_matmul,
    )
    from triton_dist_tpu_torch.kernels.allgather_group_gemm import (
        group_gemm, pallas_ag_group_gemm,
    )
    from triton_dist_tpu_torch.kernels.allreduce import (
        one_shot_all_reduce, rhd_all_reduce,
    )
    from triton_dist_tpu_torch.kernels.common_ops import (
        barrier_all_per_device, ring_shift_per_device,
    )
    from triton_dist_tpu_torch.kernels.ep_a2a import pallas_dispatch_gg
    from triton_dist_tpu_torch.kernels.low_latency_allgather import (
        bidir_ring_ag_per_device, ring2d_ag_per_device,
    )
    from triton_dist_tpu_torch.kernels.p2p import p2p_put_per_device
    from triton_dist_tpu_torch.kernels.kv_handoff import (
        kv_handoff_fanout_per_device, kv_handoff_per_device,
    )
    from triton_dist_tpu_torch.kernels.quant_wire import (
        qint8_one_shot_per_device, quantize_stage_per_device,
    )
    from triton_dist_tpu_torch.kernels.flash_attention import (
        flash_decode_partial, flash_fold_partial, flash_prefill,
        flash_prefill_varlen,
    )
    from triton_dist_tpu_torch.kernels.flash_decode import (
        pallas_combine_per_device,
    )
    from triton_dist_tpu_torch.kernels.sp_ag_attention import (
        pallas_ring_attn_per_device,
    )
    from triton_dist_tpu_torch.kernels.fused_chain import fused_add_rms
    from triton_dist_tpu_torch.kernels.gemm_allreduce import (
        gemm_ar, pallas_gemm_ar,
    )
    from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (
        pallas_gemm_rs, pallas_gemm_rs_bidir,
    )
    from triton_dist_tpu_torch.kernels.low_latency_all_to_all import (
        fast_all_to_all_per_device, fast_all_to_all_q_per_device,
    )
    from triton_dist_tpu_torch.kernels.moe_reduce_rs import (
        moe_rs, pallas_moe_reduce_rs,
    )
    from triton_dist_tpu_torch.kernels.paged_flash_decode import (
        paged_flash_decode_partial,
    )
    from triton_dist_tpu_torch.kernels.reduce_scatter import (
        ring_reduce_scatter,
    )
    return {"flash_prefill": flash_prefill,
            "paged_flash_decode_partial": paged_flash_decode_partial,
            "fused_add_rms": fused_add_rms, "gemm_ar": gemm_ar,
            "pallas_matmul": pallas_matmul, "group_gemm": group_gemm,
            "moe_rs": moe_rs, "pallas_ag_gemm": pallas_ag_gemm,
            "pallas_gemm_rs": pallas_gemm_rs,
            "pallas_gemm_ar": pallas_gemm_ar,
            "one_shot_all_reduce": one_shot_all_reduce,
            "rhd_all_reduce": rhd_all_reduce,
            "ring_reduce_scatter": ring_reduce_scatter,
            "ring_all_gather": ring_all_gather,
            "pallas_ag_group_gemm": pallas_ag_group_gemm,
            "pallas_moe_reduce_rs": pallas_moe_reduce_rs,
            "full_mesh_all_gather": full_mesh_all_gather,
            "pallas_ag_gemm_bidir": pallas_ag_gemm_bidir,
            "pallas_gemm_rs_bidir": pallas_gemm_rs_bidir,
            "fast_all_to_all_per_device": fast_all_to_all_per_device,
            "fast_all_to_all_q_per_device": fast_all_to_all_q_per_device,
            "pallas_dispatch_gg": pallas_dispatch_gg,
            "flash_prefill_varlen": flash_prefill_varlen,
            "flash_fold_partial": flash_fold_partial,
            "flash_decode_partial": flash_decode_partial,
            "pallas_combine_per_device": pallas_combine_per_device,
            "pallas_ring_attn_per_device": pallas_ring_attn_per_device,
            "bidir_ring_ag_per_device": bidir_ring_ag_per_device,
            "ring2d_ag_per_device": ring2d_ag_per_device,
            "p2p_put_per_device": p2p_put_per_device,
            "barrier_all_per_device": barrier_all_per_device,
            "ring_shift_per_device": ring_shift_per_device,
            "quantize_stage_per_device": quantize_stage_per_device,
            "qint8_one_shot_per_device": qint8_one_shot_per_device,
            "kv_handoff_per_device": kv_handoff_per_device,
            "kv_handoff_fanout_per_device": kv_handoff_fanout_per_device}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in launch_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in launch_wrappers().values():
        fn.launches = 0
