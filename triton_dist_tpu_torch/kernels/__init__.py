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
``flash_decode`` holds the LSE merge B2 feeds. Each wrapper counts its
kernel launches in a ``launches`` attribute."""


def launch_wrappers() -> dict:
    """{kernel name: its wrapper}; each wrapper's ``launches`` counts the
    kernel launches it made (or recorded into a CUDA graph)."""
    from triton_dist_tpu_torch.kernels.allgather import ring_all_gather
    from triton_dist_tpu_torch.kernels.allgather_gemm import (
        pallas_ag_gemm, pallas_matmul,
    )
    from triton_dist_tpu_torch.kernels.allgather_group_gemm import (
        group_gemm, pallas_ag_group_gemm,
    )
    from triton_dist_tpu_torch.kernels.allreduce import (
        one_shot_all_reduce, rhd_all_reduce,
    )
    from triton_dist_tpu_torch.kernels.flash_attention import flash_prefill
    from triton_dist_tpu_torch.kernels.fused_chain import fused_add_rms
    from triton_dist_tpu_torch.kernels.gemm_allreduce import (
        gemm_ar, pallas_gemm_ar,
    )
    from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (
        pallas_gemm_rs,
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
            "pallas_moe_reduce_rs": pallas_moe_reduce_rs}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in launch_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in launch_wrappers().values():
        fn.launches = 0
