"""GEMM + ReduceScatter (the reference's kernels/gemm_reduce_scatter.py), at
world 1.

At world 1 the reduce-scatter is the identity, so every method computes
the row-parallel projection out = cast(a @ b) with f32 accumulation: XLA,
XLA_RING and XLA_BIDIR the plain product; PALLAS and PALLAS_BIDIR B12, as
the reference's n == 1 path runs ``_pallas_matmul``
(kernels/allgather_gemm.py). World > 1 (the ring of partials, B13) waits
for ROADMAP A9.
"""

from __future__ import annotations

import enum

import torch

from triton_dist_tpu_torch.kernels.allgather_gemm import (
    check_tp_world, matmul_ref, pallas_matmul,
)


class GemmRsMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    XLA_RING = "xla_ring"
    XLA_BIDIR = "xla_bidir"
    PALLAS = "pallas"
    PALLAS_BIDIR = "pallas_bidir"


def gemm_rs_per_device(n: int, method: GemmRsMethod, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """The reference's per-device entry at world n = 1: a @ b."""
    check_tp_world(n, "gemm_rs")
    if method in (GemmRsMethod.XLA, GemmRsMethod.XLA_RING,
                  GemmRsMethod.XLA_BIDIR):
        return matmul_ref(a, b)
    if method in (GemmRsMethod.PALLAS, GemmRsMethod.PALLAS_BIDIR):
        return pallas_matmul(a, b)
    raise ValueError(f"unresolved method {method}")
