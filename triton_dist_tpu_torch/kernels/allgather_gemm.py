"""AllGather + GEMM (the reference's kernels/allgather_gemm.py), at world 1.

At world 1 the gather is the identity, so every method computes the
column-parallel projection out = cast(a @ b) with f32 accumulation and
returns (out, a) like the reference (the gathered A is A itself):

  * XLA, XLA_RING, XLA_BIDIR — the plain product (a ring of one step is the
    identity gather);
  * PALLAS, PALLAS_BIDIR — B12, the reference's ``_pallas_matmul`` (its
    n == 1 path): ``pallas_matmul`` launches the hand-written CUDA kernel
    ``csrc/matmul.cu`` for CUDA tensors and runs ``matmul_ref``, its plain
    PyTorch version, for CPU tensors. No fallback: a CUDA tensor the
    kernel does not take raises.

World > 1 (the ring of A shards, B10/B11) waits for ROADMAP A9. The TPU
tile sizes (bm, bn, bk) have nothing to choose on the card: the K split is
sized to fill it (``gemm_allreduce.split_plan``), and the launch is B4's
(``gemm_allreduce.splitk_launch``) through B12's own C entry point.
"""

from __future__ import annotations

import enum

import torch

from triton_dist_tpu_torch.kernels.gemm_allreduce import splitk_launch
from triton_dist_tpu_torch.kernels.plain import dot_f32


class AgGemmMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    XLA_RING = "xla_ring"
    XLA_BIDIR = "xla_bidir"
    PALLAS = "pallas"
    PALLAS_BIDIR = "pallas_bidir"


def check_tp_world(n: int, what: str) -> None:
    """The triton_dist ops run at world 1 here; their rings wait for A9."""
    if n != 1:
        raise NotImplementedError(
            f"{what} at world {n} (the overlapped ring) waits for "
            "ROADMAP A9")


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of B12: (M, K) @ (K, N) with f32 accumulation, one
    cast to the inputs' result dtype."""
    return dot_f32(a, b).to(torch.result_type(a, b))


def pallas_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B12: cast(a @ b) with a K-split f32 accumulator, a (M, K), b (K, N).
    CUDA tensors launch the kernel (counted in ``pallas_matmul.launches``);
    CPU tensors run ``matmul_ref``."""
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"pallas_matmul: unsupported device {a.device}")
    out = splitk_launch(a.contiguous(), b, "matmul", "td_matmul",
                        "pallas_matmul")
    pallas_matmul.launches += 1
    return out


pallas_matmul.launches = 0


def ag_gemm_per_device(n: int, method: AgGemmMethod, a: torch.Tensor,
                       b: torch.Tensor):
    """The reference's per-device entry at world n = 1: (a @ b, a)."""
    check_tp_world(n, "ag_gemm")
    if method in (AgGemmMethod.XLA, AgGemmMethod.XLA_RING,
                  AgGemmMethod.XLA_BIDIR):
        return matmul_ref(a, b), a
    if method in (AgGemmMethod.PALLAS, AgGemmMethod.PALLAS_BIDIR):
        return pallas_matmul(a, b), a
    raise ValueError(f"unresolved method {method}")
