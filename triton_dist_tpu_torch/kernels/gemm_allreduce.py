"""B4: fused GEMM + allreduce (the reference's kernels/gemm_allreduce.py),
at world 1.

At world 1 the reference's allreduce is the identity, so the op is the
row-parallel projection: out = cast(a @ b) with f32 accumulation.
``gemm_ar`` launches the hand-written CUDA kernel ``csrc/gemm_ar.cu`` (the
world-1 body of ``_gemm_ar_kernel``) for CUDA tensors and runs
``gemm_ar_ref``, its plain PyTorch version, for CPU tensors. There is no
fallback between the two: a CUDA tensor the kernel does not take raises.

Methods: XLA (the plain product: f32 dot, psum = identity, cast) and PALLAS
(the kernel — the reference's name for its fused tier) are ported.
XLA_RING waits for ROADMAP A9, the QINT8 tier for A13 and world > 1 (the
push of partials to the peers) for A5; each raises naming its item.
"""

from __future__ import annotations

import ctypes
import enum

import torch

from triton_dist_tpu_torch.kernels.plain import check_world, dot_f32
from triton_dist_tpu_torch.runtime import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BLOCKS_PER_SM = 4    # blocks the K split aims for at decode M
_K_ROW_STEP = 64      # k_chunk granule: 8 warps x 8 rows per pass
_M_TILE_MAX = 8       # the kernel's largest M tile


class GemmArMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    XLA_RING = "xla_ring"
    PALLAS = "pallas"
    XLA_QINT8 = "xla_qint8"


def get_auto_gemm_ar_method(world: int, cuda: bool) -> GemmArMethod:
    """The port's AUTO rule. The reference's size table is derived for a
    TPU's ICI (queue C) and does not carry over; at world 1 there is no
    transfer to size, so CUDA takes PALLAS (the kernel) and the CPU takes
    XLA (the plain product, which the reference also picks off its chip).
    Larger worlds wait for ROADMAP A5."""
    check_world(world, "gemm_ar (the push of partials to the peers)")
    return GemmArMethod.PALLAS if cuda else GemmArMethod.XLA


def gemm_ar_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: (M, K) @ (K, N) with f32 accumulation, cast to the
    inputs' result dtype."""
    return dot_f32(a, b).to(torch.result_type(a, b))


def gemm_ar(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """World-1 GEMM+AR: cast(a @ b) with f32 accumulation, a (M, K), b
    (K, N). CUDA tensors launch the kernel (counted in
    ``gemm_ar.launches``); CPU tensors run ``gemm_ar_ref``."""
    if a.device.type == "cpu":
        return gemm_ar_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"gemm_ar: unsupported device {a.device}")
    out = splitk_launch(a, b, "gemm_ar", "td_gemm_ar", "gemm_ar")
    gemm_ar.launches += 1
    return out


gemm_ar.launches = 0


def gemm_ar_per_device(n: int, method: GemmArMethod, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """The reference's per-device entry, at world n = 1 (its mesh axis,
    TPU tiles and interpret flag have nothing to choose here)."""
    check_world(n, "gemm_ar (the push of partials to the peers)")
    if method == GemmArMethod.AUTO:
        method = get_auto_gemm_ar_method(n, a.device.type == "cuda")
    if method == GemmArMethod.XLA:
        return gemm_ar_ref(a, b)
    if method == GemmArMethod.PALLAS:
        return gemm_ar(a, b)
    if method == GemmArMethod.XLA_RING:
        raise NotImplementedError(
            "GemmArMethod.XLA_RING (ring GEMM+RS then AG) waits for "
            "ROADMAP A9")
    if method == GemmArMethod.XLA_QINT8:
        raise NotImplementedError(
            "GemmArMethod.XLA_QINT8 (int8 wire) waits for ROADMAP A13")
    raise ValueError(f"unresolved method {method}")


def split_plan(m: int, k: int, n: int, vec: int,
               sm_count: int) -> tuple[int, int]:
    """(k_chunk, splits): cut K so that about _BLOCKS_PER_SM blocks per SM
    run when the (column tile, M tile) grid alone is small."""
    tiles = -(-n // (32 * vec)) * -(-m // min(m, _M_TILE_MAX))
    target = _BLOCKS_PER_SM * sm_count
    splits = max(1, min(-(-target // tiles), k // _K_ROW_STEP))
    k_chunk = -(-k // splits)
    k_chunk = -(-k_chunk // _K_ROW_STEP) * _K_ROW_STEP
    return k_chunk, -(-k // k_chunk)


def splitk_launch(a, b, source: str, symbol: str, what: str):
    """Launch the split-K GEMM of ``csrc/gemm_splitk.cuh`` through the C
    entry point ``symbol`` of ``csrc/<source>.cu`` (B4's td_gemm_ar, B12's
    td_matmul): checks, the K split, the output and f32 workspace."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: a {tuple(a.shape)} @ b {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"{what}: a/b must share one dtype of "
                         f"{list(_DTYPE_CODE)}; got {a.dtype}/{b.dtype}")
    vec = 16 // a.element_size()
    if n % vec or m == 0 or k == 0 or -(-m // _M_TILE_MAX) > 65535:
        raise ValueError(f"{what}: N={n} must be a multiple of {vec}; "
                         f"M={m}, K={k} must be positive (M tiles <= 65535)")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what}: a/b must be contiguous")
    if a.device != b.device:
        raise ValueError(f"{what}: a/b on different devices")
    if b.data_ptr() % 16:
        raise ValueError(f"{what}: b must be 16-byte aligned")
    k_chunk, splits = split_plan(
        m, k, n, vec,
        torch.cuda.get_device_properties(a.device).multi_processor_count)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
            if splits > 1 else None)
    fn = build.function(source, symbol, (
        *(ctypes.c_void_p,) * 4, *(ctypes.c_int,) * 6, ctypes.c_void_p))
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 out.data_ptr(), m, k, n, k_chunk, splits,
                 _DTYPE_CODE[a.dtype], build.stream_of(a))
    build.check(err, what)
    return out
