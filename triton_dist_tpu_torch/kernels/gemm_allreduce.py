"""B4: fused GEMM + allreduce (the reference's kernels/gemm_allreduce.py).

Every rank holds A (M, K_loc) (K sharded over the mesh) and a (K_loc, N)
row shard of B; every rank returns cast(sum over ranks of A_r @ B_r) from
f32 partials: the row-parallel projection of the o and down products.

World 1: the allreduce is the identity, so the op is cast(a @ b) with f32
accumulation. ``gemm_ar`` launches the hand-written CUDA kernel
``csrc/gemm_ar.cu`` (the world-1 body of ``_gemm_ar_kernel``) for CUDA
tensors and runs ``gemm_ar_ref``, its plain version, for CPU tensors.

World n > 1 (``mesh`` is the ranks' Mesh): XLA is the f32 product,
``dist.all_reduce`` in f32 and one cast (the reference's
``psum(part).astype``); PALLAS is ``pallas_gemm_ar``, B4 across ranks: the
kernel of ``csrc/gemm_ar.cu`` (td_gemm_ar_tp) for CUDA tensors, which
stores each tile's f32 partial into every rank's sender-indexed landing
slot and folds slot 0 + ... + slot n-1 (the reference's order, the same on
every rank), and ``gemm_ar_ref_tp`` for CPU tensors, which folds the
ranks' partials in that order.

XLA_RING is the reference's two-shot with GEMM overlap: the XLA_RING
GEMM + ReduceScatter (kernels/gemm_reduce_scatter.py), then the RING_1D
all-gather of the reduced rows (B7 on the card); M must be a multiple of
the world (a ValueError otherwise, the reference's).

XLA_QINT8 is the int8 wire: the f32 product, then the int8 ring
all-reduce of kernels/allreduce.py (QINT8: B27 encodes every hop on the
card) and one cast (QuantContract "gemm_ar"/"xla_qint8"). At an M the
world does not divide, or at world 1, it computes the lossless XLA sum
instead: the reference's own rule, not a device fallback.
``gemm_ar_per_device.qint8_branches`` counts which of the two ran
("ring", "lossless").

There is no fallback between a kernel and its plain version: a CUDA
tensor a kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import enum

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels.plain import (
    all_gather_list, dot_f32, slot_fold,
)
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.symm import op_workspace

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
    """The port's AUTO rule, at every world: PALLAS (the kernel) on CUDA,
    XLA (the plain product and, at n > 1, the process group's all-reduce)
    on the CPU, which the reference also picks off its chip. The
    reference's size table is derived for a TPU's ICI (queue C) and does
    not carry over; a size rule measured on the card is later work."""
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


def _check_tp(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: a {tuple(a.shape)} @ b {tuple(b.shape)}")


def gemm_ar_ref_tp(mesh, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of B4 across ranks: every rank's f32 partial, folded
    slot 0 + slot 1 + ... + slot n-1, one cast."""
    _check_tp(a, b, "gemm_ar")
    parts = all_gather_list(mesh, dot_f32(a, b))
    return slot_fold(parts).to(torch.result_type(a, b))


def gemm_ar_ref_shards(a_shards, b_shards) -> list[torch.Tensor]:
    """Plain version of B4 over every rank's A and B in one process (the
    one-card world): the same output for every rank."""
    out = slot_fold([dot_f32(a, b) for a, b in zip(a_shards, b_shards)])
    out = out.to(torch.result_type(a_shards[0], b_shards[0]))
    return [out] * len(a_shards)


def pallas_gemm_ar(mesh, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B4 across ranks on this rank: cast(sum over ranks of a @ b), a
    (M, K_loc), b (K_loc, N). CUDA tensors launch the kernel (counted in
    ``pallas_gemm_ar.launches``); CPU tensors run ``gemm_ar_ref_tp``.
    Every rank calls it with the same shapes, in the same order."""
    if a.device.type == "cpu":
        return gemm_ar_ref_tp(mesh, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"pallas_gemm_ar: unsupported device {a.device}")
    _check_tp(a, b, "pallas_gemm_ar")
    out = landing_launch(mesh, a, b, a.shape[0], "gemm_ar", "td_gemm_ar_tp",
                         "pallas_gemm_ar")
    pallas_gemm_ar.launches += 1
    return out


pallas_gemm_ar.launches = 0


def gemm_ar_per_device(n: int, method: GemmArMethod, a: torch.Tensor,
                       b: torch.Tensor, mesh=None) -> torch.Tensor:
    """The reference's per-device entry (its mesh axis, TPU tiles and
    interpret flag have nothing to choose here): this rank's a (M, K_loc)
    and b (K_loc, N) -> the (M, N) sum over the n ranks. ``mesh`` (the
    ranks' Mesh) is needed at n > 1."""
    if method == GemmArMethod.AUTO:
        method = get_auto_gemm_ar_method(n, a.device.type == "cuda")
    if method == GemmArMethod.XLA_RING:
        if a.shape[0] % n:
            raise ValueError(
                f"GemmArMethod.XLA_RING requires M ({a.shape[0]}) divisible "
                f"by the axis size ({n}); use PALLAS or XLA")
        from triton_dist_tpu_torch.kernels.allgather import (
            AllGatherMethod, all_gather_per_device,
        )
        from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (
            GemmRsMethod, gemm_rs_per_device,
        )
        scattered = gemm_rs_per_device(n, GemmRsMethod.XLA_RING, a, b,
                                       mesh=mesh)
        return all_gather_per_device(n, AllGatherMethod.RING_1D, scattered,
                                     mesh=mesh)
    if method == GemmArMethod.XLA_QINT8:
        if n > 1 and a.shape[0] % n == 0:
            if mesh is None or mesh.world != n:
                raise ValueError(f"gemm_ar at world {n} needs the mesh of "
                                 f"its {n} ranks; got {mesh}")
            from triton_dist_tpu_torch.kernels.allreduce import (
                qint8_ring_per_device,
            )
            gemm_ar_per_device.qint8_branches["ring"] += 1
            return qint8_ring_per_device(mesh, dot_f32(a, b)).to(
                torch.result_type(a, b))
        # the quantized ring needs rows the world divides: the lossless
        # sum, as the reference does
        gemm_ar_per_device.qint8_branches["lossless"] += 1
        method = GemmArMethod.XLA
    if method not in (GemmArMethod.XLA, GemmArMethod.PALLAS):
        raise ValueError(f"unresolved method {method}")
    if n == 1:
        return gemm_ar(a, b) if method == GemmArMethod.PALLAS else \
            gemm_ar_ref(a, b)
    if mesh is None or mesh.world != n:
        raise ValueError(f"gemm_ar at world {n} needs the mesh of its {n} "
                         f"ranks; got {mesh}")
    if method == GemmArMethod.PALLAS:
        return pallas_gemm_ar(mesh, a, b)
    part = dot_f32(a, b)
    dist.all_reduce(part, group=mesh.group)
    return part.to(torch.result_type(a, b))


gemm_ar_per_device.qint8_branches = {"ring": 0, "lossless": 0}


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


def landing_launch(mesh, a, b, m: int, source: str, symbol: str,
                   what: str):
    """Launch the landing GEMM of ``csrc/gemm_land.cuh`` through the C
    entry point ``symbol`` of ``csrc/<source>.cu`` (B13a's td_gemm_rs: a
    holds n*m rows, rank d keeps rows [d*m, (d+1)*m); B4's td_gemm_ar_tp:
    a holds m rows, every rank keeps them): checks, the K split, this op's
    landing slots (n, m, N) f32 with their control block, the output
    (m, N) and the f32 K-slice workspace."""
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"{what}: a/b must share one dtype of "
                         f"{list(_DTYPE_CODE)}; got {a.dtype}/{b.dtype}")
    a = a.contiguous()
    if not b.is_contiguous() or b.data_ptr() % 16:
        raise ValueError(f"{what}: b contiguous, 16-byte aligned")
    world, (rows, k), n_cols = mesh.world, a.shape, b.shape[1]
    vec = 16 // a.element_size()
    if n_cols % vec:
        raise ValueError(f"{what}: N={n_cols} must be a multiple of {vec}")
    # the kernel's per-tile K-slice counters: one per (row, 32-vector
    # column tile) covers any row tile it picks
    tiles = rows * -(-n_cols // (32 * vec))
    ws = op_workspace(mesh, (source, m, n_cols, a.dtype),
                      (world, m, n_cols), torch.float32, ctl_words=tiles)
    k_chunk, splits = split_plan(
        rows, k, n_cols, vec,
        torch.cuda.get_device_properties(a.device).multi_processor_count)
    out = torch.empty((m, n_cols), dtype=a.dtype, device=a.device)
    part = torch.empty((splits, rows, n_cols), dtype=torch.float32,
                       device=a.device)
    fn = build.function(source, symbol, (
        *(ctypes.c_void_p,) * 4, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        *(ctypes.c_int,) * 7, ctypes.c_void_p))
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), part.data_ptr(),
                 out.data_ptr(), mesh.rank, world, ws.buf.table.data_ptr(),
                 ws.buf.sig_off, ws.ctl.data_ptr(), m, k, n_cols, k_chunk,
                 splits, mesh.ranks_per_device, _DTYPE_CODE[a.dtype],
                 build.stream_of(a))
    build.check(err, what)
    return out
