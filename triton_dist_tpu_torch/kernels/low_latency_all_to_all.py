"""Low-latency all-to-all (the reference's kernels/low_latency_all_to_all.py):
the padded-slot exchange of the expert-parallel dispatch and combine.

Every rank holds x (n, max_m, K): slot p holds the rows for peer p, padded
to max_m. After the exchange slot s holds what rank s sent here (the
tiled ``lax.all_to_all`` layout, NCCL's ``all_to_all_single``); bytes are
moved unchanged. At world n > 1 (``mesh`` is the ranks' Mesh):

  * B17, ``fast_all_to_all_per_device``: the hand-written CUDA kernel
    ``csrc/ep_a2a.cu`` for CUDA tensors (each block pushes its contiguous
    share of slot p into peer p's landing slot `rank` with 16-byte stores
    and raises one epoch flag per (block, sender); landing slots
    double-buffered by the epoch's parity), ``plain.all_to_all_slots``
    (the process group's all_to_all_single) for CPU tensors;
  * B18, ``fast_all_to_all_q_per_device``: the same kernel over two
    payloads in one launch, the fp8 rows and their packed f32 scales
    (``pack_scales``), under one flag per (block, sender).

``quantize_rows`` / ``dequantize_rows`` (the reference's per-row
symmetric fp8 codec) stay outside the kernel, as in the reference. The
mesh-level ``fast_all_to_all`` and ``fast_all_to_all_quantized`` are
called by every rank on its (n, max_m, K) slots; they have no fallback
(ROADMAP queue C) and no fault preamble (ROADMAP A8). At world 1 the
exchange is the identity. No fallback: a CUDA tensor the kernel does not
take raises.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels.plain import all_to_all_slots
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.mesh import comm_axis_size
from triton_dist_tpu_torch.runtime.symm import op_workspace

_LANE = 128             # packed scales per row (the reference's lane tile)
_ALIGN = 256
_BLOCK_BYTES = 8192     # bytes of the slots each block aims to own
_BLOCKS_PER_SM = 4      # a light copy kernel: 4 blocks of 256 threads fit


def _round_up(x: int, a: int = _ALIGN) -> int:
    return -(-x // a) * a


def _check_slots(x: torch.Tensor, n: int, what: str) -> int:
    """Row bytes of n padded slots x (n, rows, K) the kernel can take:
    contiguous, 16-byte aligned, rows a multiple of 16 bytes. Raises
    otherwise."""
    if x.ndim != 3 or x.shape[0] != n or not x.is_contiguous() or \
            x.data_ptr() % 16 or x.numel() == 0 or \
            (x.shape[2] * x.element_size()) % 16:
        raise ValueError(f"{what}: want contiguous ({n}, rows, K) slots, "
                         "16-byte aligned, rows a multiple of 16 bytes; got "
                         f"{tuple(x.shape)} {x.dtype}")
    return x.shape[2] * x.element_size()


def _workspace(mesh, rows0: int, row_bytes0: int, rows1: int,
               row_bytes1: int):
    """B17's (rows1 == 0) or B18's workspace on this rank: the two
    payloads' landing slots (2, n, rows, row bytes) and the flags (grid,
    n). Returns (ws, grid, land0, land1, flag_off)."""
    n = mesh.world
    kv0 = row_bytes0 // 16
    sms = torch.cuda.get_device_properties(mesh.device).multi_processor_count
    # about _BLOCK_BYTES of the slots a block, at most one vector of a
    # slot each, every rank sharing the card resident at once
    grid = max(1, min(-(-n * rows0 * row_bytes0 // _BLOCK_BYTES),
                      rows0 * kv0,
                      _BLOCKS_PER_SM * sms // mesh.ranks_per_device))
    land1 = _round_up(2 * n * rows0 * row_bytes0)
    flag_off = _round_up(land1 + 2 * n * rows1 * row_bytes1)
    ws = op_workspace(mesh, ("ll_a2a", rows0, row_bytes0, rows1, row_bytes1),
                      (flag_off + grid * n * 8,), torch.uint8)
    return ws, grid, 0, land1, flag_off


def prepare(mesh, x: torch.Tensor) -> None:
    """Make B17's workspace for slots shaped like x (n, max_m, K) before
    a spinning kernel runs (B16 and B18 are followed by B17's combine in a
    layer; in the one-card world an allocation behind a spinning kernel
    waits for ranks not yet launched). A no-op off CUDA and at world 1."""
    if x.is_cuda and mesh is not None and mesh.world > 1:
        _workspace(mesh, x.shape[1], x.shape[2] * x.element_size(), 0, 0)


def _launch(mesh, x: torch.Tensor, s: torch.Tensor | None):
    n = mesh.world
    rb0 = _check_slots(x, n, "fast_all_to_all")
    rows1, rb1 = 0, 0
    if s is not None:
        rb1 = _check_slots(s, n, "fast_all_to_all_q scales")
        rows1 = s.shape[1]
    ws, grid, land0, land1, flag_off = _workspace(mesh, x.shape[1], rb0,
                                                  rows1, rb1)
    out = torch.empty_like(x)
    out_s = torch.empty_like(s) if s is not None else None
    fn = build.function("ep_a2a", "td_ll_a2a", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p))
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), x.shape[1], rb0 // 16, land0,
                 s.data_ptr() if s is not None else None,
                 out_s.data_ptr() if s is not None else None, rows1,
                 max(rb1 // 16, 1), land1, mesh.rank, n,
                 ws.buf.table.data_ptr(), ws.ctl.data_ptr(), flag_off, grid,
                 mesh.ranks_per_device, build.stream_of(x))
    build.check(err, "fast_all_to_all")
    return out, out_s


def fast_all_to_all_per_device(mesh, x: torch.Tensor) -> torch.Tensor:
    """B17 on this rank: x (n, max_m, K), slot p for peer p -> (n, max_m,
    K), slot s what rank s sent, a fresh tensor (x itself at world 1).
    CUDA tensors launch the kernel (counted in
    ``fast_all_to_all_per_device.launches``); CPU tensors run
    ``plain.all_to_all_slots``. Every rank calls it with the same shape,
    in the same order."""
    if mesh is None or mesh.world == 1:
        return x
    if x.device.type == "cpu":
        return all_to_all_slots(mesh, x)
    if x.device.type != "cuda":
        raise ValueError(f"fast_all_to_all: unsupported device {x.device}")
    out, _ = _launch(mesh, x, None)
    fast_all_to_all_per_device.launches += 1
    return out


fast_all_to_all_per_device.launches = 0


def fast_all_to_all_q_per_device(mesh, x: torch.Tensor,
                                 scales: torch.Tensor):
    """B18 on this rank: x (n, max_m, K) in a narrow dtype (fp8) and its
    packed scales (n, ceil(max_m / 128), 128) f32 (``pack_scales``) ->
    the exchanged pair, in one launch (counted in
    ``fast_all_to_all_q_per_device.launches``); CPU tensors run
    ``plain.all_to_all_slots`` on each payload. The identity at world
    1."""
    if mesh is None or mesh.world == 1:
        return x, scales
    if x.device.type == "cpu":
        return all_to_all_slots(mesh, x), all_to_all_slots(mesh, scales)
    if x.device.type != "cuda":
        raise ValueError(f"fast_all_to_all_q: unsupported device "
                         f"{x.device}")
    if scales.dtype != torch.float32 or scales.device != x.device or \
            scales.shape[:1] != x.shape[:1] or scales.shape[2] != _LANE:
        raise ValueError(f"fast_all_to_all_q: scales must be ({x.shape[0]}, "
                         f"rows, {_LANE}) f32 on {x.device}; got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    out = _launch(mesh, x, scales)
    fast_all_to_all_q_per_device.launches += 1
    return out


fast_all_to_all_q_per_device.launches = 0


def pack_scales(scale: torch.Tensor) -> torch.Tensor:
    """(n, max_m) f32 per-row scales -> (n, ceil(max_m / 128), 128), the
    pad 0: one f32 a row on the wire."""
    n, max_m = scale.shape
    rows = -(-max_m // _LANE)
    padded = torch.nn.functional.pad(scale, (0, rows * _LANE - max_m))
    return padded.reshape(n, rows, _LANE)


def unpack_scales(packed: torch.Tensor, max_m: int) -> torch.Tensor:
    return packed.reshape(packed.shape[0], -1)[:, :max_m]


def quantize_rows(x: torch.Tensor, dtype) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Per-row symmetric quantization: x (..., K) -> (q in ``dtype``,
    scale (...,) f32) with q * scale ~= x; scale = max(amax / max(dtype),
    1e-12), q = cast(x / scale) (round to nearest even)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / float(torch.finfo(dtype).max), min=1e-12)
    return (xf / scale[..., None]).to(dtype), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


def fast_all_to_all(mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """The mesh-level all-to-all of max_m-padded slots (the reference's
    ``fast_all_to_all``), called by every rank on its (n, max_m, K) slots:
    B17 on the card, its plain version on the CPU."""
    comm_axis_size(mesh, axis)
    return fast_all_to_all_per_device(mesh, x)


def fast_all_to_all_quantized(mesh, axis: str, x: torch.Tensor,
                              wire_dtype=None) -> torch.Tensor:
    """The mesh-level quantized all-to-all (the reference's
    ``fast_all_to_all_quantized``): per-row ``wire_dtype`` rows (default
    fp8 e4m3) and their f32 scales through B18 in one launch, then
    dequantized to x's dtype. Same slot semantics as ``fast_all_to_all``;
    one quantization event a row."""
    comm_axis_size(mesh, axis)
    wire_dtype = wire_dtype or torch.float8_e4m3fn
    q, scale = quantize_rows(x, wire_dtype)
    rq, rs = fast_all_to_all_q_per_device(mesh, q, pack_scales(scale))
    return dequantize_rows(rq, unpack_scales(rs, x.shape[1]), x.dtype)
