"""Low-latency all-to-all (the reference's kernels/low_latency_all_to_all.py):
the padded-slot exchange of the expert-parallel dispatch and combine.

Every rank holds x (n, max_m, K): slot p holds the rows for peer p, padded
to max_m. After the exchange slot s holds what rank s sent here (the
tiled ``lax.all_to_all`` layout, NCCL's ``all_to_all_single``); bytes are
moved unchanged. At world n > 1 (``mesh`` is the ranks' Mesh):

  * B17, ``fast_all_to_all_per_device``: the hand-written CUDA kernel
    ``csrc/ep_a2a.cu`` for CUDA tensors (each block pushes its contiguous
    share of slot p into peer p's landing slot `rank`; landing slots
    double-buffered by the epoch's parity; by a slot's bytes, LL lines
    that carry the epoch or plain stores and one epoch flag per (block,
    sender): ``a2a_plan``), ``plain.all_to_all_slots`` (the process
    group's all_to_all_single) for CPU tensors;
  * B18, ``fast_all_to_all_q_per_device``: the same kernel over two
    payloads in one launch, the fp8 rows and their packed f32 scales
    (``pack_scales``), both under the first payload's protocol.

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
import dataclasses
import functools

import torch

from triton_dist_tpu_torch.kernels.plain import all_to_all_slots
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.mesh import comm_axis_size
from triton_dist_tpu_torch.runtime.symm import op_workspace

_LANE = 128             # packed scales per row (the reference's lane tile)
_ALIGN = 256
_NT = 256               # threads a block (csrc/ep_a2a.cu NT)
_BLOCK_BYTES = 8192     # flags: bytes of the slots each block aims to own
_BLOCKS_PER_SM = 4      # flags: a light copy kernel, 4 blocks of 256 fit
# B17 / B18 protocol: LL lines (the epoch in every 16-byte line, no fence,
# no flag) while a slot of the first payload (one rank's rows for one
# peer) holds at most this many bytes, flags above. Four H100s (NVIDIA
# H100 80GB HBM3, 700.00 W; chip_compare.py --bidir --sweep, the slowest
# rank, rows of 2,048 bf16, each protocol on its own grid), LL against
# flags at 16 / 32 / 64 / 128 / 256 rows (64 KiB-1 MiB a slot): 0.0080 /
# 0.0102 / 0.0146 / 0.0262 / 0.0340 ms against 0.0104 / 0.0106 / 0.0128
# / 0.0184 / 0.0234.
A2A_LL_MAX_SLOT_BYTES = 128 * 1024


def _round_up(x: int, a: int = _ALIGN) -> int:
    return -(-x // a) * a


@dataclasses.dataclass(frozen=True)
class A2aPlan:
    """What a launch of B17 (rows1 == 0) or B18 passes besides its
    tensors, the same on every rank of a world. grid: blocks, block b
    owning vectors [b V / grid, (b + 1) V / grid) of every slot of V
    vectors of each payload. ll: LL lines (32 bytes a 16-byte vector) or
    plain vectors and flags. land0 / land1: byte offsets of the payloads'
    landing slots (2, n) [parity][sender] of rows x row bytes (doubled
    under LL). flag_off: the u64 flags (grid, n - 1) (none under LL).
    nbytes: the symmetric buffer; the control block holds an epoch word a
    block."""
    rows0: int
    kv0: int
    rows1: int
    kv1: int
    grid: int
    ll: bool
    land0: int
    land1: int
    flag_off: int
    nbytes: int


def a2a_layout(world: int, rows0: int, row_bytes0: int, rows1: int,
               row_bytes1: int, grid: int, ll: bool) -> A2aPlan:
    """The regions of B17 / B18 on `grid` blocks under the protocol ``ll``:
    payload 0's slots from byte 0, payload 1's, then the flags."""
    wide = 2 if ll else 1
    land1 = _round_up(2 * world * rows0 * row_bytes0 * wide)
    flag_off = _round_up(land1 + 2 * world * rows1 * row_bytes1 * wide)
    nbytes = flag_off + (0 if ll else 8 * grid * (world - 1))
    return A2aPlan(rows0, row_bytes0 // 16, rows1, max(row_bytes1 // 16, 1),
                   grid, ll, 0, land1, flag_off, nbytes)


@functools.lru_cache(maxsize=None)
def a2a_plan(world: int, rows0: int, row_bytes0: int, rows1: int,
             row_bytes1: int, sm_count: int,
             ranks_per_device: int) -> A2aPlan:
    """The plan of B17 / B18 at slots of rows0 rows of row_bytes0 (and
    rows1 of row_bytes1): LL while a slot of the first payload holds at
    most A2A_LL_MAX_SLOT_BYTES, a vector a thread of each slot (~4 KiB of
    a slot a block, as B7's plan), at most one block an SM per rank that
    shares the card; under flags ~_BLOCK_BYTES of the slots a block, up to
    _BLOCKS_PER_SM blocks an SM per rank. Every grid is at most one block
    a vector of the first payload's slot."""
    vectors = rows0 * row_bytes0 // 16
    ll = rows0 * row_bytes0 <= A2A_LL_MAX_SLOT_BYTES
    if ll:
        grid = min(-(-vectors // _NT), sm_count // ranks_per_device)
    else:
        grid = min(-(-world * rows0 * row_bytes0 // _BLOCK_BYTES),
                   _BLOCKS_PER_SM * sm_count // ranks_per_device)
    return a2a_layout(world, rows0, row_bytes0, rows1, row_bytes1,
                      max(1, min(grid, vectors)), ll)


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


def _plan_of(mesh, rows0: int, row_bytes0: int, rows1: int,
             row_bytes1: int) -> A2aPlan:
    sms = torch.cuda.get_device_properties(mesh.device).multi_processor_count
    return a2a_plan(mesh.world, rows0, row_bytes0, rows1, row_bytes1, sms,
                    mesh.ranks_per_device)


def _workspace(mesh, plan: A2aPlan):
    """B17's or B18's workspace on this rank under ``plan``."""
    return op_workspace(mesh, ("ll_a2a", plan), (plan.nbytes,), torch.uint8,
                        ctl_words=plan.grid)


def prepare(mesh, x: torch.Tensor) -> None:
    """Make B17's workspace for slots shaped like x (n, max_m, K) before
    a spinning kernel runs (B16 and B18 are followed by B17's combine in a
    layer; in the one-card world an allocation behind a spinning kernel
    waits for ranks not yet launched). A no-op off CUDA and at world 1."""
    if x.is_cuda and mesh is not None and mesh.world > 1:
        _workspace(mesh, _plan_of(mesh, x.shape[1],
                                  x.shape[2] * x.element_size(), 0, 0))


def _launch(mesh, x: torch.Tensor, s: torch.Tensor | None,
            plan: A2aPlan | None = None):
    """Launch B17 (s None) or B18 on this rank's slots, under their plan
    (chip_smoke.py's protocol sweep forces one through ``a2a_layout``)."""
    n = mesh.world
    rb0 = _check_slots(x, n, "fast_all_to_all")
    rows1, rb1 = 0, 0
    if s is not None:
        rb1 = _check_slots(s, n, "fast_all_to_all_q scales")
        rows1 = s.shape[1]
    if plan is None:
        plan = _plan_of(mesh, x.shape[1], rb0, rows1, rb1)
    ws = _workspace(mesh, plan)
    out = torch.empty_like(x)
    out_s = torch.empty_like(s) if s is not None else None
    fn = build.function("ep_a2a", "td_ll_a2a", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), plan.rows0, plan.kv0,
                 plan.land0, s.data_ptr() if s is not None else None,
                 out_s.data_ptr() if s is not None else None, plan.rows1,
                 plan.kv1, plan.land1, mesh.rank, n,
                 ws.buf.table.data_ptr(), ws.ctl.data_ptr(), plan.flag_off,
                 plan.grid, int(plan.ll), mesh.ranks_per_device,
                 build.stream_of(x))
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
