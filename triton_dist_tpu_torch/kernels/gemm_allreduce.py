"""B4: fused GEMM + allreduce (the reference's kernels/gemm_allreduce.py).

Every rank holds A (M, K_loc) (K sharded over the mesh) and a (K_loc, N)
row shard of B; every rank returns cast(sum over ranks of A_r @ B_r) from
f32 partials: the row-parallel projection of the o and down products.

World 1: the allreduce is the identity, so the op is cast(a @ b) with f32
accumulation. ``gemm_ar`` launches the hand-written CUDA kernel
``csrc/gemm_ar.cu`` (the world-1 body of ``_gemm_ar_kernel``) for CUDA
tensors and runs ``gemm_ar_ref``, its plain version, for CPU tensors. In
bf16 that kernel is the Hopper decode GEMM of
``csrc/gemm_stream_sm90.cuh`` (B12's too), cut by ``stream_plan``; in f32
the split-K FMA GEMM of ``csrc/gemm_splitk.cuh``, cut by ``split_plan``.

World n > 1 (``mesh`` is the ranks' Mesh): XLA is the f32 product,
``dist.all_reduce`` in f32 and one cast (the reference's
``psum(part).astype``); PALLAS is ``pallas_gemm_ar``, B4 across ranks: the
kernel of ``csrc/gemm_ar.cu`` (td_gemm_ar_tp) for CUDA tensors, and
``gemm_ar_ref_tp`` for CPU tensors, which folds the ranks' partials in the
kernel's order. The kernel is one pass over the weight shard (bf16: the
stream GEMM of ``csrc/gemm_stream_sm90.cuh``) whose warps store each
finished tile's f32 rows into this rank's landing slot on every rank, and
every rank folds slot 0 + ... + slot n-1 (the reference's order, the same
on every rank) with one cast: ``csrc/gemm_land_stream.cuh``, cut by
``ar_plan`` (``land_layout``, shared with B13b).

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
import dataclasses
import enum
import functools

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

# csrc/gemm_stream_sm90.cuh: the bf16 kernel's tile (its NBX * BOX, BK)
STREAM_BN = 128       # columns of W a tile
STREAM_BK = 128       # K rows a tile
_TICKET_WORDS = 4096  # ticket words a device keeps (4 a block)
_ALIGN = 256
_TICKETS: dict = {}   # device -> its int32 tickets


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
    (M, K_loc), b (K_loc, N). CUDA tensors launch the kernel under
    ``ar_plan`` (counted in ``pallas_gemm_ar.launches``); CPU tensors run
    ``gemm_ar_ref_tp``. Every rank calls it with the same shapes, in the
    same order."""
    if a.device.type == "cpu":
        return gemm_ar_ref_tp(mesh, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"pallas_gemm_ar: unsupported device {a.device}")
    what = "pallas_gemm_ar"
    _check_tp(a, b, what)
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"{what}: a/b must share one dtype of "
                         f"{list(_DTYPE_CODE)}; got {a.dtype}/{b.dtype}")
    if not b.is_contiguous() or b.data_ptr() % 16:
        raise ValueError(f"{what}: b contiguous, 16-byte aligned")
    vec = 16 // a.element_size()
    if b.shape[1] % vec or a.shape[0] == 0:
        raise ValueError(f"{what}: N={b.shape[1]} must be a multiple of "
                         f"{vec}, M={a.shape[0]} positive")
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    plan = ar_plan(mesh.world, a.shape[0], a.shape[1], b.shape[1],
                   a.element_size(), sms, mesh.ranks_per_device)
    out = _launch_ar(mesh, a.contiguous(), b, plan)
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


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """The cut of the bf16 kernel's launch (csrc/gemm_stream_sm90.cuh
    computes the same from M, K, N and grid): units (M group of mg rows,
    column tile of STREAM_BN, K tile of STREAM_BK) in that order, block b
    taking [b * units // grid, (b + 1) * units // grid)."""
    m: int
    k: int
    n: int
    mg: int          # rows an M group: 8 up to M = 8, else 16
    n_tiles: int     # column tiles
    n_kt: int        # K tiles
    n_mg: int        # M groups
    units: int
    grid: int        # blocks: min(SMs, units)
    ws_floats: int   # f32 workspace: 2 slots a block x STREAM_BN x mg


def stream_plan(m: int, k: int, n: int, sm_count: int) -> StreamPlan:
    """The bf16 kernel's cut: at most one block an SM, the units spread
    evenly (a block's count differs from another's by at most one)."""
    mg = 8 if m <= 8 else 16
    n_tiles, n_kt, n_mg = -(-n // STREAM_BN), -(-k // STREAM_BK), -(-m // mg)
    units = n_mg * n_tiles * n_kt
    grid = min(sm_count, units)
    return StreamPlan(m, k, n, mg, n_tiles, n_kt, n_mg, units, grid,
                      2 * grid * STREAM_BN * mg)


def _tickets(device) -> torch.Tensor:
    """The device's ticket words: zero, and left zero by every call. Made
    on first use, never under CUDA-graph capture (the warm-up call before
    a capture makes it)."""
    t = _TICKETS.get(device)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("gemm tickets: first call under CUDA-graph "
                               "capture; warm up before capturing")
        t = _TICKETS[device] = torch.zeros(_TICKET_WORDS, dtype=torch.int32,
                                           device=device)
    return t


def splitk_launch(a, b, source: str, symbol: str, what: str):
    """Launch the world-1 GEMM through the C entry point ``symbol`` of
    ``csrc/<source>.cu`` (B4's td_gemm_ar, B12's td_matmul): checks, then
    in bf16 the Hopper kernel's plan, workspace and tickets, in f32 the K
    split and the f32 (splits, M, N) workspace; the output."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: a {tuple(a.shape)} @ b {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"{what}: a/b must share one dtype of "
                         f"{list(_DTYPE_CODE)}; got {a.dtype}/{b.dtype}")
    vec = 16 // a.element_size()
    if n % vec or m == 0 or k == 0 or -(-m // _M_TILE_MAX) > 65535:
        raise ValueError(f"{what}: N={n} must be a multiple of {vec} (bf16: "
                         f"the TMA map's row stride, 16-byte units); M={m}, "
                         f"K={k} must be positive (M tiles <= 65535)")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what}: a/b must be contiguous")
    if a.device != b.device:
        raise ValueError(f"{what}: a/b on different devices")
    if b.data_ptr() % 16:
        raise ValueError(f"{what}: b must be 16-byte aligned (bf16: the TMA "
                         f"map's base address)")
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    tickets, grid = None, 0
    if a.dtype == torch.bfloat16:
        plan = stream_plan(m, k, n, sms)
        k_chunk, splits, grid = 0, 0, plan.grid
        part = torch.empty((plan.ws_floats,), dtype=torch.float32,
                           device=a.device)
        tickets = _tickets(a.device)
    else:
        k_chunk, splits = split_plan(m, k, n, vec, sms)
        part = (torch.empty((splits, m, n), dtype=torch.float32,
                            device=a.device) if splits > 1 else None)
    fn = build.function(source, symbol, (
        *(ctypes.c_void_p,) * 5, *(ctypes.c_int,) * 7, ctypes.c_void_p))
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 tickets.data_ptr() if tickets is not None else None,
                 out.data_ptr(), m, k, n, k_chunk, splits, grid,
                 _DTYPE_CODE[a.dtype], build.stream_of(a))
    build.check(err, what)
    return out


def landing_launch(mesh, a, b, m: int, source: str, symbol: str,
                   what: str):
    """Launch B13a's landing GEMM (``csrc/gemm_land.cuh``: the split-K
    FMA GEMM whose last K slice of a tile stores its f32 rows into the
    owner's slot, an opening barrier and a data flag per rank) through the
    C entry point ``symbol`` of ``csrc/<source>.cu`` (td_gemm_rs: a holds
    n*m rows, rank d keeps rows [d*m, (d+1)*m)): checks, the K split, this
    op's landing slots (n, m, N) f32 with their control block, the output
    (m, N) and the f32 K-slice workspace. B4 across ranks and B13b land
    the stream GEMM's tiles in one hop instead (``_launch_land``)."""
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


# B4's protocol: LL lines (the epoch in every 16-byte line, no fence, no
# flag, twice the bytes) while a slot (one sender's m rows of N f32, which
# every rank receives from every sender) holds at most this many bytes,
# flags above. Four H100s (NVIDIA H100 80GB HBM3, 700.00 W;
# chip_compare.py --ar --sweep, the slowest rank, Qwen3-32B's o, K 2,048,
# N 5,120 bf16), LL against flags at 4 / 8 / 16 / 32 / 64 rows (80 KiB -
# 1.25 MiB a slot): 0.0159 / 0.0210 / 0.0290 / 0.0432 / 0.0791 ms
# against 0.0219 / 0.0240 / 0.0295 / 0.0346 / 0.0602.
AR_LL_MAX_SLOT_BYTES = 320 * 1024
_F32_TILE = 32 * 4     # gemm_splitk.cuh's f32 column tile (32 lanes x 4)


@dataclasses.dataclass(frozen=True)
class LandPlan:
    """What a launch of the one-hop landing GEMM (csrc/gemm_land_stream.cuh:
    B13b, B4 across ranks) passes besides its tensors, the same on every
    rank of a world. rows: the product's rows (B13b world * m, B4 m); m:
    the rows a rank keeps (B13b its chunk, B4 all). rg: rows a landing
    group, the GEMM's row tile (bf16: the stream kernel's M group, 8 up to
    8 rows, else 16; f32: gemm_splitk.cuh's row tile, 1, 2, 4 or 8). grid:
    blocks, at most one an SM per rank that shares the card. ll: LL lines
    or flags. slot_bytes: one sender's m rows on a rank that keeps them;
    slot (P, s) of parity P and sender s at byte (P world + s) slot_bytes.
    flag_off: the flags, u64 (world, groups, quarters) (none under LL).
    nbytes: the symmetric buffer. ctl_words: the control block after its
    header: an epoch word a block, then bf16: the stream kernel's tickets
    (4 int32 a block), f32: a counter per tile. part_floats: the per-call
    f32 workspace. k_chunk, splits: the f32 K split (0 in bf16). whole:
    bf16 at many M groups (prefill): block b takes whole tiles b, b +
    grid, ... column-tile major instead of the stream-K cut (the C
    launcher's rule)."""
    rows: int
    m: int
    n: int
    rg: int
    grid: int
    ll: bool
    slot_bytes: int
    flag_off: int
    nbytes: int
    ctl_words: int
    part_floats: int
    k_chunk: int
    splits: int
    whole: bool = False

    @property
    def groups(self) -> int:
        return -(-self.rows // self.rg)

    @property
    def quarters(self) -> int:
        return -(-self.n // 32)


def _f32_row_tile(rows: int) -> int:
    return 1 if rows == 1 else 2 if rows == 2 else 4 if rows <= 4 else 8


def land_layout(world: int, rows: int, m: int, k: int, n: int, bf16: bool,
                sm_count: int, ranks_per_device: int, ll: bool) -> LandPlan:
    """The one-hop landing GEMM's plan for a product of ``rows`` rows,
    K x N, whose ranks keep m rows each, under the protocol ``ll``."""
    sms = max(1, sm_count // ranks_per_device)
    whole = False
    if bf16:
        sp = stream_plan(rows, k, n, sms)
        rg, grid, part = sp.mg, sp.grid, sp.ws_floats
        after, k_chunk, splits = 2 * grid, 0, 0
        tiles = sp.n_mg * sp.n_tiles
        whole = tiles > sp.n_tiles and tiles >= 4 * grid
    else:
        rg = _f32_row_tile(rows)
        k_chunk, splits = split_plan(rows, k, n, 4, sm_count)
        tiles = -(-rows // rg) * -(-n // _F32_TILE)
        grid = min(tiles * splits, sms)
        after, part = tiles, splits * rows * n
    slot_bytes = m * n * 4 * (2 if ll else 1)
    data = 2 * world * slot_bytes
    flag_off = -(-data // _ALIGN) * _ALIGN
    flags = 0 if ll else 8 * world * -(-rows // rg) * -(-n // 32)
    return LandPlan(rows, m, n, rg, grid, ll, slot_bytes, flag_off,
                    flag_off + flags, grid + after, part, k_chunk, splits,
                    whole)


def ar_layout(world: int, m: int, k: int, n: int, bf16: bool,
              sm_count: int, ranks_per_device: int, ll: bool) -> LandPlan:
    """B4's plan across ranks at m rows, K x N, under the protocol ``ll``:
    every rank keeps all m rows."""
    return land_layout(world, m, m, k, n, bf16, sm_count, ranks_per_device,
                       ll)


@functools.lru_cache(maxsize=None)
def ar_plan(world: int, m: int, k: int, n: int, itemsize: int,
            sm_count: int, ranks_per_device: int) -> LandPlan:
    """B4's plan across ranks for a (m, K) against W (K, N) (itemsize 2:
    bf16, 4: f32): LL while a slot holds at most AR_LL_MAX_SLOT_BYTES.
    The o and down projections at one decode batch get the same plan
    (their K tiles outnumber the blocks either way), and so one
    workspace."""
    return ar_layout(world, m, k, n, itemsize == 2, sm_count,
                     ranks_per_device, m * n * 4 <= AR_LL_MAX_SLOT_BYTES)


def _launch_land(mesh, a: torch.Tensor, b: torch.Tensor, plan: LandPlan,
                 source: str, symbol: str, what: str) -> torch.Tensor:
    """The one-hop landing GEMM's launch through the C entry point
    ``symbol`` of ``csrc/<source>.cu`` (B4's td_gemm_ar_tp, B13b's
    td_gemm_rs_bidir) under a given plan (the protocol sweeps force one
    through ``ar_layout`` / ``bidir_layout``). The plan's symmetric buffer
    is made at its first call (a collective allocation; never under
    capture): a workspace per (op, dtype, plan)."""
    ws = op_workspace(mesh, (symbol, a.dtype, plan), (plan.nbytes,),
                      torch.uint8, ctl_words=plan.ctl_words)
    out = torch.empty((plan.m, plan.n), dtype=a.dtype, device=a.device)
    part = torch.empty((plan.part_floats,), dtype=torch.float32,
                       device=a.device)
    fn = build.function(source, symbol, (
        *(ctypes.c_void_p,) * 4, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, *(ctypes.c_int,) * 5,
        ctypes.c_longlong, ctypes.c_longlong, *(ctypes.c_int,) * 5,
        ctypes.c_void_p))
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), part.data_ptr(),
                 out.data_ptr(), mesh.rank, mesh.world,
                 ws.buf.table.data_ptr(), ws.ctl.data_ptr(), plan.m,
                 a.shape[1], plan.n, plan.rg, int(plan.ll), plan.slot_bytes,
                 plan.flag_off, plan.grid, plan.k_chunk, plan.splits,
                 mesh.ranks_per_device, _DTYPE_CODE[a.dtype],
                 build.stream_of(a))
    build.check(err, what)
    return out


def _launch_ar(mesh, a: torch.Tensor, b: torch.Tensor,
               plan: LandPlan) -> torch.Tensor:
    """B4's launch across ranks under a given plan (the protocol checks
    and sweep force one through ``ar_layout``)."""
    return _launch_land(mesh, a, b, plan, "gemm_ar", "td_gemm_ar_tp",
                        "pallas_gemm_ar")
