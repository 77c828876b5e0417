"""B2: paged split-KV flash decode (the reference's
kernels/paged_flash_decode.py over its Pallas _paged_decode_kernel).

``paged_flash_decode_partial`` launches the hand-written CUDA kernel
``csrc/paged_flash_decode.cu`` for CUDA tensors and runs
``paged_flash_decode_partial_ref``, its plain PyTorch version, for CPU
tensors. There is no fallback between the two: a CUDA tensor the kernel
does not take raises, and so does a build or launch failure.

Routes of a CUDA launch (D in {64, 128}, g = Hq / Hkv in {1, 2, 4, 8};
anything else raises):

  * bf16 q and bf16 pools, page size a multiple of 64 or one of 8, 16,
    32: the Hopper kernel (``csrc/decode_tile_sm90.cuh``, shared with
    B19), cut by ``paged_plan``: each (row, kv head) split into
    ``splits`` runs of ``pages`` whole logical pages, a block each, the
    grid fixed by B, Hkv, the table's width, the page size and the SM
    count (never by ``lengths``, which the kernel reads on the device),
    the live splits merged by exact LSE in ascending order inside the
    launch;
  * f32 q and pools (the f32 gates), f32 or bf16 q over int8 pools with
    f32 row scales (the int8-resident mode), and bf16 pools of other page
    sizes (24, 48, 96, ...): the FMA body, a block a (row, kv head)
    walking its pages in order (``paged_route`` picks; a page size whose
    FMA body needs more shared memory than a block has raises).

Pool layout (head-major): (Hkv, P, page_size, D); int8-resident pools add
(Hkv, P, page_size) f32 row-scale slabs. The plain version repeats the
TPU kernel's fold page by page: live pages only, table values clamped to
[0, P-1], NEG_INF past ``lengths``, the K scale on the scores after QK^T
and the V scale on the probability row after l is summed, bf16 rounding
of the probabilities only when V is bf16.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from triton_dist_tpu_torch.kernels.flash_attention import NEG_INF, p_cast
from triton_dist_tpu_torch.runtime import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (64, 128)
_GROUPS = (1, 2, 4, 8)       # Hq/Hkv values the kernel is built for
_MAX_SMEM = 232448          # bytes of shared memory a Hopper block may use
# the bf16 kernel (csrc/decode_tile_sm90.cuh, csrc/paged_flash_decode.cu)
PAGED_TILE = 64             # keys a TMA tile (KT)
PAGED_STAGES = 4            # tiles in flight a block (STAGES)
PAGED_GROUPS = 4            # consumer warps, 16 keys of every tile each
PAGED_SMALL_PAGES = (8, 16, 32)   # page sizes under a tile: a box a page
PAGED_MAX_SPLIT_PAGES = 8192      # table entries a split stages in smem
_WORKSPACES: dict = {}      # (device, stream, B, Hkv, splits, g, D) ->
                            # (partials, tickets) of the bf16 kernel
_SMS: dict = {}             # device -> its SM count


@dataclass(frozen=True)
class PagedPlan:
    """How B2's bf16 kernel cuts one launch: block (split, kv head, row)
    folds the row's logical pages [split * pages, (split + 1) * pages)
    that lie before ceil(len / ps), ``tile`` keys at a time (TMA boxes of
    ``box`` = min(ps, tile) rows, one a page; PAGED_STAGES tiles in
    flight; each tile's keys dealt in PAGED_GROUPS runs to warps that
    merge by exact LSE, warp 0 first); the row's live splits then merge
    in ascending order by exact LSE."""
    pages: int
    splits: int
    box: int
    tile: int


def paged_route(kv_dtype, page_size: int) -> str:
    """The body that decodes a pool (csrc/paged_flash_decode.cu takes the
    same choice): "tma", the Hopper kernel, for bf16 pools whose pages a
    TMA box cuts (a multiple of PAGED_TILE keys, or one of
    PAGED_SMALL_PAGES); "fma", PR 1's FMA body, for f32 and int8 pools and
    bf16 pools of any other page size (24, 48, 96, ...)."""
    if kv_dtype == torch.bfloat16 and (page_size % PAGED_TILE == 0
                                       or page_size in PAGED_SMALL_PAGES):
        return "tma"
    return "fma"


@functools.lru_cache(maxsize=None)
def paged_plan(b: int, hkv: int, np_table: int, page_size: int,
               sms: int) -> PagedPlan:
    """B2's bf16 plan for B rows of a (B, NP) table over Hkv kv heads on a
    card of ``sms`` SMs, from what a captured CUDA graph fixes (never the
    lengths): B19's rule. One block an SM at a time (each keeps
    PAGED_STAGES tiles of K and V in flight: 128 KB at D 128), the splits
    chosen among 1 .. 2 sms / (B Hkv) to fill the waves of blocks best,
    the fewest on a tie (a second wave costs a block's start and a merge
    again), a split at least a tile of keys."""
    rows = max(b * hkv, 1)
    least = max(1, PAGED_TILE // page_size)     # a whole tile a split
    best = None
    for want in range(1, max(1, 2 * sms // rows) + 1):
        pages = min(max(-(-np_table // want), least), PAGED_MAX_SPLIT_PAGES)
        splits = -(-np_table // pages)
        blocks = splits * rows
        fill = blocks / (-(-blocks // sms) * sms)
        if best is None or fill > best[0] + 1e-9:
            best = (fill, pages, splits)
    return PagedPlan(best[1], best[2], min(page_size, PAGED_TILE),
                     PAGED_TILE)


def paged_flash_decode_partial_ref(q, k_pages, v_pages, block_table,
                                   lengths, *, k_scales=None,
                                   v_scales=None):
    """Plain PyTorch paged decode partial in the TPU kernel's fold order.

    q: (B, Hq, D); k_pages/v_pages: (Hkv, P, ps, D); block_table (B, NP)
    i32; lengths (B,) i32 keys attended per row, the token being decoded
    included. Returns (acc (B, Hq, D) f32 unnormalized, m (B, Hq),
    l (B, Hq))."""
    b, hq, d = q.shape
    hkv, num_pages, ps, _ = k_pages.shape
    g = hq // hkv
    dev = q.device
    quant = k_scales is not None
    qf = q.float().reshape(b, hkv, g, d)
    lens = lengths.to(torch.int64)
    tab = block_table.to(torch.int64).clamp(0, num_pages - 1)
    m = torch.full((b, hkv, g, 1), NEG_INF, device=dev)
    l = torch.zeros((b, hkv, g, 1), device=dev)
    acc = torch.zeros((b, hkv, g, d), device=dev)
    scale = d ** -0.5
    n_pages = min(block_table.shape[1],
                  -(-int(lens.max().clamp_min(0)) // ps) if b else 0)
    for p in range(n_pages):
        live = (p * ps < lens)[:, None, None, None]          # (B,1,1,1)
        phys = tab[:, p]
        kb = k_pages[:, phys].float().permute(1, 0, 2, 3)    # (B,Hkv,ps,D)
        vb = v_pages[:, phys].float().permute(1, 0, 2, 3)
        sc = torch.matmul(qf, kb.transpose(-1, -2)) * scale  # (B,Hkv,g,ps)
        if quant:
            sc = sc * k_scales[:, phys].permute(1, 0, 2)[:, :, None, :]
        gk = p * ps + torch.arange(ps, device=dev)
        valid = (gk[None, :] < lens[:, None])[:, None, None, :]
        sc = torch.where(valid, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        pr = torch.where(valid, torch.exp(sc - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + pr.sum(dim=-1, keepdim=True)
        if quant:
            pr = pr * v_scales[:, phys].permute(1, 0, 2)[:, :, None, :]
        else:
            pr = p_cast(pr, v_pages.dtype)
        # V rows past the horizon are zeroed, as the kernel masks its loads
        vb = torch.where(valid[:, :, 0, :, None], vb, 0.0)
        acc_new = acc * alpha + torch.matmul(pr, vb)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    return acc.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)


def paged_flash_decode_partial(q, k_pages, v_pages, block_table, lengths,
                               *, k_scales=None, v_scales=None):
    """Split-KV partial attention over paged KV for one decode step.

    Shapes as ``paged_flash_decode_partial_ref``. Merge the partials with
    ``kernels.flash_decode.lse_merge``. CUDA tensors launch the kernel
    (counted in ``paged_flash_decode_partial.launches``; one launch a
    call, its route by dtype and page size as the module says: in bf16
    the splits merge by exact LSE in the launch, so the floats differ
    from the plain version's page-by-page fold by rounding); CPU tensors
    run the plain version."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("paged_flash_decode_partial: pass both scale slabs "
                         "or neither")
    if q.device.type == "cpu":
        return paged_flash_decode_partial_ref(
            q, k_pages, v_pages, block_table, lengths,
            k_scales=k_scales, v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_flash_decode_partial: unsupported device {q.device}")
    return _launch(q, k_pages, v_pages, block_table, lengths, k_scales,
                   v_scales)


paged_flash_decode_partial.launches = 0


def paged_flash_decode(q, k_pages, v_pages, block_table, lengths, *,
                       k_scales=None, v_scales=None) -> torch.Tensor:
    """Normalized single-shard paged decode: softmax(qk)v in q.dtype."""
    acc, _, l = paged_flash_decode_partial(
        q, k_pages, v_pages, block_table, lengths,
        k_scales=k_scales, v_scales=v_scales)
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def _smem_bytes(g: int, ps: int, d: int) -> int:
    """Shared memory of the FMA body."""
    return 4 * (g * d + ps * (d + 1) + ps * d + g * ps + 2 * ps + 3 * g)


def _workspace(dev, stream: int, b: int, hkv: int, splits: int, g: int,
               d: int):
    """The bf16 kernel's scratch for calls on one stream: the live splits'
    partials (B, Hkv, splits, g, D + 2) f32 and a ticket per (row, kv
    head) (B, Hkv) i32, zero and left zero by every call.

    Keyed by (device, stream, shape): calls on one stream run one after
    another and share it; calls on two streams (a one-card world's ranks,
    graphs replayed on their own streams) never do, so no two launches
    that may run at once count on one ticket. A CUDA graph keeps the
    workspace of the stream it was captured on: replays of graphs
    captured on one stream must not overlap each other or a call on that
    stream. Made outside capture (the warm-up call on the capturing
    stream makes it). Under capture with none made, the call takes
    scratch of the graph's own (tickets zeroed by a fill node in the
    graph before the kernel, each replay), which no other graph shares."""
    key = (dev, stream, b, hkv, splits, g, d)
    ws = _WORKSPACES.get(key)
    if ws is not None:
        return ws
    ws = (torch.empty((b, hkv, splits, g, d + 2), dtype=torch.float32,
                      device=dev),
          torch.zeros((b, hkv), dtype=torch.int32, device=dev))
    if dev.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        _WORKSPACES[key] = ws
    return ws


def _launch(q, k_pages, v_pages, block_table, lengths, k_scales, v_scales):
    b, hq, d = q.shape
    if k_pages.ndim != 4 or k_pages.shape != v_pages.shape \
            or k_pages.shape[3] != d:
        raise ValueError(f"paged_flash_decode_partial: q {tuple(q.shape)} "
                         f"vs pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)}")
    hkv, num_pages, ps, _ = k_pages.shape
    np_table = block_table.shape[1] if block_table.ndim == 2 else 0
    if hq % hkv or hq // hkv not in _GROUPS:
        raise ValueError(f"paged_flash_decode_partial: Hq={hq}, Hkv={hkv}: "
                         f"need Hkv | Hq and Hq/Hkv in {_GROUPS}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"paged_flash_decode_partial: head_dim {d} not in "
                         f"{_HEAD_DIMS}")
    quant = k_scales is not None
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged_flash_decode_partial: q dtype {q.dtype}")
    want_kv = torch.int8 if quant else q.dtype
    if k_pages.dtype != want_kv or v_pages.dtype != want_kv:
        raise ValueError(f"paged_flash_decode_partial: pools {k_pages.dtype}"
                         f"/{v_pages.dtype}, want {want_kv}")
    if quant and (k_scales.shape != k_pages.shape[:3]
                  or v_scales.shape != k_pages.shape[:3]
                  or k_scales.dtype != torch.float32
                  or v_scales.dtype != torch.float32):
        raise ValueError("paged_flash_decode_partial: scale slabs must be "
                         f"f32 {tuple(k_pages.shape[:3])}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32 \
            or block_table.ndim != 2 or block_table.shape[0] != b \
            or lengths.shape != (b,) or np_table == 0:
        raise ValueError("paged_flash_decode_partial: block_table (B, NP) "
                         "and lengths (B,) must be int32")
    tensors = [q, k_pages, v_pages, block_table, lengths]
    if quant:
        tensors += [k_scales, v_scales]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_flash_decode_partial: inputs must be "
                         "contiguous")
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_flash_decode_partial: inputs on different "
                         "devices")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_flash_decode_partial: pools must be 16-byte "
                         "aligned")
    dev = q.device
    acc = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, hq), dtype=torch.float32, device=dev)
    l = torch.empty((b, hq), dtype=torch.float32, device=dev)
    part = tickets = None
    pages = splits = 0
    if paged_route(k_pages.dtype, ps) == "tma":
        if hkv * num_pages * ps >= 2 ** 31 or np_table * ps >= 2 ** 31:
            raise ValueError(f"paged_flash_decode_partial: pool of "
                             f"{hkv * num_pages * ps} rows, {np_table} pages "
                             "a row: too many for the bf16 kernel")
        sms = _SMS.get(dev)
        if sms is None:
            sms = _SMS[dev] = torch.cuda.get_device_properties(
                dev).multi_processor_count
        plan = paged_plan(b, hkv, np_table, ps, sms)
        pages, splits = plan.pages, plan.splits
    else:
        smem = _smem_bytes(hq // hkv, ps, d)
        if smem > _MAX_SMEM:
            raise ValueError(f"paged_flash_decode_partial: page_size {ps} "
                             f"needs {smem} B of shared memory "
                             f"(> {_MAX_SMEM})")
    stream = build.stream_of(q)
    if splits:
        part, tickets = _workspace(dev, stream, b, hkv, splits, hq // hkv, d)
    fn = build.function("paged_flash_decode", "td_paged_decode", (
        *(ctypes.c_void_p,) * 12, *(ctypes.c_int,) * 9, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    with torch.cuda.device(dev):
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 k_scales.data_ptr() if quant else None,
                 v_scales.data_ptr() if quant else None,
                 block_table.data_ptr(), lengths.data_ptr(),
                 acc.data_ptr(), m.data_ptr(), l.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 tickets.data_ptr() if tickets is not None else None,
                 b, hq, hkv, num_pages, ps, np_table, d, pages, splits,
                 d ** -0.5, _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pages.dtype],
                 stream)
    build.check(err, "paged_flash_decode_partial")
    paged_flash_decode_partial.launches += 1
    return acc, m, l
