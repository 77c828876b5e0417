"""KV page handoff: the disaggregated-serving wire op (the reference's
kernels/kv_handoff.py).

A prefill rank's paged-KV payload moves to a decode rank (``kv_handoff``)
or to several (``kv_handoff_fanout``), block-granular: the payload travels
in ``comm_blocks`` row blocks (``legalize_comm_blocks``: the largest
divisor of the shard's rows at most the request), each landing as a unit.
Every rank calls an op with its shard x (rows on dim 0, any dtype) and gets
its output shard. Methods (``KVHandoffMethod``):

  * XLA: the twin of the reference's XLA tier: B29's a send / receive pair
    plus a select (``plain.p2p_ref``: dst returns src's shard, every other
    rank its own), B30's the process group's all-gather plus a select
    (``plain.fanout_ref``); NCCL on the card, gloo on the CPU;
  * PALLAS: B29 ``kv_handoff_per_device`` and B30
    ``kv_handoff_fanout_per_device``, the hand-written CUDA kernels of
    ``csrc/kv_handoff.cu`` for CUDA tensors (src stores each piece of a
    comm block into every destination's landing slot and raises its flag
    there, a destination waits per comm block and copies out, the others
    copy their shard through), the XLA twins for CPU tensors;
  * AUTO: PALLAS on the card, XLA on the CPU.

The handoff is pure data movement: both tiers are bit-exact.
``kv_handoff_quantized`` puts the pages on the int8 wire: encode at every
rank (the codec, ``kv_int8_page`` by default: one f32 scale per page),
fan out the int8 payload and the f32 page scales (two B30 launches on the
card), decode at the destinations; one encode -> decode round trip per
element (QuantContract "kv_handoff"). Ranks outside the world raise; src ==
dst (or only src among the destinations) returns x; duplicate destinations
are dropped. No fault preamble (ROADMAP A8) and no fallback: a kernel that
fails raises.
"""

from __future__ import annotations

import ctypes
import enum

import torch

from triton_dist_tpu_torch.kernels.common_ops import contiguous_cuda
from triton_dist_tpu_torch.kernels.plain import fanout_ref, p2p_ref
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.mesh import comm_axis_size
from triton_dist_tpu_torch.runtime.symm import op_workspace

_BLOCK_BYTES = 8192     # the least bytes a piece of a comm block aims for
_ALIGN = 256


class KVHandoffMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"          # the send / recv (gather) twin: identical bytes
    PALLAS = "pallas"    # the blocked push kernels


def resolve_kv_handoff_method(method, cuda: bool = True) -> KVHandoffMethod:
    """A method by value or member; AUTO is PALLAS on the card, XLA on the
    CPU (the reference: PALLAS on its chip)."""
    if isinstance(method, str):
        method = KVHandoffMethod(method)
    if method != KVHandoffMethod.AUTO:
        return method
    return KVHandoffMethod.PALLAS if cuda else KVHandoffMethod.XLA


def legalize_comm_blocks(rows: int, comm_blocks: int) -> int:
    """Largest divisor of the shard's leading dim <= the requested
    granularity (the block loop must tile the payload exactly)."""
    cb = max(1, min(int(comm_blocks), rows))
    while rows % cb:
        cb -= 1
    return cb


def _round_up(x: int, a: int = _ALIGN) -> int:
    return -(-x // a) * a


def kv_plan(mesh, cbytes: int, cb: int) -> tuple[int, int, int]:
    """(rb 16-byte units a piece, ppb pieces a comm block, grid) for comm
    blocks of cbytes bytes: about one piece a block of the grid, pieces of
    at least _BLOCK_BYTES, at most one block an SM for each rank sharing
    the card (all resident at once)."""
    units = -(-cbytes // 16)
    sms = torch.cuda.get_device_properties(mesh.device).multi_processor_count
    cap = max(1, sms // mesh.ranks_per_device)
    ppb = max(1, min(-(-cbytes // _BLOCK_BYTES), units, -(-cap // cb)))
    rb = -(-units // ppb)
    ppb = -(-units // rb)
    return rb, ppb, min(cb * ppb, cap)


def _launch(kind: str, mesh, x: torch.Tensor, src: int, dsts, cb: int):
    """B29 (kind "handoff", one destination) or B30 ("fanout") on this
    rank's contiguous CUDA shard x; a fresh output."""
    shard = x.numel() * x.element_size()
    if shard == 0 or x.shape[0] % cb:
        raise ValueError(f"kv_{kind}: a non-empty shard of rows divisible "
                         f"by comm_blocks {cb}; got {tuple(x.shape)}")
    cbytes = shard // cb
    rb, ppb, grid = kv_plan(mesh, cbytes, cb)
    flag_off = _round_up(_round_up(shard, 16))
    ws = op_workspace(mesh, ("kv_" + kind, shard, cb),
                      (flag_off + 8 * cb * ppb,), torch.uint8)
    out = torch.empty_like(x)
    fn = build.function("kv_handoff", "td_kv_handoff", (
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p))
    mask = sum(1 << d for d in dsts)
    with torch.cuda.device(x.device):
        err = fn(int(kind == "fanout"), x.data_ptr(), out.data_ptr(),
                 mesh.rank, mesh.world, ws.buf.table.data_ptr(),
                 ws.buf.sig_off, ws.ctl.data_ptr(), cbytes, cb, rb, ppb,
                 flag_off, src, mask, grid, mesh.ranks_per_device,
                 build.stream_of(x))
    build.check(err, f"kv_{kind}")
    return out


def kv_handoff_per_device(mesh, x: torch.Tensor, src_rank: int,
                          dst_rank: int, comm_blocks: int = 4
                          ) -> torch.Tensor:
    """B29 on this rank: src_rank's shard on dst_rank, x elsewhere, a fresh
    tensor, moved in ``legalize_comm_blocks(rows, comm_blocks)`` blocks.
    CUDA tensors launch the kernel (counted in
    ``kv_handoff_per_device.launches``); CPU tensors run ``plain.p2p_ref``.
    src_rank != dst_rank, both ranks of the mesh; every rank calls it with
    the same shape and ranks, in the same order."""
    if x.device.type == "cpu":
        return p2p_ref(mesh, x, src_rank, dst_rank)
    x = contiguous_cuda(x, "kv_handoff")
    cb = legalize_comm_blocks(x.shape[0], comm_blocks)
    out = _launch("handoff", mesh, x, src_rank, (dst_rank,), cb)
    kv_handoff_per_device.launches += 1
    return out


kv_handoff_per_device.launches = 0


def kv_handoff_fanout_per_device(mesh, x: torch.Tensor, src_rank: int,
                                 dst_ranks, comm_blocks: int = 4
                                 ) -> torch.Tensor:
    """B30 on this rank: src_rank's shard on every rank of ``dst_ranks``
    (src not among them), x elsewhere, a fresh tensor. CUDA tensors launch
    the kernel (counted in ``kv_handoff_fanout_per_device.launches``); CPU
    tensors run ``plain.fanout_ref``."""
    if x.device.type == "cpu":
        return fanout_ref(mesh, x, src_rank, dst_ranks)
    x = contiguous_cuda(x, "kv_handoff_fanout")
    cb = legalize_comm_blocks(x.shape[0], comm_blocks)
    out = _launch("fanout", mesh, x, src_rank, dst_ranks, cb)
    kv_handoff_fanout_per_device.launches += 1
    return out


kv_handoff_fanout_per_device.launches = 0


def _check_ranks(what: str, n: int, axis: str, ranks) -> None:
    bad = [d for d in ranks if not 0 <= d < n]
    if bad:
        raise ValueError(f"{what} ranks {bad} outside the {n}-rank axis "
                         f"{axis!r}")


def kv_handoff(mesh, axis: str, x: torch.Tensor, src_rank: int,
               dst_rank: int, *, method=KVHandoffMethod.AUTO,
               comm_blocks: int = 4) -> torch.Tensor:
    """out[dst_rank] = x[src_rank], every other shard unchanged (the
    reference's ``kv_handoff``), called by every rank on its shard."""
    n = comm_axis_size(mesh, axis)
    _check_ranks("kv_handoff", n, axis, (src_rank, dst_rank))
    if src_rank == dst_rank:
        return x            # the pages are already home
    method = resolve_kv_handoff_method(method, x.device.type == "cuda")
    if method == KVHandoffMethod.PALLAS:
        return kv_handoff_per_device(mesh, x, src_rank, dst_rank,
                                     comm_blocks)
    return p2p_ref(mesh, x, src_rank, dst_rank)


def _destinations(what: str, n: int, axis: str, src_rank: int, dst_ranks):
    """The destinations, duplicates and src dropped (ranks checked)."""
    dsts = tuple(dict.fromkeys(int(d) for d in dst_ranks))
    if not dsts:
        raise ValueError(f"{what} with no destination ranks")
    _check_ranks(what, n, axis, (src_rank, *dsts))
    return tuple(d for d in dsts if d != src_rank)


def kv_handoff_fanout(mesh, axis: str, x: torch.Tensor, src_rank: int,
                      dst_ranks, *, method=KVHandoffMethod.AUTO,
                      comm_blocks: int = 4) -> torch.Tensor:
    """out[d] = x[src_rank] for every d in dst_ranks, every other shard
    unchanged (the reference's ``kv_handoff_fanout``)."""
    n = comm_axis_size(mesh, axis)
    dsts = _destinations("kv_handoff_fanout", n, axis, src_rank, dst_ranks)
    if not dsts:
        return x            # the pages are already home
    method = resolve_kv_handoff_method(method, x.device.type == "cuda")
    if method == KVHandoffMethod.PALLAS:
        return kv_handoff_fanout_per_device(mesh, x, src_rank, dsts,
                                            comm_blocks)
    return fanout_ref(mesh, x, src_rank, dsts)


def kv_handoff_quantized(mesh, axis: str, x: torch.Tensor, src_rank: int,
                         dst_ranks, *, codec: str = "kv_int8_page",
                         method=KVHandoffMethod.AUTO,
                         comm_blocks: int = 4) -> torch.Tensor:
    """The fan-out on the int8 wire (the reference's
    ``kv_handoff_quantized``): every rank encodes its shard (pages on dim
    0, page dims last), the payload and the f32 page scales fan out, the
    destinations decode; every other shard stays x, bit for bit."""
    from triton_dist_tpu_torch.quant.codec import codec as wire_codec
    from triton_dist_tpu_torch.quant.contract import contract_for
    contract_for("kv_handoff", codec)   # no error promise, no wire
    c = wire_codec(codec)
    n = comm_axis_size(mesh, axis)
    if x.ndim < 3:
        # the page scale reduces the last two axes: a rank-2 shard would
        # collapse to one scale that cannot be cut into row blocks
        raise ValueError(
            f"kv_handoff_quantized needs a rank>=3 staged payload (pages on "
            f"axis 0, page dims last); got shape {tuple(x.shape)}")
    dsts = _destinations("kv_handoff_quantized", n, axis, src_rank,
                         dst_ranks)
    if not dsts:
        return x
    q, s = c.encode(x)
    q = kv_handoff_fanout(mesh, axis, q, src_rank, dsts, method=method,
                          comm_blocks=comm_blocks)
    s = kv_handoff_fanout(mesh, axis, s, src_rank, dsts, method=method,
                          comm_blocks=comm_blocks)
    return c.decode(q, s, x.dtype) if mesh.rank in dsts else x
