"""MoE down projection + top-k reduce + ReduceScatter (the reference's
kernels/moe_reduce_rs.py): the down projection of the tensor-parallel MoE
layer.

Every rank holds the intermediate rows of the whole batch, inter (M*topk,
I_loc) token-major with its I_loc columns, the whole (M, topk) routing and
its (E, I_loc, d) row shard of the experts' down weights; rank r returns
rows [r*M/n, (r+1)*M/n) of the weighted top-k sum over every rank's
partial, (M/n, d), from f32 partials with one cast. At world n > 1
(``mesh`` is the ranks' Mesh):

  * XLA — the f32 partial of all M tokens (sort by expert, one grouped
    product, unsort, weighted top-k reduce), ``dist.reduce_scatter_tensor``,
    the cast;
  * XLA_RING — the reference's ring: at step s a rank adds its partial of
    chunk (me - 1 - s) mod n to the one received from the left and passes
    it on (``dist.batch_isend_irecv``);
  * PALLAS — B15 across ranks, ``pallas_moe_reduce_rs``: the hand-written
    CUDA kernel ``csrc/moe_group_gemm.cu`` for CUDA tensors (each chunk's
    f32 partial, in the world-1 kernel's fold order, stored into its
    owner's sender-indexed slot; the owner adds slot 0 + ... + slot n-1
    and casts once), ``moe_reduce_rs_tp_ref`` for CPU tensors (each
    chunk's f32 ``moe_rs_partial_ref``, ``dist.all_to_all_single``, the
    same fold). The reference's ring adds in a rank-dependent order, so
    the tiers agree to f32 rounding, not bit for bit. As in the
    reference, chunks over 1024 tokens raise.

At world 1 the reduce-scatter is the identity: XLA and XLA_RING compute the
one chunk's partial, PALLAS is B15's world-1 body, ``moe_rs`` (the kernel
for CUDA tensors, ``moe_rs_ref`` for CPU tensors). No fallback: a CUDA
tensor the kernel does not take raises.

The mesh-level ``moe_reduce_rs(ctx, inter, topk_ids, topk_weights,
experts_w)`` resolves the method from a ``MoeReduceRsContext``
(``create_moe_reduce_rs_context``); M must be a multiple of the world.
Under PALLAS it builds the n-chunk schedule once per call through
``ctx.schedule`` and runs B15 across ranks, as the reference does. No
fault preamble and no fallback (ROADMAP A8).
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels import moe_utils
from triton_dist_tpu_torch.kernels.allgather_gemm import _peer, check_mesh
from triton_dist_tpu_torch.kernels.allgather_group_gemm import (
    _sms, check_experts, check_schedule, chunk_of, k_split,
)
from triton_dist_tpu_torch.kernels.plain import dot_f32, slot_fold
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.mesh import comm_axis_size
from triton_dist_tpu_torch.runtime.symm import op_workspace

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
PALLAS_MAX_CHUNK = 1024   # the reference's limit on the PALLAS chunk


class MoeReduceRsMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    XLA_RING = "xla_ring"
    PALLAS = "pallas"


def resolve_moe_reduce_rs_method(method: MoeReduceRsMethod, m: int, n: int,
                                 cuda: bool = False) -> MoeReduceRsMethod:
    """The port's AUTO rule: PALLAS (the kernel) on CUDA when a chunk
    holds at most 1024 tokens, else XLA_RING (XLA at world 1, where the
    two are one function); XLA on the CPU. The reference's rule sizes
    chunks for its TPU ring (queue C)."""
    if method != MoeReduceRsMethod.AUTO:
        return method
    if not cuda:
        return MoeReduceRsMethod.XLA
    if m // n <= PALLAS_MAX_CHUNK:
        return MoeReduceRsMethod.PALLAS
    return MoeReduceRsMethod.XLA_RING if n > 1 else MoeReduceRsMethod.XLA


@dataclasses.dataclass
class MoeReduceRsContext:
    """The reference's MoeReduceRsContext: the ranks' Mesh, its axis, the
    routing's experts and top-k, the method, PALLAS's aligned tile rows
    (bm), the reference ring's row blocks (comm_blocks; B15 ships whole
    column tiles and takes none) and the tile-schedule provider
    (``moe_utils.make_chunk_schedule``)."""
    mesh: object
    axis: str
    num_experts: int
    topk: int
    method: MoeReduceRsMethod = MoeReduceRsMethod.AUTO
    bm: int = 128
    comm_blocks: int = 4
    schedule: object = "auto"

    def resolve(self, m: int) -> MoeReduceRsMethod:
        return resolve_moe_reduce_rs_method(
            self.method, m, comm_axis_size(self.mesh, self.axis),
            cuda=self.mesh.device.type == "cuda")


def create_moe_reduce_rs_context(mesh, num_experts: int, topk: int,
                                 axis: str = "tp",
                                 **kw) -> MoeReduceRsContext:
    return MoeReduceRsContext(mesh, axis, num_experts, topk, **kw)


def _chunk_moe_partial(inter_c, ids_c, w_c, experts_w, num_experts):
    """Grouped GEMM + top-k reduce of one token chunk -> (m_c, d) f32."""
    st = moe_utils.sort_by_expert(ids_c, num_experts)
    lhs = inter_c[st.sort_idx.long()]
    out_sorted = moe_utils.grouped_gemm(lhs, experts_w, st.group_sizes,
                                        out_dtype=torch.float32)
    flat = moe_utils.unsort(out_sorted, st)
    return moe_utils.reduce_topk(flat, w_c)


def moe_rs_partial_ref(inter: torch.Tensor, experts_w: torch.Tensor,
                       topk_ids: torch.Tensor, topk_weights: torch.Tensor,
                       sched: moe_utils.AlignedSchedule) -> torch.Tensor:
    """Plain version of B15's f32 partial at one chunk: tile by tile, the
    tile's rows of ``inter`` (row_flat, the sentinel clamped) times its
    expert's weight in f32, each live slot's row times its top-k weight
    added to its token's f32 accumulator (tile order: ascending expert).
    Reads used_tiles on the host. Returns (M, d) f32."""
    m, topk = topk_ids.shape
    nf = m * topk
    t_tiles = sched.tile_expert.shape[1]
    bm = sched.row_flat.shape[1] // t_tiles
    acc = torch.zeros((m, experts_w.shape[-1]), dtype=torch.float32,
                      device=inter.device)
    w_flat = topk_weights.reshape(-1).float()
    for t in range(int(sched.used_tiles[0])):
        slots = sched.row_flat[0, t * bm:(t + 1) * bm]
        o = dot_f32(inter[slots.clamp(max=nf - 1).long()],
                    experts_w[int(sched.tile_expert[0, t])])
        f = slots[slots < nf].long()
        acc.index_add_(0, f // topk, w_flat[f, None] * o[slots < nf])
    return acc


def moe_rs_ref(inter: torch.Tensor, experts_w: torch.Tensor,
               topk_ids: torch.Tensor, topk_weights: torch.Tensor,
               sched: moe_utils.AlignedSchedule) -> torch.Tensor:
    """Plain version of B15 at one chunk: ``moe_rs_partial_ref``, one
    cast."""
    return moe_rs_partial_ref(inter, experts_w, topk_ids, topk_weights,
                              sched).to(torch.result_type(inter, experts_w))


def chunk_partials_ref(inter: torch.Tensor, experts_w: torch.Tensor,
                       topk_ids: torch.Tensor, topk_weights: torch.Tensor,
                       sched: moe_utils.AlignedSchedule) -> torch.Tensor:
    """This rank's f32 partial of every chunk, (n, M/n, d): chunk c's
    tokens through ``moe_rs_partial_ref`` with chunk c's schedule."""
    n = sched.tile_expert.shape[0]
    mc, topk = topk_ids.shape[0] // n, topk_ids.shape[1]
    nf = mc * topk
    return torch.stack([moe_rs_partial_ref(
        inter[c * nf:(c + 1) * nf], experts_w, topk_ids[c * mc:(c + 1) * mc],
        topk_weights[c * mc:(c + 1) * mc], chunk_of(sched, c))
        for c in range(n)])


def moe_reduce_rs_tp_ref(mesh, inter: torch.Tensor, experts_w: torch.Tensor,
                         topk_ids: torch.Tensor, topk_weights: torch.Tensor,
                         sched: moe_utils.AlignedSchedule) -> torch.Tensor:
    """Plain version of B15 across ranks: this rank's f32 partial of every
    chunk, ``dist.all_to_all_single`` (rank r receives every sender's
    partial of chunk r), slot 0 + slot 1 + ... + slot n-1, one cast."""
    parts = chunk_partials_ref(inter, experts_w, topk_ids, topk_weights,
                               sched).contiguous()
    recv = torch.empty_like(parts)
    dist.all_to_all_single(recv, parts, group=mesh.group)
    return slot_fold(list(recv)).to(torch.result_type(inter, experts_w))


def moe_reduce_rs_ref_shards(inters, experts_ws, topk_ids, topk_weights,
                             sched) -> list[torch.Tensor]:
    """Plain version of B15 across ranks over every rank's intermediate
    rows and weight shard in one process (the one-card world): each
    rank's chunk partials, then every owner's fold in ascending sender,
    one cast. Returns the ranks' outputs in rank order."""
    parts = [chunk_partials_ref(i, w, topk_ids, topk_weights, sched)
             for i, w in zip(inters, experts_ws)]
    dtype = torch.result_type(inters[0], experts_ws[0])
    return [slot_fold([p[r] for p in parts]).to(dtype)
            for r in range(len(parts))]


def moe_rs(inter: torch.Tensor, experts_w: torch.Tensor,
           topk_ids: torch.Tensor, topk_weights: torch.Tensor,
           sched: moe_utils.AlignedSchedule) -> torch.Tensor:
    """B15 at one chunk: y (M, d) = cast(sum over each token's choices of
    w * (inter row @ its expert's weight), f32 accumulation). CUDA tensors
    launch the kernel (counted in ``moe_rs.launches``); CPU tensors run
    ``moe_rs_ref``."""
    if inter.device.type == "cpu":
        return moe_rs_ref(inter, experts_w, topk_ids, topk_weights, sched)
    if inter.device.type != "cuda":
        raise ValueError(f"moe_rs: unsupported device {inter.device}")
    return _launch(inter.contiguous(), experts_w, topk_ids, topk_weights,
                   sched)


moe_rs.launches = 0


def pallas_moe_reduce_rs(mesh, inter: torch.Tensor,
                         experts_w: torch.Tensor, topk_ids: torch.Tensor,
                         topk_weights: torch.Tensor,
                         sched: moe_utils.AlignedSchedule) -> torch.Tensor:
    """B15 across ranks on this rank: its (M/n, d) rows of the sum over
    ranks of the weighted top-k partials. CUDA tensors launch the kernel
    (counted in ``pallas_moe_reduce_rs.launches``); CPU tensors run
    ``moe_reduce_rs_tp_ref``. Every rank calls it with the same shapes,
    in the same order."""
    if inter.device.type == "cpu":
        return moe_reduce_rs_tp_ref(mesh, inter, experts_w, topk_ids,
                                    topk_weights, sched)
    if inter.device.type != "cuda":
        raise ValueError(
            f"pallas_moe_reduce_rs: unsupported device {inter.device}")
    out = _launch_tp(mesh, inter.contiguous(), experts_w, topk_ids,
                     topk_weights, sched)
    pallas_moe_reduce_rs.launches += 1
    return out


pallas_moe_reduce_rs.launches = 0


def _ring_per_device(mesh, num_experts, inter, topk_ids, topk_weights,
                     experts_w, out_dtype):
    """XLA_RING (the reference's _ring_per_device): the partial of chunk
    (me - 1 - s) mod n plus the one from the left travels right; the last
    arrival is this rank's chunk, summed over every rank."""
    n, me = mesh.world, mesh.rank
    topk = topk_ids.shape[1]
    mc = topk_ids.shape[0] // n
    right, left = _peer(mesh, (me + 1) % n), _peer(mesh, (me - 1) % n)

    def chunk_partial(c):
        return _chunk_moe_partial(
            inter[c * mc * topk:(c + 1) * mc * topk],
            topk_ids[c * mc:(c + 1) * mc], topk_weights[c * mc:(c + 1) * mc],
            experts_w, num_experts)

    acc = torch.zeros((mc, experts_w.shape[-1]), dtype=torch.float32,
                      device=inter.device)
    for s in range(n - 1):
        part = (chunk_partial((me - 1 - s) % n) + acc).contiguous()
        acc = torch.empty_like(part)
        for r in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, part, right, mesh.group),
                dist.P2POp(dist.irecv, acc, left, mesh.group)]):
            r.wait()
    return (chunk_partial(me) + acc).to(out_dtype)


def _pallas_moe_rs_per_device(n, num_experts, topk, bm, inter, topk_ids,
                              topk_weights, experts_w, sched=None,
                              mesh=None):
    m = topk_ids.shape[0]
    mc = m // n
    if mc > PALLAS_MAX_CHUNK:
        raise ValueError(
            f"PALLAS moe_reduce_rs supports chunks up to "
            f"{PALLAS_MAX_CHUNK} tokens (got {mc}); use XLA_RING for large "
            "prefill batches")
    bm = min(bm, max(8, mc * topk))
    if sched is None:
        sched = moe_utils.aligned_chunk_schedule(topk_ids, n, num_experts,
                                                 bm)
    t_tiles = sched.tile_expert.shape[1]
    if sched.row_token.shape[1] != t_tiles * bm:
        raise ValueError(
            f"schedule row length {sched.row_token.shape[1]} != "
            f"t_tiles*bm = {t_tiles}*{bm}; the schedule was built with a "
            "different block size than the kernel is running")
    if n == 1:
        return moe_rs(inter, experts_w, topk_ids, topk_weights, sched)
    return pallas_moe_reduce_rs(mesh, inter, experts_w, topk_ids,
                                topk_weights, sched)


def moe_reduce_rs_per_device(n: int, num_experts: int, topk: int,
                             method: MoeReduceRsMethod, inter: torch.Tensor,
                             topk_ids: torch.Tensor,
                             topk_weights: torch.Tensor,
                             experts_w: torch.Tensor, bm: int = 128,
                             sched=None, comm_blocks: int = 4, mesh=None):
    """The reference's per-device body. inter (M*topk, I_loc) token-major;
    topk_ids / topk_weights (M, topk); experts_w (E, I_loc, d). Returns
    this rank's (M/n, d) chunk. comm_blocks sizes the reference ring's
    blocks; B15 ships whole column tiles and takes none. ``mesh`` (the
    ranks' Mesh) is needed at n > 1."""
    out_dtype = torch.result_type(inter, experts_w)
    if method not in (MoeReduceRsMethod.XLA, MoeReduceRsMethod.XLA_RING,
                      MoeReduceRsMethod.PALLAS):
        raise ValueError(f"unresolved method {method}")
    check_mesh(n, mesh, "moe_reduce_rs")
    if method == MoeReduceRsMethod.PALLAS:
        return _pallas_moe_rs_per_device(n, num_experts, topk, bm, inter,
                                         topk_ids, topk_weights, experts_w,
                                         sched=sched, mesh=mesh)
    if n == 1:
        return _chunk_moe_partial(inter, topk_ids, topk_weights, experts_w,
                                  num_experts).to(out_dtype)
    if method == MoeReduceRsMethod.XLA:
        y = _chunk_moe_partial(inter, topk_ids, topk_weights, experts_w,
                               num_experts).contiguous()
        out = torch.empty((y.shape[0] // n, y.shape[1]), dtype=torch.float32,
                          device=y.device)
        dist.reduce_scatter_tensor(out, y, group=mesh.group)
        return out.to(out_dtype)
    return _ring_per_device(mesh, num_experts, inter, topk_ids,
                            topk_weights, experts_w, out_dtype)


def moe_reduce_rs(ctx: MoeReduceRsContext, inter: torch.Tensor,
                  topk_ids: torch.Tensor, topk_weights: torch.Tensor,
                  experts_w: torch.Tensor) -> torch.Tensor:
    """The mesh-level MoE down projection + top-k reduce + ReduceScatter
    (the reference's ``moe_reduce_rs``), called by every rank: inter
    (M*topk, I_loc) its columns, the whole (M, topk) routing, experts_w
    (E, I_loc, d) its row shard -> its (M/n, d) rows."""
    n = comm_axis_size(ctx.mesh, ctx.axis)
    m = topk_ids.shape[0]
    if m % n:
        raise ValueError(f"M={m} not divisible by world={n}")
    method = ctx.resolve(m)
    if method == MoeReduceRsMethod.PALLAS:
        bm = min(ctx.bm, max(8, (m // n) * ctx.topk))
        sched = moe_utils.make_chunk_schedule(topk_ids, n, ctx.num_experts,
                                              bm, provider=ctx.schedule)
        return moe_reduce_rs_per_device(
            n, ctx.num_experts, ctx.topk, method, inter, topk_ids,
            topk_weights, experts_w, bm=bm, sched=sched,
            comm_blocks=ctx.comm_blocks, mesh=ctx.mesh)
    return moe_reduce_rs_per_device(
        n, ctx.num_experts, ctx.topk, method, inter, topk_ids, topk_weights,
        experts_w, bm=ctx.bm, comm_blocks=ctx.comm_blocks, mesh=ctx.mesh)


def check_routing(topk_ids, topk_weights, dev, what: str) -> None:
    if topk_ids.dtype != torch.int32 or topk_weights.dtype != torch.float32 \
            or topk_weights.shape != topk_ids.shape \
            or not (topk_ids.is_contiguous()
                    and topk_weights.is_contiguous()) \
            or topk_ids.device != dev or topk_weights.device != dev:
        raise ValueError(f"{what}: topk_ids int32 and topk_weights f32, "
                         f"contiguous (M, topk) on {dev}")


def _launch(inter, experts_w, topk_ids, topk_weights, sched):
    dev = inter.device
    m, topk = topk_ids.shape
    nf = m * topk
    if inter.ndim != 2 or inter.shape[0] != nf or experts_w.ndim != 3 or \
            experts_w.shape[1] != inter.shape[1]:
        raise ValueError(f"moe_rs: inter {tuple(inter.shape)}, experts_w "
                         f"{tuple(experts_w.shape)}, topk_ids "
                         f"{tuple(topk_ids.shape)}")
    k, d = inter.shape[1], experts_w.shape[2]
    vec = check_experts(inter, experts_w, d, "moe_rs")
    check_routing(topk_ids, topk_weights, dev, "moe_rs")
    t_tiles, bm = check_schedule(sched, dev, "moe_rs")
    k_chunk, splits = k_split(min(t_tiles, nf), -(-d // (32 * vec)), k,
                              _sms(dev))
    part = torch.empty((splits, nf, d), dtype=torch.float32, device=dev)
    out = torch.empty((m, d), dtype=inter.dtype, device=dev)
    fn = build.function("moe_group_gemm", "td_moe_rs", (
        ctypes.c_void_p, ctypes.c_int, *(ctypes.c_void_p,) * 8,
        *(ctypes.c_int,) * 10, ctypes.c_void_p))
    with torch.cuda.device(dev):
        err = fn(inter.data_ptr(), nf, sched.row_flat.data_ptr(),
                 sched.tile_expert.data_ptr(), sched.used_tiles.data_ptr(),
                 experts_w.data_ptr(), topk_ids.data_ptr(),
                 topk_weights.data_ptr(), part.data_ptr(), out.data_ptr(),
                 t_tiles, bm, k, d, k_chunk, splits, m, topk, min(bm, m),
                 _DTYPE_CODE[inter.dtype], build.stream_of(inter))
    build.check(err, "moe_rs")
    moe_rs.launches += 1
    return out


def _col_tiles(d: int, dtype: torch.dtype) -> int:
    return -(-d // (32 * (16 // torch.empty((), dtype=dtype).element_size())))


def tp_workspace(mesh, mc: int, d: int, dtype: torch.dtype):
    """B15's cached workspace on ``mesh`` for chunks of mc tokens of width
    d in ``dtype``: the (2, n, mc, d) f32 landing slots (double-buffered
    by the epoch's parity) and the control block (a counter per (chunk,
    column tile) and per chunk). B14's wrapper makes it before its own
    launch: in the one-card world an allocation behind a spinning B14
    would wait for ranks not yet launched."""
    n = mesh.world
    return op_workspace(mesh, ("moe_rs_tp", mc, d, dtype), (2, n, mc, d),
                        torch.float32,
                        ctl_words=n * _col_tiles(d, dtype) + n)


def _launch_tp(mesh, inter, experts_w, topk_ids, topk_weights, sched):
    dev = inter.device
    n = mesh.world
    m, topk = topk_ids.shape
    if m % n:
        raise ValueError(f"pallas_moe_reduce_rs: M={m} not divisible by the "
                         f"world {n}")
    mc = m // n
    if inter.ndim != 2 or inter.shape[0] != m * topk or \
            experts_w.ndim != 3 or experts_w.shape[1] != inter.shape[1]:
        raise ValueError(f"pallas_moe_reduce_rs: inter "
                         f"{tuple(inter.shape)}, experts_w "
                         f"{tuple(experts_w.shape)}, topk_ids "
                         f"{tuple(topk_ids.shape)}")
    k, d = inter.shape[1], experts_w.shape[2]
    vec = check_experts(inter, experts_w, d, "pallas_moe_reduce_rs")
    check_routing(topk_ids, topk_weights, dev, "pallas_moe_reduce_rs")
    t_tiles, bm = check_schedule(sched, dev, "pallas_moe_reduce_rs", n)
    nf = mc * topk
    # one grid walks every chunk's tiles: the K split fills the card over
    # the n chunks' live tiles (the world-1 kernel's over one chunk's)
    k_chunk, splits = k_split(n * min(t_tiles, nf), -(-d // (32 * vec)), k,
                              _sms(dev))
    ws = tp_workspace(mesh, mc, d, inter.dtype)
    part = torch.empty((splits, m * topk, d), dtype=torch.float32,
                       device=dev)
    out = torch.empty((mc, d), dtype=inter.dtype, device=dev)
    fn = build.function("moe_group_gemm", "td_moe_rs_tp", (
        *(ctypes.c_void_p,) * 9, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        *(ctypes.c_int,) * 11, ctypes.c_void_p))
    with torch.cuda.device(dev):
        err = fn(inter.data_ptr(), sched.row_flat.data_ptr(),
                 sched.tile_expert.data_ptr(), sched.used_tiles.data_ptr(),
                 experts_w.data_ptr(), topk_ids.data_ptr(),
                 topk_weights.data_ptr(), part.data_ptr(), out.data_ptr(),
                 mesh.rank, n, ws.buf.table.data_ptr(), ws.buf.sig_off,
                 ws.ctl.data_ptr(), mc, topk, k, d, t_tiles, bm, k_chunk,
                 splits, min(bm, mc), mesh.ranks_per_device,
                 _DTYPE_CODE[inter.dtype], build.stream_of(inter))
    build.check(err, "pallas_moe_reduce_rs")
    return out
