"""Expert-parallel token all-to-all: dispatch and combine (the reference's
kernels/ep_a2a.py).

Each of n ranks owns E / n experts at full width. Dispatch sends every
(token, choice) to the rank that owns its expert; combine returns the
expert outputs to the token's home rank and takes the weighted top-k sum.
All shapes are static: each (src, dst) pair has max_m padded slots, and
the true counts travel alongside. The routing layout (which slot each
choice takes, ``dispatch_layout``: a stable sort by destination) is kept
on the home rank and reused by combine, whose return path is then a
gather. Nothing here reads a device value on the host, so a decode step
that calls it can be captured as a CUDA graph.

Payload transports (``EpA2AContext.method``):

  * XLA — the process group's ``all_to_all_single`` (NCCL on the card);
  * PALLAS — B17, ``low_latency_all_to_all.fast_all_to_all_per_device``
    (B18, ``fast_all_to_all_q_per_device``, for the fp8 payload);
  * PALLAS_FUSED — B16, ``pallas_dispatch_gg``: the dispatch payload
    crosses in ``comm_blocks`` row blocks and the receiver's gate/up
    grouped GEMM runs in the same kernel, each expert tile released as
    soon as the row blocks it reads have landed (``dispatch_gg``); the
    combine takes B17.

The splits exchange (counts and expert ids, two small all-to-alls) runs
before the payload, through the process group, as the reference's does.
A context with ``dcn_axis`` (the two-phase route over a factored mesh)
raises naming ROADMAP A9 (tail); the tdlint protocol registrations wait
for A16. The public ``dispatch``, ``dispatch_gg`` and ``combine`` are
called by every rank on its own rows; they have no fault preamble (A8)
and no fallback: on CUDA the kernels launch or raise, and their plain
versions (kernels/plain.py) serve CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum
from typing import Any, NamedTuple

import torch

from triton_dist_tpu_torch.kernels import low_latency_all_to_all as ll
from triton_dist_tpu_torch.kernels import moe_utils
from triton_dist_tpu_torch.kernels.allgather_gemm import check_not_2d
from triton_dist_tpu_torch.kernels.allgather_group_gemm import (
    _DTYPE_CODE, _sms, check_experts, check_schedule, k_split,
)
from triton_dist_tpu_torch.kernels.plain import (
    all_to_all_slots, dispatch_gg_ref,
)
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.symm import op_workspace

_I32 = torch.int32


class EpA2AMethod(enum.Enum):
    XLA = "xla"
    PALLAS = "pallas"
    PALLAS_FUSED = "pallas_fused"  # B16: dispatch + gate/up grouped GEMM


@dataclasses.dataclass
class EpA2AContext:
    """The reference's EpA2AContext: the ranks' Mesh (None: world 1), its
    axis, the routing's experts and top-k, max_m (the slots a (src, dst)
    pair has; below the routing's worst case, M_local * topk all to one
    rank, over-capacity choices are dropped and counted), the method, the
    dispatch payload's wire dtype (None: full width; torch.float8_e4m3fn:
    the fp8 rows + f32 scales of B18), and PALLAS_FUSED's aligned tile
    rows (bm) and row blocks a slot travels in (comm_blocks, clamped to a
    divisor of max_m). dcn_axis raises: ROADMAP A9 (tail)."""
    mesh: object
    axis: str
    num_experts: int
    topk: int
    max_m: int
    method: EpA2AMethod = EpA2AMethod.XLA
    payload_dtype: Any = None
    dcn_axis: str | None = None
    bm: int = 128
    comm_blocks: int = 4

    def __post_init__(self):
        check_not_2d(self.dcn_axis, "the expert-parallel all-to-all")
        if self.mesh is not None and self.mesh.axis != self.axis:
            raise ValueError(f"mesh axis {self.mesh.axis!r} is not the EP "
                             f"axis {self.axis!r}")

    @property
    def world(self) -> int:
        return 1 if self.mesh is None else self.mesh.world

    @property
    def experts_per_rank(self) -> int:
        return self.num_experts // self.world


def create_ep_a2a_context(mesh, num_experts: int, topk: int, max_m: int,
                          axis: str = "tp", **kw) -> EpA2AContext:
    ctx = EpA2AContext(mesh, axis, num_experts, topk, max_m, **kw)
    if num_experts % ctx.world:
        raise ValueError(f"E={num_experts} not divisible by the ep world "
                         f"({ctx.world})")
    return ctx


class DispatchLayout(NamedTuple):
    """Home-rank routing metadata, kept for combine."""
    dest: torch.Tensor         # (M*topk,) i32 destination rank per choice
    pos: torch.Tensor          # (M*topk,) i32 slot within (me, dest)
    send_counts: torch.Tensor  # (n,) i32 choices sent to each rank


def dispatch_layout(topk_ids: torch.Tensor, n: int,
                    experts_per_rank: int) -> DispatchLayout:
    """Slot of every (token, choice): its rank among the choices bound to
    the same destination, in token-major order (a stable sort by
    destination)."""
    flat = topk_ids.reshape(-1).to(_I32)
    dest = torch.div(flat, experts_per_rank, rounding_mode="floor")
    order = torch.argsort(dest, stable=True)
    counts = moe_utils.expert_histogram(dest, n)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = (torch.arange(dest.shape[0], device=dest.device)
                  - starts[dest[order].long()]).to(_I32)
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    return DispatchLayout(dest, pos, counts)


class Dispatched(NamedTuple):
    """What lands on the expert rank after dispatch."""
    x: torch.Tensor           # (n, max_m, K) payload, slot s from rank s
    expert_ids: torch.Tensor  # (n, max_m) i32 local expert (pad: E_loc)
    counts: torch.Tensor      # (n,) i32 live slots per source rank
    layout: DispatchLayout    # home-rank metadata for combine
    overflow: torch.Tensor    # (1,) i32 (token, expert) pairs dropped at
    #                           this source because a (src, dst) pair held
    #                           more than max_m


def _exchange(ctx: EpA2AContext, x: torch.Tensor) -> torch.Tensor:
    """The process group's all-to-all of slots (the XLA transport, and the
    splits exchange of every method)."""
    return all_to_all_slots(ctx.mesh, x)


def _payload_a2a(ctx: EpA2AContext, buf: torch.Tensor,
                 quantize: bool = False) -> torch.Tensor:
    """The payload exchange of ctx.method; ``quantize`` (dispatch only, as
    in the reference) takes the fp8 transport when ctx.payload_dtype is
    set."""
    if quantize and ctx.payload_dtype is not None:
        return _payload_a2a_quantized(ctx, buf)
    if ctx.method in (EpA2AMethod.PALLAS, EpA2AMethod.PALLAS_FUSED):
        return ll.fast_all_to_all_per_device(ctx.mesh, buf)
    return _exchange(ctx, buf)


def _payload_a2a_quantized(ctx: EpA2AContext,
                           buf: torch.Tensor) -> torch.Tensor:
    """Quantize -> exchange (rows + scales) -> dequantize. PALLAS carries
    both payloads in one launch of B18 (and makes B17's workspace for the
    combine that follows first); XLA exchanges them as two all-to-alls."""
    q, scale = ll.quantize_rows(buf, ctx.payload_dtype)
    if ctx.method in (EpA2AMethod.PALLAS, EpA2AMethod.PALLAS_FUSED):
        ll.prepare(ctx.mesh, buf)
        rq, rs = ll.fast_all_to_all_q_per_device(ctx.mesh, q,
                                                 ll.pack_scales(scale))
        return ll.dequantize_rows(rq, ll.unpack_scales(rs, ctx.max_m),
                                  buf.dtype)
    return ll.dequantize_rows(_exchange(ctx, q), _exchange(ctx, scale),
                              buf.dtype)


def _pack(ctx: EpA2AContext, tokens: torch.Tensor, topk_ids: torch.Tensor,
          lay: DispatchLayout):
    """This rank's send slots: (payload (n, max_m, K), local expert ids
    (n, max_m), the pad sentinel E_loc). Choices at pos >= max_m are
    dropped: they land in a spare slot row n that is cut off."""
    n, e_loc, max_m = ctx.world, ctx.experts_per_rank, ctx.max_m
    topk = topk_ids.shape[-1]
    flat = topk_ids.reshape(-1).to(_I32)
    token_of = torch.arange(flat.shape[0], device=flat.device) // topk
    keep = lay.pos < max_m
    dst = torch.where(keep, lay.dest, n).long()
    pos = torch.clamp(lay.pos, max=max_m - 1).long()
    send_x = tokens.new_zeros((n + 1, max_m, tokens.shape[-1]))
    send_x[dst, pos] = tokens[token_of]
    send_ids = torch.full((n + 1, max_m), e_loc, dtype=_I32,
                          device=flat.device)
    send_ids[dst, pos] = torch.remainder(flat, e_loc)
    return send_x[:n], send_ids[:n]


def _splits(ctx: EpA2AContext, lay: DispatchLayout, send_ids):
    """The splits exchange: (counts (n,) each source sent here, the
    received local ids (n, max_m)), and this source's overflow (1,)."""
    sent = torch.clamp(lay.send_counts, max=ctx.max_m)
    recv_counts = _exchange(ctx, sent)
    recv_ids = _exchange(ctx, send_ids)
    overflow = torch.clamp(lay.send_counts - ctx.max_m, min=0).sum(
        dtype=_I32).reshape(1)
    return recv_counts, recv_ids, overflow


def dispatch_per_device(ctx: EpA2AContext, tokens: torch.Tensor,
                        topk_ids: torch.Tensor) -> Dispatched:
    """This rank's dispatch: tokens (M_local, K), topk_ids (M_local, topk)
    GLOBAL expert ids. The splits exchange, then the payload
    (``_payload_a2a``, the fp8 transport when ctx.payload_dtype is
    set)."""
    lay = dispatch_layout(topk_ids, ctx.world, ctx.experts_per_rank)
    send_x, send_ids = _pack(ctx, tokens, topk_ids, lay)
    recv_counts, recv_ids, overflow = _splits(ctx, lay, send_ids)
    recv_x = _payload_a2a(ctx, send_x, quantize=True)
    return Dispatched(recv_x, recv_ids, recv_counts, lay, overflow)


def _recv_tile_schedule(recv_ids: torch.Tensor, n: int, e_loc: int, bm: int,
                        nblk: int):
    """The arrival-ordered expert-tile schedule over the RECEIVED routing:
    chunks are the source ranks, rows their max_m slots, a row's expert
    recv_ids[src, slot] with the pad sentinel e_loc binned last in every
    chunk, so its tiles fall outside used_tiles (pad slots compute
    nothing). In the graph, as the reference's. Returns (sched,
    tiles_ready)."""
    max_m = recv_ids.shape[1]
    sched = moe_utils.live_tile_schedule(recv_ids.reshape(n * max_m, 1), n,
                                         e_loc, bm)
    return moe_utils.arrival_ordered_schedule(sched, max_m, bm, nblk)


def _gg_workspace(mesh, max_m: int, k: int, dtype, nblk: int):
    n = mesh.world
    return op_workspace(mesh, ("ep_dispatch_gg", max_m, k, dtype, nblk),
                        (2, n, max_m, k), dtype, ctl_words=(n - 1) * nblk)


class GgPlan(NamedTuple):
    """B16's tile plan over the received ids (``dispatch_gg_plan``)."""
    sched: moe_utils.AlignedSchedule   # arrival-ordered, contiguous
    ready: torch.Tensor                # (n, nblk) i32 tiles_ready
    counts: torch.Tensor               # (n,) i32 live slots per sender
    nblk: int                          # row blocks a slot travels in


def dispatch_gg_plan(recv_ids: torch.Tensor, recv_counts: torch.Tensor,
                     e_loc: int, bm: int = 128,
                     comm_blocks: int = 4) -> GgPlan:
    """B16's plan: the received ids (n, max_m) and counts (n,) of the
    splits exchange -> the arrival-ordered schedule (tiles of
    min(bm, max(8, max_m)) rows), its release table and
    ``legal_comm_blocks(max_m, comm_blocks)`` row blocks. In the graph."""
    n, max_m = recv_ids.shape
    bm = min(bm, max(8, max_m))
    nblk = moe_utils.legal_comm_blocks(max_m, comm_blocks)
    sched, ready = _recv_tile_schedule(recv_ids, n, e_loc, bm, nblk)
    return GgPlan(moe_utils.AlignedSchedule(*(f.contiguous()
                                              for f in sched)),
                  ready.contiguous(), recv_counts.to(_I32).contiguous(),
                  nblk)


def pallas_dispatch_gg(mesh, send_x: torch.Tensor, recv_ids: torch.Tensor,
                       recv_counts: torch.Tensor, w_gate_up: torch.Tensor,
                       bm: int = 128, comm_blocks: int = 4):
    """B16 on this rank: its payload send_x (n, max_m, K) (slot p for peer
    p), the received local ids (n, max_m) and counts (n,) of the splits
    exchange, its experts' gate/up weights (E_loc, K, NI) -> (received
    rows (n * max_m, K), inter (n * max_m, NI)): inter's row s * max_m + j
    = cast(recv[s, j] @ w_gate_up[id]) with f32 accumulation for the live
    slots (j < counts[s]), 0 for the pad slots. The plan
    (``dispatch_gg_plan``) is built in the graph. CUDA tensors launch the
    kernel (``launch_dispatch_gg``; counted in
    ``pallas_dispatch_gg.launches``); CPU tensors run
    ``plain.dispatch_gg_ref``. Every rank calls it with the same shapes,
    in the same order."""
    if send_x.device.type == "cpu":
        return dispatch_gg_ref(mesh, send_x, recv_ids, recv_counts,
                               w_gate_up)
    if send_x.device.type != "cuda":
        raise ValueError(f"pallas_dispatch_gg: unsupported device "
                         f"{send_x.device}")
    plan = dispatch_gg_plan(recv_ids, recv_counts, w_gate_up.shape[0], bm,
                            comm_blocks)
    out = launch_dispatch_gg(mesh, send_x, plan, w_gate_up)
    pallas_dispatch_gg.launches += 1
    return out


def launch_dispatch_gg(mesh, send_x: torch.Tensor, plan: GgPlan,
                       w_gate_up: torch.Tensor):
    """One launch of B16 on a plan (``pallas_dispatch_gg`` builds it);
    raises on what the kernel does not take."""
    n, max_m, k = send_x.shape
    if mesh is None or mesh.world != n:
        raise ValueError(f"pallas_dispatch_gg: {n} slots need the mesh of "
                         f"{n} ranks; got {mesh}")
    ni = w_gate_up.shape[-1]
    if w_gate_up.ndim != 3 or w_gate_up.shape[1] != k or \
            not send_x.is_contiguous() or send_x.data_ptr() % 16:
        raise ValueError(f"pallas_dispatch_gg: send_x {tuple(send_x.shape)}"
                         f" contiguous and aligned, w_gate_up "
                         f"{tuple(w_gate_up.shape)}")
    vec = check_experts(send_x, w_gate_up, ni, "pallas_dispatch_gg")
    if k % vec:
        raise ValueError(f"pallas_dispatch_gg: K={k} a multiple of {vec}")
    sched, nblk = plan.sched, plan.nblk
    t_tiles, bm = check_schedule(sched, send_x.device, "pallas_dispatch_gg",
                                 n)
    k_chunk, splits = k_split(min(t_tiles, max_m), -(-ni // (32 * vec)), k,
                              _sms(send_x.device))
    ll.prepare(mesh, send_x)          # the combine's B17 that follows
    ws = _gg_workspace(mesh, max_m, k, send_x.dtype, nblk)
    part = torch.empty((splits, n * max_m, ni), dtype=torch.float32,
                       device=send_x.device)
    inter = torch.empty((n * max_m, ni), dtype=send_x.dtype,
                        device=send_x.device)
    recv = torch.empty((n * max_m, k), dtype=send_x.dtype,
                       device=send_x.device)
    fn = build.function("ep_a2a", "td_dispatch_gg", (
        *(ctypes.c_void_p,) * 11, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        *(ctypes.c_int,) * 11, ctypes.c_void_p))
    with torch.cuda.device(send_x.device):
        err = fn(send_x.data_ptr(), sched.row_token.data_ptr(),
                 sched.row_flat.data_ptr(), sched.tile_expert.data_ptr(),
                 sched.used_tiles.data_ptr(), plan.ready.data_ptr(),
                 plan.counts.data_ptr(), w_gate_up.data_ptr(),
                 part.data_ptr(), inter.data_ptr(), recv.data_ptr(),
                 mesh.rank, n, ws.buf.table.data_ptr(), ws.buf.sig_off,
                 ws.ctl.data_ptr(), max_m, k, ni, t_tiles, bm, nblk, k_chunk,
                 splits, min(bm, max_m), mesh.ranks_per_device,
                 _DTYPE_CODE[send_x.dtype], build.stream_of(send_x))
    build.check(err, "pallas_dispatch_gg")
    return recv, inter


pallas_dispatch_gg.launches = 0


def dispatch_gg_per_device(ctx: EpA2AContext, tokens: torch.Tensor,
                           topk_ids: torch.Tensor,
                           w_gate_up: torch.Tensor):
    """Dispatch fused with the gate/up grouped GEMM (method PALLAS_FUSED):
    tokens (M_local, K), topk_ids (M_local, topk) GLOBAL ids, w_gate_up
    (E_loc, K, NI) this rank's experts at full width. Returns
    (Dispatched, inter (n * max_m, NI)): the gate/up projection of every
    received row in slot order, computed as the payload blocks landed; the
    pad slots 0. The splits exchange runs first, so the receiver's tile
    schedule exists before the payload kernel launches."""
    if ctx.payload_dtype is not None:
        raise ValueError(
            "PALLAS_FUSED dispatch supports the full-width payload path; "
            "use PALLAS/XLA for the quantized transport")
    lay = dispatch_layout(topk_ids, ctx.world, ctx.experts_per_rank)
    send_x, send_ids = _pack(ctx, tokens, topk_ids, lay)
    recv_counts, recv_ids, overflow = _splits(ctx, lay, send_ids)
    recv_x, inter = pallas_dispatch_gg(
        ctx.mesh, send_x, recv_ids, recv_counts, w_gate_up, bm=ctx.bm,
        comm_blocks=ctx.comm_blocks if ctx.world > 1 else 1)
    disp = Dispatched(recv_x.reshape(send_x.shape), recv_ids, recv_counts,
                      lay, overflow)
    return disp, inter


def combine_per_device(ctx: EpA2AContext, expert_out: torch.Tensor,
                       disp: Dispatched,
                       topk_weights: torch.Tensor) -> torch.Tensor:
    """Expert outputs back to the tokens' home ranks + the weighted top-k
    sum: expert_out (n, max_m, d), slot s the outputs for rank s's tokens
    in their dispatch order -> (M_local, d) f32. The fold takes each
    token's choices in top-k order, in f32; a dropped choice adds 0."""
    back = _payload_a2a(ctx, expert_out)            # slot s from rank s
    lay = disp.layout
    m, topk = topk_weights.shape
    safe_pos = torch.clamp(lay.pos, max=ctx.max_m - 1).long()
    flat = back[lay.dest.long(), safe_pos].float()  # (M*topk, d)
    flat = torch.where((lay.pos >= ctx.max_m)[:, None],
                       torch.zeros_like(flat), flat)
    rows = (flat * topk_weights.float().reshape(m * topk, 1)).reshape(
        m, topk, -1)
    acc = rows[:, 0]
    for j in range(1, topk):
        acc = acc + rows[:, j]
    return acc


def expert_ids_flat(ctx: EpA2AContext, disp: Dispatched):
    """The dispatched slots flattened for the expert products: (rows (n *
    max_m, K), local ids (n * max_m,)). Pad rows carry the E_loc sentinel
    and a zero payload."""
    n, max_m = ctx.world, ctx.max_m
    return (disp.x.reshape(n * max_m, -1),
            disp.expert_ids.reshape(n * max_m))


def dispatch(ctx: EpA2AContext, tokens: torch.Tensor,
             topk_ids: torch.Tensor) -> Dispatched:
    """The mesh-level dispatch, called by every rank on its tokens (M, K)
    and routing (M, topk). The payload's wire dtype is the quant policy's
    (quant/policy.py ``resolve_ep_payload_dtype``): an explicit
    ctx.payload_dtype wins; under TD_QUANT=always the fp8 transport."""
    from triton_dist_tpu_torch.quant.policy import resolve_ep_payload_dtype
    eff = resolve_ep_payload_dtype(ctx.payload_dtype)
    if eff is not ctx.payload_dtype:
        ctx = dataclasses.replace(ctx, payload_dtype=eff)
    return dispatch_per_device(ctx, tokens, topk_ids)


def dispatch_gg(ctx: EpA2AContext, tokens: torch.Tensor,
                topk_ids: torch.Tensor, w_gate_up: torch.Tensor):
    """The mesh-level fused dispatch + gate/up grouped GEMM, called by
    every rank on its tokens, routing and (E_loc, K, NI) experts. No
    unfused twin to fall back to, as in the reference."""
    return dispatch_gg_per_device(ctx, tokens, topk_ids, w_gate_up)


def combine(ctx: EpA2AContext, expert_out: torch.Tensor, disp: Dispatched,
            topk_weights: torch.Tensor) -> torch.Tensor:
    """The mesh-level combine, called by every rank on its (n, max_m, d)
    expert outputs: its tokens' (M, d) f32 rows."""
    return combine_per_device(ctx, expert_out, disp, topk_weights)
