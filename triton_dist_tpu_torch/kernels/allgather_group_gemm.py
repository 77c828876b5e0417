"""AllGather + MoE grouped GEMM (the reference's
kernels/allgather_group_gemm.py): the gate/up projection of the
tensor-parallel MoE layer.

Every rank holds an (m, K) shard of the tokens (rows sharded over the
mesh), the whole (n*m, topk) routing and its (E, K, N_loc) column shard of
the experts' gate/up weights. Every method returns (out_flat, ag_tokens):
out_flat (n*m*topk, N_loc) token-major (row t*topk + j = choice j of token
t, kernels/moe_utils.py), ag_tokens the gathered (n*m, K) tokens,
rank-major. At world n > 1 (``mesh`` is the ranks' Mesh):

  * XLA — ``dist.all_gather_into_tensor`` of the tokens, then one sorted
    grouped product over them all;
  * XLA_RING — the reference's rank-rotated ring: step s computes the
    shard of chunk (me - s) mod n while it travels on to the right
    (``dist.batch_isend_irecv``);
  * PALLAS — B14 across ranks, ``pallas_ag_group_gemm``: the hand-written
    CUDA kernel ``csrc/moe_group_gemm.cu`` for CUDA tensors (each rank
    pushes its shard in row blocks into every peer, the tiles of a remote
    chunk released in the arrival-ordered schedule), ``ag_group_gemm_ref``
    (NCCL all-gather, then the world-1 plain version per chunk) for CPU
    tensors.

At world 1 the gather is the identity: XLA and XLA_RING are the one
shard's grouped GEMM, PALLAS is B14's world-1 body, ``group_gemm`` (the
kernel for CUDA tensors, ``group_gemm_ref`` for CPU tensors). No
fallback: a CUDA tensor the kernel does not take raises.

The mesh-level ``ag_group_gemm(ctx, tokens, topk_ids, experts_w)``
resolves the method from an ``AgGroupGemmContext``
(``create_ag_group_gemm_context``); under PALLAS it builds the n-chunk
schedule once per call through ``ctx.schedule`` ("auto": in the graph;
"native": the host C++ schedulers; or a precomputed AlignedSchedule) and
runs B14 across ranks, as the reference does. No fault preamble and no
fallback (ROADMAP A8).
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels import moe_utils
from triton_dist_tpu_torch.kernels.allgather_gemm import _peer, check_mesh
from triton_dist_tpu_torch.kernels.plain import dot_f32
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.mesh import comm_axis_size
from triton_dist_tpu_torch.runtime.symm import op_workspace

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BM_MAX = 128           # the kernel's largest tile (moe_group_gemm.cu)
_BLOCKS_PER_SM = 4      # blocks the K split aims for over the live tiles
_K_ROW_STEP = 64        # k_chunk granule: 8 warps x 8 rows per pass


class AgGroupGemmMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    XLA_RING = "xla_ring"
    PALLAS = "pallas"


def resolve_ag_group_gemm_method(method: AgGroupGemmMethod, m_local: int,
                                 topk: int,
                                 cuda: bool = False) -> AgGroupGemmMethod:
    """The port's AUTO rule: PALLAS (the kernel) on CUDA, XLA on the CPU,
    at every world. The reference's size rule weighs TPU ring latency
    against one fused product (queue C)."""
    if method != AgGroupGemmMethod.AUTO:
        return method
    return AgGroupGemmMethod.PALLAS if cuda else AgGroupGemmMethod.XLA


@dataclasses.dataclass
class AgGroupGemmContext:
    """The reference's AgGroupGemmContext: the ranks' Mesh, its axis, the
    routing's experts and top-k, the method, the aligned tile rows of
    PALLAS (bm), the row blocks a shard travels in (comm_blocks) and the
    tile-schedule provider (``moe_utils.make_chunk_schedule``)."""
    mesh: object
    axis: str
    num_experts: int
    topk: int
    method: AgGroupGemmMethod = AgGroupGemmMethod.AUTO
    bm: int = 128
    comm_blocks: int = 4
    schedule: object = "auto"

    def resolve(self, m_local: int) -> AgGroupGemmMethod:
        return resolve_ag_group_gemm_method(
            self.method, m_local, self.topk,
            cuda=self.mesh.device.type == "cuda")


def create_ag_group_gemm_context(mesh, num_experts: int, topk: int,
                                 axis: str = "tp",
                                 **kw) -> AgGroupGemmContext:
    return AgGroupGemmContext(mesh, axis, num_experts, topk, **kw)


def _shard_group_gemm(tokens, topk_ids, experts_w, num_experts):
    """Grouped GEMM for one token shard; returns token-major flat rows."""
    st = moe_utils.sort_by_expert(topk_ids, num_experts)
    lhs = moe_utils.gather_sorted(tokens, st)
    out_sorted = moe_utils.grouped_gemm(lhs, experts_w, st.group_sizes)
    return moe_utils.unsort(out_sorted, st)


def k_split(live_tiles: int, col_tiles: int, k: int,
            sm_count: int) -> tuple[int, int]:
    """(k_chunk, splits): cut K so that about _BLOCKS_PER_SM blocks per SM
    run over the live tiles' column tiles."""
    target = _BLOCKS_PER_SM * sm_count
    splits = max(1, min(-(-target // (live_tiles * col_tiles)),
                        k // _K_ROW_STEP))
    k_chunk = -(-k // splits)
    k_chunk = -(-k_chunk // _K_ROW_STEP) * _K_ROW_STEP
    return k_chunk, -(-k // k_chunk)


def group_gemm_ref(tokens: torch.Tensor, experts_w: torch.Tensor,
                   sched: moe_utils.AlignedSchedule, topk: int,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of B14 at one chunk: tile by tile, the tile's rows
    (row_token, the sentinel clamped to the last token) times its
    expert's weight with f32 accumulation, cast (to ``out_dtype``, default
    the inputs' dtype), written to the live slots' flat rows; rows no live
    slot writes are 0. Reads used_tiles on the host."""
    m = tokens.shape[0]
    nf = m * topk
    t_tiles = sched.tile_expert.shape[1]
    bm = sched.row_token.shape[1] // t_tiles
    dtype = out_dtype or torch.result_type(tokens, experts_w)
    out = torch.zeros((nf, experts_w.shape[-1]), dtype=dtype,
                      device=tokens.device)
    for t in range(int(sched.used_tiles[0])):
        rows = sched.row_token[0, t * bm:(t + 1) * bm].clamp(max=m - 1)
        o = dot_f32(tokens[rows.long()],
                    experts_w[int(sched.tile_expert[0, t])]).to(dtype)
        dst = sched.row_flat[0, t * bm:(t + 1) * bm]
        live = dst < nf
        out[dst[live].long()] = o[live]
    return out


def group_gemm(tokens: torch.Tensor, experts_w: torch.Tensor,
               sched: moe_utils.AlignedSchedule, topk: int,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """B14 at one chunk: (M*topk, N) token-major rows, row f =
    cast(tokens[f // topk] @ experts_w[expert of f]) with f32
    accumulation; ``out_dtype`` torch.float32 keeps the f32 sums (the
    expert-parallel layer's down product), the default casts to the
    inputs' dtype. A row that no live tile holds (an expert-parallel pad
    slot) is 0. CUDA tensors launch the kernel (counted in
    ``group_gemm.launches``); CPU tensors run ``group_gemm_ref``."""
    if out_dtype not in (None, torch.float32, tokens.dtype):
        raise ValueError(f"group_gemm: out_dtype {out_dtype} is neither "
                         f"f32 nor the inputs' {tokens.dtype}")
    if tokens.device.type == "cpu":
        return group_gemm_ref(tokens, experts_w, sched, topk, out_dtype)
    if tokens.device.type != "cuda":
        raise ValueError(f"group_gemm: unsupported device {tokens.device}")
    return _launch(tokens.contiguous(), experts_w, sched, topk,
                   out_dtype == torch.float32)


group_gemm.launches = 0


def chunk_of(sched: moe_utils.AlignedSchedule,
             c: int) -> moe_utils.AlignedSchedule:
    """Chunk c of an n-chunk schedule, as a one-chunk schedule (views)."""
    return moe_utils.AlignedSchedule(*(f[c:c + 1] for f in sched))


def ag_group_gemm_ref_chunks(ag: torch.Tensor, experts_w: torch.Tensor,
                             sched: moe_utils.AlignedSchedule,
                             topk: int) -> torch.Tensor:
    """Plain version of B14 across ranks once the tokens are gathered: the
    world-1 plain version on each chunk's m rows with its schedule, the
    chunks' flat rows in chunk order."""
    n = sched.tile_expert.shape[0]
    m = ag.shape[0] // n
    return torch.cat([group_gemm_ref(ag[c * m:(c + 1) * m], experts_w,
                                     chunk_of(sched, c), topk)
                      for c in range(n)])


def ag_group_gemm_ref(mesh, tokens: torch.Tensor, experts_w: torch.Tensor,
                      sched: moe_utils.AlignedSchedule, topk: int):
    """Plain version of B14 across ranks: the tokens all-gathered over the
    process group, then ``ag_group_gemm_ref_chunks``. Returns (out_flat,
    ag_tokens)."""
    ag = torch.empty((mesh.world * tokens.shape[0], tokens.shape[1]),
                     dtype=tokens.dtype, device=tokens.device)
    dist.all_gather_into_tensor(ag, tokens.contiguous(), group=mesh.group)
    return ag_group_gemm_ref_chunks(ag, experts_w, sched, topk), ag


def pallas_ag_group_gemm(mesh, tokens: torch.Tensor, experts_w: torch.Tensor,
                         sched: moe_utils.AlignedSchedule, topk: int,
                         comm_blocks: int = 4):
    """B14 across ranks on this rank: (out_flat (n*m*topk, N_loc),
    ag_tokens (n*m, K)) for its (m, K) tokens, the n-chunk schedule of the
    whole routing and its (E, K, N_loc) weight shard. CUDA tensors launch
    the kernel (counted in ``pallas_ag_group_gemm.launches``); the tokens
    travel in ``legal_comm_blocks(m, comm_blocks)`` row blocks. CPU
    tensors run ``ag_group_gemm_ref``. Every rank calls it with the same
    shapes, in the same order."""
    if tokens.device.type == "cpu":
        return ag_group_gemm_ref(mesh, tokens, experts_w, sched, topk)
    if tokens.device.type != "cuda":
        raise ValueError(
            f"pallas_ag_group_gemm: unsupported device {tokens.device}")
    out = _launch_tp(mesh, tokens.contiguous(), experts_w, sched, topk,
                     comm_blocks)
    pallas_ag_group_gemm.launches += 1
    return out


pallas_ag_group_gemm.launches = 0


def _ring_per_device(mesh, num_experts, tokens, topk_ids_full, experts_w):
    """XLA_RING (the reference's _ring_per_device): n rank-rotated steps,
    step s computing the shard of chunk (me - s) mod n while sending it
    to the right neighbour and receiving the next from the left."""
    n, me, m = mesh.world, mesh.rank, tokens.shape[0]
    topk = topk_ids_full.shape[-1]
    right, left = _peer(mesh, (me + 1) % n), _peer(mesh, (me - 1) % n)
    out = torch.empty((n * m * topk, experts_w.shape[-1]),
                      dtype=torch.result_type(tokens, experts_w),
                      device=tokens.device)
    ag = torch.empty((n * m, tokens.shape[1]), dtype=tokens.dtype,
                     device=tokens.device)
    cur = tokens.contiguous()
    for s in range(n):
        c = (me - s) % n
        reqs = []
        if s < n - 1:
            nxt = torch.empty_like(cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, right, mesh.group),
                dist.P2POp(dist.irecv, nxt, left, mesh.group)])
        out[c * m * topk:(c + 1) * m * topk] = _shard_group_gemm(
            cur, topk_ids_full[c * m:(c + 1) * m], experts_w, num_experts)
        ag[c * m:(c + 1) * m] = cur
        for r in reqs:
            r.wait()
        if s < n - 1:
            cur = nxt
    return out, ag


def _pallas_per_device(n, num_experts, bm, tokens, topk_ids_full, experts_w,
                       sched=None, mesh=None, comm_blocks=4):
    m = tokens.shape[0]
    topk = topk_ids_full.shape[-1]
    bm = min(bm, max(8, m * topk))
    if sched is None:
        sched = moe_utils.aligned_chunk_schedule(topk_ids_full, n,
                                                 num_experts, bm)
    t_tiles = sched.tile_expert.shape[1]
    if sched.row_token.shape[1] != t_tiles * bm:
        raise ValueError(
            f"schedule row length {sched.row_token.shape[1]} != "
            f"t_tiles*bm = {t_tiles}*{bm}; the schedule was built with a "
            "different block size than the kernel is running")
    if n == 1:
        # one chunk in one block: the arrival order is the identity, every
        # live tile is released at once (moe_utils.arrival_ordered_schedule)
        return group_gemm(tokens, experts_w, sched, topk), tokens
    return pallas_ag_group_gemm(mesh, tokens, experts_w, sched, topk,
                                comm_blocks)


def ag_group_gemm_per_device(n: int, num_experts: int,
                             method: AgGroupGemmMethod, tokens: torch.Tensor,
                             topk_ids_full: torch.Tensor,
                             experts_w: torch.Tensor, bm: int = 128,
                             comm_blocks: int = 4, sched=None, mesh=None):
    """The reference's per-device body. tokens (m, K) this rank's shard;
    topk_ids_full (n*m, topk) the whole routing; experts_w (E, K, N_loc).
    sched: optional precomputed n-chunk AlignedSchedule for PALLAS.
    comm_blocks: the row blocks B14 pushes a shard in. ``mesh`` (the
    ranks' Mesh) is needed at n > 1."""
    if method not in (AgGroupGemmMethod.XLA, AgGroupGemmMethod.XLA_RING,
                      AgGroupGemmMethod.PALLAS):
        raise ValueError(f"unresolved method {method}")
    check_mesh(n, mesh, "ag_group_gemm")
    if method == AgGroupGemmMethod.PALLAS:
        return _pallas_per_device(n, num_experts, bm, tokens, topk_ids_full,
                                  experts_w, sched=sched, mesh=mesh,
                                  comm_blocks=comm_blocks)
    if n == 1:
        return _shard_group_gemm(tokens, topk_ids_full, experts_w,
                                 num_experts), tokens
    if method == AgGroupGemmMethod.XLA:
        ag = torch.empty((n * tokens.shape[0], tokens.shape[1]),
                         dtype=tokens.dtype, device=tokens.device)
        dist.all_gather_into_tensor(ag, tokens.contiguous(),
                                    group=mesh.group)
        return _shard_group_gemm(ag, topk_ids_full, experts_w,
                                 num_experts), ag
    return _ring_per_device(mesh, num_experts, tokens, topk_ids_full,
                            experts_w)


def ag_group_gemm(ctx: AgGroupGemmContext, tokens: torch.Tensor,
                  topk_ids: torch.Tensor, experts_w: torch.Tensor):
    """The mesh-level AllGather + grouped GEMM (the reference's
    ``ag_group_gemm``), called by every rank: tokens (m, K) its shard,
    topk_ids (n*m, topk) the whole routing, experts_w (E, K, N_loc) its
    column shard -> (out_flat (n*m*topk, N_loc), ag_tokens (n*m, K))."""
    n = comm_axis_size(ctx.mesh, ctx.axis)
    m_loc = tokens.shape[0]
    method = ctx.resolve(m_loc)
    if method == AgGroupGemmMethod.PALLAS:
        bm = min(ctx.bm, max(8, m_loc * ctx.topk))
        sched = moe_utils.make_chunk_schedule(topk_ids, n, ctx.num_experts,
                                              bm, provider=ctx.schedule)
        return ag_group_gemm_per_device(
            n, ctx.num_experts, method, tokens, topk_ids, experts_w, bm=bm,
            comm_blocks=ctx.comm_blocks, sched=sched, mesh=ctx.mesh)
    return ag_group_gemm_per_device(
        n, ctx.num_experts, method, tokens, topk_ids, experts_w, bm=ctx.bm,
        comm_blocks=ctx.comm_blocks, mesh=ctx.mesh)


def check_schedule(sched: moe_utils.AlignedSchedule, dev: torch.device,
                   what: str, n_chunks: int = 1) -> tuple[int, int]:
    """(t_tiles, bm) of an n_chunks-chunk schedule the kernels can read:
    int32, contiguous, on ``dev``, bm <= 128. Raises otherwise."""
    rows, r = sched.row_token.shape
    t_tiles = sched.tile_expert.shape[1]
    if rows != n_chunks or r % t_tiles or r // t_tiles > _BM_MAX:
        raise ValueError(f"{what}: {n_chunks} chunk(s) with bm <= {_BM_MAX} "
                         f"expected; schedule rows "
                         f"{tuple(sched.row_token.shape)}, tiles {t_tiles}")
    for name, f in zip(sched._fields, sched):
        if f.dtype != torch.int32 or f.device != dev or \
                not f.is_contiguous():
            raise ValueError(f"{what}: schedule field {name} must be "
                             f"contiguous int32 on {dev}")
    return t_tiles, r // t_tiles


def check_experts(x: torch.Tensor, experts_w: torch.Tensor, n_cols: int,
                  what: str) -> int:
    """The dtype checks of the grouped-GEMM kernels: x and experts_w share
    one dtype of the kernels', experts_w contiguous, 16-byte aligned, on
    x's device, N a multiple of the 16-byte vector. Returns the vector's
    element count."""
    if x.dtype not in _DTYPE_CODE or experts_w.dtype != x.dtype:
        raise ValueError(f"{what}: the rows and experts_w must share one "
                         f"dtype of {list(_DTYPE_CODE)}; got {x.dtype}/"
                         f"{experts_w.dtype}")
    vec = 16 // x.element_size()
    if n_cols % vec or not experts_w.is_contiguous() or \
            experts_w.device != x.device or experts_w.data_ptr() % 16:
        raise ValueError(f"{what}: experts_w must be contiguous, 16-byte "
                         f"aligned, on {x.device}, N={n_cols} a multiple of "
                         f"{vec}")
    return vec


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(tokens, experts_w, sched, topk, out_f32=False):
    dev = tokens.device
    if tokens.ndim != 2 or experts_w.ndim != 3 or \
            experts_w.shape[1] != tokens.shape[1]:
        raise ValueError(f"group_gemm: tokens {tuple(tokens.shape)}, "
                         f"experts_w {tuple(experts_w.shape)}")
    m, k = tokens.shape
    nn = experts_w.shape[2]
    vec = check_experts(tokens, experts_w, nn, "group_gemm")
    t_tiles, bm = check_schedule(sched, dev, "group_gemm")
    nf = m * topk
    k_chunk, splits = k_split(min(t_tiles, nf), -(-nn // (32 * vec)), k,
                              _sms(dev))
    # zeroed: a row no live slot writes (a pad slot) sums to 0
    part = torch.zeros((splits, nf, nn), dtype=torch.float32, device=dev)
    out = torch.empty((nf, nn), dtype=torch.float32 if out_f32
                      else tokens.dtype, device=dev)
    fn = build.function("moe_group_gemm", "td_group_gemm", (
        ctypes.c_void_p, ctypes.c_int, *(ctypes.c_void_p,) * 7,
        *(ctypes.c_int,) * 10, ctypes.c_void_p))
    with torch.cuda.device(dev):
        err = fn(tokens.data_ptr(), m, sched.row_token.data_ptr(),
                 sched.row_flat.data_ptr(), sched.tile_expert.data_ptr(),
                 sched.used_tiles.data_ptr(), experts_w.data_ptr(),
                 part.data_ptr(), out.data_ptr(), t_tiles, bm, k, nn,
                 k_chunk, splits, nf, min(bm, m), _DTYPE_CODE[tokens.dtype],
                 int(out_f32), build.stream_of(tokens))
    build.check(err, "group_gemm")
    group_gemm.launches += 1
    return out


def _launch_tp(mesh, tokens, experts_w, sched, topk, comm_blocks):
    """B14 across ranks: the K split of the world-1 kernel at one chunk (so
    every row has the world-1 kernel's bits), the arrival-ordered
    schedule, the rank's symmetric gather buffer; B15's workspace of the
    same layer made first (see ``moe_reduce_rs.tp_workspace``)."""
    from triton_dist_tpu_torch.kernels.moe_reduce_rs import tp_workspace
    dev = tokens.device
    n = mesh.world
    if tokens.ndim != 2 or experts_w.ndim != 3 or \
            experts_w.shape[1] != tokens.shape[1]:
        raise ValueError(f"pallas_ag_group_gemm: tokens "
                         f"{tuple(tokens.shape)}, experts_w "
                         f"{tuple(experts_w.shape)}")
    m, k = tokens.shape
    nn = experts_w.shape[2]
    vec = check_experts(tokens, experts_w, nn, "pallas_ag_group_gemm")
    if k % vec or tokens.data_ptr() % 16:
        raise ValueError(f"pallas_ag_group_gemm: K={k} a multiple of {vec}, "
                         "tokens 16-byte aligned")
    t_tiles, bm = check_schedule(sched, dev, "pallas_ag_group_gemm", n)
    nblk = moe_utils.legal_comm_blocks(m, comm_blocks)
    sched2, ready = moe_utils.arrival_ordered_schedule(sched, m, bm, nblk)
    sched2 = moe_utils.AlignedSchedule(*(f.contiguous() for f in sched2))
    ready = ready.contiguous()
    nf = m * topk
    k_chunk, splits = k_split(min(t_tiles, nf), -(-nn // (32 * vec)), k,
                              _sms(dev))
    tp_workspace(mesh, m, k, tokens.dtype)
    ws = op_workspace(mesh, ("ag_group_gemm", m, k, tokens.dtype, nblk),
                      (2, n, m, k), tokens.dtype,
                      ctl_words=(n - 1) * nblk)
    part = torch.empty((splits, n * nf, nn), dtype=torch.float32,
                       device=dev)
    out = torch.empty((n * nf, nn), dtype=tokens.dtype, device=dev)
    ag = torch.empty((n * m, k), dtype=tokens.dtype, device=dev)
    fn = build.function("moe_group_gemm", "td_ag_group_gemm", (
        *(ctypes.c_void_p,) * 10, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        *(ctypes.c_int,) * 12, ctypes.c_void_p))
    with torch.cuda.device(dev):
        err = fn(tokens.data_ptr(), sched2.row_token.data_ptr(),
                 sched2.row_flat.data_ptr(), sched2.tile_expert.data_ptr(),
                 sched2.used_tiles.data_ptr(), ready.data_ptr(),
                 experts_w.data_ptr(), part.data_ptr(), out.data_ptr(),
                 ag.data_ptr(), mesh.rank, n, ws.buf.table.data_ptr(),
                 ws.buf.sig_off, ws.ctl.data_ptr(), m, k, nn, t_tiles, bm,
                 nblk, topk, k_chunk, splits, min(bm, m),
                 mesh.ranks_per_device, _DTYPE_CODE[tokens.dtype],
                 build.stream_of(tokens))
    build.check(err, "pallas_ag_group_gemm")
    return out, ag
