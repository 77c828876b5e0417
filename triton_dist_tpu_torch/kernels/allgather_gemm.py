"""AllGather + GEMM (the reference's kernels/allgather_gemm.py).

Every rank holds an (m, K) shard of A (rows sharded over the mesh) and a
(K, N_loc) column shard of B; the op returns (allgather(a) @ b, allgather(a))
with f32 accumulation and one cast: out (n*m, N_loc), gathered A (n*m, K),
rank-major. Methods at world n > 1 (``mesh`` is the ranks' Mesh):

  * XLA — ``dist.all_gather_into_tensor`` then ``matmul_ref``: B10's plain
    version, and the unfused baseline;
  * XLA_RING — the reference's collective matmul (its default): n ring
    steps of ``dist.batch_isend_irecv``, step s multiplying the shard of
    rank (me - s) mod n while it travels on to the right;
  * PALLAS — B10, ``pallas_ag_gemm``: the hand-written CUDA kernel
    ``csrc/ag_gemm.cu`` for CUDA tensors (one-hop push of the own shard
    into every rank's symmetric buffer beside the GEMM, which reads each
    row block as its flag rises; in bf16 two regimes by ``ag_plan``: the
    TMA weight stream at a few gathered rows, the wgmma tile GEMM above),
    ``ag_gemm_ref`` for CPU tensors. No fallback: a CUDA call the kernel
    does not take raises;
  * XLA_BIDIR — the reference's bidirectional collective matmul: the
    shard travels both ring directions at once (``dist.batch_isend_irecv``
    to both neighbours), kr = n // 2 rounds to the right and kl =
    (n - 1) // 2 to the left, one (2m, K) product per round;
  * PALLAS_BIDIR — B11 at n >= 3, ``pallas_ag_gemm_bidir``: the
    hand-written CUDA kernel of ``csrc/ag_gemm.cu`` for CUDA tensors (the
    reference's neighbour-forwarding schedule over both directions, B10's
    GEMM, so out is B10's bits), ``ag_gemm_ref`` for CPU tensors; at
    n <= 2 there is no second direction and it is B10, as in the
    reference.

The mesh-level ``ag_gemm(ctx, a, b)`` resolves the method from an
``AgGemmContext`` (``create_ag_gemm_context``) and runs the per-device
entry on this rank's shards. A context with ``dcn_axis`` set (the 2-D
schedule over a multi-axis mesh) raises naming ROADMAP A9 (tail). The
mesh-level op has no fault preamble and no fallback (ROADMAP A8).

At world 1 the gather is the identity and every method computes
out = cast(a @ b), returning (out, a): XLA, XLA_RING and XLA_BIDIR the
plain product, PALLAS and PALLAS_BIDIR B12 (``pallas_matmul``, the
reference's ``_pallas_matmul``, its n == 1 path; ``csrc/matmul.cu``).

The TPU tile sizes (bm, bn, bk) have nothing to choose on the card: in
bf16 ``ag_plan`` cuts the launch (the weight stream's units,
``stream_plan``, at one 16-row M group of gathered rows, or up to
AG_STREAM_L2_ROWS while the card's weights fit its L2; else 128 x 256
tiles in ``ag_row_order``'s order), in f32 the K split fills the card
(``gemm_allreduce.split_plan``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels.gemm_allreduce import (
    _DTYPE_CODE, StreamPlan, split_plan, splitk_launch, stream_plan,
)
from triton_dist_tpu_torch.kernels.plain import dot_f32
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.mesh import comm_axis_size
from triton_dist_tpu_torch.runtime.symm import op_workspace

_ALIGN = 256


class AgGemmMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    XLA_RING = "xla_ring"
    XLA_BIDIR = "xla_bidir"
    PALLAS = "pallas"
    PALLAS_BIDIR = "pallas_bidir"


def check_mesh(n: int, mesh, what: str) -> None:
    """World n > 1 needs the ranks' mesh, of that size."""
    if n > 1 and (mesh is None or mesh.world != n):
        raise ValueError(f"{what} at world {n} needs the mesh of its {n} "
                         f"ranks; got {mesh}")


def check_not_2d(dcn_axis, what: str) -> None:
    """The 2-D schedules (a context with dcn_axis) need a multi-axis
    mesh."""
    if dcn_axis is not None:
        raise NotImplementedError(
            f"{what} over a factored (dcn_axis x axis) mesh waits for "
            "ROADMAP A9 (tail): the 2-D variants need A1's multi-axis "
            "meshes")


@dataclasses.dataclass
class AgGemmContext:
    """The reference's AgGemmContext: the ranks' Mesh, its axis, the
    method and the TPU kernel's tiles (carried for the reference's
    signatures; nothing on the card reads them: the K split is sized to
    fill the card). dcn_axis, set, raises in ``ag_gemm``: ROADMAP A9
    (tail)."""
    mesh: object
    axis: str = "tp"
    method: AgGemmMethod = AgGemmMethod.AUTO
    bm: int = 512
    bn: int = 1024
    bk: int = 512
    dcn_axis: str | None = None

    @property
    def world(self) -> int:
        return comm_axis_size(self.mesh, self.axis)

    def resolve(self) -> AgGemmMethod:
        """The reference's rule, platform-neutral: an explicit method
        stands; AUTO is XLA at world 1, XLA_RING above."""
        if self.method != AgGemmMethod.AUTO:
            return self.method
        if self.world == 1:
            return AgGemmMethod.XLA
        return AgGemmMethod.XLA_RING

    def resolve_for(self, m: int, k: int, n_local: int, dtype=None):
        """(method, bm, bn, bk) for the local dims (m, k, n_local). The
        reference consults tools/tune.py's tables, measured on a TPU; the
        port has no tuned table until ROADMAP A16's tuner, so this is
        ``resolve()`` with the context's tiles."""
        return self.resolve(), self.bm, self.bn, self.bk


def create_ag_gemm_context(mesh, axis: str = "tp", **kw) -> AgGemmContext:
    return AgGemmContext(mesh, axis, **kw)


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of B12: (M, K) @ (K, N) with f32 accumulation, one
    cast to the inputs' result dtype."""
    return dot_f32(a, b).to(torch.result_type(a, b))


def pallas_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B12: cast(a @ b) with a K-split f32 accumulator, a (M, K), b (K, N).
    CUDA tensors launch the kernel (counted in ``pallas_matmul.launches``);
    CPU tensors run ``matmul_ref``."""
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"pallas_matmul: unsupported device {a.device}")
    out = splitk_launch(a.contiguous(), b, "matmul", "td_matmul",
                        "pallas_matmul")
    pallas_matmul.launches += 1
    return out


pallas_matmul.launches = 0


def _peer(mesh, r: int) -> int:
    return dist.get_global_rank(mesh.group, r)


def ag_gemm_ref(mesh, a: torch.Tensor, b: torch.Tensor):
    """Plain version of B10 (the XLA tier): all-gather the row shards,
    then one product with f32 accumulation and one cast."""
    ag = torch.empty((mesh.world * a.shape[0], a.shape[1]), dtype=a.dtype,
                     device=a.device)
    dist.all_gather_into_tensor(ag, a.contiguous(), group=mesh.group)
    return matmul_ref(ag, b), ag


def ag_gemm_ref_shards(a_shards, b: torch.Tensor):
    """Plain version of B10 over the shards of every rank in one process
    (the one-card world): concatenate, then ``matmul_ref``."""
    ag = torch.cat(list(a_shards), dim=0)
    return matmul_ref(ag, b), ag


def _ring_ag_gemm(mesh, a: torch.Tensor, b: torch.Tensor):
    """XLA_RING: step s multiplies the shard of rank (me - s) mod n while
    sending it to the right neighbour and receiving the next from the
    left (the reference's _ring_matmul_per_device)."""
    n, me, m = mesh.world, mesh.rank, a.shape[0]
    right, left = _peer(mesh, (me + 1) % n), _peer(mesh, (me - 1) % n)
    out = torch.empty((n * m, b.shape[1]), dtype=torch.result_type(a, b),
                      device=a.device)
    ag = torch.empty((n * m, a.shape[1]), dtype=a.dtype, device=a.device)
    cur = a.contiguous()
    for s in range(n):
        chunk = (me - s) % n
        reqs = []
        if s < n - 1:
            nxt = torch.empty_like(cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, right, mesh.group),
                dist.P2POp(dist.irecv, nxt, left, mesh.group)])
        out[chunk * m:(chunk + 1) * m] = matmul_ref(cur, b)
        ag[chunk * m:(chunk + 1) * m] = cur
        for r in reqs:
            r.wait()
        if s < n - 1:
            cur = nxt
    return out, ag


def _bidir_ring_ag_gemm(mesh, a: torch.Tensor, b: torch.Tensor):
    """XLA_BIDIR (the reference's _bidir_ring_matmul_per_device): the own
    shard first; at round s the shard of rank (me - s) arrives from the
    left (s <= kr = n // 2) and that of rank (me + s) from the right
    (s <= kl = (n - 1) // 2), both multiplied in one (2m, K) product."""
    n, me, m = mesh.world, mesh.rank, a.shape[0]
    kr, kl = n // 2, (n - 1) // 2
    right, left = _peer(mesh, (me + 1) % n), _peer(mesh, (me - 1) % n)
    dt = torch.result_type(a, b)
    out = torch.empty((n * m, b.shape[1]), dtype=dt, device=a.device)
    ag = torch.empty((n * m, a.shape[1]), dtype=a.dtype, device=a.device)
    a = a.contiguous()

    def put(c, prod, rows):
        out[c * m:(c + 1) * m] = prod.to(dt)
        ag[c * m:(c + 1) * m] = rows

    put(me, dot_f32(a, b), a)
    a_r = a_l = a
    for s in range(1, kr + 1):
        nr = torch.empty_like(a)
        ops = [dist.P2POp(dist.isend, a_r, right, mesh.group),
               dist.P2POp(dist.irecv, nr, left, mesh.group)]
        if s <= kl:
            nl = torch.empty_like(a)
            ops += [dist.P2POp(dist.isend, a_l, left, mesh.group),
                    dist.P2POp(dist.irecv, nl, right, mesh.group)]
        for r in dist.batch_isend_irecv(ops):
            r.wait()
        a_r = nr
        if s <= kl:
            a_l = nl
            prod = dot_f32(torch.cat([a_r, a_l]), b)
            put((me - s) % n, prod[:m], a_r)
            put((me + s) % n, prod[m:], a_l)
        else:
            put((me - s) % n, dot_f32(a_r, b), a_r)
    return out, ag


# csrc/ag_gemm.cu, bf16: the regime is the plan's. The weight stream
# (gemm_stream_sm90.cuh) reads W once a 16-row M group of the gathered
# rows; the wgmma tile GEMM (gemm_tile_sm90.cuh) reads it once, but a
# wave of its 128 x 256 tiles runs on as few as 10 clusters. Timed on
# H100s at 16-2,048 gathered rows (chip_compare.py --ag --sweep): the
# stream wins at one M group whatever W, and further groups re-read W
# from L2 cheaply only while the weights the card streams (W times the
# ranks it hosts) fit there (QKV of Qwen3-32B at TP=4 on four cards, up
# to 128 rows); else the tile GEMM wins from the second group.
AG_STREAM_MAX_ROWS = 16       # one M group: the stream whatever W
AG_STREAM_L2_ROWS = 128       # while the card's weights fit its L2
# csrc/gemm_tile_sm90.cuh
TILE_BM = 128         # rows a tile; also the prefill's row block (flags)
TILE_BN = 256         # columns a tile
TILE_BK = 64          # K a stage
TILE_STAGES = 4
TILE_GM = 16          # row tiles a group of the order
TILE_GN = 4           # column tiles a column group
TILE_CLUSTER = 2      # blocks a cluster, W multicast to both
TILE_SMEM_BYTES = (1024 + TILE_STAGES * (TILE_BM + TILE_BN) * TILE_BK * 2
                   + 2 * TILE_STAGES * 8)
_CARD: dict = {}          # device -> (its SM count, its L2 bytes)


@dataclasses.dataclass(frozen=True)
class AgPlan:
    """The bf16 launch of B10 / B11 (csrc/ag_gemm.cu checks it and takes
    its regime): the same on every rank of a world and for both kernels,
    so B11 computes B10's bits. regime "stream" (gemm_stream_sm90.cuh's
    stream-K units over the landed rows, ``stream`` its cut) or "tile"
    (gemm_tile_sm90.cuh's 128 x 256 tiles, taken in pairs by clusters of
    TILE_CLUSTER blocks); grid: blocks, at most the SMs a rank gets (whole
    clusters for tiles); rb: rows a row block, the granule of the push
    and its flags (the shard for the stream, TILE_BM for tiles). The
    symmetric buffer: the landing rows (2, world * m, K) bf16 from byte 0
    (halves by parity), the flags u64 (2, world, mb) at flag_off. The
    control block after its header: a counter per (chunk, row block),
    then the stream kernel's tickets (4 int32 a block, for the most
    blocks a rank gets: one workspace serves every N of one regime at one
    (m, K))."""
    world: int
    m: int
    k: int
    n: int
    regime: str
    grid: int
    rb: int
    max_grid: int
    stream: StreamPlan | None = None

    @property
    def rows(self) -> int:
        return self.world * self.m

    @property
    def mb(self) -> int:
        return -(-self.m // self.rb)

    @property
    def row_tiles(self) -> int:
        return -(-self.rows // TILE_BM)

    @property
    def col_tiles(self) -> int:
        return -(-self.n // TILE_BN)

    @property
    def row_pairs(self) -> int:
        return -(-self.row_tiles // TILE_CLUSTER)

    @property
    def tiles(self) -> int:
        """The tile kernel's work items: pair tiles (a row pair, one
        column tile), one a cluster at a time."""
        return self.row_pairs * self.col_tiles

    @property
    def half_bytes(self) -> int:
        return self.rows * self.k * 2

    @property
    def flag_off(self) -> int:
        return -(-2 * self.half_bytes // _ALIGN) * _ALIGN

    @property
    def nbytes(self) -> int:
        return self.flag_off + 2 * self.world * self.mb * 8

    @property
    def ticket_word(self) -> int:
        """The tickets' first control-block word (after the header)."""
        return self.world * self.mb

    @property
    def ctl_words(self) -> int:
        return self.ticket_word + 2 * self.max_grid


def ag_plan(world: int, m: int, k: int, n: int, sm_count: int,
            ranks_per_device: int, l2_bytes: int) -> AgPlan:
    """B10 / B11's bf16 plan for a rank's (m, K) shard against W (K, N)
    on a card of `sm_count` SMs and `l2_bytes` of L2 that hosts
    `ranks_per_device` ranks."""
    rows = world * m
    per = max(1, sm_count // ranks_per_device)
    if rows <= AG_STREAM_MAX_ROWS or (
            rows <= AG_STREAM_L2_ROWS
            and k * n * 2 * ranks_per_device <= l2_bytes):
        sp = stream_plan(rows, k, n, per)
        return AgPlan(world, m, k, n, "stream", sp.grid, m, per, sp)
    pairs = -(-(-(-rows // TILE_BM)) // TILE_CLUSTER) * -(-n // TILE_BN)
    grid = TILE_CLUSTER * min(per // TILE_CLUSTER, pairs)
    return AgPlan(world, m, k, n, "tile", grid, TILE_BM, per)


def chunk_key(world: int, rank: int, c: int, bidir: bool) -> tuple:
    """When chunk c lands on `rank`, as an order key: B10 (one hop from
    every rank) by rank distance, the next rank first; B11 by the ring
    round it arrives in (me - s from the left at round s <= n // 2, me + s
    from the right at s <= (n - 1) // 2), the left first on a tie."""
    if not bidir:
        return ((c - rank) % world,)
    d_left = (rank - c) % world
    if d_left == 0:
        return (0, 0)
    if d_left <= world // 2:
        return (d_left, 0)
    return ((c - rank) % world, 1)


def tile_chunks(rows: int, m: int, r0: int, r1: int) -> range:
    """The chunks (ranks' shards) that gathered rows [r0, r1) come from."""
    return range(r0 // m, (min(r1, rows) - 1) // m + 1)


def ag_row_order(world: int, rank: int, m: int, bidir: bool) -> list[int]:
    """The prefill's row tiles in the order they run on `rank`: each tile
    keyed by the latest-landing chunk it reads (chunk_key), ties by
    index; so the own shard's tiles first, then the others as they land."""
    rows = world * m
    keys = []
    for t in range(-(-rows // TILE_BM)):
        cs = tile_chunks(rows, m, t * TILE_BM, (t + 1) * TILE_BM)
        keys.append((max(chunk_key(world, rank, c, bidir) for c in cs), t))
    return [t for _, t in sorted(keys)]


def _card(dev) -> tuple[int, int]:
    card = _CARD.get(dev)
    if card is None:
        prop = torch.cuda.get_device_properties(dev)
        card = _CARD[dev] = (prop.multi_processor_count, prop.L2_cache_size)
    return card


def _row_order(mesh, m: int, bidir: bool, dev) -> torch.Tensor:
    """This rank's row order on the card (int32), made on first use and
    kept with the mesh's workspaces; never under CUDA-graph capture."""
    key = ("ag_gemm_order", bidir, m)
    t = mesh.workspaces.get(key)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{key}: first call under CUDA-graph "
                               "capture; warm up before capturing")
        t = mesh.workspaces[key] = torch.tensor(
            ag_row_order(mesh.world, mesh.rank, m, bidir), dtype=torch.int32,
            device=dev)
    return t


def ag_workspace(mesh, plan: AgPlan, bidir: bool):
    """The bf16 workspace of B10 (bidir False) or B11 at the plan's
    regime and (m, K): every N of that regime at that (m, K) shares it
    (the QKV and gate/up products of a layer, when both take one regime).
    Made on first use (a collective allocation; never under capture)."""
    return op_workspace(mesh, ("ag_gemm_bf16", bidir, plan.regime, plan.m,
                               plan.k),
                        (plan.nbytes,), torch.uint8,
                        ctl_words=plan.ctl_words)


def _ag_launch(mesh, a: torch.Tensor, b: torch.Tensor, bidir: bool,
               what: str):
    """Launch B10 (td_ag_gemm) or B11 (td_ag_gemm_bidir) of
    ``csrc/ag_gemm.cu`` on this rank's shard: checks, this op's symmetric
    buffer, the outputs; bf16 under ``ag_plan`` (the same for both, so
    B11 computes B10's bits), f32 under the K split with its f32 K-slice
    workspace."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: a {tuple(a.shape)} @ b "
                         f"{tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"{what}: a/b must share one dtype of "
                         f"{list(_DTYPE_CODE)}; got {a.dtype}/{b.dtype}")
    a = a.contiguous()
    if not b.is_contiguous() or b.data_ptr() % 16 or a.data_ptr() % 16:
        raise ValueError(f"{what}: b contiguous, a/b 16-byte aligned")
    m, k = a.shape
    n_cols, world = b.shape[1], mesh.world
    vec = 16 // a.element_size()
    if n_cols % vec or k % vec:
        raise ValueError(f"{what}: K={k} and N={n_cols} must be "
                         f"multiples of {vec}")
    rows, dev = world * m, a.device
    out = torch.empty((rows, n_cols), dtype=a.dtype, device=dev)
    ag = torch.empty((rows, k), dtype=a.dtype, device=dev)
    part = order = land = None
    sig_off = flag_off = k_chunk = splits = grid = rb = 0
    if a.dtype == torch.bfloat16:
        sms, l2 = _card(dev)
        plan = ag_plan(world, m, k, n_cols, sms, mesh.ranks_per_device, l2)
        ws = ag_workspace(mesh, plan, bidir)
        flag_off, grid, rb = plan.flag_off, plan.grid, plan.rb
        if plan.regime == "stream":
            part = torch.empty((plan.stream.ws_floats,), dtype=torch.float32,
                               device=dev)
        else:
            order = _row_order(mesh, m, bidir, dev)
            land = ws.buf.tensor
    else:
        if bidir:
            # the gathered rows (2 parities) then one flag per (chunk, row
            # block); m flags per chunk cover any row block
            data = 2 * rows * k * a.element_size()
            flag_off = -(-data // _ALIGN) * _ALIGN
            ws = op_workspace(mesh, ("ag_gemm_bidir", m, k, a.dtype),
                              (flag_off + rows * 8,), torch.uint8)
        else:
            ws = op_workspace(mesh, ("ag_gemm", m, k, a.dtype), (rows, k),
                              a.dtype)
            sig_off = ws.buf.sig_off
        k_chunk, splits = split_plan(rows, k, n_cols, vec, _card(dev)[0])
        part = (torch.empty((splits, rows, n_cols), dtype=torch.float32,
                            device=dev) if splits > 1 else None)
    fn = build.function("ag_gemm", "td_ag_gemm_bidir" if bidir
                        else "td_ag_gemm", (
        *(ctypes.c_void_p,) * 7, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, *(ctypes.c_int,) * 9, ctypes.c_void_p))
    with torch.cuda.device(dev):
        err = fn(a.data_ptr(), b.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 out.data_ptr(), ag.data_ptr(),
                 order.data_ptr() if order is not None else None,
                 land.data_ptr() if land is not None else None,
                 mesh.rank, world, ws.buf.table.data_ptr(), sig_off,
                 flag_off, ws.ctl.data_ptr(), m, k, n_cols, k_chunk, splits,
                 grid, rb, mesh.ranks_per_device, _DTYPE_CODE[a.dtype],
                 build.stream_of(a))
    build.check(err, what)
    return out, ag


def pallas_ag_gemm(mesh, a: torch.Tensor, b: torch.Tensor):
    """B10 on this rank: (allgather(a) @ b, allgather(a)), a (m, K) this
    rank's shard, b (K, N_loc). CUDA tensors launch the kernel (counted in
    ``pallas_ag_gemm.launches``; it copies the gathered A out of the rank's
    symmetric buffer into a fresh tensor); CPU tensors run
    ``ag_gemm_ref``. Every rank calls it with the same shapes, in the same
    order."""
    if a.device.type == "cpu":
        return ag_gemm_ref(mesh, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"pallas_ag_gemm: unsupported device {a.device}")
    out = _ag_launch(mesh, a, b, False, "pallas_ag_gemm")
    pallas_ag_gemm.launches += 1
    return out


pallas_ag_gemm.launches = 0


def pallas_ag_gemm_bidir(mesh, a: torch.Tensor, b: torch.Tensor):
    """B11 on this rank, world >= 3: (allgather(a) @ b, allgather(a)) over
    both ring directions, B10's bits. CUDA tensors launch the kernel
    (counted in ``pallas_ag_gemm_bidir.launches``); CPU tensors run
    ``ag_gemm_ref``. Every rank calls it with the same shapes, in the
    same order."""
    if a.device.type == "cpu":
        return ag_gemm_ref(mesh, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"pallas_ag_gemm_bidir: unsupported device "
                         f"{a.device}")
    if mesh.world < 3:
        raise ValueError(f"pallas_ag_gemm_bidir needs a world of at least "
                         f"3 (both ring directions); got {mesh.world}")
    out = _ag_launch(mesh, a, b, True, "pallas_ag_gemm_bidir")
    pallas_ag_gemm_bidir.launches += 1
    return out


pallas_ag_gemm_bidir.launches = 0


def ag_gemm_per_device(n: int, method: AgGemmMethod, a: torch.Tensor,
                       b: torch.Tensor, mesh=None):
    """The reference's per-device entry: this rank's (m, K) shard of A and
    (K, N_loc) shard of B -> (out (n*m, N_loc), gathered A). ``mesh``
    (the ranks' Mesh) is needed at n > 1."""
    if n == 1:
        if method in (AgGemmMethod.XLA, AgGemmMethod.XLA_RING,
                      AgGemmMethod.XLA_BIDIR):
            return matmul_ref(a, b), a
        if method in (AgGemmMethod.PALLAS, AgGemmMethod.PALLAS_BIDIR):
            return pallas_matmul(a, b), a
        raise ValueError(f"unresolved method {method}")
    check_mesh(n, mesh, "ag_gemm")
    if method == AgGemmMethod.XLA:
        return ag_gemm_ref(mesh, a, b)
    if method == AgGemmMethod.XLA_RING:
        return _ring_ag_gemm(mesh, a, b)
    if method == AgGemmMethod.XLA_BIDIR:
        return _bidir_ring_ag_gemm(mesh, a, b)
    if method == AgGemmMethod.PALLAS:
        return pallas_ag_gemm(mesh, a, b)
    if method == AgGemmMethod.PALLAS_BIDIR:
        if n <= 2:      # no second direction to use: B10, as the reference
            return pallas_ag_gemm(mesh, a, b)
        return pallas_ag_gemm_bidir(mesh, a, b)
    raise ValueError(f"unresolved method {method}")


def ag_gemm(ctx: AgGemmContext, a: torch.Tensor, b: torch.Tensor):
    """The mesh-level AllGather + GEMM (the reference's ``ag_gemm``),
    called by every rank: a (m, K) this rank's row shard, b (K, N_loc) its
    column shard -> (allgather(a) @ b (n*m, N_loc), allgather(a)), the
    method resolved by ``ctx.resolve_for``."""
    check_not_2d(ctx.dcn_axis, "ag_gemm")
    n = ctx.world
    method = ctx.resolve_for(a.shape[0] * n, a.shape[1], b.shape[1],
                             a.dtype)[0]
    return ag_gemm_per_device(n, method, a, b, mesh=ctx.mesh)
