"""GEMM + ReduceScatter (the reference's kernels/gemm_reduce_scatter.py).

Every rank holds A (n*m, K_loc) (the K dimension sharded over the mesh)
and a (K_loc, N) row shard of B; rank d returns rows [d*m, (d+1)*m) of
sum over ranks of a @ b: the row-parallel projection, from f32 partials
with one cast. Methods at world n > 1 (``mesh`` is the ranks' Mesh):

  * XLA — the f32 product, ``dist.reduce_scatter_tensor``, the cast:
    B13a's plain version and the unfused baseline;
  * XLA_RING — the reference's ring (its default): at step s a rank adds
    its partial of chunk (me - 1 - s) mod n to the one received from the
    left and passes it on (``dist.batch_isend_irecv``);
  * PALLAS — B13a, ``pallas_gemm_rs``: the hand-written CUDA kernel
    ``csrc/gemm_rs.cu`` for CUDA tensors, ``gemm_rs_ref`` for CPU tensors.
    Each rank stores its f32 partial of every destination's rows into that
    destination's landing slot for this sender; the owner adds its n slots
    in a FIXED order, slot 0 + slot 1 + ... + slot n-1 (ascending sender
    rank), and casts once. The reference's ring adds in a rank-dependent
    order, so the tiers agree to f32 rounding, not bit for bit. No
    fallback: a CUDA call the kernel does not take raises;
  * XLA_BIDIR — the reference's bidirectional ring: chunk d's partial
    sums flow to d along the shorter arc, ranks d - kr .. d - 1 to the
    right (kr = n // 2) and d + kl .. d + 1 to the left (kl = (n - 1) //
    2), one (2m, K) product per round (``dist.batch_isend_irecv`` to both
    neighbours); the owner adds own + right arrival + left arrival;
  * PALLAS_BIDIR — B13b at n >= 3, ``pallas_gemm_rs_bidir``: the
    hand-written CUDA kernel of ``csrc/gemm_rs.cu`` for CUDA tensors,
    ``gemm_rs_bidir_ref`` for CPU tensors, both in the reference's fold
    (each hop own + arrival, the owner own + right + left, one cast); at
    n <= 2 there is no second direction and it is B13a, as in the
    reference. On the card the arcs' hops become one (an NVSwitch full
    mesh): one pass over W for every chunk's rows, each row stored into
    its owner's slot for this sender, the owner folding its n slots in
    the arcs' order (``bidir_plan``).

The mesh-level ``gemm_rs(ctx, a, b)`` resolves the method from a
``GemmRsContext`` (``create_gemm_rs_context``); M must be a multiple of
the world (a ValueError otherwise, before any launch), and a context with
``dcn_axis`` set raises naming ROADMAP A9 (tail). No fault preamble and
no fallback (ROADMAP A8).

At world 1 the reduce-scatter is the identity: XLA, XLA_RING and XLA_BIDIR
compute the plain product, PALLAS and PALLAS_BIDIR B12 (as the reference's
n == 1 path runs ``_pallas_matmul``).
"""

from __future__ import annotations

import dataclasses
import enum
import functools

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels.allgather_gemm import (
    _peer, check_mesh, check_not_2d, matmul_ref, pallas_matmul,
)
from triton_dist_tpu_torch.kernels.gemm_allreduce import (
    _DTYPE_CODE, LandPlan, _launch_land, land_layout, landing_launch,
)
from triton_dist_tpu_torch.kernels.plain import (
    all_gather_list, bidir_rs_fold, dot_f32,
)
from triton_dist_tpu_torch.runtime.mesh import comm_axis_size


class GemmRsMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    XLA_RING = "xla_ring"
    XLA_BIDIR = "xla_bidir"
    PALLAS = "pallas"
    PALLAS_BIDIR = "pallas_bidir"


@dataclasses.dataclass
class GemmRsContext:
    """The reference's GemmRsContext: the ranks' Mesh, its axis, the
    method and the TPU kernel's tiles (carried for the reference's
    signatures; nothing on the card reads them). dcn_axis, set, raises
    in ``gemm_rs``: ROADMAP A9 (tail)."""
    mesh: object
    axis: str = "tp"
    method: GemmRsMethod = GemmRsMethod.AUTO
    bm: int = 512
    bn: int = 512
    bk: int = 512
    dcn_axis: str | None = None

    @property
    def world(self) -> int:
        return comm_axis_size(self.mesh, self.axis)

    def resolve(self) -> GemmRsMethod:
        """The reference's rule, platform-neutral: an explicit method
        stands; AUTO is XLA at world 1, XLA_RING above."""
        if self.method != GemmRsMethod.AUTO:
            return self.method
        if self.world == 1:
            return GemmRsMethod.XLA
        return GemmRsMethod.XLA_RING

    def resolve_for(self, m: int, k_local: int, n: int, dtype=None):
        """(method, bm, bn, bk): ``resolve()`` with the context's tiles;
        the reference's tuned tables were measured on a TPU, and the port
        has none until ROADMAP A16's tuner."""
        return self.resolve(), self.bm, self.bn, self.bk


def create_gemm_rs_context(mesh, axis: str = "tp", **kw) -> GemmRsContext:
    return GemmRsContext(mesh, axis, **kw)


def _rows_per_rank(mesh, a: torch.Tensor, what: str) -> int:
    if a.shape[0] % mesh.world:
        raise ValueError(f"{what}: M={a.shape[0]} not divisible by the "
                         f"world {mesh.world}")
    return a.shape[0] // mesh.world


def gemm_rs_ref(mesh, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of B13a (the XLA tier): the f32 product, a
    reduce-scatter of the f32 partials along rows, one cast."""
    m = _rows_per_rank(mesh, a, "gemm_rs")
    part = dot_f32(a, b).contiguous()
    out = torch.empty((m, b.shape[1]), dtype=torch.float32, device=a.device)
    dist.reduce_scatter_tensor(out, part, group=mesh.group)
    return out.to(torch.result_type(a, b))


def gemm_rs_ref_shards(a_shards, b_shards) -> list[torch.Tensor]:
    """Plain version of B13a over every rank's A and B in one process (the
    one-card world), one pass for all ranks: each sender's f32 partial,
    added in the kernel's order (ascending sender rank), then every rank's
    rows cast once. Returns the ranks' outputs in rank order."""
    world = len(a_shards)
    m = a_shards[0].shape[0] // world
    acc = dot_f32(a_shards[0], b_shards[0])
    for s in range(1, world):
        acc = acc + dot_f32(a_shards[s], b_shards[s])
    out = acc.to(torch.result_type(a_shards[0], b_shards[0]))
    return [out[r * m:(r + 1) * m] for r in range(world)]


def _ring_gemm_rs(mesh, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA_RING (the reference's _ring_gemm_rs_per_device): the partial of
    chunk (me - 1 - s) mod n plus the one from the left travels right; the
    last arrival is this rank's chunk, summed over every rank."""
    n, me = mesh.world, mesh.rank
    m = _rows_per_rank(mesh, a, "gemm_rs")
    right, left = _peer(mesh, (me + 1) % n), _peer(mesh, (me - 1) % n)
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    for s in range(n - 1):
        c = (me - 1 - s) % n
        part = (dot_f32(a[c * m:(c + 1) * m], b) + acc).contiguous()
        acc = torch.empty_like(part)
        for r in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, part, right, mesh.group),
                dist.P2POp(dist.irecv, acc, left, mesh.group)]):
            r.wait()
    out = dot_f32(a[me * m:(me + 1) * m], b) + acc
    return out.to(torch.result_type(a, b))


def _bidir_gemm_rs(mesh, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA_BIDIR (the reference's _bidir_gemm_rs_per_device): at round s
    the right chain adds its partial of chunk (me + kr - s) to what came
    from the left and sends it right, the left chain that of chunk
    (me - kl + s) to what came from the right and sends it left; the
    owner adds own + right + left and casts once."""
    n, me = mesh.world, mesh.rank
    m = _rows_per_rank(mesh, a, "gemm_rs")
    kr, kl = n // 2, (n - 1) // 2
    right, left = _peer(mesh, (me + 1) % n), _peer(mesh, (me - 1) % n)

    def rows(c):
        return a[c * m:(c + 1) * m]

    acc_r = torch.zeros((m, b.shape[1]), dtype=torch.float32,
                        device=a.device)
    acc_l = torch.zeros_like(acc_r)
    for s in range(kr):               # kr >= kl
        cr = (me + kr - s) % n
        if s < kl:
            cl = (me - kl + s) % n
            prod = dot_f32(torch.cat([rows(cr), rows(cl)]), b)
            send_r = (prod[:m] + acc_r).contiguous()
            send_l = (prod[m:] + acc_l).contiguous()
        else:
            send_r = (dot_f32(rows(cr), b) + acc_r).contiguous()
        acc_r = torch.empty_like(send_r)
        ops = [dist.P2POp(dist.isend, send_r, right, mesh.group),
               dist.P2POp(dist.irecv, acc_r, left, mesh.group)]
        if s < kl:
            acc_l = torch.empty_like(send_l)
            ops += [dist.P2POp(dist.isend, send_l, left, mesh.group),
                    dist.P2POp(dist.irecv, acc_l, right, mesh.group)]
        for r in dist.batch_isend_irecv(ops):
            r.wait()
    out = dot_f32(rows(me), b) + acc_r
    if kl > 0:
        out = out + acc_l
    return out.to(torch.result_type(a, b))


def gemm_rs_bidir_ref(mesh, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of B13b over the process group: every rank's f32
    product, this rank's chunk folded along both arcs in the reference's
    order (``bidir_rs_fold``), one cast."""
    _rows_per_rank(mesh, a, "gemm_rs")
    parts = all_gather_list(mesh, dot_f32(a, b).contiguous())
    return bidir_rs_fold(parts, mesh.rank).to(torch.result_type(a, b))


def gemm_rs_bidir_ref_shards(a_shards, b_shards) -> list[torch.Tensor]:
    """Plain version of B13b over every rank's A and B in one process (the
    one-card world): the ranks' outputs in rank order."""
    parts = [dot_f32(a, b) for a, b in zip(a_shards, b_shards)]
    dt = torch.result_type(a_shards[0], b_shards[0])
    return [bidir_rs_fold(parts, r).to(dt) for r in range(len(parts))]


def pallas_gemm_rs(mesh, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B13a on this rank: rows [rank*m, (rank+1)*m) of the sum over ranks of
    a @ b, a (n*m, K_loc), b (K_loc, N). CUDA tensors launch the kernel
    (counted in ``pallas_gemm_rs.launches``); CPU tensors run
    ``gemm_rs_ref``. Every rank calls it with the same shapes, in the same
    order."""
    if a.device.type == "cpu":
        return gemm_rs_ref(mesh, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"pallas_gemm_rs: unsupported device {a.device}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"pallas_gemm_rs: a {tuple(a.shape)} @ b "
                         f"{tuple(b.shape)}")
    out = landing_launch(mesh, a, b,
                         _rows_per_rank(mesh, a, "pallas_gemm_rs"),
                         "gemm_rs", "td_gemm_rs", "pallas_gemm_rs")
    pallas_gemm_rs.launches += 1
    return out


pallas_gemm_rs.launches = 0


# B13b's protocol: LL lines (the epoch in every 16-byte line) while a slot
# (one sender's m rows of N f32 for one owner) holds at most this many
# bytes, flags above. Four H100s (NVIDIA H100 80GB HBM3, 700.00 W;
# chip_compare.py --bidir --sweep, the slowest rank, K 2,048, N 5,120
# bf16), LL against flags at m = 4 / 8 / 16 / 32 rows a rank (80-640
# KiB a slot): 0.0170 / 0.0258 / 0.0388 / 0.0536 ms against 0.0227 /
# 0.0291 / 0.0471 / 0.0670; larger slots not measured (the prefill's 40
# MiB take flags).
RS_LL_MAX_SLOT_BYTES = 640 * 1024


def bidir_layout(world: int, m: int, k: int, n: int, bf16: bool,
                 sm_count: int, ranks_per_device: int,
                 ll: bool) -> LandPlan:
    """B13b's plan at m rows a chunk, K x N, under the protocol ``ll``:
    ``land_layout`` of the world * m rows, each rank keeping its chunk."""
    return land_layout(world, world * m, m, k, n, bf16, sm_count,
                       ranks_per_device, ll)


@functools.lru_cache(maxsize=None)
def bidir_plan(world: int, m: int, k: int, n: int, itemsize: int,
               sm_count: int, ranks_per_device: int) -> LandPlan:
    """B13b's plan at m rows a chunk of A (world * m, K) against W (K, N)
    (itemsize 2: bf16, 4: f32): LL while a slot holds at most
    RS_LL_MAX_SLOT_BYTES."""
    return bidir_layout(world, m, k, n, itemsize == 2, sm_count,
                        ranks_per_device, m * n * 4 <= RS_LL_MAX_SLOT_BYTES)


def pallas_gemm_rs_bidir(mesh, a: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """B13b on this rank, world >= 3: rows [rank*m, (rank+1)*m) of the sum
    over ranks of a @ b, reduce-scattered over both ring directions in the
    reference's fold. CUDA tensors launch the kernel (counted in
    ``pallas_gemm_rs_bidir.launches``); CPU tensors run
    ``gemm_rs_bidir_ref``. Every rank calls it with the same shapes, in
    the same order."""
    if a.device.type == "cpu":
        return gemm_rs_bidir_ref(mesh, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"pallas_gemm_rs_bidir: unsupported device "
                         f"{a.device}")
    what = "pallas_gemm_rs_bidir"
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: a {tuple(a.shape)} @ b {tuple(b.shape)}")
    if mesh.world < 3:
        raise ValueError(f"{what} needs a world of at least 3 (both ring "
                         f"directions); got {mesh.world}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"{what}: a/b must share one dtype of "
                         f"{list(_DTYPE_CODE)}; got {a.dtype}/{b.dtype}")
    if not b.is_contiguous() or b.data_ptr() % 16:
        raise ValueError(f"{what}: b contiguous, 16-byte aligned")
    m = _rows_per_rank(mesh, a, what)
    vec = 16 // a.element_size()
    if b.shape[1] % vec:
        raise ValueError(f"{what}: N={b.shape[1]} must be a multiple of "
                         f"{vec}")
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    plan = bidir_plan(mesh.world, m, a.shape[1], b.shape[1],
                      a.element_size(), sms, mesh.ranks_per_device)
    out = _launch_bidir(mesh, a.contiguous(), b, plan)
    pallas_gemm_rs_bidir.launches += 1
    return out


def _launch_bidir(mesh, a: torch.Tensor, b: torch.Tensor,
                  plan: LandPlan) -> torch.Tensor:
    """pallas_gemm_rs_bidir's launch under a given plan (chip_smoke.py's
    protocol sweep forces one through ``bidir_layout``)."""
    return _launch_land(mesh, a, b, plan, "gemm_rs", "td_gemm_rs_bidir",
                        "pallas_gemm_rs_bidir")


pallas_gemm_rs_bidir.launches = 0


def gemm_rs_per_device(n: int, method: GemmRsMethod, a: torch.Tensor,
                       b: torch.Tensor, mesh=None) -> torch.Tensor:
    """The reference's per-device entry: A (n*m, K_loc) and this rank's
    (K_loc, N) shard of B -> this rank's (m, N) rows of the sum. ``mesh``
    (the ranks' Mesh) is needed at n > 1."""
    if n == 1:
        if method in (GemmRsMethod.XLA, GemmRsMethod.XLA_RING,
                      GemmRsMethod.XLA_BIDIR):
            return matmul_ref(a, b)
        if method in (GemmRsMethod.PALLAS, GemmRsMethod.PALLAS_BIDIR):
            return pallas_matmul(a, b)
        raise ValueError(f"unresolved method {method}")
    check_mesh(n, mesh, "gemm_rs")
    if method == GemmRsMethod.XLA:
        return gemm_rs_ref(mesh, a, b)
    if method == GemmRsMethod.XLA_RING:
        return _ring_gemm_rs(mesh, a, b)
    if method == GemmRsMethod.XLA_BIDIR:
        return _bidir_gemm_rs(mesh, a, b)
    if method == GemmRsMethod.PALLAS:
        return pallas_gemm_rs(mesh, a, b)
    if method == GemmRsMethod.PALLAS_BIDIR:
        if n <= 2:      # no second direction to use: B13a, as the reference
            return pallas_gemm_rs(mesh, a, b)
        return pallas_gemm_rs_bidir(mesh, a, b)
    raise ValueError(f"unresolved method {method}")


def gemm_rs(ctx: GemmRsContext, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """The mesh-level GEMM + ReduceScatter (the reference's ``gemm_rs``),
    called by every rank: a (M, K_loc) its column shard of A, b (K_loc, N)
    its row shard of B -> its (M/n, N) rows of the sum, the method
    resolved by ``ctx.resolve_for``. M must be a multiple of the world."""
    check_not_2d(ctx.dcn_axis, "gemm_rs")
    n = ctx.world
    if a.shape[0] % n:
        raise ValueError(f"gemm_rs requires M ({a.shape[0]}) divisible by "
                         f"the total axis size ({n})")
    method = ctx.resolve_for(a.shape[0], a.shape[1], b.shape[1],
                             a.dtype)[0]
    return gemm_rs_per_device(n, method, a, b, mesh=ctx.mesh)
