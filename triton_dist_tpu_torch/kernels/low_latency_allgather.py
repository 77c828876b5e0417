"""Low-latency all-gather of small messages (the reference's
kernels/low_latency_allgather.py).

Every rank calls ``fast_allgather`` with its shard x (m, ...) and gets the
(n*m, ...) rows of all ranks in rank order. Methods at world n > 1
(``mesh`` is the ranks' Mesh):

  * XLA — ``dist.all_gather_into_tensor`` (NCCL on the card);
  * FULL_MESH — the ported ``all_gather_op(method=FULL_MESH)`` (B8), as
    the reference does;
  * BIDIR_RING — B22, ``bidir_ring_ag_per_device``: both ring directions
    at once, at round s chunk (me - s) travels right and (me + s) left,
    so the farthest shard makes ceil((n - 1) / 2) hops (the hand-written
    kernel ``csrc/ll_collectives.cu`` for CUDA tensors,
    ``plain.all_gather_cat`` for CPU tensors);
  * RING_2D — B23, ``ring2d_ag_per_device``: n = nx * ny from the linear
    rank, a ring over the nx shards of each row, then a ring of the
    completed rows down each column (nx + ny - 2 hops, the 1-D ring's
    bytes); an nx that is 1 or does not divide n takes B22;
  * AUTO — XLA on the CPU and at world 1, as the reference resolves off
    its chip; on the card the port's own rule,
    ``get_auto_ll_allgather_method``, set by a sweep on four H100s, and
    BIDIR_RING for a shard whose rows are not a multiple of 16 bytes,
    which B8 does not take (an explicit FULL_MESH raises on it).

n-D shards travel as 2-D (m, prod(rest)) and are reshaped back. At world
1 the all-gather is the identity. ``FastAllGatherContext.resolve`` takes
the tuned-table key (``dims``) and does not use it until ROADMAP A16, as
``AgGemmContext.resolve_for``. No fault preamble (ROADMAP A8) and no
fallback: a kernel that fails raises.
"""

from __future__ import annotations

import dataclasses
import enum
import math

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels.allgather import (
    AllGatherMethod,
    all_gather_op,
)
from triton_dist_tpu_torch.kernels.common_ops import (
    contiguous_cuda,
    ll_launch,
)
from triton_dist_tpu_torch.kernels.plain import all_gather_cat
from triton_dist_tpu_torch.runtime.mesh import Mesh, comm_axis_size

# AUTO's crossover on CUDA: FULL_MESH (B8) for shards up to this many
# bytes, the reference's rule above it. chip_smoke.py's sweep (phase
# tp4_comm, ll_ag_auto_sweep) on four H100s (700 W) at 1-2,048 rows of
# 5120 bf16 a rank, the slowest rank's ms: B8 0.0198 / 0.0216 / 0.0520 /
# 0.3215 at 1 / 16 / 256 / 2,048 rows, B22 0.0220 / 0.0235 / 0.0532 /
# 0.3414, B23 0.0246 / 0.0260 / 0.0619 / 0.3764: B8 the fastest of the
# three at every size, 10 KiB to 20 MiB a shard (every pair is one
# NVSwitch hop; the rings pay their extra hop), so the crossover is set at
# the sweep's top; above it nothing was measured and the reference's
# rings stay.
LL_FULL_MESH_MAX_SHARD_BYTES = 20 * 1024 * 1024


class LLAllGatherMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    FULL_MESH = "full_mesh"
    BIDIR_RING = "bidir_ring"
    RING_2D = "ring_2d"


def _factor_2d(n: int) -> int:
    """Largest divisor of n that is <= sqrt(n) (the row ring's width nx);
    1 when n is prime."""
    for nx in range(int(math.isqrt(n)), 0, -1):
        if n % nx == 0:
            return nx
    return 1


def get_auto_ll_allgather_method(nbytes_per_shard: int,
                                 world: int) -> LLAllGatherMethod:
    """The port's rule on the card: FULL_MESH for shards up to
    LL_FULL_MESH_MAX_SHARD_BYTES or a world of at most 2; above, the
    reference's choice between the rings by hop count (RING_2D where n
    factors into fewer hops than half the ring, else BIDIR_RING)."""
    if world <= 2 or nbytes_per_shard <= LL_FULL_MESH_MAX_SHARD_BYTES:
        return LLAllGatherMethod.FULL_MESH
    nx = _factor_2d(world)
    if nx > 1 and (nx + world // nx - 2) < (world // 2):
        return LLAllGatherMethod.RING_2D
    return LLAllGatherMethod.BIDIR_RING


def _gathered(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))


def bidir_ring_ag_per_device(mesh, x: torch.Tensor) -> torch.Tensor:
    """B22 on this rank: every rank's x (m, ...) in rank order, (n*m,
    ...), a fresh tensor. CUDA tensors launch the kernel (counted in
    ``bidir_ring_ag_per_device.launches``); CPU tensors run
    ``plain.all_gather_cat``. Every rank calls it with the same shape, in
    the same order."""
    if x.device.type == "cpu":
        return all_gather_cat(mesh, x)
    x = contiguous_cuda(x, "bidir_ring_all_gather")
    out = ll_launch("bidir", mesh, x, _gathered(x, mesh.world))
    bidir_ring_ag_per_device.launches += 1
    return out


bidir_ring_ag_per_device.launches = 0


def ring2d_ag_per_device(mesh, x: torch.Tensor, nx: int) -> torch.Tensor:
    """B23 on this rank, rows of nx ranks (nx > 1 divides n): every rank's
    x (m, ...) in rank order, (n*m, ...), a fresh tensor. CUDA tensors
    launch the kernel (counted in ``ring2d_ag_per_device.launches``); CPU
    tensors run ``plain.all_gather_cat``."""
    if nx <= 1 or mesh.world % nx:
        raise ValueError(f"ring2d all-gather: nx={nx} must be > 1 and "
                         f"divide the world {mesh.world}")
    if x.device.type == "cpu":
        return all_gather_cat(mesh, x)
    x = contiguous_cuda(x, "ring2d_all_gather")
    out = ll_launch("ring2d", mesh, x, _gathered(x, mesh.world), a=nx)
    ring2d_ag_per_device.launches += 1
    return out


ring2d_ag_per_device.launches = 0


@dataclasses.dataclass
class FastAllGatherContext:
    """The reference's FastAllGatherContext: the mesh, the axis, the
    method and RING_2D's row width nx (None: ``_factor_2d``)."""
    mesh: Mesh
    axis: str
    method: LLAllGatherMethod = LLAllGatherMethod.AUTO
    nx: int | None = None

    def resolve(self, nbytes_per_shard: int,
                dims: tuple[int, ...] | None = None,
                dtype=None) -> LLAllGatherMethod:
        """The method a call of this shard size runs. ``dims`` and
        ``dtype`` are the tuned table's key, unused until ROADMAP A16."""
        n = comm_axis_size(self.mesh, self.axis)
        if self.method == LLAllGatherMethod.AUTO:
            if self.mesh.device.type != "cuda" or n == 1:
                return LLAllGatherMethod.XLA
            method = get_auto_ll_allgather_method(nbytes_per_shard, n)
        else:
            method = self.method
        # the unfactorable world's fall-back, as ll_allgather_per_device
        # dispatches it
        if method == LLAllGatherMethod.RING_2D:
            nx = self.nx or _factor_2d(n)
            if nx <= 1 or n % nx:
                return LLAllGatherMethod.BIDIR_RING
        return method


def create_fast_allgather_context(mesh: Mesh, axis: str = "tp",
                                  **kw) -> FastAllGatherContext:
    return FastAllGatherContext(mesh, axis, **kw)


def ll_allgather_per_device(n: int, method: LLAllGatherMethod,
                            nx: int | None, xs: torch.Tensor,
                            mesh=None) -> torch.Tensor:
    """The reference's per-device entry: this rank's (m, K) rows -> the
    (n*m, K) rows of all n ranks, by XLA, BIDIR_RING or RING_2D (FULL_MESH
    and AUTO are the mesh level's). ``mesh`` is needed at n > 1."""
    if n == 1:
        return xs
    if mesh is None or mesh.world != n:
        raise ValueError(f"ll_allgather at world {n} needs the mesh of its "
                         f"{n} ranks; got {mesh}")
    if method == LLAllGatherMethod.XLA:
        out = _gathered(xs, n)
        dist.all_gather_into_tensor(out, xs.contiguous(), group=mesh.group)
        return out
    if method == LLAllGatherMethod.BIDIR_RING:
        return bidir_ring_ag_per_device(mesh, xs)
    if method == LLAllGatherMethod.RING_2D:
        nx = nx or _factor_2d(n)
        if nx <= 1 or n % nx:
            return bidir_ring_ag_per_device(mesh, xs)
        return ring2d_ag_per_device(mesh, xs, nx)
    raise ValueError(f"unresolved method {method}")


def fast_allgather(ctx: FastAllGatherContext, x: torch.Tensor) -> torch.Tensor:
    """The latency-optimised all-gather (the reference's
    ``fast_allgather``), called by every rank on its shard x (m, ...):
    the (n*m, ...) rows of all ranks in rank order, on every rank."""
    n = comm_axis_size(ctx.mesh, ctx.axis)
    dims = (x.shape[0], math.prod(x.shape[1:]))
    method = ctx.resolve(x.numel() * x.element_size(), dims=dims,
                         dtype=x.dtype)
    if (method == LLAllGatherMethod.FULL_MESH and x.is_cuda
            and ctx.method == LLAllGatherMethod.AUTO
            and dims[1] * x.element_size() % 16):
        # B8 takes rows of a multiple of 16 bytes; AUTO gives B22 the rest
        method = LLAllGatherMethod.BIDIR_RING
    if method == LLAllGatherMethod.FULL_MESH:
        return all_gather_op(ctx.mesh, x, method=AllGatherMethod.FULL_MESH)
    rows = x.reshape(dims)
    out = ll_allgather_per_device(n, method, ctx.nx, rows, mesh=ctx.mesh)
    return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
