"""AllGather across ranks (the reference's kernels/allgather.py).

Every rank holds x (m, K) and returns the (n*m, K) rows of all ranks in
rank order. Methods at world n > 1 (``mesh`` is the ranks' Mesh):

  * XLA — ``dist.all_gather_into_tensor`` (NCCL on the card), the
    reference's ``lax.all_gather``;
  * RING_1D — B7, ``ring_all_gather``: the hand-written CUDA kernel
    ``csrc/ring_collectives.cu`` for CUDA tensors, ``ring_ag_ref`` for CPU
    tensors. At step s rank r forwards chunk (r - s) mod n to its right
    neighbour; the gathered rows are the ranks' bytes, unchanged;
  * FULL_MESH — B8, ``full_mesh_all_gather``: the hand-written CUDA kernel
    of the same source for CUDA tensors (each rank stores its shard
    straight into slot ``rank`` of every rank's buffer, one hop on
    NVSwitch), ``ring_ag_ref`` for CPU tensors: the same bytes;
  * AUTO — resolved by the mesh-level ``all_gather_op`` (the per-device
    entry raises "unresolved method", as in the reference), with the
    port's own rule, ``get_auto_all_gather_method``.

At world 1 the all-gather is the identity. No fallback: a CUDA call the
kernel does not take raises. The mesh-level ``all_gather_op`` has no
fault preamble (ROADMAP A8); the mesh-level ``all_reduce_op`` waits for
ROADMAP A9 (tail).
"""

from __future__ import annotations

import ctypes
import enum

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels.allreduce import grid_blocks
from triton_dist_tpu_torch.kernels.plain import all_gather_cat
from triton_dist_tpu_torch.kernels.reduce_scatter import ring_launch
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.symm import op_workspace

# AUTO's crossover on CUDA: FULL_MESH (B8) for shards up to this many
# bytes, RING_1D (B7) above. chip_smoke.py's sweep of B8 against B7 on
# four H100s (phase b8_auto_sweep, 1-2,048 rows of 5120 bf16 a rank) found
# B8 the faster at every size, 10 KiB to 20 MiB a shard, so the crossover
# is set at the sweep's top; above it nothing was measured and the
# reference's ring stays.
FULL_MESH_MAX_SHARD_BYTES = 20 * 1024 * 1024


class AllGatherMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    RING_1D = "ring_1d"
    FULL_MESH = "full_mesh"


def get_auto_all_gather_method(nbytes_per_shard: int, world: int,
                               cuda: bool = True) -> AllGatherMethod:
    """The reference's rule's shape (FULL_MESH for small shards or a world
    of at most 2, RING_1D above) with the port's own crossover,
    FULL_MESH_MAX_SHARD_BYTES; XLA off CUDA, as the reference picks XLA
    off its chip."""
    if not cuda:
        return AllGatherMethod.XLA
    if nbytes_per_shard <= FULL_MESH_MAX_SHARD_BYTES or world <= 2:
        return AllGatherMethod.FULL_MESH
    return AllGatherMethod.RING_1D


def ring_ag_ref(mesh, x: torch.Tensor) -> torch.Tensor:
    """Plain version of B7 and B8 over the process group: every rank's x,
    concatenated in rank order."""
    return all_gather_cat(mesh, x)


def ring_all_gather(mesh, x: torch.Tensor) -> torch.Tensor:
    """B7 on this rank: every rank's x (m, K) in rank order, (n*m, K), a
    fresh tensor. CUDA tensors launch the kernel (counted in
    ``ring_all_gather.launches``); CPU tensors run ``ring_ag_ref``. Every
    rank calls it with the same shape, in the same order."""
    if x.device.type == "cpu":
        return ring_ag_ref(mesh, x)
    if x.device.type != "cuda":
        raise ValueError(f"ring_all_gather: unsupported device {x.device}")
    out = ring_launch("ring_ag", mesh, x, x.shape[0])
    ring_all_gather.launches += 1
    return out


ring_all_gather.launches = 0


def full_mesh_all_gather(mesh, x: torch.Tensor) -> torch.Tensor:
    """B8 on this rank: every rank's x (m, K) in rank order, (n*m, K), a
    fresh tensor, the bytes of ``dist.all_gather_into_tensor``. CUDA
    tensors launch the kernel (counted in
    ``full_mesh_all_gather.launches``); CPU tensors run ``ring_ag_ref``.
    Every rank calls it with the same shape, in the same order."""
    if x.device.type == "cpu":
        return ring_ag_ref(mesh, x)
    if x.device.type != "cuda":
        raise ValueError(f"full_mesh_all_gather: unsupported device "
                         f"{x.device}")
    if x.ndim != 2 or not x.is_contiguous() or x.data_ptr() % 16 or \
            (x.shape[1] * x.element_size()) % 16 or x.numel() == 0:
        raise ValueError("full_mesh_all_gather: x must be a non-empty "
                         "contiguous 2-D tensor, 16-byte aligned, rows a "
                         f"multiple of 16 bytes; got {tuple(x.shape)}")
    n, (m, k) = mesh.world, x.shape
    kv = k * x.element_size() // 16
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = grid_blocks(m, kv, sms, mesh.ranks_per_device)
    ws = op_workspace(mesh, ("full_mesh_ag", m, k, x.dtype),
                      (2 * n * m * k * x.element_size(),), torch.uint8)
    out = x.new_empty((n * m, k))
    with torch.cuda.device(x.device):
        fn = build.function("ring_collectives", "td_full_mesh_ag", (
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p))
        err = fn(x.data_ptr(), out.data_ptr(), mesh.rank, n,
                 ws.buf.table.data_ptr(), ws.buf.sig_off, ws.ctl.data_ptr(),
                 m, kv, grid, mesh.ranks_per_device, build.stream_of(x))
    build.check(err, "full_mesh_all_gather")
    full_mesh_all_gather.launches += 1
    return out


full_mesh_all_gather.launches = 0


def all_gather_per_device(n: int, method: AllGatherMethod, x: torch.Tensor,
                          mesh=None) -> torch.Tensor:
    """The reference's per-device entry: this rank's x (m, K) -> the
    (n*m, K) rows of all n ranks. ``mesh`` (the ranks' Mesh) is needed at
    n > 1."""
    if method == AllGatherMethod.AUTO:
        raise ValueError(f"unresolved method {method}")
    if n == 1:
        return x
    if mesh is None or mesh.world != n:
        raise ValueError(f"all_gather at world {n} needs the mesh of its "
                         f"{n} ranks; got {mesh}")
    if method == AllGatherMethod.XLA:
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
        return out
    if method == AllGatherMethod.RING_1D:
        return ring_all_gather(mesh, x)
    if method == AllGatherMethod.FULL_MESH:
        return full_mesh_all_gather(mesh, x)
    raise ValueError(f"unresolved method {method}")


def all_gather_op(mesh, x: torch.Tensor,
                  method: AllGatherMethod = AllGatherMethod.AUTO
                  ) -> torch.Tensor:
    """The mesh-level all-gather (the reference's ``all_gather_op``),
    called by every rank on its shard x (m, ...): the (n*m, ...) rows of
    all ranks in rank order, on every rank. AUTO takes
    ``get_auto_all_gather_method`` of this rank's shard bytes. The rows
    travel as 2-D (m, prod(rest)) through the per-device entry."""
    n = mesh.world
    if method == AllGatherMethod.AUTO:
        method = get_auto_all_gather_method(
            x.numel() * x.element_size(), n, x.is_cuda)
    rows = x.reshape(x.shape[0], -1).contiguous()
    out = all_gather_per_device(n, method, rows, mesh=mesh)
    return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
