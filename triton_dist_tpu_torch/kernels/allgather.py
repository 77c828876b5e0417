"""AllGather across ranks (the reference's kernels/allgather.py).

Every rank holds x (m, K) and returns the (n*m, K) rows of all ranks in
rank order. Methods at world n > 1 (``mesh`` is the ranks' Mesh):

  * XLA — ``dist.all_gather_into_tensor`` (NCCL on the card), the
    reference's ``lax.all_gather``;
  * RING_1D — B7, ``ring_all_gather``: the hand-written CUDA kernel
    ``csrc/ring_collectives.cu`` for CUDA tensors, ``ring_ag_ref`` for CPU
    tensors. At step s rank r forwards chunk (r - s) mod n to its right
    neighbour; the gathered rows are the ranks' bytes, unchanged;
  * FULL_MESH (B8) waits for ROADMAP A9; AUTO is resolved above the
    per-device level ("unresolved method"), as in the reference, whose
    size rule is an ICI one.

At world 1 the all-gather is the identity. No fallback: a CUDA call the
kernel does not take raises. The mesh-level ``all_gather_op`` waits for
ROADMAP A8.
"""

from __future__ import annotations

import enum

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels.plain import all_gather_list
from triton_dist_tpu_torch.kernels.reduce_scatter import ring_launch


class AllGatherMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    RING_1D = "ring_1d"
    FULL_MESH = "full_mesh"


def ring_ag_ref(mesh, x: torch.Tensor) -> torch.Tensor:
    """Plain version of B7 over the process group: every rank's x,
    concatenated in rank order."""
    return torch.cat(all_gather_list(mesh, x))


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


def all_gather_per_device(n: int, method: AllGatherMethod, x: torch.Tensor,
                          mesh=None) -> torch.Tensor:
    """The reference's per-device entry: this rank's x (m, K) -> the
    (n*m, K) rows of all n ranks. ``mesh`` (the ranks' Mesh) is needed at
    n > 1."""
    if method == AllGatherMethod.FULL_MESH:
        raise NotImplementedError(
            "AllGatherMethod.FULL_MESH (the full-mesh push, B8) waits for "
            "ROADMAP A9")
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
    raise ValueError(f"unresolved method {method}")
