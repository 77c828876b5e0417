"""Point-to-point put (the reference's kernels/p2p.py).

Every rank calls ``p2p_put_op`` with its shard x (any shape, any dtype);
rank dst_rank returns rank src_rank's shard, every other rank its own. At
world n > 1 (``mesh`` is the ranks' Mesh):

  * B24, ``p2p_put_per_device``: the hand-written CUDA kernel
    ``csrc/ll_collectives.cu`` for CUDA tensors. Every rank launches it
    and passes its opening barrier; then src stores its shard into dst's
    landing slot and raises a flag there, dst waits and copies it out, and
    every other rank copies its own shard through (dst takes no
    passthrough copy). src == dst returns x on every rank.
    ``plain.p2p_ref`` (a send / receive pair) for CPU tensors.

At world 1 the put is the identity. src_rank and dst_rank must be ranks
of the mesh (the reference's kernel would wait forever for a put that no
rank makes). No fault preamble (ROADMAP A8) and no fallback: a kernel
that fails raises.
"""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.common_ops import (
    contiguous_cuda,
    ll_launch,
)
from triton_dist_tpu_torch.kernels.plain import p2p_ref
from triton_dist_tpu_torch.runtime.mesh import comm_axis_size


def p2p_put_per_device(mesh, x: torch.Tensor, src_rank: int,
                       dst_rank: int) -> torch.Tensor:
    """B24 on this rank: src_rank's shard on dst_rank, x elsewhere, a
    fresh tensor. CUDA tensors launch the kernel (counted in
    ``p2p_put_per_device.launches``); CPU tensors run ``plain.p2p_ref``.
    Every rank calls it with the same shape and ranks, in the same
    order."""
    n = 1 if mesh is None else mesh.world
    if not (0 <= src_rank < n and 0 <= dst_rank < n):
        raise ValueError(f"p2p_put: src_rank {src_rank} and dst_rank "
                         f"{dst_rank} must be ranks of a world of {n}")
    if n == 1:
        return x
    if x.device.type == "cpu":
        return p2p_ref(mesh, x, src_rank, dst_rank)
    x = contiguous_cuda(x, "p2p_put")
    out = ll_launch("p2p", mesh, x, torch.empty_like(x), a=src_rank,
                    b=dst_rank)
    p2p_put_per_device.launches += 1
    return out


p2p_put_per_device.launches = 0


def p2p_put_op(mesh, axis: str, x: torch.Tensor, src_rank: int,
               dst_rank: int) -> torch.Tensor:
    """out[dst_rank] = x[src_rank], every other shard unchanged (the
    reference's ``p2p_put_op``), called by every rank on its shard."""
    comm_axis_size(mesh, axis)
    return p2p_put_per_device(mesh, x, src_rank, dst_rank)
