"""Pipeline-parallel communication (the reference's layers/p2p.py).

A stage boundary is the one axis ("pp") of a mesh of the whole world
(``make_comm_mesh(axes=[("pp", n)])``). The microbatch handoff that every
stage makes at once, ``shift``, is the reference's ``ppermute``: NCCL
point-to-point on the card (``dist.batch_isend_irecv``, every request
waited on), gloo on the CPU. A one-to-one transfer between two stages,
``send_recv``, is the put B24 (``kernels/p2p.py``). Every rank calls them
with its stage's shard.
"""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.kernels.p2p import p2p_put_op
from triton_dist_tpu_torch.kernels.plain import ring_shift_ref
from triton_dist_tpu_torch.runtime.mesh import Mesh, comm_axis_size


@dataclasses.dataclass(frozen=True)
class CommOp:
    """The reference's CommOp over the mesh's ``axis``."""
    mesh: Mesh
    axis: str = "pp"

    @property
    def num_stages(self) -> int:
        return comm_axis_size(self.mesh, self.axis)

    def shift_per_device(self, x: torch.Tensor, by: int = 1) -> torch.Tensor:
        """Every stage sends its activation to stage + by (mod n) and
        returns the one stage - by sent."""
        if self.num_stages == 1:
            return x
        return ring_shift_ref(self.mesh, x, by)

    def send_recv(self, x: torch.Tensor, src_stage: int,
                  dst_stage: int) -> torch.Tensor:
        """dst_stage returns src_stage's x, every other stage its own."""
        return p2p_put_op(self.mesh, self.axis, x, src_stage, dst_stage)

    def shift(self, x: torch.Tensor, by: int = 1) -> torch.Tensor:
        return self.shift_per_device(x, by)
