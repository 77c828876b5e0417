"""Low-latency all-gather layer (the reference's
layers/low_latency_allgather_layer.py): the context of ``fast_allgather``
and a call. Its symmetric buffers are the kernels' workspaces, made at the
first call of each shard size (runtime/symm.py)."""

from __future__ import annotations

import dataclasses

import torch

from triton_dist_tpu_torch.kernels.low_latency_allgather import (
    FastAllGatherContext,
    create_fast_allgather_context,
    fast_allgather,
)


@dataclasses.dataclass
class LowLatencyAllGatherLayer:
    ctx: FastAllGatherContext

    @classmethod
    def create(cls, mesh, axis: str = "tp", **kw):
        return cls(create_fast_allgather_context(mesh, axis, **kw))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return fast_allgather(self.ctx, x)
