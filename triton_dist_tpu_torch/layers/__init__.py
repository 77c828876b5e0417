"""Layers: shared math, the attention core, attention and MLP blocks, the
sequence-parallel attention layer, the low-latency all-gather layer and
the pipeline-parallel CommOp."""

from triton_dist_tpu_torch.layers.common import TPContext  # noqa: F401
from triton_dist_tpu_torch.layers.low_latency_allgather_layer import (  # noqa: F401,E501
    LowLatencyAllGatherLayer,
)
from triton_dist_tpu_torch.layers.p2p import CommOp  # noqa: F401
from triton_dist_tpu_torch.layers.sp_flash_decode_layer import (  # noqa: F401,E501
    SpGQAFlashDecodeAttention,
)
