"""Layers: shared math, the attention core, attention and MLP blocks, the
sequence-parallel attention layer."""

from triton_dist_tpu_torch.layers.common import TPContext  # noqa: F401
from triton_dist_tpu_torch.layers.sp_flash_decode_layer import (  # noqa: F401,E501
    SpGQAFlashDecodeAttention,
)
