"""Layers: shared math, the attention core, attention and MLP blocks."""

from triton_dist_tpu_torch.layers.common import TPContext  # noqa: F401
