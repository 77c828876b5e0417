"""Runtime: device resolution and the CUDA kernel builder."""

from triton_dist_tpu_torch.runtime.device import resolve_device  # noqa: F401
