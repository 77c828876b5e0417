"""Runtime: device resolution, process groups (mesh), symmetric memory
(symm) and nvcc builds of the CUDA kernels (build)."""

from triton_dist_tpu_torch.runtime.device import resolve_device  # noqa: F401
