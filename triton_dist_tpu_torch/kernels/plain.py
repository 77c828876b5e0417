"""Plain products shared by the kernels' plain versions and the layers: the
reference's ``preferred_element_type=f32`` products, and the world check of
the paths that still run at world 1 only. A leaf module: the kernel modules import it, and
``layers/common.py`` (which imports the kernel modules' method enums)
re-exports it."""

from __future__ import annotations

import torch


def check_world(world: int, what: str) -> None:
    """B4's push to the peers, the mega graph and the all-reduce kernels
    run at world 1 only; a larger world raises naming A5."""
    if world != 1:
        raise NotImplementedError(
            f"{what} at world {world} (tensor-parallel collectives) waits "
            "for ROADMAP A5")


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as f32 from a's dtype with f32 accumulation (the reference's
    preferred_element_type=f32). A bf16 product rounded to bf16 would
    change greedy tokens; CUDA has an f32-output bf16 mm, the CPU build
    does not, so there the exact bf16 products are summed in f32."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (G, M, K) @ (G, K, N) as f32 with f32 accumulation, on the
    same rule as ``dot_f32``."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())
