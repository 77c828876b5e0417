"""Shared layer math: RMSNorm, rotary embeddings, the TP context (the
reference's layers/common.py)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TPContext:
    """Parallelism context of a model. This slice runs at world 1, where
    the reference's psum is the identity; the tensor-parallel collectives
    wait for ROADMAP A5/A9.

    attn_method: "auto" (flash kernel when head_dim % 128 == 0 and the
    chunk has at least 128 keys), "pallas" (always the flash kernel —
    the reference's name for it) or "xla" (masked-einsum baseline)."""
    attn_method: str = "auto"

    @property
    def world(self) -> int:
        return 1


MODES = ("xla", "triton_dist", "triton_dist_AR")


def check_mode(mode: str) -> None:
    """Only the "xla" forward (plain matmuls, psum = identity at world 1)
    is ported; the other reference modes raise naming their ROADMAP item."""
    if mode == "xla":
        return
    if mode == "triton_dist":
        raise NotImplementedError(
            "mode 'triton_dist' (AG+GEMM / GEMM+RS) waits for ROADMAP A9")
    if mode == "triton_dist_AR":
        raise NotImplementedError(
            "mode 'triton_dist_AR' (fused all-reduce) waits for ROADMAP A5")
    raise ValueError(f"mode {mode!r} not in {MODES}")


def check_world(world: int, what: str) -> None:
    """This slice runs at world 1; a larger world raises naming A5."""
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


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in the reference's order: normalize in f32, cast to x's
    dtype, THEN multiply by w."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def make_cos_sin_cache(head_dim: int, max_length: int, theta: float,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """(max_length, 2, head_dim) f32 cos/sin table."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    t = torch.arange(max_length, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)                    # (S, D/2)
    emb = torch.cat([freqs, freqs], dim=-1)             # (S, D)
    return torch.stack([torch.cos(emb), torch.sin(emb)], dim=1)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos_sin: torch.Tensor,
               positions: torch.Tensor):
    """Rotary embedding of q/k (B, T, H, D); positions (T,) shared or
    (B, T) per sequence. Computed in f32, returned in the inputs' dtypes."""
    table = cos_sin[positions.long()]                   # (..., T, 2, D)
    if positions.ndim == 2:
        cos = table[:, :, 0][:, :, None, :]             # (B, T, 1, D)
        sin = table[:, :, 1][:, :, None, :]
    else:
        cos = table[:, 0][None, :, None, :]             # (1, T, 1, D)
        sin = table[:, 1][None, :, None, :]
    qf, kf = q.float(), k.float()
    q_rot = qf * cos + _rotate_half(qf) * sin
    k_rot = kf * cos + _rotate_half(kf) * sin
    return q_rot.to(q.dtype), k_rot.to(k.dtype)
