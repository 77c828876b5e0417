"""Attention core: causal GQA over a cache (the reference's
layers/attention_core.py). "auto" picks the flash kernel (B1) whenever the
head_dim is a multiple of 128 and the chunk has at least 128 keys, else the
masked-einsum baseline, exactly as the reference decides."""

from __future__ import annotations

import torch

from triton_dist_tpu_torch.kernels.flash_attention import flash_prefill


def _use_flash(method: str, d: int, s: int) -> bool:
    if method == "pallas":
        return True
    if method == "xla":
        return False
    if method != "auto":
        raise ValueError(f"unknown attention method {method!r}")
    return d % 128 == 0 and s >= 128


def gqa_attend(q: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, offset, q_len: int, *,
               method: str = "auto") -> torch.Tensor:
    """q: (B, T, Hq, D); k_cache/v_cache: (B, S, Hkv, D) with valid keys
    in [0, offset + T); query i sits at position offset + i. Returns
    (B, T, Hq, D)."""
    if _use_flash(method, q.shape[-1], k_cache.shape[1]):
        return flash_prefill(q, k_cache, v_cache, offset)
    return gqa_attend_xla(q, k_cache, v_cache, offset, q_len)


def gqa_attend_xla(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, offset, q_len: int
                   ) -> torch.Tensor:
    """Masked-einsum baseline: the full (B, Hkv, g, T, S) f32 scores."""
    b, t, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    qf = q.float() * (d ** -0.5)
    scores = torch.einsum("bthgd,bshd->bhgts",
                          qf.reshape(b, t, hkv, group, d), k_cache.float())
    key_pos = torch.arange(s, device=q.device)
    q_pos = offset + torch.arange(t, device=q.device)
    mask = key_pos[None, :] <= q_pos[:, None]           # causal + length
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v_cache.float())
    return out.reshape(b, t, hq, d).to(q.dtype)
