"""LSE merge of split-KV decode partials (the reference's
kernels/flash_decode.py lse_partial_merge / lse_merge). Plain math: the
cross-rank combine kernel (B20) and the distributed decode wait for the
sequence-parallel slice (ROADMAP A11)."""

from __future__ import annotations

import torch


def lse_partial_merge(accs: torch.Tensor, ms: torch.Tensor,
                      ls: torch.Tensor):
    """Merge partials stacked on axis 0 — accs (n, B, Hq, D), ms/ls
    (n, B, Hq) — WITHOUT normalizing: returns the (acc, m, l) triple of
    one partial over the union of the inputs' key ranges."""
    m = ms.amax(dim=0)                                  # (B, Hq)
    scale = torch.exp(ms - m[None])                     # (n, B, Hq)
    acc = (accs * scale[..., None]).sum(dim=0)          # (B, Hq, D)
    l = (ls * scale).sum(dim=0)                         # (B, Hq)
    return acc, m, l


def lse_merge(accs: torch.Tensor, ms: torch.Tensor,
              ls: torch.Tensor) -> torch.Tensor:
    """Merge partials stacked on axis 0 and normalize: (B, Hq, D) f32."""
    acc, _, l = lse_partial_merge(accs, ms, ls)
    return acc / torch.clamp_min(l, 1e-30)[..., None]
