"""Sampling and rank-0 logging (the reference's models/utils.py).

Greedy sampling is ``argmax`` with first-index ties, as in the reference.
Temperature / top-p draws come from the caller's ``torch.Generator``: the
same filtering as the reference and a Gumbel-max draw like the reference's
categorical sampler, but not its threefry bits (porting threefry is
ROADMAP A2). ``sample_token_rows`` (the ContinuousEngine's per-request
streams) is greedy only until then.
"""

from __future__ import annotations

import sys
import time

import torch


def sample_token(logits: torch.Tensor,
                 generator: torch.Generator | None = None,
                 temperature: float = 0.0, top_p: float = 1.0
                 ) -> torch.Tensor:
    """Next token ids from (B, V) f32 logits; returns (B,) int32.
    temperature == 0 or no generator -> greedy."""
    if temperature == 0.0 or generator is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep tokens whose logit is >= the cutoff logit of the top-p mass
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff_idx = cutoff_idx.clamp_max(logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits >= cutoff, logits, float("-inf"))
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


def sample_token_rows(logits: torch.Tensor) -> torch.Tensor:
    """The ContinuousEngine's per-row tokens from (B, V) logits; returns
    (B,) int32. Greedy only: argmax with first-index ties. The
    reference's per-request threefry streams (temperature / top-p) wait
    for ROADMAP A2, and the engine refuses temperature > 0 until then."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


class Logger:
    """Rank-0-gated colored logging to stderr. enabled=None: log unless a
    torch.distributed group is up and this is not rank 0."""

    COLORS = {"info": "\033[94m", "success": "\033[92m",
              "warn": "\033[93m", "error": "\033[91m"}

    def __init__(self, enabled: bool | None = None):
        self.enabled = enabled

    def log(self, msg: str, level: str = "info") -> None:
        enabled = self.enabled
        if enabled is None:
            dist = torch.distributed
            enabled = not (dist.is_available() and dist.is_initialized()
                           and dist.get_rank() != 0)
        if not enabled:
            return
        color = self.COLORS.get(level, "")
        ts = time.strftime("%H:%M:%S")
        print(f"{color}[{ts}] {msg}\033[0m", file=sys.stderr)


logger = Logger()
