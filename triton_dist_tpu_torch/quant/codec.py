"""The kv_int8_row codec: int8 payload + one f32 symmetric scale per row
(the reference's quant/codec.py kv_row_encode / kv_row_decode).

The resident pool writer (models/kv_cache.paged_write_layer) encodes with
these, and the bytes must equal the reference's: round half to even
(``torch.round`` and ``jnp.round`` agree), an IEEE f32 division by the
row scale, and a clip to [-127, 127]. The other wire codecs wait for the
quantized-wire slice (ROADMAP A13).
"""

from __future__ import annotations

import torch

_INT8_MAX = 127.0


def _row_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-row (last axis) symmetric scale, (..., 1) f32; 1 for all-zero
    rows."""
    s = x.float().abs().amax(dim=-1, keepdim=True) / _INT8_MAX
    return torch.where(s == 0, 1.0, s)


def kv_row_encode(x: torch.Tensor):
    """x (..., D) -> (int8 (..., D), f32 scale (..., 1))."""
    s = _row_scale(x)
    q = torch.clamp(torch.round(x.float() / s), -_INT8_MAX, _INT8_MAX)
    return q.to(torch.int8), s


def kv_row_decode(q: torch.Tensor, s: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of kv_row_encode; ``s`` is the keepdims (..., 1) scale."""
    return (q.float() * s).to(dtype)
