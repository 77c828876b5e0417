"""Wire codecs: what the quantized-communication tiers put on the wire (the
reference's quant/codec.py).

One module owns the encode / decode math, so every transport (the int8
one-shot all-reduce B28 and its plain twin, the int8 ring, the
expert-parallel fp8 payload, the KV page handoff) agrees on the layout and
on the error bound the contracts (quant/contract.py) promise per
quantization event. Each codec is a frozen description with plain torch
``encode`` / ``decode`` plus:

  * ``err_bound(x, scale)``: the elementwise worst-case absolute error of
    ONE encode -> decode round trip;
  * ``wire_bytes(shape, base_dtype)``: the bytes the codec puts on the
    wire for a payload of ``shape`` (payload + scales);
  * ``scale_of(x)``: the scale encode derives for x.

The scale is decided once, here, for the plain versions and the kernels
alike: ``s = amax / 127`` as an IEEE f32 division (1 for an all-zero
row), then ``q = clip(round(x / s), -127, 127)`` with another IEEE
division and round half to even (``torch.round``; ``rintf`` in the CUDA
kernels of csrc/quant_wire.cu, which divide with ``__fdiv_rn``); the
divisors are tensors, since torch on CUDA multiplies by the reciprocal of
a Python number divisor, which is not the quotient in every row. That is
what the reference's source says and what it computes when it runs op by
op; compiled as one program the reference multiplies by the reciprocal
instead (``amax * (1/127)``), which can move a scale by one ulp.

Determinism: encode is a pure function of the input bytes. The dithered
variant draws its rounding field from the reference's generator under a
FIXED key (runtime/prng.py), so re-encoding the same tensor gives the
same bytes on every rank and every run; the field is cached per (shape,
device).

``kv_row_encode`` / ``kv_row_decode`` (the int8-resident KV pool's
per-row codec) are ``INT8_BLOCK``'s math under the resident pool's name.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from triton_dist_tpu_torch.runtime import prng

# int8 symmetric range: round-to-nearest across [-127, 127] moves a value
# by at most half a step = amax/254; the dither by up to one full step
_INT8_MAX = 127.0

# fixed root of the dithered variant's field: NOT a knob (same input =>
# same wire bytes is a correctness property)
_SR_KEY = (0x51, 0xC0DEC)


@functools.lru_cache(maxsize=None)
def _sr_field_key() -> tuple[int, int]:
    return prng.fold_in(prng.PRNGKey(_SR_KEY[0]), _SR_KEY[1])


def _div127(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 as an IEEE division on every device: the divisor is a
    tensor, because torch on CUDA multiplies by the reciprocal of a Python
    number divisor (one ulp off the quotient in some rows)."""
    return amax / torch.full_like(amax, _INT8_MAX)


def _row_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-row (last axis) symmetric scale, (..., 1) f32; 1 for all-zero
    rows."""
    s = _div127(x.float().abs().amax(dim=-1, keepdim=True))
    return torch.where(s == 0, 1.0, s)


def encode_int8_nearest(x: torch.Tensor):
    """x (..., K) -> (q int8 (..., K), s f32 (..., 1)): the int8 row encode
    of B27, B28 and the ring's hops."""
    s = _row_scale(x)
    q = torch.clamp(torch.round(x.float() / s), -_INT8_MAX, _INT8_MAX)
    return q.to(torch.int8), s


def _encode_int8_stochastic(x: torch.Tensor):
    s = _row_scale(x)
    v = x.float() / s
    # deterministic dithered rounding: the threshold field depends only on
    # the fixed key and the element's position
    u = prng.cached_uniform(_sr_field_key(), v.shape, v.device)
    q = torch.clamp(torch.floor(v + u), -_INT8_MAX, _INT8_MAX)
    return q.to(torch.int8), s


def decode_int8(q: torch.Tensor, s: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * s).to(dtype)


def _int8_wire_bytes(shape, base_dtype) -> int:
    del base_dtype  # the wire width is the codec's, not the input's
    return math.prod(shape) + math.prod(shape[:-1]) * 4


def _half_step(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    # nearest rounding moves x/s by at most 1/2, so |dq - x| <= s/2
    return torch.broadcast_to(0.5 * s, x.shape)


def _full_step(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    # floor(v + u) moves v by at most one full step either way
    return torch.broadcast_to(1.0 * s, x.shape)


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """One wire format: encode / decode and its executable error bound.

    worst_rel_err is the per-event elementwise bound relative to the
    block's amax: 1/254 for nearest-rounded int8, 1/127 for the dither,
    2^-4 for fp8 e4m3."""
    name: str
    wire_itemsize: float           # payload bytes per element on the wire
    scale_block: int | None        # elements sharing one f32 scale (None:
    #                                per row, the last axis)
    worst_rel_err: float
    encode: Callable
    decode: Callable
    wire_bytes: Callable
    err_bound: Callable            # (x, scale) -> elementwise abs bound
    scale_of: Callable = _row_scale

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        q, s = self.encode(x)
        return self.decode(q, s, x.dtype)

    def reduction_vs(self, shape, base_dtype) -> float:
        """Wire-bytes multiplier this codec buys over full width."""
        full = math.prod(shape) * base_dtype.itemsize
        return full / max(self.wire_bytes(shape, base_dtype), 1)


INT8_BLOCK = WireCodec(
    name="int8_block", wire_itemsize=1.0, scale_block=None,
    worst_rel_err=1.0 / 254.0, encode=encode_int8_nearest,
    decode=decode_int8, wire_bytes=_int8_wire_bytes, err_bound=_half_step)

INT8_STOCHASTIC = WireCodec(
    name="int8_stochastic", wire_itemsize=1.0, scale_block=None,
    worst_rel_err=1.0 / 127.0, encode=_encode_int8_stochastic,
    decode=decode_int8, wire_bytes=_int8_wire_bytes, err_bound=_full_step)


def _encode_fp8_row(x: torch.Tensor, dtype=None):
    # the expert-parallel payload's codec (B18's rows), under its error
    # bound here
    from triton_dist_tpu_torch.kernels.low_latency_all_to_all import (
        quantize_rows,
    )
    q, s = quantize_rows(x, dtype or torch.float8_e4m3fn)
    return q, s[..., None].float()


def _decode_fp8_row(q: torch.Tensor, s: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    from triton_dist_tpu_torch.kernels.low_latency_all_to_all import (
        dequantize_rows,
    )
    return dequantize_rows(q, s[..., 0], dtype)


def _fp8_scale(x: torch.Tensor) -> torch.Tensor:
    amax = x.float().abs().amax(dim=-1, keepdim=True)
    return torch.clamp(amax / float(torch.finfo(torch.float8_e4m3fn).max),
                       min=1e-12)


def _fp8_err_bound(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    # e4m3: 3 mantissa bits -> relative rounding error <= 2^-4 for
    # normals, plus half the smallest subnormal step (2^-9) times the
    # scale
    return x.float().abs() * 2.0 ** -4 + s * 2.0 ** -9


FP8_ROW = WireCodec(
    name="fp8_row", wire_itemsize=1.0, scale_block=None,
    worst_rel_err=2.0 ** -4, encode=_encode_fp8_row, decode=_decode_fp8_row,
    wire_bytes=_int8_wire_bytes, err_bound=_fp8_err_bound,
    scale_of=_fp8_scale)


def _page_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-page symmetric scale: one f32 amax over the trailing
    (page_size, head_dim) plane, (..., 1, 1); 1 for an all-zero page."""
    s = _div127(x.float().abs().amax(dim=(-2, -1), keepdim=True))
    return torch.where(s == 0, 1.0, s)


def _encode_kv_int8_page(x: torch.Tensor):
    s = _page_scale(x)
    q = torch.clamp(torch.round(x.float() / s), -_INT8_MAX, _INT8_MAX)
    return q.to(torch.int8), s


def _kv_page_wire_bytes(shape, base_dtype) -> int:
    del base_dtype
    return math.prod(shape) + math.prod(shape[:-2]) * 4


KV_INT8_PAGE = WireCodec(
    name="kv_int8_page", wire_itemsize=1.0, scale_block=None,
    worst_rel_err=1.0 / 254.0, encode=_encode_kv_int8_page,
    decode=decode_int8, wire_bytes=_kv_page_wire_bytes,
    err_bound=_half_step, scale_of=_page_scale)

# The resident pool's codec: int8_block's bytes under their own name, so
# that contracts and packets mark resident-encoded payloads apart.
KV_INT8_ROW = WireCodec(
    name="kv_int8_row", wire_itemsize=1.0, scale_block=None,
    worst_rel_err=1.0 / 254.0, encode=encode_int8_nearest,
    decode=decode_int8, wire_bytes=_int8_wire_bytes, err_bound=_half_step)


def kv_row_encode(x: torch.Tensor):
    """x (..., D) -> (int8 (..., D), f32 scale (..., 1)); the pool writer
    (models/kv_cache.paged_write_layer) and the wire codec share these
    bytes."""
    return encode_int8_nearest(x)


def kv_row_decode(q: torch.Tensor, s: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of kv_row_encode; ``s`` is the keepdims (..., 1) scale."""
    return decode_int8(q, s, dtype)


CODECS = {c.name: c for c in (INT8_BLOCK, INT8_STOCHASTIC, FP8_ROW,
                              KV_INT8_PAGE, KV_INT8_ROW)}


def codec(name: str) -> WireCodec:
    try:
        return CODECS[name]
    except KeyError:
        raise KeyError(f"unknown wire codec {name!r} "
                       f"(known: {sorted(CODECS)})") from None
