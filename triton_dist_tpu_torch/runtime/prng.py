"""Counter-based random bits: the reference framework's threefry-2x32
generator, bit for bit, in torch.

The reference draws the dithered int8 codec's rounding field
(quant/codec.py ``INT8_STOCHASTIC``) from its threefry generator with a
fixed key, so the same input gives the same wire bytes on every rank and
every run. The port reproduces that generator exactly, in the
partitionable counter layout the reference uses (its
``threefry_partitionable`` setting on): element i of a draw of any shape
is the threefry-2x32 hash of the counter pair (hi, lo) of the 64-bit flat
index i under the key, and its 32 random bits are the XOR of the hash's
two words. ``fold_in`` hashes the counter pair (0, data); ``PRNGKey``
makes the key (0, seed) of a 32-bit seed; ``uniform`` puts the
top 23 bits into the mantissa of a float in [1, 2) and subtracts 1.

The arithmetic runs on int64 tensors masked to 32 bits (torch has no
full uint32 arithmetic), on whatever device the caller names. Every draw
is a pure function of (key, shape), so ``cached_uniform`` keeps one
tensor per (key, shape, device): a captured CUDA graph then reads a fixed
buffer. The sampling of ROADMAP A2 reuses this module.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

_CACHE: dict[tuple, torch.Tensor] = {}


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry_2x32(key, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under ``key`` = (k0, k1), each word an int64 tensor holding a uint32;
    returns the two hashed words."""
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int) -> tuple[int, int]:
    """The raw key of an integer seed, taken as 32 bits as the reference
    takes it with its 64-bit mode off (the default): (0, seed &
    0xffffffff)."""
    return (0, int(seed) & _MASK)


def fold_in(key, data: int) -> tuple[int, int]:
    """A new key from ``key`` and a 32-bit integer: the hash of the counter
    pair (0, data)."""
    a, b = threefry_2x32(key, torch.zeros(1, dtype=torch.int64),
                         torch.tensor([int(data) & _MASK]))
    return (int(a[0]), int(b[0]))


def random_bits(key, shape, device) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 tensor holding
    uint32 values) on ``device``: the hash of each element's flat-index
    counter pair, its two words XORed."""
    size = math.prod(shape)
    idx = torch.arange(size, dtype=torch.int64, device=device)
    w0, w1 = threefry_2x32(key, idx >> 32, idx & _MASK)
    return (w0 ^ w1).reshape(shape)


def uniform(key, shape, device) -> torch.Tensor:
    """f32 uniform in [0, 1) of ``shape`` on ``device``: the top 23 random
    bits as the mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def cached_uniform(key, shape, device) -> torch.Tensor:
    """``uniform(key, shape, device)``, made once per (key, shape, device)
    and kept: the same tensor (and address) on every call."""
    dev = torch.device(device)
    k = (tuple(key), tuple(int(s) for s in shape), str(dev))
    u = _CACHE.get(k)
    if u is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"dither field {k[1]}: first draw under "
                               "CUDA-graph capture; warm up before capturing")
        u = _CACHE[k] = uniform(key, shape, dev)
    return u
