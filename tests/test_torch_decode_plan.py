"""B19's plan (``flash_attention.decode_plan``): how one launch of the
split-KV decode partial cuts a shard into splits (a block each per batch
row and kv head) and the splits into tiles, held on the CPU. The kernel
works out each block's live keys and tiles from the plan's chunk and tile
and the positions it reads on the device; this file writes the same
formulas down (_live, _tiles) and holds them: every live key (inside the
shard, at or before q_pos) lies in exactly one split and one tile, no
tile starts past the live keys (a split wholly past q_pos loads nothing),
and the blocks fill an H100's SMs at Qwen3-32B's and Qwen3-8B's
sequence-parallel heads and at g = 1. That the kernel's own addressing
is these formulas is held on the card: ``chip_smoke.py``'s
``b19_flash_decode_partial`` compares every case with the plain version.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from triton_dist_tpu_torch.kernels.flash_attention import (
    decode_plan, decode_splits,
)

SMS = 132          # an H100's SMs
# (name, Hq, Hkv): Qwen3-32B's and Qwen3-8B's attention, and g = 1
HEADS = (("qwen3_32b", 64, 8), ("qwen3_8b", 32, 8), ("g1", 32, 32))


def _live(plan, sp, s_loc, start, q_pos):
    """Split sp's live keys [k_lo, k_hi) (the kernel's k_lo, k_hi)."""
    k_lo = sp * plan.chunk
    hi = min(k_lo + plan.chunk, s_loc, q_pos - start + 1)
    return k_lo, max(hi, k_lo)


def _tiles(plan, sp, s_loc, start, q_pos):
    """The first key of each tile split sp loads (the producer's loop:
    tile i at k_lo + i * tile while it starts before k_hi)."""
    k_lo, k_hi = _live(plan, sp, s_loc, start, q_pos)
    return list(range(k_lo, k_hi, plan.tile))


CASES = [(s_loc, rows, dt, start, q_pos)
         for s_loc in (1, 200, 3000, 4096, 32768)
         for rows in (1, 8, 32, 256)
         for dt in (torch.bfloat16, torch.float32)
         for start, q_pos in ((0, 10 ** 6), (0, 150), (100, 2999),
                              (4096, 4095), (0, 0))]


@pytest.mark.parametrize("s_loc,rows,dt,start,q_pos", CASES)
def test_every_live_key_in_one_split_and_one_tile(s_loc, rows, dt, start,
                                                  q_pos):
    plan = decode_plan(s_loc, rows, SMS, dt)
    assert plan.chunk % 128 == 0 and plan.tile in (64, 128)
    assert plan.chunk % plan.tile == 0
    assert plan.chunk * (plan.splits - 1) < s_loc <= plan.chunk * plan.splits
    live = min(s_loc, max(q_pos - start + 1, 0))
    seen = np.zeros(s_loc, dtype=np.int64)
    for sp in range(plan.splits):
        for t0 in _tiles(plan, sp, s_loc, start, q_pos):
            k_lo, k_hi = _live(plan, sp, s_loc, start, q_pos)
            assert k_lo <= t0 < k_hi                # a tile only where keys live
            keys = np.arange(t0, min(t0 + plan.tile, k_hi))
            seen[keys] += 1
    assert (seen[:live] == 1).all()                 # each live key once
    assert (seen[live:] == 0).all()                 # nothing past q_pos / S


def test_split_past_q_pos_loads_nothing():
    plan = decode_plan(32768, 8, SMS, torch.bfloat16)
    assert plan.splits > 2
    # the horizon 200 keys into the shard: every split but the first is
    # wholly in the future
    loads = [_tiles(plan, sp, 32768, 0, 199) for sp in range(plan.splits)]
    assert loads[0] == list(range(0, 200, plan.tile))
    assert all(t == [] for t in loads[1:])
    # a shard wholly past q_pos: no split loads
    assert all(_tiles(plan, sp, 32768, 32768, 32767) == []
               for sp in range(plan.splits))


@pytest.mark.parametrize("name,hq,hkv", HEADS)
@pytest.mark.parametrize("b", (1, 2, 4, 8, 16))
@pytest.mark.parametrize("s_loc", (4096, 32768))
def test_grid_fills_the_sms(name, hq, hkv, b, s_loc):
    """One bf16 block an SM at a time (its shared memory allows one): the
    waves of blocks, the last one included, at least 90% full."""
    plan = decode_plan(s_loc, b * hkv, SMS, torch.bfloat16)
    blocks = plan.splits * b * hkv
    waves = -(-blocks // SMS)
    assert blocks / (waves * SMS) >= 0.9, (name, b, plan)
    assert plan.tile == 64 and plan.stages >= 3 and plan.groups == 4
    assert hq % hkv == 0 and hq // hkv in (1, 2, 4, 8)


def test_f32_keeps_the_fma_plan():
    for s_loc, rows in ((1000, 8), (32768, 32), (160, 4)):
        plan = decode_plan(s_loc, rows, SMS, torch.float32)
        assert (plan.chunk, plan.splits) == decode_splits(s_loc, rows, SMS)
        assert plan.tile == 128 and plan.groups == 1
