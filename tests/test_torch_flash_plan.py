"""B1's launch plan (``flash_attention.flash_plan``): the packing of the
bf16 kernel's blocks into (query, head) rows of one kv head, which the
launch passes to the kernel, held on the CPU. Every (b, query, q head)
triple must be covered by exactly one live row of one block, at the heads
of the models the port serves and ragged T. The rows are read with the
kernel's own mapping (``csrc/flash_prefill.cu``'s ``attn_kernel``: block
x holds query tile x // h_tiles and head tile x % h_tiles). The kernel's
key-step bounds (the causal bound with the key start, and the varlen
skip) are computed on the device from the positions it reads there; they
are held only by ``chip_smoke.py``'s chunk, offset and varlen cases."""

from __future__ import annotations

import numpy as np
import pytest

from triton_dist_tpu_torch.kernels.flash_attention import FlashPlan, flash_plan

HEADS = {  # (Hq, Hkv)
    "qwen3_8b": (32, 8),
    "qwen3_32b_tp4_rank": (16, 2),
    "qwen3_30b_a3b": (32, 4),
    "qwen3_32b_sp": (64, 8),
    "g1": (8, 8),
    "g3": (24, 8),
    "g16": (32, 2),
}
TS = (1, 7, 200, 512, 2048)
B = 2


def _rows(plan: FlashPlan, t: int, g: int):
    """(query, group head, live) of every row of every block x, as
    (grid x, rows) arrays."""
    x = np.arange(plan.grid[0])[:, None]
    r = np.arange(plan.rows)[None, :]
    q = (x // plan.h_tiles) * plan.q_per_tile + r // plan.h_per_tile
    h = (x % plan.h_tiles) * plan.h_per_tile + r % plan.h_per_tile
    live = (r < plan.q_per_tile * plan.h_per_tile) & (q < t) & (h < g)
    return q, h, live


@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("heads", sorted(HEADS))
def test_flash_plan_covers_every_pair_once(heads, t):
    hq, hkv = HEADS[heads]
    g = hq // hkv
    plan = flash_plan(B, t, hq, hkv)
    assert plan.rows in (64, 128)
    assert plan.grid[1:] == (hkv, B) and plan.grid[0] % plan.h_tiles == 0
    assert plan.q_per_tile * plan.h_per_tile <= plan.rows
    q, h, live = _rows(plan, t, g)
    # blocks (x, hk, b): kv head hk's rows are q heads hk * g + h, batch
    # row b its own, so per (hk, b) the (query, group head) pairs of the
    # x axis must each appear once
    counts = np.bincount((q * g + h)[live], minlength=t * g)
    assert counts.shape == (t * g,) and (counts == 1).all()
    assert int(live.sum()) == t * g
    # every block holds a live row; at T = 1 a block holds the g heads
    assert live.any(axis=1).all()
    if t == 1 and g <= 64:
        assert plan.rows == 64 and int(live.sum()) == g


def test_flash_plan_grid_ignores_positions_and_refuses_bad_heads():
    """The grid is a function of (B, T, Hq, Hkv) alone: a captured graph
    replayed at a moved offset launches the same blocks."""
    plan = flash_plan(4, 1, 32, 8)
    assert plan.grid == (1, 8, 4) and plan.rows == 64
    assert plan.q_per_tile * plan.h_per_tile >= 4
    big = flash_plan(1, 3, 256, 1)      # a group wider than a block
    assert (big.h_per_tile, big.h_tiles, big.q_per_tile) == (128, 2, 1)
    with pytest.raises(ValueError):
        flash_plan(1, 4, 30, 8)
    with pytest.raises(ValueError):
        flash_plan(1, 0, 32, 8)
