"""The plan of the bf16 decode GEMM that B4's world-1 body and B12 share
(``gemm_allreduce.stream_plan``, ``csrc/gemm_stream_sm90.cuh``), held on
the CPU. The kernel cuts the (M group, column tile, K tile) units of
out = A @ W evenly over a persistent grid (stream-K), walks each block's
run as items, and folds a column tile's partial sums in the same launch;
this file writes the kernel's formulas down (_unit0, _owner, _items,
_slot, _ticket) and holds them: every element of W lies in exactly one
item, each tile's slices are folded in block (K) order whatever order
they arrive in (a numpy emulation of the workspace, the tickets and the
fold), no two tiles of a launch share a workspace slot or a ticket, the
units spread evenly over an H100's 132 SMs, and the tile obeys the TMA
box, stride and shared-memory rules. That the kernel's own addressing is
these formulas is held on the card: ``chip_smoke.py``'s ``b4_gemm_ar``
and ``b12_matmul`` compare every case with the plain version.
"""

from __future__ import annotations

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from triton_dist_tpu_torch.kernels import gemm_allreduce as ga

SMS = 132                  # an H100's SMs
SMEM_MAX = 232448          # shared memory a block may use (227 KB)
SOURCE = (Path(ga.__file__).resolve().parent.parent / "csrc"
          / "gemm_stream_sm90.cuh").read_text()


def _const(name):
    """An integer constant of the kernel's source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE)[1])


BOX, NBX, BK = _const("BOX"), _const("NBX"), _const("BK")
STAGES, NCW = _const("STAGES"), _const("NCW")
A_LD = BK + 8              # the source's A_LD (held below)


def _smem_bytes(mg):
    """The kernel's smem_bytes: alignment slack, the ring's W tiles and
    A rows, its full and empty barriers."""
    return 1024 + STAGES * BK * NBX * BOX * 2 + STAGES * mg * A_LD * 2 + \
        2 * STAGES * 8


# (name, K, N): Qwen3-8B's QKV, o, gate_up and down, Qwen3-30B-A3B's QKV
# and o, and odd shapes (a K the tile does not divide, one 8-column tile)
SHAPES = (("qkv_8b", 4096, 6144), ("o_8b", 4096, 4096),
          ("gate_up_8b", 4096, 24576), ("down_8b", 12288, 4096),
          ("qkv_30b", 2048, 5120), ("o_30b", 4096, 2048),
          ("k100_n8", 100, 8), ("k1000_n136", 1000, 136),
          ("k257_n72", 257, 72))
ROWS = (1, 4, 8, 16, 2048)


def _unit0(units, grid, b):
    """Block b's first unit (the kernel's unit0)."""
    return b * units // grid


def _owner(units, grid, u):
    """The block whose run holds unit u (the kernel's owner)."""
    return ((u + 1) * grid - 1) // units


def _items(plan, b):
    """The kernel's for_items: block b's (tile, kt0, kt1), in order."""
    out, u = [], _unit0(plan.units, plan.grid, b)
    end = _unit0(plan.units, plan.grid, b + 1)
    while u < end:
        t, kt0 = divmod(u, plan.n_kt)
        kt1 = kt0 + min(end - u, plan.n_kt - kt0)
        out.append((t, kt0, kt1))
        u += kt1 - kt0
    return out


def _bounds(plan, t):
    """Tile t's first and last block (the kernel's b_first, b_last)."""
    t0 = t * plan.n_kt
    return (_owner(plan.units, plan.grid, t0),
            _owner(plan.units, plan.grid, t0 + plan.n_kt - 1))


def _slot(plan, t, b):
    """Block b's workspace slot for tile t: 2b for its first item, 2b + 1
    for a later one."""
    return 2 * b + (1 if t * plan.n_kt > _unit0(plan.units, plan.grid, b)
                    else 0)


def _ticket(plan, t):
    """The ticket row of tile t: its last block."""
    return _bounds(plan, t)[1]


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("name,k,n", SHAPES)
def test_every_weight_element_in_one_item(name, k, n, m):
    plan = ga.stream_plan(m, k, n, SMS)
    assert plan.mg == (8 if m <= 8 else 16)
    bn, bk = ga.STREAM_BN, ga.STREAM_BK
    assert (plan.n_tiles - 1) * bn < n <= plan.n_tiles * bn
    assert (plan.n_kt - 1) * bk < k <= plan.n_kt * bk
    assert (plan.n_mg - 1) * plan.mg < m <= plan.n_mg * plan.mg
    assert plan.units == plan.n_mg * plan.n_tiles * plan.n_kt
    assert plan.grid == min(SMS, plan.units)
    seen = np.zeros((plan.n_mg * plan.n_tiles, plan.n_kt), dtype=np.int64)
    for b in range(plan.grid):
        items = _items(plan, b)
        assert items
        for t, kt0, kt1 in items:
            assert 0 <= kt0 < kt1 <= plan.n_kt
            seen[t, kt0:kt1] += 1
    # each (M group, column tile) x K tile once: every (K row, column) of
    # W once per M group, every row of A in its group
    assert (seen == 1).all()


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("name,k,n", SHAPES)
def test_slots_and_tickets_unique(name, k, n, m):
    """Within a launch no two tiles write one workspace slot, and no two
    tiles of several slices count on one ticket; a block's slots are its
    first item (2b) and its last (2b + 1)."""
    plan = ga.stream_plan(m, k, n, SMS)
    slots, tickets = {}, {}
    for t in range(plan.n_mg * plan.n_tiles):
        first, last = _bounds(plan, t)
        got = [(b, _slot(plan, t, b)) for b in range(first, last + 1)]
        if first == last:
            continue                       # stored by its one block
        assert _ticket(plan, t) == last
        assert tickets.setdefault(last, t) == t
        for b, s in got:
            assert s in (2 * b, 2 * b + 1)
            assert slots.setdefault(s, t) == t
            items = _items(plan, b)
            assert (t, s) in ((items[0][0], 2 * b), (items[-1][0], 2 * b + 1))
    assert len(slots) <= 2 * plan.grid
    assert plan.ws_floats == 2 * plan.grid * ga.STREAM_BN * plan.mg


def _emulate(plan, a, w, order):
    """The kernel's data flow in numpy, f32: each item's partial (its K
    tiles' products summed), stored into its block's slot, or cast and
    stored if the item holds the whole tile; the tiles' tickets count the
    items as they arrive in ``order`` (a permutation of every block's
    items) and the last to arrive folds the slices in block order."""
    m, k = a.shape
    n = w.shape[1]
    out = np.full((m, n), np.nan, dtype=np.float32)
    ws = {}
    tickets = np.zeros(plan.grid, dtype=np.int64)
    bk, bn, mg = ga.STREAM_BK, ga.STREAM_BN, plan.mg

    def block_of(t):
        g, ct = divmod(t, plan.n_tiles)
        return (slice(g * mg, min(m, (g + 1) * mg)),
                slice(ct * bn, min(n, (ct + 1) * bn)))

    for b, (t, kt0, kt1) in order:
        rows, cols = block_of(t)
        part = a[rows, kt0 * bk:kt1 * bk] @ w[kt0 * bk:kt1 * bk, cols]
        first, last = _bounds(plan, t)
        if first == last:
            out[rows, cols] = part
            continue
        ws[_slot(plan, t, b)] = part
        tickets[last] += 1
        if tickets[last] == last - first + 1:
            acc = np.zeros_like(part)
            for bb in range(first, last + 1):
                acc = acc + ws[_slot(plan, t, bb)]
            out[rows, cols] = acc
            tickets[last] = 0
    assert (tickets == 0).all()             # left zero for the next call
    return out


@pytest.mark.parametrize("m,k,n,sms", [
    (4, 1000, 136, 132), (4, 1000, 136, 7), (9, 700, 264, 5),
    (3, 4096, 256, 132), (17, 300, 128, 3)])
def test_fold_in_slice_order_whatever_the_arrival(m, k, n, sms):
    """Every arrival order gives the same bytes: the sequential f32 sum of
    the tile's slices in block order, within f32 rounding of the exact
    product."""
    plan = ga.stream_plan(m, k, n, sms)
    rng = np.random.default_rng(m * 1000 + k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    items = [(b, it) for b in range(plan.grid) for it in _items(plan, b)]
    assert any(_bounds(plan, t)[0] != _bounds(plan, t)[1]
               for _, (t, _, _) in items)    # some tile has several slices
    want = _emulate(plan, a, w, items)
    for seed in range(4):
        order = [items[i] for i in
                 np.random.default_rng(seed).permutation(len(items))]
        np.testing.assert_array_equal(_emulate(plan, a, w, order), want)
    exact = a.astype(np.float64) @ w.astype(np.float64)
    np.testing.assert_allclose(want, exact, rtol=1e-4, atol=1e-4 * k ** 0.5)


def _weight_bytes(plan, k, n, b):
    """The weight bytes block b streams (edge tiles counted as loaded:
    TMA reads only what lies inside W)."""
    total = 0
    for t, kt0, kt1 in _items(plan, b):
        ct = t % plan.n_tiles
        cols = min(ga.STREAM_BN, n - ct * ga.STREAM_BN)
        rows = min(k, kt1 * ga.STREAM_BK) - kt0 * ga.STREAM_BK
        total += 2 * rows * cols
    return total


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("name,k,n", SHAPES)
def test_units_spread_evenly_over_the_sms(name, k, n, m):
    """Every block gets floor or ceil of units / grid units; at the
    models' decode shapes (M <= 16) the block that streams the most
    weight bytes streams at most 1/floor(units / grid) more than the
    mean (4% at Qwen3-30B-A3B's o, the coarsest), and the grid fills the
    132 SMs."""
    plan = ga.stream_plan(m, k, n, SMS)
    counts = [_unit0(plan.units, plan.grid, b + 1)
              - _unit0(plan.units, plan.grid, b) for b in range(plan.grid)]
    lo = plan.units // plan.grid
    assert set(counts) <= {lo, lo + 1} and min(counts) >= 1
    per = [_weight_bytes(plan, k, n, b) for b in range(plan.grid)]
    assert sum(per) == plan.n_mg * 2 * k * n
    if name.endswith(("_8b", "_30b")) and m <= 16:
        assert plan.grid == SMS
        assert max(per) / np.mean(per) <= 1 + 1 / lo
        assert max(per) / np.mean(per) <= 1.04


def test_tma_box_stride_and_shared_memory_rules():
    """The 2-D map's box: 64 columns (128 bytes, the 128-byte swizzle's
    span), at most 256 rows; tiles 1024-byte aligned in shared memory
    (the swizzle's repeat); the ring and A's rows within a block's shared
    memory at MG 8 and 16; A's row stride keeps its 16-byte copies aligned
    and puts an ldmatrix's 8 rows on 8 distinct 16-byte bank groups; the
    K loop takes 32 rows a step."""
    assert BOX * 2 == 128
    assert (NBX * BOX) % (16 * NCW) == 0      # whole 16-column MMA rows
    assert BK <= 256 and BK % 32 == 0
    assert (BK * BOX * 2) % 1024 == 0
    for mg in (8, 16):
        assert _smem_bytes(mg) <= SMEM_MAX
    row = A_LD * 2
    assert row % 16 == 0
    assert len({(r * row // 16) % 8 for r in range(8)}) == 8
    # the map's row stride is N * 2 bytes: a multiple of 16 exactly when N
    # is a multiple of 8, the wrapper's rule
    for n in (8, 16, 2048, 5120, 6144, 24576):
        assert (n * 2) % 16 == 0
    assert all((n * 2) % 16 for n in (4, 12, 100))


def test_constants_match_the_kernel_source():
    """The Python plan's tile is the kernel's, and so are the formulas
    this file uses for the shared memory and A's rows."""
    assert NBX * BOX == ga.STREAM_BN
    assert BK == ga.STREAM_BK
    assert "constexpr int A_LD = BK + 8;" in SOURCE
    assert "2 * STAGES * sizeof(uint64_t);" in SOURCE


@pytest.mark.parametrize("bad", ["n12", "misaligned_w"])
def test_wrapper_raises_on_what_tma_cannot_take(bad):
    """A shape the map cannot take raises in the wrapper with its reason,
    before any device call."""
    a = torch.zeros((4, 64), dtype=torch.bfloat16)
    if bad == "n12":
        w = torch.zeros((64, 12), dtype=torch.bfloat16)
        match = "multiple of 8"
    else:
        w = torch.zeros((64 * 16 + 1,), dtype=torch.bfloat16)[1:].view(
            64, 16)
        match = "16-byte aligned"
    with pytest.raises(ValueError, match=match):
        ga.splitk_launch(a, w, "gemm_ar", "td_gemm_ar", "gemm_ar")


def test_tickets_fit_the_grid():
    """The device's ticket words hold 4 a block at any grid the plan
    gives (at most one block an SM of an H100)."""
    worst = max(ga.stream_plan(m, k, n, SMS).grid
                for (_, k, n), m in itertools.product(SHAPES, ROWS))
    assert worst == SMS
    assert NCW * worst <= ga._TICKET_WORDS
