"""B6's plan (``allreduce.rhd_plan``): the regime, the protocol, the grid
and the buffer's layout that the launch passes to ``csrc/allreduce.cu``,
held on the CPU. The kernel works out each slot, flag, column slice and
fold position from those few numbers; this file writes the same formulas
down (_flag, _tree, _term_slot; the slot and column formulas and the
slots' emulation in ``torch_slot_emulation.py``, shared with B9 / B7's
test) and holds them: the slots of both regions disjoint, aligned and
inside the buffer, the flags after their region's data, the regime
following the bytes of x and the protocol the bytes of a slot, the grid
leaving every rank that shares an H100 resident. An emulation of the
kernel's data movement in both regimes (one-shot: every rank's x into its
slot of every peer, then the halving tree over the n terms; two-shot: the
row chunks into their owners' slots, the owner's tree fold, the folded
chunks into every peer's second region), in plain vectors and in LL
lines, over both parities, must give ``rhd_fold``'s bytes on every rank.
That the kernel's own addressing is these formulas is held on the card:
``chip_smoke.py``'s B6 phases compare every output with the plain version
bit for bit. ``rhd_fold`` is held to the JAX package's RHD tier by
``tests/test_torch_ar.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_slot_emulation import cols, exchange, slot, tensor, vectors
from triton_dist_tpu_torch.kernels.allreduce import (
    RHD_ONE_SHOT_MAX_BYTES, rhd_grid, rhd_layout, rhd_plan,
)
from triton_dist_tpu_torch.kernels.plain import rhd_fold
from triton_dist_tpu_torch.kernels.reduce_scatter import LL_MAX_SLOT_BYTES

SMS = 132          # an H100's SMs
SHAPES = [(n, rows, k, es, rpd)
          for n in (2, 4, 8) for rows in (8, 16, 64, 128, 512, 2048)
          for k, es in ((5120, 2), (5000, 2), (5120, 4)) for rpd in (1, 4)
          if rpd <= n]
MODES = ((False, True), (False, False), (True, True), (True, False))


def _plan(n, rows, k, es, rpd, mode=None, sms=SMS):
    """rhd_plan's plan, or the plan under a forced (two_shot, ll) on that
    regime's grid (as the chip's regime sweep forces one)."""
    if mode is None:
        return rhd_plan(n, rows, k, es, sms, rpd)
    two, ll = mode
    kv = k * es // 16
    m = rows // n if two else rows
    return rhd_layout(n, rows, kv, rhd_grid(m, kv, sms, rpd), ll, two)


def _plans():
    return [(n, _plan(n, rows, k, es, rpd, mode))
            for n, rows, k, es, rpd in SHAPES for mode in (None, *MODES)]


def _regions(plan):
    """Byte offsets of the plan's slot regions: the first from byte 0,
    the second (two-shot) from ag_off; each with its flags' offset."""
    out = [(0, plan.flag_off)]
    if plan.two_shot:
        out.append((plan.ag_off, plan.ag_flag_off))
    return out


def _flag(flag_off, b, j, n):
    """Byte offset of block b's flag for slot j of a region."""
    return flag_off + 8 * (b * (n - 1) + j)


def _term_slot(r, me, n):
    """The slot of rank me that holds rank r's term (r != me): rank r
    stores into slot (r - me - 1) mod n (the kernel's fold reads it)."""
    return (r - me - 1) % n


def _tree(terms):
    """The kernel's fold of the n terms in rank order: for d = n/2, n/4,
    ..., 1, t[i] = t[i] + t[i + d] for i < d (each add in the terms'
    dtype); t[0]."""
    t = list(terms)
    d = len(t) // 2
    while d >= 1:
        for i in range(d):
            t[i] = t[i] + t[i + d]
        d //= 2
    return t[0]


@pytest.mark.parametrize("n,rows,k,es,rpd", SHAPES)
def test_slots_disjoint_aligned_inside(n, rows, k, es, rpd):
    for mode in (None, *MODES):
        plan = _plan(n, rows, k, es, rpd, mode)
        assert plan.m == (rows // n if plan.two_shot else rows)
        assert plan.kv == k * es // 16
        assert plan.slot_bytes >= plan.m * plan.kv * 16 * (2 if plan.ll
                                                           else 1)
        spans = sorted((base + slot(plan, p, j, n),
                        base + slot(plan, p, j, n) + plan.slot_bytes)
                       for base, _ in _regions(plan)
                       for p in range(2) for j in range(n - 1))
        assert len(spans) == 2 * (n - 1) * len(_regions(plan))
        for (lo, hi), (lo2, _) in zip(spans, spans[1:]):
            assert hi <= lo2
        assert all(lo % 16 == 0 for lo, _ in spans)
        assert spans[0][0] >= 0 and spans[-1][1] <= plan.nbytes


def test_flags_aligned_after_their_data():
    for n, plan in _plans():
        regions = _regions(plan)
        ends = [base + 2 * (n - 1) * plan.slot_bytes for base, _ in regions]
        if plan.ll:
            continue                            # no flags under LL
        offs = []
        for (base, flag_off), end in zip(regions, ends):
            mine = [_flag(flag_off, b, j, n) for b in range(plan.grid)
                    for j in range(n - 1)]
            assert all(o % 8 == 0 and o >= end for o in mine)
            offs += mine
        assert len(set(offs)) == len(offs)
        assert all(o + 8 <= plan.nbytes for o in offs)
        if plan.two_shot:                       # the first region's flags
            assert max(_flag(plan.flag_off, plan.grid - 1, n - 2, n) + 8,
                       ends[0]) <= plan.ag_off


def test_columns_cover_every_vector_once():
    for _, plan in _plans():
        seen = np.zeros(plan.kv, dtype=np.int64)
        for c0, cw in cols(plan):
            assert cw >= 1
            seen[c0:c0 + cw] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("rpd", (1, 4))
def test_grid_resident(rpd):
    for n, rows, k, es, _ in SHAPES:
        if rpd > n:
            continue
        for mode in (None, *MODES):
            plan = _plan(n, rows, k, es, rpd, mode)
            assert 1 <= plan.grid <= plan.kv
            assert plan.grid * rpd <= SMS   # one block an SM a rank at most


def test_regime_and_protocol_follow_the_bytes():
    for n, rows, k, es, rpd in SHAPES:
        plan = rhd_plan(n, rows, k, es, SMS, rpd)
        assert plan.two_shot == (rows * k * es > RHD_ONE_SHOT_MAX_BYTES)
        slot_bytes = (rows // n if plan.two_shot else rows) * k * es
        assert plan.ll == (slot_bytes <= LL_MAX_SLOT_BYTES)
    # a TP=4 decode step's sum (16 rows of Qwen3-32B's 5,120 bf16) goes
    # one-shot, a 512-token prefill chunk two-shot
    assert not rhd_plan(4, 16, 5120, 2, SMS, 1).two_shot
    assert rhd_plan(4, 512, 5120, 2, SMS, 1).two_shot


def test_term_slots_are_the_senders():
    for n in (2, 4, 8):
        for me in range(n):
            got = sorted(_term_slot(r, me, n) for r in range(n) if r != me)
            assert got == list(range(n - 1))
            # slot s holds rank me + 1 + s's term; a rank stores into the
            # peer at distance i + 1's slot n - 2 - i (the kernel's put)
            for i in range(n - 1):
                assert _term_slot((me + 1 + i) % n, me, n) == i
                assert _term_slot(me, (me + 1 + i) % n, n) == n - 2 - i


def test_tree_is_rhd_fold():
    rng = np.random.default_rng(3)
    for n in (1, 2, 4, 8):
        xs = [torch.from_numpy(rng.standard_normal((4, 24)).astype(
            np.float32)).to(torch.bfloat16) for _ in range(n)]
        assert torch.equal(_tree(xs), rhd_fold(xs))


def _one_shot(plan, n, xs, epoch):
    """Every rank's output under the one-shot regime."""
    got = exchange(plan, n, [[vectors(x)] * n for x in xs], epoch)
    outs = []
    for me in range(n):
        terms = [xs[me] if r == me else
                 tensor(got[me][_term_slot(r, me, n)], xs[0].dtype,
                        xs[0].shape[1]) for r in range(n)]
        assert all(torch.equal(t, x) for t, x in zip(terms, xs))
        outs.append(_tree(terms))
    return outs


def _two_shot(plan, n, xs, epoch):
    """Every rank's output under the two-shot regime: the row chunks into
    their owners' first region, the owners' tree folds, the folded chunks
    into every peer's second region, gathered into out."""
    m, k, dt = plan.m, xs[0].shape[1], xs[0].dtype
    chunks = [[vectors(x[p * m:(p + 1) * m]) for p in range(n)] for x in xs]
    got = exchange(plan, n, chunks, epoch)
    folded = []
    for p in range(n):
        terms = [xs[p][p * m:(p + 1) * m] if r == p else
                 tensor(got[p][_term_slot(r, p, n)], dt, k)
                 for r in range(n)]
        folded.append(_tree(terms))
    got2 = exchange(plan, n, [[vectors(y)] * n for y in folded], epoch,
                    base=plan.ag_off)
    outs = []
    for q in range(n):
        rows = [None] * n
        rows[q] = folded[q]
        for s in range(n - 1):
            rows[(q + 1 + s) % n] = tensor(got2[q][s], dt, k)
        outs.append(torch.cat(rows))
    return outs


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("two,ll", MODES)
def test_emulation_is_the_halving_tree(dtype, n, two, ll):
    rows, k = 3 * n, 1000
    es = dtype.itemsize
    plan = _plan(n, rows, k, es, 2, (two, ll), sms=8)
    assert plan.two_shot == two and plan.ll == ll
    assert plan.grid > 1 and len({cw for _, cw in cols(plan)}) > 1  # ragged
    rng = np.random.default_rng(21 + n)
    for epoch in (1, 2, 3):
        xs = [torch.from_numpy(rng.standard_normal((rows, k)).astype(
            np.float32)).to(dtype) for _ in range(n)]
        outs = (_two_shot if two else _one_shot)(plan, n, xs, epoch)
        want = rhd_fold(xs)
        assert all(torch.equal(o, want) for o in outs)
