"""The plan B9 and B7 share (``reduce_scatter.ring_plan``): the grid, the
protocol and the buffer's layout that the launch passes to
``csrc/ring_collectives.cu``, held on the CPU. The kernel works out each
slot, flag, column slice and fold position from those few numbers; this
file writes the same formulas down (_flag, _fold; the slot and column
formulas and the slots' emulation in ``torch_slot_emulation.py``, shared
with B6's test) and holds them: the slots must be disjoint and aligned inside the buffer, the flags
after the data, the blocks' column slices must cover every vector once,
and the grid must leave every rank that shares an H100 resident. An
emulation of the kernels' data movement (every rank's chunks stored into
the owners' slots, in plain vectors or in LL lines tagged with the epoch,
then read back and folded in the ring's order) must give
``ring_rs_fold``'s bytes (B9) and the concatenation (B7). That the kernel's
own addressing is these formulas is held on the card: ``chip_smoke.py``'s
ring phases compare every output with the plain version bit for bit.
``ring_rs_fold`` is held to the JAX interpret-mode ring kernel by
``tests/torch_continuous_tp_cases.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_slot_emulation import cols as _cols
from torch_slot_emulation import exchange as _exchange
from torch_slot_emulation import slot as _slot
from torch_slot_emulation import tensor as _tensor
from torch_slot_emulation import vectors as _vectors
from triton_dist_tpu_torch.kernels.plain import ring_rs_fold
from triton_dist_tpu_torch.kernels.reduce_scatter import (
    LL_MAX_SLOT_BYTES, ring_layout, ring_plan,
)

SMS = 132          # an H100's SMs
SHAPES = [(n, m, k, es, rpd)
          for n in (2, 4, 8) for m in (1, 2, 4, 16, 128)
          for k, es in ((5120, 2), (5000, 2), (5120, 4)) for rpd in (1, 4)
          if rpd <= n]
PROTOCOLS = (None, True, False)


def _plan(n, m, k, es, rpd, ll=None, sms=SMS):
    """ring_plan's plan, or its grid under the protocol ``ll`` (as the
    chip's protocol sweep forces one)."""
    plan = ring_plan(n, m, k, es, sms, rpd)
    return plan if ll is None else ring_layout(n, m, plan.kv, plan.grid, ll)


def _plans():
    return [(n, _plan(n, m, k, es, rpd, ll))
            for n, m, k, es, rpd in SHAPES for ll in PROTOCOLS]


def _flag(plan, b, j, n):
    """Byte offset of block b's flag for slot j."""
    return plan.flag_off + 8 * (b * (n - 1) + j)


def _fold(n, p):
    """Owner p's terms in fold order: the senders of slots 0..n-2, then p
    (slot s of p holds rank p + 1 + s's rows)."""
    return [(p + 1 + s) % n for s in range(n - 1)] + [p]


@pytest.mark.parametrize("n,m,k,es,rpd", SHAPES)
def test_slots_disjoint_aligned_inside(n, m, k, es, rpd):
    for ll in PROTOCOLS:
        plan = _plan(n, m, k, es, rpd, ll)
        assert plan.m == m and plan.kv == k * es // 16
        spans = sorted((off, off + plan.slot_bytes)
                       for p in range(2) for off in
                       (_slot(plan, p, j, n) for j in range(n - 1)))
        assert len(spans) == 2 * (n - 1)
        assert plan.slot_bytes >= m * plan.kv * 16 * (2 if plan.ll else 1)
        for (lo, hi), (lo2, _) in zip(spans, spans[1:]):
            assert hi <= lo2
        assert all(lo % 16 == 0 for lo, _ in spans)
        assert spans[0][0] >= 0 and spans[-1][1] <= plan.nbytes


def test_flags_aligned_after_data():
    for n, plan in _plans():
        data_end = 2 * (n - 1) * plan.slot_bytes
        if plan.ll:
            assert plan.nbytes == data_end     # no flags under LL
            continue
        offs = [_flag(plan, b, j, n) for b in range(plan.grid)
                for j in range(n - 1)]
        assert len(set(offs)) == plan.grid * (n - 1)
        assert all(o % 8 == 0 and o >= data_end and o + 8 <= plan.nbytes
                   for o in offs)


def test_columns_cover_every_vector_once():
    for _, plan in _plans():
        seen = np.zeros(plan.kv, dtype=np.int64)
        for c0, cw in _cols(plan):
            assert cw >= 1
            seen[c0:c0 + cw] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("rpd", (1, 4))
def test_grid_resident(rpd):
    for n, m, k, es, _ in SHAPES:
        plan = ring_plan(n, m, k, es, SMS, rpd)
        assert 1 <= plan.grid <= plan.kv
        assert plan.grid * rpd <= SMS     # one block an SM a rank at most


def test_protocol_follows_slot_bytes():
    for n, m, k, es, rpd in SHAPES:
        plan = ring_plan(n, m, k, es, SMS, rpd)
        assert plan.ll == (m * k * es <= LL_MAX_SLOT_BYTES)


def test_fold_order_is_the_ring():
    for n in (2, 4, 8):
        for p in range(n):
            assert _fold(n, p) == [(p + j) % n for j in range(1, n + 1)]
            # the sender of slot j is the one whose slot for p is j
            for j, r in enumerate(_fold(n, p)[:-1]):
                assert (r - p - 1) % n == j


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("ll", (True, False))
def test_reduce_scatter_emulation_is_the_ring_fold(dtype, n, ll):
    m, k = 3, 1000
    es = dtype.itemsize
    plan = _plan(n, m, k, es, 2, ll, sms=8)
    assert plan.grid > 1 and len({cw for _, cw in _cols(plan)}) > 1  # ragged
    rng = np.random.default_rng(14 + n)
    for epoch in (1, 2, 3):
        xs = [torch.from_numpy(rng.standard_normal((n * m, k)).astype(
            np.float32)).to(dtype) for _ in range(n)]
        chunks = [[_vectors(x[p * m:(p + 1) * m]) for p in range(n)]
                  for x in xs]
        got = _exchange(plan, n, chunks, epoch)
        for p in range(n):
            senders = _fold(n, p)
            terms = [_tensor(got[p][j], dtype, k) for j in range(n - 1)]
            assert all(torch.equal(t, xs[r][p * m:(p + 1) * m])
                       for t, r in zip(terms, senders))
            acc = terms[0]
            for t in terms[1:] + [xs[p][p * m:(p + 1) * m]]:
                acc = acc + t
            assert torch.equal(acc, ring_rs_fold(xs, p))


@pytest.mark.parametrize("n", (2, 4, 8))
@pytest.mark.parametrize("ll", (True, False))
def test_all_gather_emulation_is_the_concatenation(n, ll):
    m, k = 3, 1000
    plan = _plan(n, m, k, 2, 2, ll, sms=6)
    assert plan.grid > 1 and len({cw for _, cw in _cols(plan)}) > 1  # ragged
    rng = np.random.default_rng(7 + n)
    xs = [torch.from_numpy(rng.standard_normal((m, k)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(n)]
    got = _exchange(plan, n, [[_vectors(x)] * n for x in xs], 2)
    for p in range(n):
        rows = [None] * n
        rows[p] = xs[p]
        for j in range(n - 1):
            rows[(p + 1 + j) % n] = _tensor(got[p][j], torch.bfloat16, k)
        assert torch.equal(torch.cat(rows), torch.cat(xs))
