"""B13b's landing plan (``gemm_reduce_scatter.bidir_plan``), held on the
CPU. The kernel (``csrc/gemm_rs.cu`` on ``csrc/gemm_land_stream.cuh``)
computes the product of every chunk in one pass over W, stores each row
of its f32 partial into the landing slot of the row's owner for this
sender (slot (parity, sender)), signals by LL lines or by flags per
(sender, row group, 32-column quarter), and each owner folds its n slots
in the arcs' order (``plain.bidir_rs_fold``) and casts once. This file
writes the kernel's formulas down (_slot, _flag, _land, _owners,
_fold_units, _fold) and holds them: the slots and flags are disjoint,
aligned and inside the buffer, every row lands once, every owner's rows
are folded once by units whose flags every sender raises, the grid
leaves every rank that shares an H100 resident, and the control block
holds the epochs and tickets. An emulation of the landing (every rank's
f32 partials, whose sums depend on the order of the adds, stored in
plain vectors or in LL lines tagged with the epoch, over both parities)
and of the kernel's fold must give ``bidir_rs_fold``'s bytes on every
rank at n = 3, 4, 5 and 8. That the kernel's own addressing is these
formulas is held on the card: ``chip_smoke.py``'s ``b13b_gemm_rs_bidir``
and ``tp4_serve`` compare every output with the plain version.
"""

from __future__ import annotations

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_slot_emulation import load as _load
from torch_slot_emulation import store_vectors as _store_vectors
from triton_dist_tpu_torch.kernels import gemm_allreduce as ga
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
from triton_dist_tpu_torch.kernels.plain import bidir_rs_fold

SMS = 132                  # an H100's SMs
CSRC = Path(grs.__file__).resolve().parent.parent / "csrc"
# the entry point and the landing device code it shares with B4
SOURCE = "".join((CSRC / f).read_text()
                 for f in ("gemm_rs.cu", "gemm_land_stream.cuh"))
WORLDS = (3, 4, 5, 8)
# (m rows a chunk, K, N, itemsize): Qwen3-32B's o and down at TP=4 decode
# (4 rows a rank) and prefill (2,048), f32 gates, odd shapes (a group
# across owners, a ragged quarter, one row)
SHAPES = ((4, 2048, 5120, 2), (4, 6400, 5120, 2), (2048, 6400, 5120, 2),
          (4, 2048, 5120, 4), (4, 6400, 5120, 4), (3, 1000, 136, 2),
          (5, 256, 264, 2), (1, 64, 40, 4), (3, 100, 36, 4))
CASES = [(n, *s) for n in WORLDS for s in SHAPES]
SMALL = [c for c in CASES if c[1] < 2048]   # loops over every vector
PROTOCOLS = (None, True, False)


def _plan(n, m, k, nc, es, rpd=1, ll=None, sms=SMS):
    """bidir_plan's plan, or its grid under the protocol ``ll`` (as the
    chip's protocol sweep forces one)."""
    if ll is None:
        return grs.bidir_plan(n, m, k, nc, es, sms, rpd)
    return grs.bidir_layout(n, m, k, nc, es == 2, sms, rpd, ll)


def _slot(plan, par, s, n):
    """Byte offset of sender s's slot of parity par."""
    return (par * n + s) * plan.slot_bytes


def _flag(plan, s, g, q):
    """Byte offset of the flag (sender s, row group g, quarter q)."""
    return plan.flag_off + 8 * ((s * plan.groups + g) * plan.quarters + q)


def _owners(plan, g):
    """The ranks whose rows row group g holds."""
    r1 = min((g + 1) * plan.rg, plan.rows)
    return range(g * plan.rg // plan.m, (r1 - 1) // plan.m + 1)


def _land(plan, row, c4):
    """(owner, vector index in its slot) of vector c4 of product row
    `row`."""
    c = row // plan.m
    return c, (row - c * plan.m) * (plan.n // 4) + c4


def _fold_units(plan, me):
    """Owner me's fold units: (row group, quarter, its rows, its vectors)."""
    kv = plan.n // 4
    g0, g1 = me * plan.m // plan.rg, ((me + 1) * plan.m - 1) // plan.rg
    for g in range(g0, g1 + 1):
        r0 = max(g * plan.rg, me * plan.m)
        r1 = min((g + 1) * plan.rg, plan.rows, (me + 1) * plan.m)
        for q in range(plan.quarters):
            c0 = 8 * q
            yield g, q, range(r0, r1), range(c0, min(c0 + 8, kv))


def _fold(ys, n):
    """The kernel's fold of ys[d], the partial of rank me + d (mod n): own
    + the right chain (distances n - kr .. n - 1, own + arrival) + the left
    chain (distances kl .. 1)."""
    kr, kl = n // 2, (n - 1) // 2
    right = ys[n - kr]
    for d in range(n - kr + 1, n):
        right = ys[d] + right
    out = ys[0] + right
    if kl:
        left = ys[kl]
        for d in range(kl - 1, 0, -1):
            left = ys[d] + left
        out = out + left
    return out


@pytest.mark.parametrize("n,m,k,nc,es", CASES)
def test_slots_and_flags_disjoint_aligned_inside(n, m, k, nc, es):
    for ll in PROTOCOLS:
        plan = _plan(n, m, k, nc, es, 1, ll)
        assert (plan.rows, plan.m, plan.n) == (n * m, m, nc)
        assert plan.slot_bytes >= m * nc * 4 * (2 if plan.ll else 1)
        spans = sorted((o, o + plan.slot_bytes) for o in
                       (_slot(plan, p, s, n) for p in (0, 1)
                        for s in range(n)))
        assert len(spans) == 2 * n and spans[0][0] == 0
        for (_, hi), (lo2, _) in zip(spans, spans[1:]):
            assert hi <= lo2
        assert all(lo % 16 == 0 for lo, _ in spans)
        data_end = spans[-1][1]
        assert data_end <= plan.flag_off and plan.flag_off % 8 == 0
        if plan.ll:
            assert plan.nbytes == plan.flag_off     # no flags under LL
            continue
        s, g, q = np.meshgrid(np.arange(n), np.arange(plan.groups),
                              np.arange(plan.quarters), indexing="ij")
        offs = np.unique(_flag(plan, s, g, q))
        assert offs.size == n * plan.groups * plan.quarters
        assert offs.min() == plan.flag_off
        assert offs.max() + 8 == plan.nbytes


@pytest.mark.parametrize("n,m,k,nc,es", CASES)
def test_protocol_follows_slot_bytes(n, m, k, nc, es):
    plan = _plan(n, m, k, nc, es)
    assert plan.ll == (m * nc * 4 <= grs.RS_LL_MAX_SLOT_BYTES)


@pytest.mark.parametrize("rpd", (1, 4))
def test_grid_resident(rpd):
    """At most one block an SM for every rank that shares the card (the
    stream kernel's ~190 KB of shared memory fits one block an SM), and no
    more blocks than the product has units (bf16) or items (f32)."""
    for n, m, k, nc, es in CASES:
        plan = _plan(n, m, k, nc, es, rpd)
        assert 1 <= plan.grid and plan.grid * rpd <= SMS
        if es == 2:
            assert plan.grid <= ga.stream_plan(n * m, k, nc, SMS).units
        else:
            tiles = -(-plan.rows // plan.rg) * -(-nc // 128)
            assert plan.grid <= tiles * plan.splits


def test_grid_fills_the_card_at_decode():
    for rpd in (1, 4):
        for k in (2048, 6400):
            assert _plan(4, 4, k, 5120, 2, rpd).grid == SMS // rpd


@pytest.mark.parametrize("n,m,k,nc,es", CASES)
def test_row_group_is_the_kernels_row_tile(n, m, k, nc, es):
    """rg is the GEMM's row tile, as the C entry checks it: the stream
    kernel's M group in bf16, gemm_splitk.cuh's row tile in f32."""
    plan, rows = _plan(n, m, k, nc, es), n * m
    if es == 2:
        assert plan.rg == ga.stream_plan(rows, k, nc, SMS).mg
        assert plan.rg == (8 if rows <= 8 else 16)
    else:
        assert plan.rg == (1 if rows == 1 else 2 if rows == 2
                           else 4 if rows <= 4 else 8)
    assert "rg != (rows <= 8 ? 8 : 16)" in SOURCE
    assert "rg != (rows == 1 ? 1 : rows == 2 ? 2 : rows <= 4 ? 4 : 8)" \
        in SOURCE


@pytest.mark.parametrize("n,m,k,nc,es", CASES)
def test_control_block_and_workspace(n, m, k, nc, es):
    """The control block after its header: an epoch word a block, then the
    stream kernel's tickets (4 int32 a block: 2 words) or a counter per
    f32 tile; the per-call workspace: the stream kernel's 2 slots a block
    of 128 x rg f32, or the f32 K slices."""
    plan = _plan(n, m, k, nc, es)
    if es == 2:
        assert plan.ctl_words == plan.grid + 2 * plan.grid
        assert plan.part_floats == 2 * plan.grid * ga.STREAM_BN * plan.rg
        assert (plan.k_chunk, plan.splits) == (0, 0)
    else:
        tiles = -(-plan.rows // plan.rg) * -(-nc // 128)
        assert plan.ctl_words == plan.grid + tiles
        assert plan.part_floats == plan.splits * plan.rows * nc
        assert plan.k_chunk * plan.splits >= k
        assert plan.k_chunk * (plan.splits - 1) < k


@pytest.mark.parametrize("n,m,k,nc,es", SMALL)
def test_every_row_lands_once_and_folds_once(n, m, k, nc, es):
    """Every vector of every sender's product lands once, in its owner's
    slot for that sender; the owner's fold units cover its slot's vectors
    once; every fold unit's flag is raised by every sender, by the warp
    (or block) that lands that group's quarter."""
    plan = _plan(n, m, k, nc, es, ll=False)
    kv = nc // 4
    rows = np.arange(plan.rows)[:, None]
    owner, vec = _land(plan, rows, np.arange(kv)[None, :])
    assert (owner == rows // m).all()
    owner = np.broadcast_to(owner, vec.shape)
    for c in range(n):
        got = np.sort(vec[owner == c])
        assert (got == np.arange(m * kv)).all()
    raised = {(c, g, q) for g in range(plan.groups) for c in _owners(plan, g)
              for q in range(plan.quarters)}
    for me in range(n):
        seen = np.zeros((m, kv), dtype=np.int64)
        for g, q, rs, cs in _fold_units(plan, me):
            assert (me, g, q) in raised
            for r in rs:
                seen[r - me * m, cs.start:cs.stop] += 1
        assert (seen == 1).all()
    assert {c for c, _, _ in raised} == set(range(n))


def _partials(rng, n, rows, nc):
    """f32 partials whose sums depend on the order of the adds: values
    spread over 2^-20 .. 2^20 with both signs."""
    mant = rng.standard_normal((n, rows, nc))
    expo = rng.integers(-20, 21, size=(n, rows, nc))
    return [torch.from_numpy((mant[r] * 2.0 ** expo[r]).astype(np.float32))
            for r in range(n)]


def _emulate(plan, n, parts, bufs, epoch):
    """One call: every rank stores its partial's rows into their owners'
    slots for it, a (row group, quarter) unit at a time as a warp does
    (plain vectors, or LL lines tagged with the epoch), in parity epoch &
    1; then every owner reads its n slots and folds them as the kernel
    does. Returns the owners' f32 outputs."""
    par, kv = epoch & 1, plan.n // 4
    words = [p.contiguous().view(torch.int32).numpy().view(np.uint32)
             .reshape(plan.rows, kv, 4) for p in parts]
    for s in range(n):
        for g in range(plan.groups):
            r0, r1 = g * plan.rg, min((g + 1) * plan.rg, plan.rows)
            for q in range(plan.quarters):
                for row in range(r0, r1):
                    c4 = np.arange(8 * q, min(8 * q + 8, kv))
                    c, v = _land(plan, row, c4)
                    _store_vectors(bufs[c], plan.ll, _slot(plan, par, s, n),
                                   words[s][row, c4], v, epoch)
    view = SimpleNamespace(m=plan.m, kv=kv, ll=plan.ll)
    outs = []
    for me in range(n):
        slots = [torch.from_numpy(_load(bufs[me], view,
                                        _slot(plan, par, s, n), epoch)
                                  .copy().reshape(-1).view(np.float32))
                 .view(plan.m, plan.n) for s in range(n)]
        out = torch.empty(plan.m, plan.n)
        for _, _, rs, cs in _fold_units(plan, me):
            lr = slice(rs.start - me * plan.m, rs.stop - me * plan.m)
            cols = slice(4 * cs.start, 4 * cs.stop)
            ys = [slots[(me + d) % n][lr, cols] for d in range(n)]
            out[lr, cols] = _fold(ys, n)
        outs.append(out)
    return outs


@pytest.mark.parametrize("es", (2, 4))
@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("ll", (True, False))
def test_emulated_landing_and_fold_is_bidir_rs_fold(es, n, ll):
    """Over both parities twice (epochs 1-4, each with fresh partials, the
    other parity still holding the call before), every rank's output is
    ``bidir_rs_fold``'s bytes, and the same partials added in ascending
    sender order give other bytes (the order of the adds shows)."""
    m, nc = 7, 72             # groups across owners, a ragged quarter
    plan = _plan(n, m, 256, nc, es, 2, ll)
    assert plan.groups > 1 and any(
        len(_owners(plan, g)) > 1 for g in range(plan.groups))
    rng = np.random.default_rng(17 + n)
    bufs = [np.zeros(plan.nbytes // 4, dtype=np.uint32) for _ in range(n)]
    order_shows = False
    for epoch in (1, 2, 3, 4):
        parts = _partials(rng, n, plan.rows, nc)
        outs = _emulate(plan, n, parts, bufs, epoch)
        for me in range(n):
            want = bidir_rs_fold(parts, me)
            assert torch.equal(outs[me].view(torch.int32),
                               want.view(torch.int32))
            rows = slice(me * m, (me + 1) * m)
            asc = parts[0][rows]
            for p in parts[1:]:
                asc = asc + p[rows]
            order_shows |= not torch.equal(asc, want)
    assert order_shows


@pytest.mark.parametrize("n", WORLDS)
def test_fold_is_the_arcs(n):
    """The kernel's distance form of the fold is bidir_rs_fold's: right
    chain ranks me - kr .. me - 1, left chain me + kl .. me + 1, disjoint,
    together every rank but me."""
    kr, kl = n // 2, (n - 1) // 2
    right = list(range(n - kr, n))
    left = list(range(kl, 0, -1))
    assert sorted(right + left) == list(range(1, n))
    for me in range(n):
        assert [(me + d) % n for d in right] == \
            [r % n for r in range(me - kr, me)]
        assert [(me + d) % n for d in left] == \
            [r % n for r in range(me + kl, me, -1)]


def test_constants_match_the_kernel_source():
    """The staging row and the flags' shape are the kernel's."""
    assert re.search(r"constexpr int SLD = 36;", SOURCE)
    assert "(s * groups + g) * quarters(L) + q" in SOURCE
    assert "(static_cast<long long>(par) * L.team.world + s) * L.slot_bytes" \
        in SOURCE
    assert "(row - c * L.m) * (L.n / 4) + c4" in SOURCE


@pytest.mark.parametrize("n,m,k,nc,es", CASES)
def test_whole_tiles_column_major_at_prefill(n, m, k, nc, es):
    """With many M groups (the static serve's prefill) the bf16 kernel
    takes whole tiles, block b tiles b, b + grid, ... of a column-tile-
    major order (the source's for_items): every tile once, and the blocks
    of one round on one column strip of W (or two) while it lasts. At
    decode (one M group) the stream-K cut stays."""
    plan = _plan(n, m, k, nc, es)
    if es != 2:
        assert not plan.whole
        return
    sp = ga.stream_plan(plan.rows, k, nc, SMS)
    tiles = sp.n_mg * sp.n_tiles
    assert plan.whole == (tiles > sp.n_tiles and tiles >= 4 * plan.grid)
    assert plan.whole == (m == 2048)
    if not plan.whole:
        return
    order = np.arange(tiles)
    t = (order % sp.n_mg) * sp.n_tiles + order // sp.n_mg
    assert (np.sort(t) == order).all()
    for start in range(0, tiles, plan.grid):
        strips = np.unique(t[start:start + plan.grid] % sp.n_tiles)
        assert strips.size <= 2
    assert "p.whole = tiles > p.n_tiles && tiles >= 4LL * grid;" in SOURCE
