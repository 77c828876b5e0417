"""B4 across ranks' landing plan (``gemm_allreduce.ar_plan``), held on the
CPU. The kernel (``csrc/gemm_ar.cu`` on ``csrc/gemm_land_stream.cuh``)
computes this rank's product in one pass over its weight shard, stores
each row of its f32 partial into this rank's landing slot on every rank
(slot (parity, sender)), signals by LL lines or by flags per (sender, row
group, 32-column quarter) on every rank, and every rank folds its n slots
slot 0 + slot 1 + ... + slot n-1 in f32 and casts once. This file writes
the kernel's formulas down (_slot, _flag, _land, _fold_units) and holds
them: the slots and flags are disjoint, aligned and inside the buffer,
every row lands once on every rank, every rank's rows are folded once by
units whose flags every sender raises, the grid leaves every rank that
shares an H100 resident, the o and down projections of a decode step
share one plan (and so one workspace: the same grid, the same epochs),
and the control block holds the epochs and tickets. An emulation of the
landing (every rank's f32 partials, whose sums depend on the order of
the adds, stored in plain vectors or in LL lines tagged with the epoch,
over both parities) and of the fold must give ``gemm_ar_ref_shards``'
bytes on every rank at n = 2, 3, 4 and 8, and those bytes must equal the
JAX ``gemm_ar_per_device`` (PALLAS in interpret mode, and XLA) run per
device as ``tests/test_torch_ar.py`` runs it: exactly on integer-valued
f32 inputs, within rtol = atol = 1e-5 on random ones (the products' own
summation differs between BLAS and XLA). That the kernel's own addressing
is these formulas is held on the card: ``chip_smoke.py``'s
``b4_gemm_ar_tp`` and ``tp4_serve`` compare every output with the plain
version.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_slot_emulation import load as _load
from torch_slot_emulation import store_vectors as _store_vectors
from triton_dist_tpu.kernels.gemm_allreduce import (
    GemmArMethod as JGarMethod, gemm_ar_per_device as j_gemm_ar,
)
from triton_dist_tpu.runtime import make_comm_mesh
from triton_dist_tpu.runtime.compat import td_shard_map
from triton_dist_tpu_torch.kernels import gemm_allreduce as ga
from triton_dist_tpu_torch.kernels.plain import dot_f32, slot_fold

SMS = 132                  # an H100's SMs
CSRC = Path(ga.__file__).resolve().parent.parent / "csrc"
SOURCE = "".join((CSRC / f).read_text()
                 for f in ("gemm_ar.cu", "gemm_land_stream.cuh"))
WORLDS = (2, 3, 4, 8)
# (m rows, K_loc, N, itemsize): Qwen3-32B's o and down at TP=4 decode (16
# rows) and the ContinuousEngine's 8, a 512-token prefill chunk, f32
# gates, odd shapes (a ragged quarter, one row, a group of 8 rows)
SHAPES = ((16, 2048, 5120, 2), (16, 6400, 5120, 2), (8, 2048, 5120, 2),
          (512, 6400, 5120, 2), (16, 2048, 5120, 4), (16, 6400, 5120, 4),
          (6, 1000, 136, 2), (12, 256, 264, 2), (1, 64, 40, 4),
          (5, 100, 36, 4))
CASES = [(n, *s) for n in WORLDS for s in SHAPES]
SMALL = [c for c in CASES if c[2] < 2048]   # loops over every vector
PROTOCOLS = (None, True, False)


def _plan(n, m, k, nc, es, rpd=1, ll=None, sms=SMS):
    """ar_plan's plan, or its grid under the protocol ``ll`` (as the
    chip's protocol sweep forces one)."""
    if ll is None:
        return ga.ar_plan(n, m, k, nc, es, sms, rpd)
    return ga.ar_layout(n, m, k, nc, es == 2, sms, rpd, ll)


def _slot(plan, par, s, n):
    """Byte offset of sender s's slot of parity par (on every rank)."""
    return (par * n + s) * plan.slot_bytes


def _flag(plan, s, g, q):
    """Byte offset of the flag (sender s, row group g, quarter q)."""
    return plan.flag_off + 8 * ((s * plan.groups + g) * plan.quarters + q)


def _land(plan, row, c4):
    """Vector index of vector c4 of product row `row` in the sender's slot
    on every rank."""
    return row * (plan.n // 4) + c4


def _fold_units(plan):
    """A rank's fold units: (row group, quarter, its rows, its vectors),
    every rank folding all m rows."""
    kv = plan.n // 4
    for g in range(plan.groups):
        r0, r1 = g * plan.rg, min((g + 1) * plan.rg, plan.m)
        for q in range(plan.quarters):
            c0 = 8 * q
            yield g, q, range(r0, r1), range(c0, min(c0 + 8, kv))


@pytest.mark.parametrize("n,m,k,nc,es", CASES)
def test_slots_and_flags_disjoint_aligned_inside(n, m, k, nc, es):
    for ll in PROTOCOLS:
        plan = _plan(n, m, k, nc, es, 1, ll)
        assert (plan.rows, plan.m, plan.n) == (m, m, nc)
        assert plan.slot_bytes >= m * nc * 4 * (2 if plan.ll else 1)
        spans = sorted((o, o + plan.slot_bytes) for o in
                       (_slot(plan, p, s, n) for p in (0, 1)
                        for s in range(n)))
        assert len(spans) == 2 * n and spans[0][0] == 0
        for (_, hi), (lo2, _) in zip(spans, spans[1:]):
            assert hi <= lo2
        assert all(lo % 16 == 0 for lo, _ in spans)
        assert spans[-1][1] <= plan.flag_off and plan.flag_off % 8 == 0
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
    assert plan.ll == (m * nc * 4 <= ga.AR_LL_MAX_SLOT_BYTES)


@pytest.mark.parametrize("rpd", (1, 4))
def test_grid_resident(rpd):
    """At most one block an SM for every rank that shares the card (the
    stream kernel's ~196 KB of shared memory with the landing stage fits
    one block an SM), and no more blocks than the product has units
    (bf16) or items (f32)."""
    for n, m, k, nc, es in CASES:
        if rpd > n:
            continue
        plan = _plan(n, m, k, nc, es, rpd)
        assert 1 <= plan.grid and plan.grid * rpd <= SMS
        if es == 2:
            assert plan.grid <= ga.stream_plan(m, k, nc, SMS).units
        else:
            tiles = -(-plan.rows // plan.rg) * -(-nc // 128)
            assert plan.grid <= tiles * plan.splits


def test_shared_memory_fits_one_block_an_sm():
    """The stream kernel's ring (5 stages of a 128 x 128 bf16 tile and
    A's rows) plus the landing epilogue's stage (4 warps x 16 rows x 36
    f32) within the 227 KB a block may take."""
    ring = 1024 + 5 * 128 * 128 * 2 + 5 * 16 * (128 + 8) * 2 + 2 * 5 * 8
    stage = 4 * 16 * 36 * 4
    assert ring + stage <= 232448
    assert "kSmemBytes = size_t(ts::NCW) * MG * SLD * 4" in SOURCE


def test_grid_fills_the_card_at_decode():
    for rpd in (1, 4):
        for k in (2048, 6400):
            assert _plan(4, 16, k, 5120, 2, rpd).grid == SMS // rpd


@pytest.mark.parametrize("rpd", (1, 4))
@pytest.mark.parametrize("m", (1, 4, 8, 16, 32, 64))
def test_o_and_down_share_one_plan_in_bf16(rpd, m):
    """At a decode batch the o (K_loc 2,048) and down (K_loc 6,400)
    projections of Qwen3-32B at TP=4 get the same plan, so they share one
    workspace (the key is the plan) and one grid: every call of either
    advances every block's epoch once, so alternating calls keep the
    parities in step (held on the card by chip_smoke.py's alternating
    gate). In f32 their K splits differ: two plans, two workspaces."""
    o, down = (_plan(4, m, k, 5120, 2, rpd) for k in (2048, 6400))
    assert o == down
    o32, down32 = (_plan(4, m, k, 5120, 4, rpd) for k in (2048, 6400))
    assert o32.grid == down32.grid and o32 != down32


@pytest.mark.parametrize("n,m,k,nc,es", CASES)
def test_row_group_is_the_kernels_row_tile(n, m, k, nc, es):
    """rg is the GEMM's row tile, as the C entry checks it: the stream
    kernel's M group in bf16, gemm_splitk.cuh's row tile in f32."""
    plan = _plan(n, m, k, nc, es)
    if es == 2:
        assert plan.rg == ga.stream_plan(m, k, nc, SMS).mg
        assert plan.rg == (8 if m <= 8 else 16)
    else:
        assert plan.rg == (1 if m == 1 else 2 if m == 2
                           else 4 if m <= 4 else 8)
    assert "rg != (rows <= 8 ? 8 : 16)" in SOURCE
    assert "const int rows = kAll ? m : world * m;" in SOURCE


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
def test_every_row_lands_once_on_every_rank_and_folds_once(n, m, k, nc,
                                                            es):
    """Every vector of a sender's product lands once in that sender's slot
    on each rank (the n puts of land_vec); each rank's fold units cover
    its m rows once; every fold unit's flag (sender, group, quarter) is
    raised on every rank by every sender."""
    plan = _plan(n, m, k, nc, es, ll=False)
    kv = nc // 4
    vec = _land(plan, np.arange(m)[:, None], np.arange(kv)[None, :])
    assert (np.sort(vec.ravel()) == np.arange(m * kv)).all()
    raised = {(p, s, g, q) for p in range(n) for s in range(n)
              for g in range(plan.groups) for q in range(plan.quarters)}
    for me in range(n):
        seen = np.zeros((m, kv), dtype=np.int64)
        for g, q, rs, cs in _fold_units(plan):
            assert all((me, s, g, q) in raised for s in range(n))
            seen[rs.start:rs.stop, cs.start:cs.stop] += 1
        assert (seen == 1).all()


def _partials(rng, n, m, nc):
    """f32 partials whose sums depend on the order of the adds: values
    spread over 2^-20 .. 2^20 with both signs."""
    mant = rng.standard_normal((n, m, nc))
    expo = rng.integers(-20, 21, size=(n, m, nc))
    return [torch.from_numpy((mant[r] * 2.0 ** expo[r]).astype(np.float32))
            for r in range(n)]


def _emulate(plan, n, parts, bufs, epoch):
    """One call: every rank stores its partial's rows into its slot on
    every rank, a (row group, quarter) unit at a time as a warp does
    (plain vectors, or LL lines tagged with the epoch), in parity epoch &
    1; then every rank reads its n slots and folds them as the kernel
    does, slot 0 + ... + slot n-1 in f32. Returns the ranks' f32 sums."""
    par, kv = epoch & 1, plan.n // 4
    words = [p.contiguous().view(torch.int32).numpy().view(np.uint32)
             .reshape(plan.m, kv, 4) for p in parts]
    for s in range(n):
        for g in range(plan.groups):
            for q in range(plan.quarters):
                for row in range(g * plan.rg, min((g + 1) * plan.rg, plan.m)):
                    c4 = np.arange(8 * q, min(8 * q + 8, kv))
                    for i in range(1, n + 1):       # the next rank first
                        _store_vectors(bufs[(s + i) % n], plan.ll,
                                       _slot(plan, par, s, n),
                                       words[s][row, c4],
                                       _land(plan, row, c4), epoch)
    view = SimpleNamespace(m=plan.m, kv=kv, ll=plan.ll)
    outs = []
    for me in range(n):
        slots = [torch.from_numpy(_load(bufs[me], view,
                                        _slot(plan, par, s, n), epoch)
                                  .copy().reshape(-1).view(np.float32))
                 .view(plan.m, plan.n) for s in range(n)]
        out = torch.empty(plan.m, plan.n)
        for _, _, rs, cs in _fold_units(plan):
            rows = slice(rs.start, rs.stop)
            cols = slice(4 * cs.start, 4 * cs.stop)
            acc = slots[0][rows, cols]
            for s in range(1, n):
                acc = acc + slots[s][rows, cols]
            out[rows, cols] = acc
        outs.append(out)
    return outs


@pytest.mark.parametrize("es", (2, 4))
@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("ll", (True, False))
def test_emulated_landing_and_fold_is_the_slot_fold(es, n, ll):
    """Over both parities twice (epochs 1-4, each with fresh partials, the
    other parity still holding the call before), every rank's output is
    the same bytes, the fold of ``gemm_ar_ref_tp`` / ``gemm_ar_ref_shards``
    (``plain.slot_fold``: slot 0 + ... + slot n-1, one cast) of the same
    partials, and at n >= 3 the same partials added in the other order
    give other bytes (the order of the adds shows; two terms commute)."""
    m, nc = 12, 72            # groups of 8 rows (f32), a ragged quarter
    plan = _plan(n, m, 256, nc, es, 2, ll)
    dt = torch.bfloat16 if es == 2 else torch.float32
    rng = np.random.default_rng(23 + n)
    bufs = [np.zeros(plan.nbytes // 4, dtype=np.uint32) for _ in range(n)]
    order_shows = False
    for epoch in (1, 2, 3, 4):
        parts = _partials(rng, n, m, nc)
        sums = _emulate(plan, n, parts, bufs, epoch)
        want = slot_fold(parts)
        for me in range(n):
            assert torch.equal(sums[me].view(torch.int32),
                               want.view(torch.int32))
            assert torch.equal(sums[me].to(dt).view(torch.uint8),
                               sums[0].to(dt).view(torch.uint8))
        order_shows |= not torch.equal(slot_fold(parts[::-1]), want)
    assert order_shows == (n >= 3)


def _jax_mesh(n):
    return make_comm_mesh(axes=[("tp", n)], devices=jax.devices()[:n])


@functools.lru_cache(maxsize=None)
def _jax_per_device(n, method):
    """The JAX gemm_ar_per_device on every device of an n-device mesh,
    as tests/test_torch_ar.py runs it (bm 8, bn 128; PALLAS in interpret
    mode), compiled once: its outputs stacked in rank order."""
    fn = functools.partial(j_gemm_ar, "tp", n, method, 8, 128, None)
    return jax.jit(td_shard_map(
        lambda a, b: fn(a, b)[None], mesh=_jax_mesh(n),
        in_specs=(P(None, "tp"), P("tp", None)), out_specs=P("tp")))


@pytest.mark.parametrize("kind", ("int", "rand"))
@pytest.mark.parametrize("n", WORLDS)
def test_emulated_bytes_equal_the_jax_tiers(n, kind):
    """The ranks' A (8, n x 32) and W (n x 32, 128) column / row shards,
    made with numpy: the emulated landing and fold of the ranks' f32
    partials (under LL lines and under flags, epoch 3), cast once, equal
    the JAX PALLAS and XLA tiers on every rank, exactly on integer-valued
    inputs and within 1e-5 on random ones."""
    m, k_loc, nc = 8, 32, 128
    rng = np.random.default_rng(31 + n)
    if kind == "int":
        a = rng.integers(-3, 4, (m, n * k_loc)).astype(np.float32)
        b = rng.integers(-3, 4, (n * k_loc, nc)).astype(np.float32)
    else:
        a = rng.standard_normal((m, n * k_loc)).astype(np.float32)
        b = rng.standard_normal((n * k_loc, nc)).astype(np.float32)
    parts = [dot_f32(torch.from_numpy(a[:, r * k_loc:(r + 1) * k_loc]),
                     torch.from_numpy(b[r * k_loc:(r + 1) * k_loc]))
             for r in range(n)]
    for ll in (True, False):
        plan = _plan(n, m, k_loc, nc, 4, 1, ll)
        bufs = [np.zeros(plan.nbytes // 4, dtype=np.uint32)
                for _ in range(n)]
        outs = [o.numpy() for o in _emulate(plan, n, parts, bufs, 3)]
        for method in (JGarMethod.PALLAS, JGarMethod.XLA):
            want = np.asarray(_jax_per_device(n, method)(
                jnp.asarray(a), jnp.asarray(b)))
            for r in range(n):
                if kind == "int":
                    np.testing.assert_array_equal(outs[r], want[r])
                else:
                    np.testing.assert_allclose(outs[r], want[r], rtol=1e-5,
                                               atol=1e-5)
                np.testing.assert_array_equal(outs[r], outs[0])


def test_constants_match_the_kernel_source():
    """The staging row, the slot and flag formulas and the landing on
    every rank are the kernel's."""
    assert re.search(r"constexpr int SLD = 36;", SOURCE)
    assert "(s * groups + g) * quarters(L) + q" in SOURCE
    assert "(static_cast<long long>(par) * L.team.world + s) * L.slot_bytes" \
        in SOURCE
    assert "static_cast<long>(row) * (L.n / 4) + c4" in SOURCE
    assert "put(L, slot(L, (me + i) % world, par, me), v, val, f);" in SOURCE
    assert "if (kAll) return make_int2(0, L.team.world - 1);" in SOURCE
    assert "return land::land_gemm<true>(" in SOURCE
