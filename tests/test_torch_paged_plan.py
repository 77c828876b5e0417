"""B2's plan (``paged_flash_decode.paged_plan``) and its order of work,
held on the CPU.

On the card the bf16 form of ``paged_flash_decode_partial`` launches one
block per (split, kv head, row): the split's live keys [k_lo, k_hi) from
the row's length read on the device (``_range``), the table entries of its
live pages staged by the producer warp with the reference's clamp
(``_staged``), each 64-key tile issued as TMA boxes of min(ps, 64) pool
rows, a box a page, boxes past the length not issued (``_boxes``), and
the row's live splits (``_live``) merged by exact LSE in ascending order
by the last to arrive. This file writes those formulas down as the kernel
computes them and holds them: every live key of every row lies in
exactly one split, one tile and one box; no split reads a table entry at
or past ceil(len / ps) pages; the grid depends on no length; the blocks
fill an H100's 132 SMs at the main path's shapes. Then it emulates the
split-and-merge in torch (each split folded by the plain version's page
fold, the live splits merged in ascending order by exact LSE) and holds
it against the JAX package's ``paged_flash_decode_partial`` (its Pallas
kernel in interpret mode) and against the port's plain version, on bf16
and f32 pools, lengths 0, 1, ps - 1, ps, ps + 1 and full, a shuffled
table with out-of-range values in its dead slots, NaN in unused pages and
in the dead rows past the length of a live page.

Tolerances. The scores are exact (q and k are multiples of 1/8 in
[-2, 2]: every product and sum of 64 of them is exact in f32), so m is
equal exactly. l: 1e-5 relative (the splits rescale their sums by
e^(m_s - m) in another order, and the two libraries' exp differ in the
last bit). acc / l: f32 pools 1e-5; bf16 pools 2^-8 x max|V| absolute:
both sides round each probability to bf16 (relative error 2^-9), each
against its own running max, so the two sums differ by at most
2 x 2^-9 of sum p |v| / l <= 2^-8 max|V|.

That the kernel's own addressing is these formulas is held on the card:
``chip_smoke.py``'s ``b2_paged_flash_decode`` compares every case with
the plain version.
"""

from __future__ import annotations

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.kernels.paged_flash_decode import (
    paged_flash_decode_partial as jax_pfd,
)
from triton_dist_tpu.runtime.compat import tpu_interpreter_available

from triton_dist_tpu_torch.kernels import paged_flash_decode as pfd
from triton_dist_tpu_torch.kernels.flash_attention import NEG_INF

SMS = 132          # an H100's SMs
CSRC = Path(pfd.__file__).resolve().parent.parent / "csrc"
SMEM_MAX = 232448  # bytes of shared memory a Hopper block may use


# -- the kernel's formulas -----------------------------------------------

def _row_keys(length, ps, np_table):
    """Keys attended in a row, within the table's width (row_keys)."""
    return min(max(length, 0), np_table * ps)


def _range(plan, sp, length, ps, np_table):
    """Split sp's live keys [k_lo, k_hi) (PagedSrc::range)."""
    k_lo = sp * plan.pages * ps
    hi = min(k_lo + plan.pages * ps, _row_keys(length, ps, np_table))
    return k_lo, max(hi, k_lo)


def _runs(plan, sp, length, ps, np_table):
    """Whether block sp runs (PagedSrc::skip: a split past the length
    exits; split 0 always runs)."""
    k_lo, k_hi = _range(plan, sp, length, ps, np_table)
    return sp == 0 or k_hi > k_lo


def _staged(plan, sp, length, ps, np_table):
    """The table columns the producer reads (PagedSrc::prologue): the
    split's live pages."""
    k_lo, k_hi = _range(plan, sp, length, ps, np_table)
    n = -(-(k_hi - k_lo) // ps)
    return list(range(k_lo // ps, k_lo // ps + n))


def _tiles(plan, sp, length, ps, np_table):
    """The first key of each tile (the producer's loop)."""
    k_lo, k_hi = _range(plan, sp, length, ps, np_table)
    return list(range(k_lo, k_hi, plan.tile))


def _boxes(plan, k0, k_lo, k_hi, ps):
    """(first key, local page, row in the page, rows) of each box tile k0
    issues (PagedSrc::load_tile)."""
    nbox = min(plan.tile // plan.box, -(-(k_hi - k0) // plan.box))
    out = []
    for j in range(nbox):
        key = k0 - k_lo + j * plan.box
        out.append((k0 + j * plan.box, key // ps, key % ps, plan.box))
    return out


def _live(plan, length, ps, np_table):
    """Live splits of a row (PagedSrc::finish's `live`)."""
    return -(-_row_keys(length, ps, np_table) // (plan.pages * ps))


PAGE_SIZES = (8, 16, 32, 64, 128, 256)
SHAPES = ((1, 1, 1), (4, 8, 8), (8, 8, 16), (16, 2, 16), (3, 2, 5),
          (2, 4, 40))      # (B, Hkv, NP)


def _lengths(ps, np_table):
    full = ps * np_table
    return sorted({0, 1, ps - 1, ps, ps + 1, full - 1, full, full + 5,
                   full // 2, 3 * ps + 7, -4})


@pytest.mark.parametrize("ps", PAGE_SIZES)
@pytest.mark.parametrize("b,hkv,np_table", SHAPES)
def test_every_live_key_in_one_split_tile_and_box(b, hkv, np_table, ps):
    plan = pfd.paged_plan(b, hkv, np_table, ps, SMS)
    assert plan.tile == 64 and plan.box == min(ps, 64)
    assert plan.tile % plan.box == 0 and plan.box % 8 == 0
    assert plan.pages * (plan.splits - 1) < np_table
    assert plan.pages * plan.splits >= np_table
    assert plan.pages >= min(np_table, max(1, plan.tile // ps))
    for length in _lengths(ps, np_table):
        keys = _row_keys(length, ps, np_table)
        seen = np.zeros(np_table * ps, dtype=np.int64)
        for sp in range(plan.splits):
            k_lo, k_hi = _range(plan, sp, length, ps, np_table)
            for t0 in _tiles(plan, sp, length, ps, np_table):
                assert k_lo <= t0 < k_hi      # a tile only where keys live
                for key0, page, within, rows in _boxes(plan, t0, k_lo, k_hi,
                                                       ps):
                    assert key0 < k_hi        # no box wholly past the end
                    assert within + rows <= ps   # a box inside one page
                    assert (k_lo // ps + page) * ps + within == key0
                    live = np.arange(key0, min(key0 + rows, k_hi,
                                               t0 + plan.tile))
                    seen[live] += 1
        assert (seen[:keys] == 1).all()       # each live key once
        assert (seen[keys:] == 0).all()       # nothing past the length


@pytest.mark.parametrize("ps", PAGE_SIZES)
@pytest.mark.parametrize("b,hkv,np_table", SHAPES)
def test_no_split_reads_a_dead_page(b, hkv, np_table, ps):
    """The producer reads only table columns below ceil(len / ps); a split
    wholly past them reads nothing and exits (split 0 writes the empty
    row's result); the live splits are a prefix and the merge takes
    exactly them."""
    plan = pfd.paged_plan(b, hkv, np_table, ps, SMS)
    for length in _lengths(ps, np_table):
        n_live = -(-_row_keys(length, ps, np_table) // ps)
        read = []
        for sp in range(plan.splits):
            cols = _staged(plan, sp, length, ps, np_table)
            assert all(c < n_live for c in cols)
            assert len(cols) <= plan.pages <= pfd.PAGED_MAX_SPLIT_PAGES
            read += cols
            if not cols:
                assert _runs(plan, sp, length, ps, np_table) == (sp == 0)
        assert read == list(range(n_live))    # each live page once
        live = _live(plan, length, ps, np_table)
        assert [bool(_staged(plan, sp, length, ps, np_table))
                for sp in range(plan.splits)] == \
            [sp < live for sp in range(plan.splits)]


def test_the_grid_depends_on_no_length():
    """The plan, and with it the grid (splits, Hkv, B), is a function of
    what a captured CUDA graph fixes: B, Hkv, the table's width, the page
    size and the SM count. The lengths are read by the kernel alone."""
    params = list(inspect.signature(pfd.paged_plan).parameters)
    assert params == ["b", "hkv", "np_table", "page_size", "sms"]
    src = inspect.getsource(pfd._launch)
    assert not re.search(r"lengths\.(cpu|item|tolist|max|sum|min)", src)
    assert "paged_plan(b, hkv, np_table, ps, sms)" in src


# (name, B, Hkv, NP): the static paged Engine (Qwen3-8B, B=4 x 1,024), the
# ContinuousEngine's 8B batch, a TP=4 rank of Qwen3-32B, tp4_sp's paged
# decode (32,768 keys a row)
MAIN_SHAPES = (("static_8b", 4, 8, 8), ("continuous_8b", 8, 8, 16),
               ("tp4_rank_32b", 16, 2, 16), ("tp4_sp_paged", 4, 8, 256))


@pytest.mark.parametrize("name,b,hkv,np_table", MAIN_SHAPES)
def test_grid_fills_the_sms(name, b, hkv, np_table):
    """One block an SM at a time (its shared memory allows one at D 128):
    the waves of blocks, the last one included, at least 90% full, in one
    wave here, and more blocks than the old (B, Hkv) grid."""
    plan = pfd.paged_plan(b, hkv, np_table, 128, SMS)
    blocks = plan.splits * b * hkv
    waves = -(-blocks // SMS)
    assert blocks / (waves * SMS) >= 0.9, (name, plan)
    assert plan.splits > 1 and waves == 1


def _header_int(path, name):
    m = re.search(rf"constexpr int {name} = ([0-9]+);", path.read_text())
    assert m, (path, name)
    return int(m.group(1))


def test_constants_and_shared_memory_agree_with_the_kernel():
    hdr = CSRC / "decode_tile_sm90.cuh"
    src = CSRC / "paged_flash_decode.cu"
    assert _header_int(hdr, "KT") == pfd.PAGED_TILE
    assert _header_int(hdr, "STAGES") == pfd.PAGED_STAGES
    assert _header_int(hdr, "NCW") == pfd.PAGED_GROUPS
    assert _header_int(src, "MAX_SPLIT_PAGES") == pfd.PAGED_MAX_SPLIT_PAGES
    maxg = _header_int(hdr, "MAXG")
    for d in (64, 128):
        ring = (1024 + pfd.PAGED_STAGES * 2 * (d // 64) * 64 * 64 * 2
                + 2 * pfd.PAGED_STAGES * 8 + pfd.PAGED_GROUPS * maxg
                * (d + 2) * 4)
        # the attribute set once (the most any plan asks) and its static int
        assert ring + 4 * pfd.PAGED_MAX_SPLIT_PAGES + 4 <= SMEM_MAX
    assert max(pfd._GROUPS) <= maxg
    plan = pfd.paged_plan(1, 1, 10 ** 5, 128, SMS)
    assert plan.pages <= pfd.PAGED_MAX_SPLIT_PAGES


# -- the split-and-merge, emulated ----------------------------------------

B, HQ, HKV, D, PS, NP = 6, 4, 2, 64, 16, 4
LENGTHS = (0, 1, PS - 1, PS, PS + 1, PS * NP)
SPARE = 4          # unused pages, NaN


def _inputs(seed, v_tail_nan):
    """q, k / v pools (f32, every value a multiple of 1/8 in [-2, 2]), the
    table and lengths. Dead slots of the table hold out-of-range values;
    the SPARE unused pages are NaN; the rows past the length of each
    row's last live page are NaN in K, and in V NaN (v_tail_nan) or
    large finite garbage (the JAX kernel multiplies them by 0 in P.V, so
    NaN there would reach its output)."""
    rng = np.random.default_rng(seed)
    pages = B * NP + SPARE

    def eighths(*shape):
        return rng.integers(-16, 17, shape).astype(np.float32) / 8

    q = eighths(B, HQ, D)
    kp = eighths(HKV, pages, PS, D)
    vp = eighths(HKV, pages, PS, D)
    perm = rng.permutation(B * NP).astype(np.int32)
    table = np.empty((B, NP), np.int32)
    dead = np.array([-7, pages, 10 ** 6, -1], np.int32)
    lengths = np.array(LENGTHS, np.int32)
    used = 0
    for i, n in enumerate(lengths):
        live = -(-int(n) // PS)
        table[i, :live] = perm[used:used + live]
        table[i, live:] = dead[:NP - live]
        used += live
    kp[:, B * NP:] = np.nan
    vp[:, B * NP:] = np.nan
    for i, n in enumerate(lengths):
        if n % PS:
            last = table[i, n // PS]
            kp[:, last, n % PS:] = np.nan
            vp[:, last, n % PS:] = np.nan if v_tail_nan else 1e4
    return q, kp, vp, table, lengths


def _t(x, dt=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(dt) if dt is not None else t


def _emulate(q, kp, vp, table, lengths, plan):
    """B2's bf16 order of work at page granularity: split sp of each row
    folds its live pages by the plain version's page fold; a row's live
    splits merge in ascending order by exact LSE (one live split, or
    none: split 0's result as it is)."""
    ps = kp.shape[2]
    np_table = table.shape[1]
    splits = []
    for sp in range(plan.splits):
        cols = slice(sp * plan.pages, (sp + 1) * plan.pages)
        sub_len = torch.clamp(lengths.long() - sp * plan.pages * ps, 0,
                              plan.pages * ps).to(torch.int32)
        splits.append(pfd.paged_flash_decode_partial_ref(
            q, kp, vp, table[:, cols].contiguous(), sub_len))
    accs, ms, ls = [], [], []
    for i, n in enumerate(lengths.tolist()):
        live = _live(plan, n, ps, np_table)
        if live <= 1:
            acc, m, l = (x[i] for x in splits[0])
        else:
            part = [(a[i], m_[i], l_[i]) for a, m_, l_ in splits[:live]]
            m = part[0][1]
            for _, mi, _ in part[1:]:
                m = torch.maximum(m, mi)
            acc = torch.zeros_like(part[0][0])
            l = torch.zeros_like(part[0][2])
            for ai, mi, li in part:
                sc = torch.exp(mi - m)
                acc = acc + ai * sc[:, None]
                l = l + li * sc
        accs.append(acc)
        ms.append(m)
        ls.append(l)
    return torch.stack(accs), torch.stack(ms), torch.stack(ls)


# plans of every shape the split takes at this table: the card's own
# (paged_plan on a 132-SM card: one split here), a page a split, two
# pages, and a split of three pages whose last is short
PLANS = {
    "paged_plan": pfd.paged_plan(B, HKV, NP, PS, SMS),
    "pages1": pfd.PagedPlan(1, NP, PS, 64),
    "pages2": pfd.PagedPlan(2, 2, PS, 64),
    "pages3": pfd.PagedPlan(3, 2, PS, 64),
}


def _held(got, want, v_max, bf16):
    acc, m, l = got
    racc, rm, rl = want
    assert torch.isfinite(acc).all() and torch.isfinite(l).all()
    torch.testing.assert_close(m, rm, rtol=0, atol=0)          # exact
    torch.testing.assert_close(l, rl, rtol=1e-5, atol=0)
    out = acc / l.clamp_min(1e-30)[..., None]
    rout = racc / rl.clamp_min(1e-30)[..., None]
    atol = 2.0 ** -8 * v_max if bf16 else 1e-5
    torch.testing.assert_close(out, rout, rtol=0 if bf16 else 1e-5,
                               atol=atol)
    empty = torch.tensor(LENGTHS) == 0
    assert (m[empty] == NEG_INF).all() and (l[empty] == 0).all()
    assert (acc[empty] == 0).all()


@pytest.fixture(scope="module")
def jax_partials():
    """The JAX kernel's (acc, m, l) per pool dtype, in interpret mode."""
    if not tpu_interpreter_available():
        pytest.skip("this jax lacks the Pallas TPU interpreter")
    q, kp, vp, table, lengths = _inputs(0, v_tail_nan=False)
    out = {}
    for name, jdt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        acc, m, l = jax_pfd(jnp.asarray(q, jdt), jnp.asarray(kp, jdt),
                            jnp.asarray(vp, jdt), jnp.asarray(table),
                            jnp.asarray(lengths))
        out[name] = tuple(torch.from_numpy(np.array(x, np.float32))
                          for x in (acc, m, l))
    return out


@pytest.mark.parametrize("plan_name", list(PLANS))
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_split_and_merge_matches_the_jax_kernel(jax_partials, dtype,
                                                plan_name):
    q, kp, vp, table, lengths = _inputs(0, v_tail_nan=False)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    got = _emulate(_t(q, dt), _t(kp, dt), _t(vp, dt), _t(table),
                   _t(lengths), PLANS[plan_name])
    _held(got, jax_partials[dtype], 2.0, dtype == "bf16")


@pytest.mark.parametrize("plan_name", list(PLANS))
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_split_and_merge_with_nan_past_the_length(dtype, plan_name):
    """NaN in V's dead rows too: the emulation, like the kernel and the
    plain version, never lets them reach the output."""
    q, kp, vp, table, lengths = _inputs(1, v_tail_nan=True)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    args = (_t(q, dt), _t(kp, dt), _t(vp, dt), _t(table), _t(lengths))
    got = _emulate(*args, PLANS[plan_name])
    want = pfd.paged_flash_decode_partial_ref(*args)
    _held(got, want, 2.0, dtype == "bf16")


def test_the_launch_refuses_what_no_route_takes():
    """bf16 page sizes the TMA boxes cannot cut whose FMA body needs more
    shared memory than a block has, and head dims no route takes, raise
    in the launcher before any CUDA call (meta tensors carry the
    shapes)."""
    q = torch.zeros((2, 4, 128), dtype=torch.bfloat16, device="meta")
    for ps in (1000, 1500):
        pool = torch.zeros((2, 8, ps, 128), dtype=torch.bfloat16,
                           device="meta")
        tab = torch.zeros((2, 4), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="page_size"):
            pfd._launch(q, pool, pool, tab, tab[:, 0].contiguous(), None,
                        None)
    pool = torch.zeros((2, 8, 128, 96), dtype=torch.bfloat16, device="meta")
    tab = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        pfd._launch(torch.zeros((2, 4, 96), dtype=torch.bfloat16,
                                device="meta"), pool, pool, tab,
                    tab[:, 0].contiguous(), None, None)


@pytest.mark.parametrize("ps", [8, 16, 24, 32, 48, 64, 96, 100, 128, 192])
def test_the_route_by_page_size(ps):
    """bf16 pools: the Hopper kernel where a TMA box cuts the pages (a
    multiple of 64 keys, or 8 / 16 / 32), else PR 1's FMA body, whose
    shared memory fits a block at every g and D the launcher takes (the
    route csrc/paged_flash_decode.cu takes: box_ok); f32 and int8 pools
    always the FMA body."""
    tma = ps % pfd.PAGED_TILE == 0 or ps in pfd.PAGED_SMALL_PAGES
    assert pfd.paged_route(torch.bfloat16, ps) == ("tma" if tma else "fma")
    assert pfd.paged_route(torch.float32, ps) == "fma"
    assert pfd.paged_route(torch.int8, ps) == "fma"
    if not tma:
        for g in pfd._GROUPS:
            for d in pfd._HEAD_DIMS:
                assert pfd._smem_bytes(g, ps, d) <= SMEM_MAX
    src = (CSRC / "paged_flash_decode.cu").read_text()
    assert "ps % hop::KT == 0 || ps == 8 || ps == 16 || ps == 32" in src
    assert pfd.PAGED_SMALL_PAGES == (8, 16, 32)
    assert "td::BF16, __nv_bfloat16, td::BF16, __nv_bfloat16, 128" in src


def test_the_workspace_is_the_streams():
    """The bf16 kernel's partials and tickets are kept per (device, stream,
    shape): calls on one stream share them, calls on two streams (which
    may run at once: a one-card world's ranks, graphs replayed on their
    own streams) never do; the tickets start at zero."""
    dev = torch.device("cpu")
    keys = [(dev, s, 4, 8, 4, 4, 128) for s in (11, 12)]
    try:
        a = pfd._workspace(dev, 11, 4, 8, 4, 4, 128)
        again = pfd._workspace(dev, 11, 4, 8, 4, 4, 128)
        other = pfd._workspace(dev, 12, 4, 8, 4, 4, 128)
        assert again[0] is a[0] and again[1] is a[1]
        assert other[0].data_ptr() != a[0].data_ptr()
        assert other[1].data_ptr() != a[1].data_ptr()
        assert a[0].shape == (4, 8, 4, 4, 130) and a[0].dtype == torch.float32
        assert a[1].shape == (4, 8) and a[1].dtype == torch.int32
        assert not a[1].any() and not other[1].any()
    finally:
        for key in keys:
            pfd._WORKSPACES.pop(key, None)
