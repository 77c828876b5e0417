"""B21's bf16 plan (``sp_ag_attention.ring_plan``) and its order of work,
held on the CPU.

On the card the bf16 form of ``pallas_ring_attn_per_device`` launches
``plan.grid`` persistent blocks; block j takes work items j, j + grid,
... (``_item``: a tile of 128 GQA-packed rows of one kv head and batch
row, the last query tiles first), and folds each item's live key steps
(``_steps``: src = (me - s) mod n, comm blocks ascending, 128-key steps
from a block's first row to its end or the tile's last query, each read
through a 5-D tensor map whose rows past the block's end arrive as
zeros), every key of a step masked for a row past its position or past
the block's end (``_live``). This file writes those formulas down as the
kernel computes them and holds them: every (batch, query, head) row lies
in exactly one item; each row's live keys over its item's steps are
exactly its causal keys, each once, in ring order; items run heaviest
first; the grid leaves every rank resident at 1-4 ranks a card; every
TMA box and flag lies inside the workspace of ``ring_layout``.

Then it emulates the kernel's fold in torch (per item and step: scores
in f32, the masks, one online-softmax rescale a step, l from the f32
probabilities, P rounded to bf16 for P.V, the division by max(l, 1e-30))
and holds it against the port's plain version (``ring_attn_shards_ref``:
XLA_BLOCK's fold) and the JAX package's XLA_BLOCK tier at 4 ranks,
T_loc 256, g = 8, on bf16 inputs, within SP_TOL_BF16 = 2e-2 x max|ref|
(chip_smoke's tolerance for the kernel: both fold the same keys, the
rounding of P to bf16 (relative 2^-9 a probability) and the order of the
sums differ). With comm blocks of 75 rows (no multiple of the step) the
emulation is held against the plain version alone.

That the kernel's addressing is these formulas is held on the card:
``chip_smoke.py``'s ``b21_ring_attn`` and ``tp4_sp`` compare every case,
ragged comm blocks over NaN-filled landing slots included, with the plain
version.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from triton_dist_tpu_torch.kernels import plain
from triton_dist_tpu_torch.kernels import sp_ag_attention as sp
from triton_dist_tpu_torch.kernels.plain import NEG_INF

jsp = importlib.import_module("triton_dist_tpu.kernels.sp_ag_attention")

SMS = 132                  # an H100's SMs
SMEM_MAX = 232448          # bytes of shared memory a Hopper block may use
SMEM_SM = 233472           # bytes of shared memory an SM holds
CSRC = Path(sp.__file__).resolve().parent.parent / "csrc"
KEYS = sp.RING_KEYS
SP_TOL_BF16 = 2e-2


# -- the kernel's formulas -----------------------------------------------

def _item(plan, i, b_len, hkv):
    """(b, kv head, first query, first head) of work item i
    (hop::item_tile)."""
    per = b_len * hkv * plan.h_tiles
    qt = plan.q_tiles - 1 - i // per
    r = i % per
    return (r // (plan.h_tiles * hkv), (r // plan.h_tiles) % hkv,
            qt * plan.q_per_tile, (r % plan.h_tiles) * plan.h_per_tile)


def _rows(plan, q0, h0, t_loc, g):
    """(row, query, group head) of a tile's live rows (hop::tile_row)."""
    out = []
    for r in range(sp.RING_ROWS):
        q, h = q0 + r // plan.h_per_tile, h0 + r % plan.h_per_tile
        if r < plan.q_per_tile * plan.h_per_tile and q < t_loc and h < g:
            out.append((r, q, h))
    return out


def _q_hi(plan, me, q0, t_loc):
    """The tile's last query's global position."""
    return me * t_loc + min(q0 + plan.q_per_tile, t_loc) - 1


def _steps(plan, me, n, t_loc, q_hi):
    """(s, src, blk, k0, blk_end) of every key step (hop::for_each_step)."""
    bb = plan.bb
    out = []
    for s in range(n):
        src = (me - s) % n
        for blk in range(plan.nblk):
            if src * t_loc + blk * bb > q_hi:
                break
            blk_end = blk * bb + bb
            k_end = min(blk_end, q_hi - src * t_loc + 1)
            out += [(s, src, blk, k0, blk_end)
                    for k0 in range(blk * bb, k_end, KEYS)]
    return out


def _live(step, t_loc, pos):
    """Global positions of the step's keys a row at `pos` attends: the
    box's rows up to the block's end (the rest arrive as zeros) at or
    before pos (the consumer's mask: c <= min(pos - kp0, blk_end - k0 - 1))."""
    _, src, _, k0, blk_end = step
    kp0 = src * t_loc + k0
    hi = min(pos - kp0, blk_end - k0 - 1, KEYS - 1)
    return list(range(kp0, kp0 + hi + 1))


# (B, T_loc, Hq, Hkv, n, comm_blocks): Qwen3-32B on four cards and on the
# one-card world, ragged comm blocks, g = 5 (a tile of 125 rows), g = 256
# (heads cut into tiles), one rank, B = 2
PLANS = ((1, 8192, 64, 8, 4, 4), (1, 2048, 64, 8, 4, 4),
         (1, 600, 64, 8, 4, 4), (1, 600, 64, 8, 4, 3), (2, 256, 8, 1, 4, 4),
         (1, 100, 40, 8, 2, 4), (1, 3, 256, 1, 2, 1), (2, 300, 16, 2, 1, 4))


@pytest.mark.parametrize("b,t_loc,hq,hkv,n,cb", PLANS)
def test_every_row_in_one_item(b, t_loc, hq, hkv, n, cb):
    plan = sp.ring_plan(b, t_loc, hq, hkv, n, cb, SMS)
    g = hq // hkv
    assert plan.q_per_tile * plan.h_per_tile <= sp.RING_ROWS
    assert plan.h_per_tile * plan.h_tiles >= g
    seen = np.zeros((b, t_loc, hq), dtype=np.int64)
    for i in range(plan.items):
        bi, hk, q0, h0 = _item(plan, i, b, hkv)
        for _, q, h in _rows(plan, q0, h0, t_loc, g):
            seen[bi, q, hk * g + h] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("b,t_loc,hq,hkv,n,cb", PLANS)
def test_each_row_folds_its_causal_keys_once_in_ring_order(b, t_loc, hq, hkv,
                                                           n, cb):
    plan = sp.ring_plan(b, t_loc, hq, hkv, n, cb, SMS)
    assert plan.nblk == sp.legal_attn_blocks(t_loc, cb, n)
    assert plan.bb * plan.nblk == t_loc
    g = hq // hkv
    # every rank, the first, a middle and the last query tiles
    for me in range(n):
        for qt in sorted({0, plan.q_tiles // 2, plan.q_tiles - 1}):
            q0 = qt * plan.q_per_tile
            q_hi = _q_hi(plan, me, q0, t_loc)
            steps = _steps(plan, me, n, t_loc, q_hi)
            order = [(s, blk, k0) for s, _, blk, k0, _ in steps]
            assert order == sorted(order)            # ring order
            for s, src, blk, k0, blk_end in steps:
                assert src == (me - s) % n
                assert blk * plan.bb <= k0 < blk_end  # inside its block
                assert src * t_loc + k0 <= q_hi       # never wholly future
            for _, q, _ in _rows(plan, q0, 0, t_loc, g)[::7]:
                pos = me * t_loc + q
                keys = [k for st in steps for k in _live(st, t_loc, pos)]
                srcs = [(me - s) % n for s in range(me + 1)]
                want = [k for src in srcs
                        for k in range(src * t_loc,
                                       min(src * t_loc + t_loc, pos + 1))]
                assert keys == want                  # causal, once, in order


@pytest.mark.parametrize("b,t_loc,hq,hkv,n,cb", PLANS)
def test_items_run_heaviest_first(b, t_loc, hq, hkv, n, cb):
    plan = sp.ring_plan(b, t_loc, hq, hkv, n, cb, SMS)
    for me in range(n):
        work = [_q_hi(plan, me, _item(plan, i, b, hkv)[2], t_loc)
                for i in range(plan.items)]
        assert work == sorted(work, reverse=True)


@pytest.mark.parametrize("ranks", [1, 2, 3, 4])
def test_every_rank_resident(ranks):
    """One block an SM (the Q tile and the K/V ring take 161 KB at D 128,
    two do not fit an SM), the card's SMs shared by the ranks on it; every
    item taken by exactly one block of the stride loop."""
    smem = 1024 + 2 * 2 * (2 * 64 * 64 + 2 * 2 * KEYS * 64) + 3 * 2 * 8
    assert smem <= SMEM_MAX and 2 * smem > SMEM_SM
    assert sp.RING_BLOCKS_PER_SM == SMEM_SM // smem
    for b, t_loc, hq, hkv, n, cb in PLANS:
        plan = sp.ring_plan(b, t_loc, hq, hkv, n, cb, SMS, ranks)
        assert 1 <= plan.grid <= plan.items
        assert plan.grid * ranks <= sp.RING_BLOCKS_PER_SM * SMS
        taken = sorted(i for j in range(plan.grid)
                       for i in range(j, plan.items, plan.grid))
        assert taken == list(range(plan.items))
    with pytest.raises(ValueError):
        sp.ring_plan(1, 256, 8, 1, 4, 4, 3, 4)


def test_the_constants_are_the_kernels():
    """RING_KEYS, RING_ROWS and the stages are the CUDA source's."""
    src = (CSRC / "sp_attention.cu").read_text()
    assert re.search(rf"constexpr int KEYS = {KEYS};", src)
    assert re.search(r"constexpr int NWG = (\d+);", src).group(1) == \
        str(sp.RING_ROWS // 64)
    assert re.search(r"constexpr int ST = 2;", src)


@pytest.mark.parametrize("b,t_loc,hq,hkv,n,cb", PLANS)
def test_boxes_and_flags_inside_the_workspace(b, t_loc, hq, hkv, n, cb):
    """The landing maps' extents (slabs 2 n B of T_loc rows of Hkv x D
    bf16) end at land_v (K) and flag_off (V); every box's slab, block and
    row coordinates lie inside the map's dims; the flags end the
    buffer."""
    d = 128
    plan = sp.ring_plan(b, t_loc, hq, hkv, n, cb, SMS)
    land_v, flag_off, total = sp.ring_layout(n, b, t_loc, hkv, d, 2,
                                             plan.nblk)
    extent = 2 * n * b * t_loc * hkv * d * 2
    assert extent <= land_v and land_v + extent <= flag_off
    assert land_v % 256 == 0 and flag_off + n * plan.nblk * 8 == total
    for me in range(n):
        for par in (0, 1):
            for i in (0, plan.items - 1):
                bi, _, q0, _ = _item(plan, i, b, hkv)
                for s, src, blk, k0, _ in _steps(
                        plan, me, n, t_loc, _q_hi(plan, me, q0, t_loc)):
                    slab = bi if s == 0 else (par * n + src) * b + bi
                    assert slab < (b if s == 0 else 2 * n * b)
                    assert 0 <= k0 - blk * plan.bb < plan.bb
                    assert blk < plan.nblk
                    assert src * plan.nblk + blk < n * plan.nblk  # its flag


# -- the fold, emulated --------------------------------------------------

def _emulate(q, ks, vs, me, cb):
    """The bf16 kernel's fold of rank me's q (B, T_loc, Hq, D) over every
    rank's k / v (lists in rank order), item by item and step by step."""
    b, t_loc, hq, d = q.shape
    n, hkv = len(ks), ks[0].shape[2]
    g = hq // hkv
    plan = sp.ring_plan(b, t_loc, hq, hkv, n, cb, SMS)
    scale = d ** -0.5
    out = torch.zeros(q.shape, dtype=torch.float32)
    for i in range(plan.items):
        bi, hk, q0, h0 = _item(plan, i, b, hkv)
        rows = _rows(plan, q0, h0, t_loc, g)
        qi = torch.tensor([q for _, q, _ in rows])
        hi = torch.tensor([hk * g + h for _, _, h in rows])
        qr = q[bi, qi, hi].float()                        # (R, D)
        pos = me * t_loc + qi
        m = torch.full((len(rows),), NEG_INF)
        l = torch.zeros(len(rows))
        acc = torch.zeros((len(rows), d))
        for _, src, _, k0, blk_end in _steps(
                plan, me, n, t_loc, _q_hi(plan, me, q0, t_loc)):
            kb = ks[src][bi, k0:min(k0 + KEYS, blk_end), hk].float()
            vb = vs[src][bi, k0:min(k0 + KEYS, blk_end), hk].float()
            kpos = src * t_loc + k0 + torch.arange(kb.shape[0])
            s = qr @ kb.T
            s = torch.where(kpos[None, :] <= pos[:, None], s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1) * scale)
            p = torch.exp(s * scale - m_new[:, None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[:, None] + p.to(torch.bfloat16).float() @ vb
            m = m_new
        out[bi, qi, hi] = acc / torch.clamp_min(l, 1e-30)[:, None]
    return out.to(q.dtype)


def _draw(seed, b, t, h, d):
    x = np.random.default_rng(seed).standard_normal((b, t, h, d))
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def _near(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    return err <= SP_TOL_BF16 * ref.float().abs().max().item(), err


def test_fold_emulation_equals_plain_and_jax_xla_block(mesh4):
    n, t_loc, hq, hkv, d, cb = 4, 256, 8, 1, 128, 4
    q = _draw(1, 1, n * t_loc, hq, d)
    k, v = _draw(2, 1, n * t_loc, hkv, d), _draw(3, 1, n * t_loc, hkv, d)
    ctx = jsp.create_sp_attn_context(mesh4, axis="tp",
                                     method=jsp.SpAttnMethod.XLA_BLOCK,
                                     comm_blocks=cb)
    want = np.asarray(jax.jit(lambda q, k, v: jsp.sp_attention(
        ctx, q, k, v))(*(x.float().numpy() for x in (q, k, v))))
    ks = [k[:, r * t_loc:(r + 1) * t_loc] for r in range(n)]
    vs = [v[:, r * t_loc:(r + 1) * t_loc] for r in range(n)]
    for me in range(n):
        qm = q[:, me * t_loc:(me + 1) * t_loc]
        got = _emulate(qm, ks, vs, me, cb)
        ok, err = _near(got, plain.ring_attn_shards_ref(
            qm, ks, vs, me, sp.legal_attn_blocks(t_loc, cb, n)))
        assert ok, f"rank {me}: {err} from the plain version"
        ok, err = _near(got, torch.from_numpy(
            want[:, me * t_loc:(me + 1) * t_loc]))
        assert ok, f"rank {me}: {err} from the JAX XLA_BLOCK tier"


def test_fold_emulation_on_ragged_comm_blocks():
    """Comm blocks of 75 rows: steps of 75 keys, cut at each block's end
    (their rows past it arrive as zeros on the card)."""
    n, t_loc, hq, hkv, d, cb = 2, 300, 16, 2, 64, 4
    plan = sp.ring_plan(1, t_loc, hq, hkv, n, cb, SMS)
    assert plan.bb == 75
    q = _draw(4, 1, n * t_loc, hq, d)
    k, v = _draw(5, 1, n * t_loc, hkv, d), _draw(6, 1, n * t_loc, hkv, d)
    ks = [k[:, r * t_loc:(r + 1) * t_loc] for r in range(n)]
    vs = [v[:, r * t_loc:(r + 1) * t_loc] for r in range(n)]
    for me in range(n):
        qm = q[:, me * t_loc:(me + 1) * t_loc]
        ok, err = _near(_emulate(qm, ks, vs, me, cb),
                        plain.ring_attn_shards_ref(qm, ks, vs, me, plan.nblk))
        assert ok, f"rank {me}: {err}"
