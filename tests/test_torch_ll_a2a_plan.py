"""The plan of B17 and B18 (``low_latency_all_to_all.a2a_plan``), held on
the CPU. The kernel (``csrc/ep_a2a.cu``) pushes block b's contiguous share
of every slot of each payload into the peer's landing slot (parity,
sender), copies its own slot straight to the output, and reads the landed
slots back: by LL lines tagged with the epoch (no fence, no flag) where a
slot of the first payload is small, else plain vectors and one flag per
(block, sender). This file writes the kernel's formulas down (_share,
_slot, _flag) and holds them: the protocol follows a slot's bytes, the
regions are disjoint, aligned and inside the buffer, the shares cover
every vector once, and the grid leaves every rank that shares an H100
resident. An emulation of the kernel's data movement (LL lines or plain
vectors, over both parities, for one payload and for two) must give the
bytes of ``all_to_all_slots`` (its one-process form,
``all_to_all_slots_shards``), fp8 as bytes. That the kernel's own
addressing is these formulas is held on the card: ``chip_smoke.py``'s
``b17_ll_a2a``, ``b18_ll_a2a_q`` and ``tp4_ep`` compare every output with
the plain version bit for bit.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_slot_emulation import load as _load
from torch_slot_emulation import store_vectors as _store_vectors
from triton_dist_tpu_torch.kernels import low_latency_all_to_all as ll
from triton_dist_tpu_torch.kernels.plain import all_to_all_slots_shards

SMS = 132                  # an H100's SMs
NT = 256                   # threads a block (csrc/ep_a2a.cu)
HIDDEN = 2048              # Qwen3-30B-A3B's hidden
# (world, rows, row bytes, rows1, row bytes1): B17 at EP=4 decode (32
# slots of 2,048 bf16) and at a 512-token chunk (4,096), f32 decode; B18's
# fp8 rows with their packed scales (one row of 128 f32); odd sizes
CASES = ((4, 32, 2 * HIDDEN, 0, 0), (4, 4096, 2 * HIDDEN, 0, 0),
         (4, 32, 4 * HIDDEN, 0, 0), (4, 32, HIDDEN, 1, 512),
         (4, 4096, HIDDEN, 32, 512), (2, 8, 16, 0, 0), (3, 5, 48, 1, 512),
         (8, 64, 2 * HIDDEN, 1, 512), (8, 2048, 2 * HIDDEN, 0, 0))


def _plan(world, r0, b0, r1, b1, rpd=1, ll_=None, sms=SMS):
    """a2a_plan's plan, or its grid under the protocol ``ll_`` (as the
    chip's protocol sweep forces one)."""
    plan = ll.a2a_plan(world, r0, b0, r1, b1, sms, rpd)
    if ll_ is None:
        return plan
    return ll.a2a_layout(world, r0, b0, r1, b1, plan.grid, ll_)


def _share(plan, slot):
    """Block b's (first vector, count) of a slot of `slot` vectors."""
    g = plan.grid
    return [(b * slot // g, (b + 1) * slot // g - b * slot // g)
            for b in range(g)]


def _slot(plan, land, rows, kv, par, s, world):
    """Byte offset of sender s's landing slot of parity par of a payload
    whose slots start at byte `land`."""
    return land + (par * world + s) * rows * kv * (32 if plan.ll else 16)


def _flag(plan, b, j, world):
    """Byte offset of block b's flag for slot j (td_oneshot.cuh's
    exchange_flags: rank r's flag for peer p is p's slot (r - p - 1) mod
    world)."""
    return plan.flag_off + 8 * (b * (world - 1) + j)


def _payloads(plan):
    out = [(plan.land0, plan.rows0, plan.kv0)]
    if plan.rows1:
        out.append((plan.land1, plan.rows1, plan.kv1))
    return out


@pytest.mark.parametrize("case", CASES)
def test_protocol_follows_slot_bytes(case):
    world, r0, b0, r1, b1 = case
    for rpd in (1, 4):
        plan = _plan(world, r0, b0, r1, b1, rpd)
        assert plan.ll == (r0 * b0 <= ll.A2A_LL_MAX_SLOT_BYTES)
    # the decode dispatch / combine and B18's fp8 rows under LL, the
    # 512-token chunk under flags
    assert _plan(4, 32, 2 * HIDDEN, 0, 0).ll
    assert _plan(4, 32, HIDDEN, 1, 512).ll
    assert not _plan(4, 4096, 2 * HIDDEN, 0, 0).ll


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("proto", (None, True, False))
def test_regions_disjoint_aligned_inside(case, proto):
    world, r0, b0, r1, b1 = case
    plan = _plan(world, r0, b0, r1, b1, 1, proto)
    assert (plan.rows0, plan.kv0) == (r0, b0 // 16)
    spans = []
    for land, rows, kv in _payloads(plan):
        for par in (0, 1):
            for s in range(world):
                lo = _slot(plan, land, rows, kv, par, s, world)
                spans.append((lo, lo + rows * kv * (32 if plan.ll else 16)))
    if not plan.ll:
        spans += [(_flag(plan, b, j, world), _flag(plan, b, j, world) + 8)
                  for b in range(plan.grid) for j in range(world - 1)]
    spans.sort()
    assert spans[0][0] == 0 and spans[-1][1] <= plan.nbytes
    for (_, hi), (lo2, _) in zip(spans, spans[1:]):
        assert hi <= lo2
    assert all(lo % 16 == 0 for lo, hi in spans if hi - lo > 8)
    assert all(lo % 8 == 0 for lo, _ in spans)
    if plan.ll:
        assert plan.nbytes == plan.flag_off      # no flags under LL


@pytest.mark.parametrize("rpd", (1, 4))
def test_grid_resident(rpd):
    """LL: a vector a thread of a slot, at most one block an SM per rank
    that shares the card; flags: ~8 KiB of the slots a block, at most 4
    blocks (of 256 threads) an SM per rank; never more blocks than a slot
    of the first payload has vectors."""
    for world, r0, b0, r1, b1 in CASES:
        plan = _plan(world, r0, b0, r1, b1, rpd)
        vectors = r0 * b0 // 16
        assert 1 <= plan.grid <= vectors
        if plan.ll:
            assert plan.grid <= -(-vectors // NT)
            assert plan.grid * rpd <= SMS
        else:
            assert plan.grid * rpd <= 4 * SMS


def test_ll_block_bytes_at_decode():
    """B7's cut: about 4 KiB of a slot a block (a 16-byte vector a thread)
    at the decode dispatch, on four cards and in the one-card world."""
    for rpd in (1, 4):
        plan = _plan(4, 32, 2 * HIDDEN, 0, 0, rpd)
        assert plan.grid == 32
        assert 32 * 2 * HIDDEN // plan.grid == 4096


@pytest.mark.parametrize("case", CASES)
def test_shares_cover_every_vector_once(case):
    plan = _plan(*case)
    for _, rows, kv in _payloads(plan):
        seen = np.zeros(rows * kv, dtype=np.int64)
        for v0, nv in _share(plan, rows * kv):
            seen[v0:v0 + nv] += 1
        assert (seen == 1).all()


def _words(t):
    """A (world, rows, K) payload's bytes as (world, rows * kv, 4) u32."""
    return t.contiguous().view(torch.uint8).numpy().view(np.uint32).reshape(
        t.shape[0], -1, 4)


def _emulate(plan, world, payloads, bufs, epoch):
    """One call of the kernel on every rank: block by block, each rank's
    share of slot q of each payload into peer q's landing slot (parity
    epoch & 1, sender = the rank), plain or as LL lines tagged with the
    epoch, its own slot straight into the output; then every rank reads
    its landed slots (under LL every line must carry the epoch). Returns
    each rank's outputs, payload by payload, as u32 words."""
    par = epoch & 1
    outs = [[np.zeros_like(_words(p[r])) for p in payloads]
            for r in range(world)]
    regions = _payloads(plan)
    for r in range(world):
        for (land, rows, kv), p, out in zip(regions, payloads, outs[r]):
            x = _words(p[r])
            for v0, nv in _share(plan, rows * kv):
                v = np.arange(v0, v0 + nv)
                for i in range(1, world):
                    q = (r + i) % world
                    _store_vectors(bufs[q], plan.ll,
                                   _slot(plan, land, rows, kv, par, r, world),
                                   x[q, v], v, epoch)
                out[r, v] = x[r, v]
    for r in range(world):
        for (land, rows, kv), out in zip(regions, outs[r]):
            view = SimpleNamespace(m=rows, kv=kv, ll=plan.ll)
            for i in range(1, world):
                s = (r + i) % world
                out[s] = _load(bufs[r], view, _slot(plan, land, rows, kv,
                                                    par, s, world),
                               epoch).reshape(-1, 4)
    return outs


@pytest.mark.parametrize("world", (2, 3, 4, 8))
@pytest.mark.parametrize("proto", (True, False))
@pytest.mark.parametrize("two", (False, True))
def test_emulation_is_all_to_all_slots(world, proto, two):
    """Over both parities twice (epochs 1-4, fresh slots each call, the
    other parity still holding the call before), every rank's output is
    the plain exchange's bytes: bf16 slots for B17; fp8 rows and their
    packed f32 scales in one launch for B18 (fp8 as bytes)."""
    rng = np.random.default_rng(90 + world)
    if two:                   # fp8 rows of 208 bytes, one row of scales
        rows, k, rb0, rows1, rb1 = 21, 208, 208, 1, 4 * 128
    else:                     # bf16 rows of 400 bytes
        rows, k, rb0, rows1, rb1 = 13, 200, 400, 0, 0
    plan = _plan(world, rows, rb0, rows1, rb1, 2, proto, sms=6)
    assert plan.grid > 1 and len({nv for _, nv in _share(
        plan, rows * rb0 // 16)}) > 1                           # ragged
    bufs = [np.zeros(plan.nbytes // 4, dtype=np.uint32)
            for _ in range(world)]
    for epoch in (1, 2, 3, 4):
        xs = [torch.from_numpy(rng.standard_normal((world, rows, k)).astype(
            np.float32)) for _ in range(world)]
        if two:
            qs, ss = zip(*(ll.quantize_rows(x, torch.float8_e4m3fn)
                           for x in xs))
            payloads = [list(qs), [ll.pack_scales(s) for s in ss]]
        else:
            payloads = [[x.to(torch.bfloat16) for x in xs]]
        outs = _emulate(plan, world, payloads, bufs, epoch)
        for i, p in enumerate(payloads):
            want = all_to_all_slots_shards(p)
            for r in range(world):
                assert (outs[r][i] == _words(want[r])).all()
