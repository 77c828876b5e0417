"""B5's plan (``allreduce.one_shot_plan``), held on the CPU. On the card
B5 is B6's one-shot regime (``csrc/allreduce.cu``, ``all_reduce_kernel``
with the fold ``kOwnFirst``): every rank stores its whole x into its
sender-indexed slot of every peer (rank r's x in rank p's slot (r - p -
1) mod n, double-buffered by the epoch's parity), LL lines or flags by the
bytes of a slot, and each rank adds its own term first, then the others
in ascending rank, each add rounded to x's dtype. This file holds the
plan (one-shot always, the protocol by ONE_SHOT_LL_MAX_SLOT_BYTES, B6's
grid resident on a card that four ranks share, the slots and flags
disjoint, aligned and inside the buffer; the slot, column and flag
formulas are ``tests/torch_slot_emulation.py``'s and
``test_torch_rhd_plan.py``'s, the kernel's) and emulates the exchange
(plain vectors and LL lines, both parities) at n = 2, 3, 4, 5 and 8: every
rank's fold of what landed must be ``plain.one_shot_fold``'s bytes, in
bf16 and f32, and in f32 the JAX ``_one_shot_kernel``'s result on that
rank (``all_reduce_per_device`` ONE_SHOT in interpret mode, run per
device as ``tests/test_torch_ar.py`` runs it), exactly: the same adds in
the same order. That the kernel's own addressing is these formulas is
held on the card: ``chip_smoke.py``'s ``b5_one_shot`` and ``tp4_serve``
compare every output with the plain version bit for bit.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_slot_emulation import cols, exchange, slot, tensor, vectors
from triton_dist_tpu.kernels.allreduce import (
    AllReduceMethod as JArMethod, all_reduce_per_device as j_all_reduce,
)
from triton_dist_tpu.runtime import make_comm_mesh
from triton_dist_tpu.runtime.compat import td_shard_map
from triton_dist_tpu_torch.kernels import allreduce as arm
from triton_dist_tpu_torch.kernels.plain import one_shot_fold

SMS = 132          # an H100's SMs
SOURCE = (Path(arm.__file__).resolve().parent.parent / "csrc"
          / "allreduce.cu").read_text()
SHAPES = [(n, rows, k, es, rpd)
          for n in (2, 3, 4, 5, 8) for rows in (1, 4, 16, 64, 512)
          for k, es in ((5120, 2), (5000, 2), (5120, 4)) for rpd in (1, 4)
          if rpd <= n]


def _plan(n, rows, k, es, rpd, ll=None, sms=SMS):
    """one_shot_plan's plan, or its grid under the protocol ``ll`` (as the
    chip's protocol sweep forces one)."""
    if ll is None:
        return arm.one_shot_plan(n, rows, k, es, sms, rpd)
    kv = k * es // 16
    return arm.rhd_layout(n, rows, kv, arm.rhd_grid(rows, kv, sms, rpd), ll,
                          False)


def _flag(plan, b, j, n):
    """Byte offset of block b's flag for slot j."""
    return plan.flag_off + 8 * (b * (n - 1) + j)


@pytest.mark.parametrize("n,rows,k,es,rpd", SHAPES)
def test_slots_and_flags_disjoint_aligned_inside(n, rows, k, es, rpd):
    for ll in (None, True, False):
        plan = _plan(n, rows, k, es, rpd, ll)
        assert not plan.two_shot and plan.m == rows
        assert plan.kv == k * es // 16
        assert plan.slot_bytes >= rows * plan.kv * 16 * (2 if plan.ll
                                                          else 1)
        spans = sorted((slot(plan, p, j, n),
                        slot(plan, p, j, n) + plan.slot_bytes)
                       for p in range(2) for j in range(n - 1))
        for (_, hi), (lo2, _) in zip(spans, spans[1:]):
            assert hi <= lo2
        assert all(lo % 16 == 0 for lo, _ in spans)
        assert spans[-1][1] <= plan.nbytes
        if plan.ll:
            continue                           # no flags under LL
        offs = [_flag(plan, b, j, n) for b in range(plan.grid)
                for j in range(n - 1)]
        assert len(set(offs)) == len(offs)
        assert min(offs) >= spans[-1][1] and min(offs) % 8 == 0
        assert max(offs) + 8 <= plan.nbytes


@pytest.mark.parametrize("n,rows,k,es,rpd", SHAPES)
def test_protocol_follows_slot_bytes_on_b6s_grid(n, rows, k, es, rpd):
    """LL lines while a slot (one rank's whole x) holds at most
    ONE_SHOT_LL_MAX_SLOT_BYTES, flags above; B6's grid (a vector a thread
    a slot, at most one block an SM per rank that shares the card and
    one a column vector), every column vector in one block's slice."""
    plan = _plan(n, rows, k, es, rpd)
    assert plan.ll == (rows * k * es <= arm.ONE_SHOT_LL_MAX_SLOT_BYTES)
    kv = k * es // 16
    assert plan.grid == arm.rhd_grid(rows, kv, SMS, rpd)
    assert 1 <= plan.grid <= kv and plan.grid * rpd <= SMS
    seen = np.zeros(kv, dtype=np.int64)
    for c0, cw in cols(plan):
        assert cw >= 1
        seen[c0:c0 + cw] += 1
    assert (seen == 1).all()


def test_decode_step_takes_the_rows_it_should():
    """Qwen3-32B's decode sum at TP=4 (16 rows of 5,120 bf16, 160 KiB)
    and a 512-token prefill chunk (5 MiB): one-shot both, the protocol by
    the slot's bytes."""
    for rows in (16, 512):
        plan = _plan(4, rows, 5120, 2, 1)
        assert not plan.two_shot
        assert plan.ll == (rows * 10240 <= arm.ONE_SHOT_LL_MAX_SLOT_BYTES)


def _fold(terms, me):
    """The kernel's fold on rank me of the n terms in rank order (terms[me]
    its own x): t = own, then t + terms[r] for r ascending, r != me, each
    add in the terms' dtype."""
    acc = terms[me]
    for r, t in enumerate(terms):
        if r != me:
            acc = acc + t
    return acc


def _emulate(plan, n, xs, epoch):
    """One call: every rank's x into its slot of every peer (the kernel's
    block by block stores, plain or LL lines tagged with the epoch), then
    each rank's n terms (its own x and its n - 1 slots) folded. Returns
    the ranks' outputs."""
    dt, k = xs[0].dtype, xs[0].shape[1]
    words = [vectors(x) for x in xs]
    got = exchange(plan, n, [[words[r]] * n for r in range(n)], epoch)
    outs = []
    for me in range(n):
        terms = [xs[me] if r == me else
                 tensor(got[me][(r - me - 1) % n], dt, k) for r in range(n)]
        outs.append(_fold(terms, me))
    return outs


@pytest.mark.parametrize("dt", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("n", (2, 3, 4, 5, 8))
@pytest.mark.parametrize("ll", (True, False))
def test_emulated_exchange_and_fold_is_one_shot_fold(dt, n, ll):
    """Over both parities twice (epochs 1-4, fresh x each), every rank's
    output is one_shot_fold's bytes for that rank; at n >= 3 the ranks'
    bytes differ somewhere (the rank-dependent order shows)."""
    rows, k = 24, 200 if dt == torch.bfloat16 else 100  # 25 vectors a row
    plan = _plan(n, rows, k, torch.tensor([], dtype=dt).element_size(), 2,
                 ll, sms=8)
    assert plan.grid > 1
    rng = np.random.default_rng(41 + n)
    differs = False
    for epoch in (1, 2, 3, 4):
        xs = [torch.from_numpy(
            (rng.standard_normal((rows, k)) * 2.0 ** rng.integers(
                -8, 9, (rows, k))).astype(np.float32)).to(dt)
            for _ in range(n)]
        outs = _emulate(plan, n, xs, epoch)
        for me in range(n):
            want = one_shot_fold(xs, me)
            assert torch.equal(outs[me].view(torch.uint8),
                               want.view(torch.uint8))
        differs |= any(not torch.equal(o, outs[0]) for o in outs)
    assert differs == (n >= 3)


def _jax_mesh(n):
    return make_comm_mesh(axes=[("tp", n)], devices=jax.devices()[:n])


@functools.lru_cache(maxsize=None)
def _jax_one_shot(n):
    """The JAX all_reduce_per_device ONE_SHOT (its _one_shot_kernel in
    interpret mode) on every device of an n-device mesh, compiled once:
    each rank's (1, M, K) output stacked in rank order."""
    fn = functools.partial(j_all_reduce, "tp", n, JArMethod.ONE_SHOT, None)
    return jax.jit(td_shard_map(lambda x: fn(x[0])[None], mesh=_jax_mesh(n),
                                in_specs=(P("tp"),), out_specs=P("tp")))


@pytest.mark.parametrize("kind", ("int", "rand"))
@pytest.mark.parametrize("n", (2, 3, 4, 8))
def test_emulated_bytes_equal_the_jax_kernel_per_rank(n, kind):
    """Each rank's x (8, 128) f32, made with numpy: the emulated exchange
    (LL lines and flags) and own-first fold equal the JAX _one_shot_kernel
    on that rank, bit for bit."""
    rng = np.random.default_rng(53 + n)
    if kind == "int":
        xs = rng.integers(-3, 4, (n, 8, 128)).astype(np.float32)
    else:
        xs = rng.standard_normal((n, 8, 128)).astype(np.float32)
    want = np.asarray(_jax_one_shot(n)(jnp.asarray(xs)))
    for ll in (True, False):
        plan = _plan(n, 8, 128, 4, 1, ll)
        outs = _emulate(plan, n, [torch.from_numpy(x) for x in xs], 3)
        for r in range(n):
            np.testing.assert_array_equal(outs[r].numpy(), want[r],
                                          err_msg=f"rank {r} ll={ll}")


def test_kernel_source_folds_own_first():
    """The kernel's B5 fold: its own term, then ascending rank skipping
    itself, each add rounded to T; B5 is the one-shot regime only."""
    assert "t[0] = me == 0 ? own : add_vec<T>(own, t[0]);" in SOURCE
    assert "if (r < n && r != me) t[0] = add_vec<T>(t[0], t[r]);" in SOURCE
    assert re.search(r'static_assert\(F == kTree \|\| !TWO, "B5 is '
                     r'one-shot"\);', SOURCE)
    assert "(!tree && two_shot != 0)" in SOURCE
