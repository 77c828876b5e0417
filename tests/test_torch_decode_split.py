"""B19's order of work, run in torch on the CPU and held to the JAX
package's ``flash_decode_partial`` (its Pallas kernel in interpret mode).

On the card B19's bf16 form cuts the shard by ``decode_plan``: each block
folds one split's live keys tile by tile, each tile's keys dealt in runs
of tile / groups to warps that keep their own online softmax and merge by
exact LSE (warp 0 first) at the split's end; the splits are merged in
ascending order by exact LSE (``decode_merge_kernel``). ``_emulate``
writes that order out in f32 (probabilities unrounded: V is f32) and must
agree with the sequential fold of the reference within 1e-5 at a small
ragged shape (S_loc 300: no multiple of a tile or of a split unit) with
the horizon inside a tile, the whole shard live, and a shard wholly in the
future, in both layouts. That the kernel computes this order is held on
the card by ``chip_smoke.py``'s ``b19_flash_decode_partial``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.kernels import flash_attention as jfa
from triton_dist_tpu.runtime.compat import tpu_interpreter_available

from triton_dist_tpu_torch.kernels.flash_attention import (
    NEG_INF, decode_plan,
)

TOL = dict(rtol=1e-5, atol=1e-5)
SMS = 6            # a small card: the 300-key shard cut into three splits


@pytest.fixture(scope="module", autouse=True)
def _interpreter():
    if not tpu_interpreter_available():
        pytest.skip("this jax lacks the Pallas TPU interpreter")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _lse_merge(parts):
    """(acc, m, l) triples merged in order by exact LSE: m = max m_i,
    acc = sum_i acc_i e^(m_i - m) and l alike, added one after another."""
    m = parts[0][1]
    for _, mi, _ in parts[1:]:
        m = torch.maximum(m, mi)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for ai, mi, li in parts:
        sc = torch.exp(mi - m)
        acc = acc + ai * sc[..., None]
        l = l + li * sc
    return acc, m, l


def _emulate(q, k, v, start, q_pos, plan):
    """B19's bf16 order of work on (B, S, Hkv, D) f32 k / v: (acc, m, l)."""
    b, hq, d = q.shape
    s_loc, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.reshape(b, hkv, g, d)
    kf, vf = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)   # (B, Hkv, S, D)
    run = plan.tile // plan.groups
    splits = []
    for sp in range(plan.splits):
        k_lo = sp * plan.chunk
        k_hi = max(k_lo, min(k_lo + plan.chunk, s_loc, q_pos - start + 1))
        warps = []
        for w in range(plan.groups):
            m = torch.full((b, hkv, g), NEG_INF)
            l = torch.zeros((b, hkv, g))
            acc = torch.zeros((b, hkv, g, d))
            for t0 in range(k_lo, k_hi, plan.tile):
                j0 = t0 + w * run
                if j0 >= k_hi:
                    continue
                kb, vb = kf[:, :, j0:j0 + run], vf[:, :, j0:j0 + run]
                sc = torch.einsum("bhgd,bhjd->bhgj", qf, kb) * d ** -0.5
                valid = (j0 + torch.arange(kb.shape[2])) < k_hi
                sc = torch.where(valid, sc, NEG_INF)
                m_new = torch.maximum(m, sc.amax(-1))
                p = torch.where(valid, torch.exp(sc - m_new[..., None]), 0.0)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhgj,bhjd->bhgd", p, vb)
                m = m_new
            warps.append((acc, m, l))
        splits.append(_lse_merge(warps))
    acc, m, l = _lse_merge(splits)
    return acc.reshape(b, hq, d), m.reshape(b, hq), l.reshape(b, hq)


@pytest.mark.parametrize("head_major", [False, True])
@pytest.mark.parametrize("start,q_pos", [(0, 150), (0, 1000), (300, 150)],
                         ids=["horizon_in_tile", "whole", "future"])
def test_b19_split_and_merge_equals_jax(start, q_pos, head_major):
    q = _rand(31, 2, 8, 128)
    k, v = _rand(32, 2, 300, 2, 128), _rand(33, 2, 300, 2, 128)
    plan = decode_plan(300, 2 * 2, SMS, torch.bfloat16)
    assert plan.splits == 3 and plan.chunk == 128 and plan.tile == 64
    got = _emulate(torch.from_numpy(q), torch.from_numpy(k),
                   torch.from_numpy(v), start, q_pos, plan)
    kj, vj = k, v
    if head_major:
        kj, vj = k.transpose(0, 2, 1, 3).copy(), v.transpose(0, 2, 1, 3).copy()
    want = jax.jit(lambda q, k, v: jfa.flash_decode_partial(
        q, k, v, jnp.int32(start), jnp.int32(q_pos),
        head_major=head_major))(q, kj, vj)
    for gt, w in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(w), **TOL)
    if start > q_pos:
        assert not got[0].any() and not got[2].any()
        assert (got[1] == NEG_INF).all()
