"""The sequence-parallel slice's kernels, one process: the plain versions
of B1's fold and varlen forms and of B19 against the JAX package's
kernels (run in interpret mode), the local decode passes, the zigzag
layout and the one-card plain version of B21.

Inputs are made with numpy from seeds, at lane-aligned shapes (D 128);
f32, held within 1e-5. B1's fold form: 64 queries at global rows 100..163
against a 96-key chunk (96 % 128 != 0) whose origin is 0, 64 or 170 (the
last wholly in the future: the merge's identity (0, -1e30, 0)), with and
without three packed segments. B1's varlen form: 160 queries over a
224-key cache at offset 64. B19: a 200-key shard (200 % 128 != 0) at
start 0 and 100, an empty shard (start past the query), both layouts.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.kernels import flash_attention as jfa
from triton_dist_tpu.runtime.compat import tpu_interpreter_available

from triton_dist_tpu_torch.kernels import flash_attention as fa
from triton_dist_tpu_torch.kernels import plain
from triton_dist_tpu_torch.kernels import sp_ag_attention as sp
from triton_dist_tpu_torch.kernels.flash_attention import decode_splits

# the packages export functions of these modules' names
jfd = importlib.import_module("triton_dist_tpu.kernels.flash_decode")
jsp = importlib.import_module("triton_dist_tpu.kernels.sp_ag_attention")
fd = importlib.import_module("triton_dist_tpu_torch.kernels.flash_decode")

TOL = dict(rtol=1e-5, atol=1e-5)
CU = [0, 40, 130, 190]


@pytest.fixture(scope="module", autouse=True)
def _interpreter():
    if not tpu_interpreter_available():
        pytest.skip("this jax lacks the Pallas TPU interpreter")


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)


@pytest.mark.parametrize("varlen", [False, True], ids=["causal", "varlen"])
@pytest.mark.parametrize("k_start", [0, 64, 170])
def test_b1_fold_plain_equals_jax(k_start, varlen):
    q, k, v = _rand(1, 2, 64, 4, 128), _rand(2, 2, 96, 2, 128), \
        _rand(3, 2, 96, 2, 128)
    cu = np.asarray(CU, np.int32) if varlen else None
    got = fa.flash_fold_partial(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 100,
        k_start, cu_seqlens=None if cu is None else torch.from_numpy(cu))
    want = jax.jit(lambda q, k, v: jfa.flash_fold_partial(
        q, k, v, jnp.int32(100), jnp.int32(k_start),
        cu_seqlens=None if cu is None else jnp.asarray(cu)))(q, k, v)
    _check(got, want)
    if k_start == 170:                      # wholly in the future
        acc, m, l = got
        assert not acc.any() and not l.any() and (m == fa.NEG_INF).all()


def test_b1_varlen_plain_equals_jax():
    q, k, v = _rand(4, 1, 160, 4, 128), _rand(5, 1, 224, 2, 128), \
        _rand(6, 1, 224, 2, 128)
    cu = np.asarray([0, 40, 130, 190, 224], np.int32)
    got = fa.flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), 64,
                           cu_seqlens=torch.from_numpy(cu))
    want = jax.jit(lambda q, k, v: jfa.flash_prefill(
        q, k, v, jnp.int32(64), cu_seqlens=jnp.asarray(cu)))(q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("head_major", [False, True])
@pytest.mark.parametrize("start,q_pos", [(0, 150), (100, 350), (300, 150)],
                         ids=["partial", "whole", "empty"])
def test_b19_plain_equals_jax(start, q_pos, head_major):
    q = _rand(7, 2, 8, 128)
    k, v = _rand(8, 2, 200, 2, 128), _rand(9, 2, 200, 2, 128)
    if head_major:
        k, v = k.transpose(0, 2, 1, 3).copy(), v.transpose(0, 2, 1, 3).copy()
    got = fa.flash_decode_partial(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), start,
                                  torch.tensor(q_pos, dtype=torch.int32),
                                  head_major=head_major)
    want = jax.jit(lambda q, k, v: jfa.flash_decode_partial(
        q, k, v, jnp.int32(start), jnp.int32(q_pos),
        head_major=head_major))(q, k, v)
    _check(got, want)
    if start > q_pos:
        assert not got[0].any() and not got[2].any()
        assert (got[1] == fa.NEG_INF).all()


@pytest.mark.parametrize("method,splits", [("xla", 1), ("pallas", 1),
                                           ("auto", 1), ("xla", 2),
                                           ("pallas", 3)])
def test_local_decode_partial_equals_jax(method, splits):
    """local_decode_partial(_split): kv_splits 3 clamps to 2 on 200 keys;
    "auto" takes B19 at head_dim 128."""
    q = _rand(10, 2, 8, 128)
    k, v = _rand(11, 2, 200, 2, 128), _rand(12, 2, 200, 2, 128)
    got = fd.local_decode_partial_split(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), 40,
        190, method=method, kv_splits=splits)
    want = jax.jit(lambda q, k, v: jfd.local_decode_partial_split(
        q, k, v, jnp.int32(40), jnp.int32(190), method=method,
        kv_splits=splits))(q, k, v)
    _check(got, want)


@pytest.mark.parametrize("n,axis", [(2, 1), (4, 1), (4, 0), (8, 2)])
def test_zigzag_shard_roundtrip_equals_jax(n, axis):
    x = np.arange(2 * 32 * 3 * 16).reshape(
        (32, 2, 3, 16) if axis == 0 else (2, 32, 16, 3) if axis == 1
        else (2, 3, 32, 16))
    z = sp.zigzag_shard(torch.from_numpy(x), n, axis=axis)
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(jsp.zigzag_shard(jnp.asarray(x), n, axis)))
    np.testing.assert_array_equal(
        sp.zigzag_unshard(z, n, axis=axis).numpy(), x)
    with pytest.raises(ValueError):
        sp.zigzag_shard(torch.from_numpy(x), 5, axis=axis)


@pytest.mark.parametrize("cb", [1, 2, 4])
def test_b21_one_card_plain_equals_jax_xla_block(mesh4, cb):
    """plain.ring_attn_shards_ref (B21's plain version over every rank's
    shards in one process, as the one-card world holds the kernel to it)
    for each rank against the JAX XLA_BLOCK tier's rows of that rank."""
    q, k, v = _rand(13, 1, 32, 4, 128), _rand(14, 1, 32, 2, 128), \
        _rand(15, 1, 32, 2, 128)
    ctx = jsp.create_sp_attn_context(mesh4, axis="tp",
                                     method=jsp.SpAttnMethod.XLA_BLOCK,
                                     comm_blocks=cb)
    want = np.asarray(jax.jit(lambda q, k, v: jsp.sp_attention(
        ctx, q, k, v))(q, k, v))
    ks = [torch.from_numpy(k[:, 8 * r:8 * r + 8]) for r in range(4)]
    vs = [torch.from_numpy(v[:, 8 * r:8 * r + 8]) for r in range(4)]
    for r in range(4):
        got = plain.ring_attn_shards_ref(
            torch.from_numpy(q[:, 8 * r:8 * r + 8]), ks, vs, r,
            sp.legal_attn_blocks(8, cb, 4))
        np.testing.assert_allclose(got.numpy(), want[:, 8 * r:8 * r + 8],
                                   err_msg=f"rank {r}", **TOL)


@pytest.mark.parametrize("s_loc,rows", [(32768, 32), (160, 4), (1, 1),
                                        (1000, 512)])
def test_decode_splits_cover_the_shard(s_loc, rows):
    """B19's split plan: 128-key multiples, every key in exactly one
    split, none empty."""
    chunk, splits = decode_splits(s_loc, rows, 132)
    assert chunk % 128 == 0 and chunk * splits >= s_loc
    assert chunk * (splits - 1) < s_loc
