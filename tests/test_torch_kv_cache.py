"""The port's PagedKVCache and pool writer against the JAX package.

Integer state (block tables, lengths, free stacks, stack pointer,
overflow, refcounts) must be exactly equal after the same sequence of
calls; f32 page writes are copies, so the pools must be equal too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.models.kv_cache import PagedKVCache as JaxPagedKVCache
from triton_dist_tpu.models.kv_cache import (
    paged_write_layer as jax_paged_write_layer,
)
from triton_dist_tpu.quant import policy as jax_policy

from triton_dist_tpu_torch.models.kv_cache import (
    PagedKVCache, paged_write_layer,
)
from triton_dist_tpu_torch.quant.policy import (
    QuantPolicy, parse_td_quant, resolve_kv_resident,
)

_STATE = ("block_table", "lengths", "free_stack", "next_free", "overflow",
          "ref_count")


def _assert_state_equal(tc, jc):
    for name in _STATE:
        np.testing.assert_array_equal(
            getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
            err_msg=name)


# (op, argument, max_tokens): a ragged prefill, decode steps crossing a page
# boundary, per-row growth with frozen rows, then growth past the pool
# (overflow: the stack position clamps at P-1), a clear, and regrowth
_OPS = [
    ("allocate", 20, None), ("advance", 20, None),
    ("allocate", 12, None), ("advance", 12, None),
    ("allocate", 1, None), ("advance", 1, None),
    ("allocate", [5, 0, 17], 17), ("advance", [5, 0, 17], None),
    ("allocate", [0, 9, 0], None), ("advance", [0, 9, 0], None),
    ("allocate", 40, None), ("advance", 40, None),
    ("clear", None, None),
    ("allocate", [3, 33, 0], 33), ("advance", [3, 33, 0], None),
    ("allocate", 64, None), ("advance", 64, None),
]


@pytest.mark.parametrize("resident", [None, "kv_int8_row"])
def test_allocator_state_exactly_matches_jax(resident):
    kw = dict(num_layers=1, batch=3, max_length=96, local_kv_heads=2,
              head_dim=8, page_size=16, num_pages=9, resident=resident)
    tc = PagedKVCache.create(**kw, dtype=torch.float32)
    jc = JaxPagedKVCache.create(**kw, dtype=jnp.float32)
    _assert_state_equal(tc, jc)
    for op, arg, max_tok in _OPS:
        if op == "clear":
            tc, jc = tc.clear(), jc.clear()
        else:
            targ = (torch.tensor(arg, dtype=torch.int32)
                    if isinstance(arg, list) else arg)
            jarg = jnp.asarray(arg, jnp.int32) if isinstance(arg, list) \
                else arg
            if op == "allocate":
                tc = tc.allocate(targ, max_tokens=max_tok)
                jc = jc.allocate(jarg, max_tokens=max_tok)
            else:
                tc, jc = tc.advance(targ), jc.advance(jarg)
        _assert_state_equal(tc, jc)
    assert int(tc.overflow) > 0            # the sequence did overflow


def test_create_sizing_and_properties_match_jax():
    for resident in (None, "kv_int8_row"):
        for kw in (dict(), dict(num_pages=7),
                   dict(hbm_budget_bytes=1 << 20),
                   dict(hbm_budget_bytes=10)):
            args = (3, 2, 100, 2, 128)
            tc = PagedKVCache.create(*args, page_size=32, resident=resident,
                                     dtype=torch.bfloat16, **kw)
            jc = JaxPagedKVCache.create(*args, page_size=32,
                                        resident=resident,
                                        dtype=jnp.bfloat16, **kw)
            assert tuple(tc.k_pages.shape) == jc.k_pages.shape
            assert str(tc.k_pages.dtype).split(".")[-1] == \
                str(jc.k_pages.dtype)
            assert tc.page_size == jc.page_size
            assert tc.num_pages == jc.num_pages
            assert tc.resident_codec == jc.resident_codec
            assert tc.max_tokens_per_alloc == jc.max_tokens_per_alloc
            assert tc.hbm_bytes_per_token() == jc.hbm_bytes_per_token()
            if resident:
                assert tuple(tc.k_scales.shape) == jc.k_scales.shape
    with pytest.raises(ValueError, match="resident"):
        PagedKVCache.create(1, 1, 8, 1, 8, resident="kv_int4")


@pytest.mark.parametrize("mask", [None, "rows", "tokens"])
def test_paged_write_layer_matches_jax(mask):
    """(B,) frozen-row and (B, T) padded-tail masks write nothing where
    False; everything else lands where the JAX writer puts it."""
    rng = np.random.default_rng(5)
    b, t, hkv, d, ps, num_pages = 3, 5, 2, 8, 4, 10
    table = np.array([[3, 7, 1], [0, 9, 2], [5, 4, 8]], np.int32)
    lengths = np.array([2, 4, 7], np.int32)
    k_new = rng.standard_normal((b, t, hkv, d), np.float32)
    v_new = rng.standard_normal((b, t, hkv, d), np.float32)
    pools = rng.standard_normal((2, hkv, num_pages, ps, d), np.float32)
    active = None
    if mask == "rows":
        active = np.array([True, False, True])
    elif mask == "tokens":
        active = np.arange(t)[None, :] < np.array([[5], [2], [0]])
    lk, lv = torch.from_numpy(pools[0].copy()), torch.from_numpy(
        pools[1].copy())
    paged_write_layer(torch.from_numpy(table), torch.from_numpy(lengths), ps,
                      lk, lv, torch.from_numpy(k_new),
                      torch.from_numpy(v_new),
                      active=None if active is None
                      else torch.from_numpy(active))
    jlk, jlv = jax_paged_write_layer(
        jnp.asarray(table), jnp.asarray(lengths), ps, jnp.asarray(pools[0]),
        jnp.asarray(pools[1]), jnp.asarray(k_new), jnp.asarray(v_new),
        active=None if active is None else jnp.asarray(active))
    np.testing.assert_array_equal(lk.numpy(), np.asarray(jlk))
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
    if mask is not None:
        assert not np.array_equal(lk.numpy(), pools[0])


@pytest.mark.parametrize("raw", ["", "off", "0", "always", "1",
                                 "error_budget", "error_budget:0.001",
                                 "error_budget:0.5"])
def test_td_quant_parse_and_resident_resolution_match_jax(raw):
    state = parse_td_quant(raw)
    jstate = jax_policy._parse_env(raw)
    assert state.policy.value == jstate.policy.value
    assert state.error_budget == jstate.error_budget
    jax_policy.set_quant_policy(jstate.policy.value, jstate.error_budget)
    try:
        for req in (None, "auto", "int8", "off"):
            assert resolve_kv_resident(req, state) == \
                jax_policy.resolve_kv_resident(req)
    finally:
        jax_policy.reset_quant_policy()


def test_td_quant_default_is_off_and_bad_values_raise(monkeypatch):
    monkeypatch.delenv("TD_QUANT", raising=False)
    assert parse_td_quant("").policy == QuantPolicy.OFF
    assert resolve_kv_resident(None) is None
    assert resolve_kv_resident("int8") == "kv_int8_row"
    monkeypatch.setenv("TD_QUANT", "always")
    assert resolve_kv_resident("auto") == "kv_int8_row"
    with pytest.raises(ValueError):
        parse_td_quant("sometimes")
    with pytest.raises(ValueError):
        parse_td_quant("error_budget:x")
    with pytest.raises(ValueError):
        resolve_kv_resident("int4")
