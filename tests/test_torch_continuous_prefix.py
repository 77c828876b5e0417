"""The port's ContinuousEngine against the JAX package's, at world 1: the
prefix cache (adoption, LRU eviction, eviction that skips the arrival's
own prefix, a preempted request adopting its own pages back), the
admission reservation of live growth, and EOS inside a multi-step
decode program.

Each case runs on both engines (tests/torch_continuous_cases.py): the
same paged cache state, slots, queue, prefix index and counters after
every operation, identical greedy tokens per request, and the reference
test's own claims against the port's static Engine.
"""

import pytest

from conftest import needs_interpreter
from torch_continuous_cases import (
    both, static, out, PREFIX,
)

pytestmark = needs_interpreter()


def test_prefix_cache_reuse_matches_static():
    res = both("prefix_reuse")
    assert out(res, "done_a") == [static(tuple(PREFIX + [2, 3]), 4)]
    assert out(res, "done_b") == [static(tuple(PREFIX + [8, 4, 6]), 4)]
    assert res["index_a"] == 2 and res["done_b"][0][2] == 2
    assert res["growth"] <= 1


def test_prefix_cache_eviction_under_pressure():
    res = both("prefix_eviction")
    assert out(res, "done0") == [static((3, 1, 4, 1, 5, 9, 2, 6, 5), 3)]
    assert out(res, "done1") == [static((2, 7, 1, 8, 2, 8, 1, 8, 2), 3)]
    assert res["index0"] == 1 and res["index1"] <= 1


def test_admission_reserves_live_growth():
    res = both("reserves")
    assert out(res) == [static((3, 1, 4, 1, 5), 9),
                         static((2, 7, 1, 8, 2), 9)]


def test_eviction_skips_adoptable_entries():
    res = both("evict_skips_adoptable")
    assert res["freed"] and res["kept"]
    assert out(res) == [static((3, 1, 4, 1, 5, 9, 2, 6, 6, 6), 3)]
    assert res["done"][0][2] == 1


def test_preempt_replay_adopts_own_pages():
    res = both("preempt_adopts")
    assert res["emitted"] >= 2
    assert out(res) == [static(tuple(PREFIX), 6)]
    assert res["done"][0][2] >= 2


def test_decode_steps_eos_parity():
    w0 = static((5, 9, 2, 6), 8)
    res = both("decode_steps_eos", args=(w0[2],))
    assert out(res) == [w0[:3], static((1, 2, 3), 5)]
