"""The port's ContinuousEngine against the JAX package's, at world 1: the
paged allocator (release, adoption, pins), the frozen-row decode, and the
serving loop's admission, chunked prefill, the MoE model and the
triton_dist_AR mode.

The cases of tests/test_continuous.py that need neither per-request
sampling streams (ROADMAP A2) nor expert parallelism (A10) are split over
this file, tests/test_torch_continuous_prefix.py,
tests/test_torch_continuous_sched.py and
tests/test_torch_continuous_priority.py; each is driven through BOTH engines
(tests/torch_continuous_cases.py) and must leave the two with exactly the
same paged cache state, slots, queue, prefix index and counters after
every operation, and identical greedy tokens per request. The reference
test's own claims are held too, with the port's static Engine as the
ground truth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import needs_interpreter
from torch_continuous_cases import (
    LONG, STATE, both, cache_pair, models, out, same_state, static,
)
from triton_dist_tpu.mega.models.qwen3 import (
    build_qwen3_paged_decode as j_build_qwen3_paged_decode,
)
from triton_dist_tpu.mega.scheduler import schedule_tasks as j_schedule
from triton_dist_tpu.models import tiny_qwen3 as jtiny

from triton_dist_tpu_torch.mega.models.qwen3 import build_qwen3_paged_decode
from triton_dist_tpu_torch.mega.runtime import MegaDecodeRuntime
from triton_dist_tpu_torch.mega.scheduler import POLICIES, schedule_tasks
from triton_dist_tpu_torch.models import ContinuousEngine, tiny_qwen3

pytestmark = needs_interpreter()


def test_free_stack_allocator_roundtrip():
    jc, tc = cache_pair(3, 12)
    ops = [("alloc", [20, 0, 9]), ("release", 0), ("alloc", [0, 16, 0])]
    for op, arg in ops:
        if op == "alloc":
            jc = jc.allocate(jnp.asarray(arg)).advance(jnp.asarray(arg))
            tc = tc.allocate(torch.tensor(arg)).advance(torch.tensor(arg))
        else:
            jc, tc = jc.release(jnp.int32(arg)), tc.release(arg)
        same_state(jc, tc)
    assert int(tc.next_free) == 4 and int(tc.overflow) == 0


def test_refcount_adopt_pin_unpin():
    jc, tc = cache_pair(2, 8)
    jc = jc.allocate(jnp.asarray([16, 0])).advance(jnp.asarray([16, 0]))
    tc = tc.allocate(torch.tensor([16, 0])).advance(torch.tensor([16, 0]))
    ids = tc.block_table[0, :2].tolist()
    jids, tids = jnp.asarray(ids, jnp.int32), torch.tensor(ids,
                                                           dtype=torch.int32)
    padded = ids + [0] * 6
    steps = [
        (lambda c: c.pin_pages(jids, 2), lambda c: c.pin_pages(tids, 2)),
        (lambda c: c.release(jnp.int32(0)), lambda c: c.release(0)),
        (lambda c: c.adopt_prefix(jnp.int32(1), jnp.asarray(padded,
                                                             jnp.int32), 2),
         lambda c: c.adopt_prefix(1, torch.tensor(padded, dtype=torch.int32),
                                  2)),
        (lambda c: c.unpin_pages(jids, 2), lambda c: c.unpin_pages(tids, 2)),
        (lambda c: c.release(jnp.int32(1)), lambda c: c.release(1)),
        (lambda c: c.allocate(jnp.asarray([0, 24])).advance(
            jnp.asarray([0, 24])),
         lambda c: c.allocate(torch.tensor([0, 24])).advance(
             torch.tensor([0, 24]))),
    ]
    free_after = []
    for jop, top in steps:
        jc, tc = jop(jc), top(tc)
        same_state(jc, tc)
        free_after.append(int(tc.next_free))
    assert free_after == [2, 2, 2, 2, 0, 3] and int(tc.overflow) == 0
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        tc.rewind(1)


def test_active_mask_freezes_rows():
    jmodel, jparams, tmodel, tparams = models("dense")
    ids = [[3, 1, 4, 1], [2, 7, 1, 8]]
    jc = jmodel.create_paged_kv_cache(2, page_size=8)
    tc = tmodel.create_paged_kv_cache(2, page_size=8)
    # the JAX model jitted: eager, every op (B2 in interpret mode too)
    # dispatches on its own
    jinfer = jax.jit(jmodel.inference)
    _, jc = jinfer(jparams, jc, jnp.asarray(ids, jnp.int32))
    _, tc = tmodel.inference(tparams, tc, torch.tensor(ids))
    tok, act = [[5], [5]], [True, False]
    jl, jc = jinfer(jparams, jc, jnp.asarray(tok, jnp.int32),
                    active=jnp.asarray(act))
    before = tc.lengths.clone()
    tl, tc = tmodel.inference(tparams, tc, torch.tensor(tok),
                              active=torch.tensor(act))
    assert tc.lengths.tolist() == [int(before[0]) + 1, int(before[1])]
    same_state(jc, tc)
    np.testing.assert_allclose(tc.k_pages.numpy(), np.asarray(jc.k_pages),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0], rtol=1e-4,
                               atol=1e-5)


def test_continuous_matches_static_engine():
    res = both("matches_static")
    assert [o[0] for o in res["done"]] == [0, 1, 2]
    assert out(res) == [static((3, 1, 4, 1, 5), 6), static((2, 7, 1), 4),
                         static((8, 2, 8, 1, 8, 2, 8), 5)]


def test_continuous_eos_and_midstream_submit():
    w0 = static((5, 9, 2, 6), 8)
    res = both("eos_midstream", args=(w0[2],))
    assert out(res) == [w0[:3], static((1, 2, 3), 5)]


def test_admission_defers_on_page_pressure():
    res = both("defers")
    assert out(res) == [static((3, 1, 4, 1, 5), 4), static((2, 7, 1), 4)]
    assert res["refused"]


def test_continuous_moe():
    res = both("moe", kind="moe")
    assert out(res) == [static((3, 1, 4, 1), 4, "moe"),
                         static((2, 7), 3, "moe")]


def test_chunked_prefill_matches_full():
    res = both("chunked")
    assert out(res)[0] == static(tuple(LONG), 5)
    assert len(out(res)[1]) == 3


def test_continuous_mode_ar_parity():
    res = both("mode_ar")
    assert out(res) == [static((3, 1, 4, 1, 5), 4), static((2, 7, 1), 4)]
    _, _, tmodel, tparams = models("dense")
    with pytest.raises(ValueError, match="triton_dist"):
        ContinuousEngine(tmodel, tparams, max_batch=2, mode="triton_dist")


@pytest.mark.parametrize("resident", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("world", [1, 4])
def test_paged_graph_schedule_matches_jax(world, resident):
    """The paged decode graph (one rank's heads at world n, the
    int8-resident variant included) has the reference's tasks, names and
    comm marks, and every schedule policy orders it as the reference
    does."""
    ours = build_qwen3_paged_decode(tiny_qwen3(num_layers=2, tp=4), world,
                                    8, torch.float32, resident=resident)
    ref = j_build_qwen3_paged_decode(jtiny(num_layers=2, tp=4), "tp", world,
                                     8, jnp.float32, resident=resident)

    def shape(g):
        return [(t.task_type, t.layer_id, t.inputs, t.outputs, t.is_comm)
                for t in g.tasks]
    assert shape(ours.graph) == shape(ref.graph)
    assert ours.logits_name == ref.logits_name
    for policy in POLICIES:
        assert schedule_tasks(ours.graph, policy) == j_schedule(ref.graph,
                                                                policy)


@pytest.mark.parametrize("tier", ["xla", "pallas_chain"])
def test_paged_mega_step_equals_layer_path(tier):
    """The paged mega step with an active mask against the layer path's
    paged decode on a copy of the same cache: the xla tier bit for bit,
    the pallas_chain tier (B3, B4 plain versions on the CPU) to f32
    rounding; the allocator state equal."""
    _, _, tmodel, tparams = models("dense")
    caches = [tmodel.create_paged_kv_cache(3, page_size=8) for _ in range(2)]
    ids = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6, 5], [2, 7, 1, 8, 2, 8, 1, 8,
                                                       2], [5] * 9])
    for c in caches:
        tmodel.inference(tparams, c, ids)
    rt = MegaDecodeRuntime(tmodel, method=tier)
    tok, act = torch.tensor([[4], [6], [1]]), torch.tensor([True, False,
                                                           True])
    for _ in range(2):
        want, _ = tmodel.inference(tparams, caches[0], tok, active=act)
        got, _ = rt.step_fn(tier)(tparams, caches[1], tok, act)
        if tier == "xla":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        for k in STATE:
            assert torch.equal(getattr(caches[1], k), getattr(caches[0], k))
