"""Shared harness of the ContinuousEngine parity tests
(tests/test_torch_continuous*.py): the port's engine and the JAX package's
driven through the same scenarios on the same numpy-built ``tiny_qwen3``
f32 weights, the JAX side on a one-device mesh (its paged decode kernel B2
in interpret mode), the port on the CPU.

A scenario runs on one ``Side`` (engines of one package) and records,
after every step and every cancel / preempt / eviction, the paged cache
state (block_table, lengths, ref_count, free_stack, next_free, overflow),
the slot occupancy, the queue order, the prefix index and the serving
counters. ``both`` runs a scenario on the two sides (the JAX run once per
process) and holds the records and results equal; ``static`` is the
port's static Engine, the ground truth of the reference's own claims.
The JAX engines share their jitted decode and prefill programs by model,
mode and decode_steps (they close over nothing else).
"""


import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from triton_dist_tpu.layers import TPContext as JTPContext
from triton_dist_tpu.models import ContinuousEngine as JContinuousEngine
from triton_dist_tpu.models import Qwen3 as JQwen3
from triton_dist_tpu.models import Qwen3MoE as JQwen3MoE
from triton_dist_tpu.models.config import Qwen3Arch as JQwen3Arch
from triton_dist_tpu.models.config import Qwen3MoEArch as JQwen3MoEArch
from triton_dist_tpu.models.kv_cache import PagedKVCache as JPagedKVCache
from triton_dist_tpu.models.weights import put_params
from triton_dist_tpu.runtime import make_comm_mesh

from triton_dist_tpu_torch.models import (
    ContinuousEngine, Engine, PagedKVCache, Qwen3, Qwen3MoE,
    params_from_numpy, tiny_qwen3, tiny_qwen3_moe,
)
from triton_dist_tpu_torch.models.weights import param_shapes

MAX_LEN = 64
STATE = ("block_table", "lengths", "ref_count", "free_stack", "next_free",
         "overflow")
COUNTERS = ("submitted", "finished", "cancelled", "preemptions",
            "tokens_out", "decode_batches", "decode_slot_steps",
            "prefill_chunks", "admission_deferrals", "evicted_pages",
            "timed_out", "prefix_pages_adopted")
ARCHS = {"dense": tiny_qwen3(num_layers=2, tp=2),
         "moe": tiny_qwen3_moe(num_layers=1, tp=2, num_experts=4, topk=2)}



def _raw(arch, seed):
    """numpy weights in the reference's layout: matrices ~ N(0, 1/d),
    norm weights near 1."""
    rng = np.random.default_rng(seed)

    def make(name, shape):
        if "norm" in name:
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        return (rng.standard_normal(shape, np.float32)
                * arch.hidden_size ** -0.5)

    shapes = param_shapes(arch)
    raw = {k: make(k, s) for k, s in shapes.items() if k != "layers"}
    raw["layers"] = {k: make(k, s) for k, s in shapes["layers"].items()}
    return raw


@functools.lru_cache(maxsize=None)
def models(kind):
    """(JAX model, JAX params, torch model, torch params) of one arch."""
    arch = ARCHS[kind]
    raw = _raw(arch, 7 if kind == "dense" else 3)
    mesh = make_comm_mesh(axes=[("tp", 1)], devices=jax.devices()[:1])
    ctx = JTPContext(mesh, "tp")
    if kind == "dense":
        jarch = JQwen3Arch(**dataclasses.asdict(arch))
        jmodel = JQwen3(jarch, ctx, max_length=MAX_LEN, dtype=jnp.float32)
        tmodel = Qwen3(arch, max_length=MAX_LEN, dtype=torch.float32,
                       device="cpu")
    else:
        jarch = JQwen3MoEArch(**dataclasses.asdict(arch))
        jmodel = JQwen3MoE(jarch, ctx, max_length=MAX_LEN,
                           dtype=jnp.float32)
        tmodel = Qwen3MoE(arch, max_length=MAX_LEN, dtype=torch.float32,
                          device="cpu")
    return (jmodel, put_params(raw, jarch, ctx), tmodel,
            params_from_numpy(raw, arch, "cpu", torch.float32))


_J_PROGRAMS: dict = {}
# the engine's cache ops, jitted once for every engine (the engine's own
# jit them per instance)
_J_CACHE_OPS = {
    "_release": jax.jit(lambda c, s: c.release(s), donate_argnums=0),
    "_adopt": jax.jit(lambda c, s, ids, n: c.adopt_prefix(s, ids, n),
                      donate_argnums=0),
    "_pin": jax.jit(lambda c, ids, n: c.pin_pages(ids, n),
                    donate_argnums=0),
    "_unpin": jax.jit(lambda c, ids, n: c.unpin_pages(ids, n),
                      donate_argnums=0),
}


def _jax_engine(model, params, **kw):
    """A JAX ContinuousEngine that reuses the jitted decode and prefill
    programs of an earlier engine of the same model, mode and
    decode_steps (they close over nothing else), and shared cache ops."""
    eng = JContinuousEngine(model, params, temperature=0.0, **kw)
    key = (id(model), kw.get("mode", "xla"), kw.get("decode_steps", 1))
    decode, prefill = _J_PROGRAMS.setdefault(
        key, (eng._decode, eng._prefill_cache))
    eng._decode, eng._prefill_cache = decode, prefill
    for name, fn in _J_CACHE_OPS.items():
        setattr(eng, name, fn)
    return eng


class Side:
    """One engine family driven by a scenario: makes engines and records
    their state."""

    def __init__(self, name, model, params):
        self.name, self.model, self.params = name, model, params
        self.trace = []

    def make(self, **kw):
        kw.setdefault("page_size", 8)
        if self.name == "jax":
            return _jax_engine(self.model, self.params, **kw)
        return ContinuousEngine(self.model, self.params, **kw)

    def rec(self, eng, tag):
        st = eng.stats()
        self.trace.append({
            "tag": tag,
            **{k: np.asarray(getattr(eng.cache, k)).tolist() for k in STATE},
            "slots": [None if r is None else r.uid for r in eng.slots],
            "queue": [r.uid for r in eng.queue],
            "index": list(eng._prefix_index.items()),
            **{k: st[k] for k in COUNTERS}})

    def step(self, eng, n=1):
        for _ in range(n):
            eng.step()
            self.rec(eng, "step")

    def run(self, eng):
        while eng.queue or any(r is not None for r in eng.slots):
            self.step(eng)
        return sorted(eng.finished, key=lambda r: r.uid)


def _outs(reqs):
    return [(r.uid, list(r.out), r.adopted_pages, r.timed_out)
            for r in reqs]


# -- the scenarios: one per reference case, run on both sides ---------------

def sc_matches_static(s):
    eng = s.make(max_batch=2)
    for p, g in zip([[3, 1, 4, 1, 5], [2, 7, 1], [8, 2, 8, 1, 8, 2, 8]],
                    [6, 4, 5]):
        eng.submit(p, max_new_tokens=g)
    return {"done": _outs(s.run(eng))}


def sc_eos_midstream(s, eos):
    eng = s.make(max_batch=1)
    eng.submit([5, 9, 2, 6], max_new_tokens=8, eos_id=eos)
    s.step(eng, 2)
    eng.submit([1, 2, 3], max_new_tokens=5)
    return {"done": _outs(s.run(eng))}


def sc_defers(s):
    eng = s.make(max_batch=2, num_pages=2)
    eng.submit([3, 1, 4, 1, 5], max_new_tokens=4)
    eng.submit([2, 7, 1], max_new_tokens=4)
    done = s.run(eng)
    try:
        eng.submit(list(range(17)), max_new_tokens=8)
        refused = False
    except ValueError as e:
        refused = "pages" in str(e)
    return {"done": _outs(done), "refused": refused}


def sc_moe(s):
    eng = s.make(max_batch=2)
    eng.submit([3, 1, 4, 1], max_new_tokens=4)
    eng.submit([2, 7], max_new_tokens=3)
    return {"done": _outs(s.run(eng))}


LONG = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3]     # 18


def sc_chunked(s):
    eng = s.make(max_batch=2, prefill_chunk=8)
    eng.submit(LONG, max_new_tokens=5)
    eng.submit([2, 7, 1], max_new_tokens=3)
    return {"done": _outs(s.run(eng))}


PREFIX = LONG[:16]


def sc_prefix_reuse(s):
    eng = s.make(max_batch=1, prefix_cache=True)
    eng.submit(PREFIX + [2, 3], max_new_tokens=4)
    done_a = _outs(s.run(eng))
    index_a = len(eng._prefix_index)
    used = int(np.asarray(eng.cache.next_free))
    eng.finished.clear()
    eng.submit(PREFIX + [8, 4, 6], max_new_tokens=4)
    done_b = _outs(s.run(eng))
    return {"done_a": done_a, "done_b": done_b, "index_a": index_a,
            "growth": int(np.asarray(eng.cache.next_free)) - used}


def sc_prefix_eviction(s):
    eng = s.make(max_batch=1, num_pages=2, prefix_cache=True)
    eng.submit([3, 1, 4, 1, 5, 9, 2, 6, 5], max_new_tokens=3)
    done0 = _outs(s.run(eng))
    index0 = len(eng._prefix_index)
    eng.finished.clear()
    eng.submit([2, 7, 1, 8, 2, 8, 1, 8, 2], max_new_tokens=3)
    return {"done0": done0, "index0": index0, "done1": _outs(s.run(eng)),
            "index1": len(eng._prefix_index)}


def sc_decode_steps(s):
    outs = {}
    for k in (1, 4, 8):
        eng = s.make(max_batch=2, decode_steps=k)
        for p, g in zip([[3, 1, 4, 1, 5], [2, 7, 1], [8, 2, 8, 1, 8, 2, 8]],
                        [7, 3, 5]):
            eng.submit(p, max_new_tokens=g)
        outs[k] = _outs(s.run(eng))
    return outs


def sc_decode_steps_eos(s, eos):
    eng = s.make(max_batch=1, decode_steps=4)
    eng.submit([5, 9, 2, 6], max_new_tokens=8, eos_id=eos)
    eng.submit([1, 2, 3], max_new_tokens=5)
    return {"done": _outs(s.run(eng))}


def sc_mode_ar(s):
    eng = s.make(max_batch=2, mode="triton_dist_AR", decode_steps=2)
    for p in ([3, 1, 4, 1, 5], [2, 7, 1]):
        eng.submit(p, max_new_tokens=4)
    return {"done": _outs(s.run(eng))}


def sc_reserves(s):
    eng = s.make(max_batch=2, num_pages=3)
    eng.submit([3, 1, 4, 1, 5], max_new_tokens=9)
    eng.submit([2, 7, 1, 8, 2], max_new_tokens=9)
    return {"done": _outs(s.run(eng))}


def sc_evict_skips_adoptable(s):
    pa, pb = [3, 1, 4, 1, 5, 9, 2, 6, 5], [2, 7, 1, 8, 2, 8, 1, 8, 2]
    eng = s.make(max_batch=1, num_pages=3, prefix_cache=True)
    eng.submit(pa, max_new_tokens=3)
    eng.submit(pb, max_new_tokens=3)
    s.run(eng)
    ka, kb = list(eng._prefix_index)
    eng._prefix_index.move_to_end(kb)
    free = eng.cache.num_pages - int(np.asarray(eng.cache.next_free))
    avail = eng._evict_for(free + 1, free,
                           adoptable={eng._prefix_index[ka]})
    s.rec(eng, "evict")
    kept = list(eng._prefix_index) == [ka]
    eng.finished.clear()
    eng.submit(pa[:8] + [6, 6], max_new_tokens=3)
    return {"freed": avail == free + 1, "kept": kept,
            "done": _outs(s.run(eng))}


def sc_cancel(s):
    eng = s.make(max_batch=1, prefill_chunk=4)
    u0 = eng.submit([3, 1, 4, 1, 5], max_new_tokens=8)
    eng.submit([2, 7, 1], max_new_tokens=4)
    uq = eng.submit([8, 2, 8], max_new_tokens=4)
    res = {"cancel_queued": bool(eng.cancel(uq))}
    s.rec(eng, "cancel_queued")
    s.step(eng)
    res["cancel_running"] = bool(eng.cancel(u0))
    s.rec(eng, "cancel_running")
    res["done1"] = _outs(s.run(eng))
    res["cancel_finished"] = eng.cancel(1) is None
    ul = eng.submit(LONG, max_new_tokens=4)
    eng.finished.clear()
    s.step(eng)
    res["mid_prefill"] = eng.slots[0] is not None and eng.slots[0].prefilling
    used = int(np.asarray(eng.cache.next_free))
    res["cancel_prefill"] = bool(eng.cancel(ul))
    s.rec(eng, "cancel_prefill")
    res["reclaimed"] = int(np.asarray(eng.cache.next_free)) < used
    eng.submit([8, 2, 8], max_new_tokens=4)
    res["done2"] = _outs(s.run(eng))
    return res


def sc_preempt(s):
    eng = s.make(max_batch=1)
    u0 = eng.submit([3, 1, 4, 1, 5], max_new_tokens=8)
    s.step(eng, 3)
    res = {"emitted": len(eng.slots[0].out)}
    res["preempt"] = bool(eng.preempt(u0))
    res["again"] = eng.preempt(u0) is None
    s.rec(eng, "preempt")
    eng.submit([2, 7, 1], max_new_tokens=4)
    res["done"] = _outs(s.run(eng))
    res["preemptions"] = eng.stats()["preemptions"]
    e2 = s.make(max_batch=1, prefill_chunk=4)
    ul = e2.submit([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8], max_new_tokens=4)
    s.step(e2)
    res["mid_prefill"] = e2.slots[0] is not None and e2.slots[0].prefilling
    res["preempt_prefill"] = bool(e2.preempt(ul))
    s.rec(e2, "preempt_prefill")
    res["done2"] = _outs(s.run(e2))
    return res


def sc_priority_preempt(s):
    eng = s.make(max_batch=1)
    u_vic = eng.submit([3, 1, 4, 1, 5], max_new_tokens=8)
    s.step(eng, 3)
    u_hot = eng.submit([2, 7, 1], max_new_tokens=3, priority=True)
    res = {"preempt": bool(eng.preempt(u_vic))}
    s.rec(eng, "preempt")
    res["queue"] = [r.uid for r in eng.queue] == [u_hot, u_vic]
    res["done"] = _outs(s.run(eng))
    res["order"] = [r.uid for r in eng.finished]
    return res


def sc_priority_fifo(s):
    p = [3, 1, 4, 1, 5]
    eng = s.make(max_batch=4, num_pages=16)
    for _ in range(4):
        eng.submit([7, 7], max_new_tokens=6)
    s.step(eng)
    ua = eng.submit(p, max_new_tokens=2, priority=True)
    ub = eng.submit(p, max_new_tokens=2, priority=True)
    un = eng.submit(p, max_new_tokens=2)
    res = {"fifo": [r.uid for r in eng.queue] == [ua, ub, un],
           "done": _outs(s.run(eng))}
    e2 = s.make(max_batch=2, num_pages=3)
    u_vic = e2.submit(p, max_new_tokens=9)
    s.step(e2)
    e2.submit([2, 7, 1, 8, 2], max_new_tokens=9, priority=True)
    res["progress"] = e2.ensure_priority_progress() == u_vic
    s.rec(e2, "progress")
    res["done2"] = _outs(s.run(e2))
    res["order2"] = [r.uid for r in e2.finished]
    return res


def sc_preempt_adopts(s):
    eng = s.make(max_batch=1, prefix_cache=True)
    u = eng.submit(PREFIX, max_new_tokens=6)
    s.step(eng, 3)
    res = {"emitted": len(eng.slots[0].out)}
    eng.preempt(u)
    s.rec(eng, "preempt")
    res["done"] = _outs(s.run(eng))
    return res


def sc_timeout(s):
    eng = s.make(max_batch=1)
    eng.submit([3, 1, 4, 1, 5], max_new_tokens=30, timeout_s=1.5)
    eng.submit([2, 7, 1], max_new_tokens=4)
    eng.submit([2, 7, 1], max_new_tokens=4, timeout_s=0.0)
    s.step(eng)
    time.sleep(1.6)
    done = s.run(eng)
    st = eng.stats()
    return {"done": _outs(done), "timed_out": st["timed_out"],
            "cancelled": st["cancelled"]}


@functools.lru_cache(maxsize=None)
def _jax_run(name, kind, args):
    jmodel, jparams, _, _ = models(kind)
    side = Side("jax", jmodel, jparams)
    return side.trace, SCENARIOS[name](side, *args)


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_matches_static, sc_eos_midstream, sc_defers, sc_moe, sc_chunked,
    sc_prefix_reuse, sc_prefix_eviction, sc_decode_steps,
    sc_decode_steps_eos, sc_mode_ar, sc_reserves, sc_evict_skips_adoptable,
    sc_cancel, sc_preempt, sc_priority_preempt, sc_priority_fifo,
    sc_preempt_adopts, sc_timeout)}


def both(name, kind="dense", args=()):
    """Run scenario ``name`` on both engines; hold the traces and results
    equal; return the port's results."""
    jtrace, jres = _jax_run(name, kind, args)
    _, _, tmodel, tparams = models(kind)
    side = Side("torch", tmodel, tparams)
    res = SCENARIOS[name](side, *args)
    assert len(side.trace) == len(jtrace)
    for i, (t, j) in enumerate(zip(side.trace, jtrace)):
        assert t == j, f"{name}: state after op {i} ({t['tag']}) differs"
    assert res == jres
    return res


@functools.lru_cache(maxsize=None)
def static(prompt, gen, kind="dense"):
    """Ground truth: the port's static Engine, batch of one, greedy."""
    _, _, tmodel, tparams = models(kind)
    toks = Engine(tmodel, tparams).serve(torch.tensor([list(prompt)]), gen)
    return [int(x) for x in toks[0]]


def out(res, key="done"):
    """The finished requests' tokens, in uid order."""
    return [o[1] for o in res[key]]


def cache_pair(batch, num_pages):
    """A JAX and a port PagedKVCache of the same small geometry."""
    return (JPagedKVCache.create(1, batch, 64, 1, 8, page_size=8,
                                 num_pages=num_pages, dtype=jnp.float32),
            PagedKVCache.create(1, batch, 64, 1, 8, page_size=8,
                                num_pages=num_pages, dtype=torch.float32))


def same_state(jc, tc):
    """The two caches' allocator state, exactly equal."""
    for k in STATE:
        np.testing.assert_array_equal(np.asarray(getattr(tc, k)),
                                      np.asarray(getattr(jc, k)), err_msg=k)
