"""Qwen3 MoE at TP=4 in the PyTorch port against the JAX package.

Four gloo ranks (tests/torch_moe_tp_worker.py, part "model") run the port
on the CPU; the JAX side runs here on the suite's ``mesh4``
(tests/torch_moe_tp_cases.py). The JAX model's global f32 parameters reach
the ranks through numpy.

Held here: the MoE parameter shards of ``params_from_numpy(rank,
world=4)`` equal the JAX ``put_params`` shards exactly (w_gate_up by
[gate | up] groups, w_down by rows, w_router replicated); ``moe_fwd`` in
modes xla, triton_dist_AR and triton_dist (each rank its rows), under the
XLA_RING and PALLAS tiers, within 1e-5 of the JAX layer; ``tiny_qwen3_moe
(tp=4)`` logits in modes xla and triton_dist within 1e-5 of the JAX
model's; the greedy tokens of ``Engine(backend="triton_dist")`` and of
``Engine(model, params)`` at its defaults (the mega step at world 4, its
MoE task the xla tier with the f32 all-reduce) identical to the JAX
Engine's; the ContinuousEngine's run of the continuous TP tests' script
on the MoE model equal to the JAX engine's, step by step; and what stays
refused raises naming its ROADMAP item.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_continuous_worker import (
    ENGINE_KW, LAYERS as CONT_LAYERS, MAX_LEN as CONT_MAX_LEN, run_script,
)
from torch_moe_tp_cases import WORLD, flatten, run
from triton_dist_tpu.layers import TPContext as JTPContext
from triton_dist_tpu.layers.tp_moe import moe_fwd as j_moe_fwd
from triton_dist_tpu.models import ContinuousEngine as JContinuousEngine
from triton_dist_tpu.models import Engine as JEngine
from triton_dist_tpu.models import Qwen3MoE as JQwen3MoE
from triton_dist_tpu.models import init_random_params as jinit
from triton_dist_tpu.models import tiny_qwen3_moe as jtiny_moe
from triton_dist_tpu.models.weights import put_params as jput
from triton_dist_tpu.runtime.compat import td_shard_map

from triton_dist_tpu_torch.kernels import moe_utils
from triton_dist_tpu_torch.kernels.moe_reduce_rs import (
    MoeReduceRsMethod, resolve_moe_reduce_rs_method,
)
from triton_dist_tpu_torch.layers import TPContext
from triton_dist_tpu_torch.models import (
    Qwen3MoE, Qwen3MoEArch, tiny_qwen3_moe,
)
from triton_dist_tpu_torch.runtime.mesh import Mesh

LAYERS, MAX_LEN, GEN = 2, 32, 4       # as tests/torch_moe_tp_worker.py
FWD_MODES = ("xla", "triton_dist_AR", "triton_dist")


def _jax_moe_fwd(mesh, mode, arch, w, x):
    """The JAX layer on mesh4: the weights sharded as the model shards
    them, x replicated (xla, triton_dist_AR) or batch-sharded
    (triton_dist)."""
    ctx = JTPContext(mesh, "tp")
    wspec = {"w_router": P(), "w_gate_up": P(None, None, "tp"),
             "w_down": P(None, "tp", None)}
    xspec = P("tp") if mode == "triton_dist" else P()

    def fn(w_, x_):
        return j_moe_fwd(mode, ctx, arch.num_experts,
                         arch.num_experts_per_tok, arch.norm_topk_prob, w_,
                         x_)

    return np.asarray(td_shard_map(
        fn, mesh=mesh, in_specs=(wspec, xspec), out_specs=xspec,
        check_vma=False)({k: jnp.asarray(v) for k, v in w.items()},
                         jnp.asarray(x)))


@pytest.fixture(scope="module")
def tp(mesh4, tmp_path_factory):
    arch = jtiny_moe(num_layers=LAYERS, tp=WORLD)
    ctx = JTPContext(mesh4, "tp")
    model = JQwen3MoE(arch, ctx, max_length=MAX_LEN, dtype=jnp.float32)
    params = jinit(jax.random.PRNGKey(13), arch, ctx, jnp.float32)
    raw = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(23)
    d, e, im = arch.hidden_size, arch.num_experts, arch.moe_intermediate_size
    inp = {"ids_model": rng.integers(0, arch.vocab_size, (4, 6)).astype(
               np.int32),
           "prompt": rng.integers(0, arch.vocab_size, (4, 5)).astype(
               np.int32),
           "fwd_x": rng.standard_normal((8, 1, d)).astype(np.float32),
           "fwd_w_router": rng.standard_normal((d, e)).astype(np.float32),
           "fwd_w_gate_up": (rng.standard_normal((e, d, 2 * im))
                             * d ** -0.5).astype(np.float32),
           "fwd_w_down": (rng.standard_normal((e, im, d))
                          * im ** -0.5).astype(np.float32)}
    inp.update({f"param/{k}": v for k, v in flatten(raw).items()})
    c_arch = jtiny_moe(num_layers=CONT_LAYERS, tp=WORLD)
    c_ctx = JTPContext(mesh4, "tp", interpret=True)
    c_params = jinit(jax.random.PRNGKey(29), c_arch, c_ctx, jnp.float32)
    inp.update({f"cparam/{k}": v for k, v in flatten(
        jax.tree_util.tree_map(np.asarray, c_params)).items()})

    def jax_side():
        ids = jnp.asarray(inp["ids_model"])
        out = {}
        for mode in ("xla", "triton_dist"):
            lg, _ = model.inference(params, model.create_kv_cache(4), ids,
                                    mode=mode)
            out[f"logits/{mode}"] = np.asarray(lg)
        prompt = jnp.asarray(inp["prompt"])
        out["tokens/triton_dist"] = np.asarray(JEngine(
            model, params, temperature=0.0, backend="triton_dist",
            mega="off").serve(prompt, GEN))
        out["tokens/mega_default"] = np.asarray(JEngine(
            model, params, temperature=0.0).serve(prompt, GEN))
        w = {k[len("fwd_"):]: inp[k] for k in inp if k.startswith("fwd_w")}
        for mode in FWD_MODES:
            out[f"fwd/{mode}"] = _jax_moe_fwd(mesh4, mode, arch, w,
                                              inp["fwd_x"])
        out["continuous"] = run_script(JContinuousEngine(
            JQwen3MoE(c_arch, c_ctx, max_length=CONT_MAX_LEN,
                      dtype=jnp.float32), c_params, temperature=0.0,
            mode="xla", **ENGINE_KW))
        return out

    want, ranks, checks = run(tmp_path_factory.mktemp("moe_tp_model"),
                              "model", inp, jax_side)
    return {"arch": arch, "ctx": ctx, "raw": raw, "jax": want,
            "ranks": ranks, "checks": checks}


def _shards(arr):
    """Rank order of a mesh4 array's shards (device r is rank r)."""
    by_dev = {s.device.id: np.asarray(s.data) for s in
              arr.addressable_shards}
    return [by_dev[d.id] for d in jax.devices()[:WORLD]]


def test_moe_param_shards_equal_jax_put_params(tp):
    put = jput(tp["raw"], tp["arch"], tp["ctx"])
    names = [(k, put[k]) for k in put if k != "layers"] + \
        [(f"layers/{k}", v) for k, v in put["layers"].items()]
    assert {"layers/w_router", "layers/w_gate_up", "layers/w_down"} <= \
        {n for n, _ in names}
    for name, leaf in names:
        for r, want in enumerate(_shards(leaf)):
            got = tp["ranks"][r][f"shard/{name}"]
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("mode", FWD_MODES)
def test_moe_fwd_modes_match_jax(tp, mode):
    want = tp["jax"][f"fwd/{mode}"]
    b = want.shape[0] // WORLD
    for r in range(WORLD):
        for tier in ("xla_ring", "pallas"):
            ref = want[r * b:(r + 1) * b] if mode == "triton_dist" else want
            np.testing.assert_allclose(tp["ranks"][r][f"fwd/{tier}/{mode}"],
                                       ref, rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {tier}")


@pytest.mark.parametrize("mode", ["xla", "triton_dist"])
def test_tp4_moe_logits_match_jax(tp, mode):
    """f32 logits of the last position: xla (the whole batch on every
    rank) and triton_dist (each rank its rows; B14 / B15 across ranks
    under PALLAS), within 1e-5 of the JAX model on mesh4."""
    want = tp["jax"][f"logits/{mode}"]
    b = want.shape[0] // WORLD
    for r in range(WORLD):
        for tier in ("xla_ring", "pallas"):
            got = tp["ranks"][r][f"logits/{tier}/{mode}"]
            ref = want if mode == "xla" else want[r * b:(r + 1) * b]
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {tier}")


@pytest.mark.parametrize("path", ["triton_dist", "mega_default"])
def test_engine_greedy_tokens_equal_jax(tp, path):
    """Engine.serve at TP=4 returns the whole batch's greedy tokens on
    every rank, identical to the JAX Engine's on mesh4: triton_dist under
    XLA_RING and PALLAS, and the Engine's defaults (the mega step, its
    tier xla on the CPU, with no own token differing from rank 0's)."""
    want = tp["jax"][f"tokens/{path}"]
    for r in range(WORLD):
        if path == "mega_default":
            np.testing.assert_array_equal(
                tp["ranks"][r]["tokens/mega_default"], want)
            assert not tp["ranks"][r]["differs/mega_default"].any()
            assert tp["checks"][r]["mega_tier"] == "xla"
            continue
        for tier in ("xla_ring", "pallas"):
            np.testing.assert_array_equal(
                tp["ranks"][r][f"tokens/{tier}/triton_dist"], want,
                err_msg=f"rank {r} {tier}")


def test_continuous_engine_equals_jax(tp):
    """ContinuousEngine on ``tiny_qwen3_moe(tp=4)`` (one layer), mode xla:
    the paged mega graph's moe task with the f32 all-reduce, driven
    through the continuous TP tests' script on every rank. The paged
    cache state, slots and counters after every step, and the greedy
    tokens, equal the JAX ContinuousEngine's on mesh4; a prefix page was
    adopted; no rank's own token differed from rank 0's."""
    jtrace, jdone = tp["jax"]["continuous"]
    for r, c in enumerate(tp["checks"]):
        got = c["continuous"]
        assert len(got["trace"]) == len(jtrace)
        for i, (a, b) in enumerate(zip(got["trace"], jtrace)):
            assert a == b, f"rank {r}: state after step {i} differs"
        assert got["done"] == [list(d) for d in jdone], f"rank {r}"
        assert got["own_token_differs"] == 0
        assert got["mega"] == "xla"
    assert any(d[2] > 0 for d in jdone)


def test_what_stays_refused(tp):
    """The mega graph records one MoE task per layer at world 4;
    AutoLLM.from_pretrained with a TP context gives a Qwen3MoE and the
    rank's shard of the seed-0 weights; B15's PALLAS tier over 1024 tokens
    a chunk, a world > 1 without its mesh, an expert width the world does
    not divide and a triton_dist batch the world does not divide raise;
    the expert-parallel layout (A10's EP half) is taken, and an expert
    count the EP world does not divide raises; the native schedule
    provider builds
    the in-graph schedule at world 4 (its live tiles). AUTO: PALLAS on CUDA up to 1024 tokens a chunk, then XLA_RING at
    world n (XLA at world 1); XLA on the CPU."""
    for r, c in enumerate(tp["checks"]):
        assert c["mega_moe_tasks_at_world_n"] == LAYERS, r
        for key in ("b15_pallas_over_1024_raises", "no_mesh_raises",
                    "odd_width_raises", "odd_batch_raises",
                    "autollm_moe_rank_shard"):
            assert c[key] is True, (r, key)
    ep_model = Qwen3MoE(Qwen3MoEArch(moe_parallel="ep"), device="cpu")
    assert ep_model.arch.moe_parallel == "ep"
    assert TPContext(ep_max_m=64).ep_max_m == 64
    world4 = Mesh(None, "tp", 0, WORLD, torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible by ep world"):
        Qwen3MoE(Qwen3MoEArch(moe_parallel="ep", num_experts=6),
                 TPContext(world4), device="cpu")
    ids = torch.tensor([[0, 3], [1, 2]] * 4, dtype=torch.int32)
    host = moe_utils.make_chunk_schedule(ids, WORLD, 4, 8,
                                         provider="native")
    graph = moe_utils.make_chunk_schedule(ids, WORLD, 4, 8)
    assert all(torch.equal(h, g) for name, h, g in zip(
        graph._fields, host, graph) if name != "tile_expert")
    for c in range(WORLD):
        used = int(graph.used_tiles[c])
        assert torch.equal(host.tile_expert[c, :used],
                           graph.tile_expert[c, :used])
    r = resolve_moe_reduce_rs_method
    assert r(MoeReduceRsMethod.AUTO, WORLD * 1024, WORLD, cuda=True) == \
        MoeReduceRsMethod.PALLAS
    assert r(MoeReduceRsMethod.AUTO, WORLD * 1025, WORLD, cuda=True) == \
        MoeReduceRsMethod.XLA_RING
    assert r(MoeReduceRsMethod.AUTO, 1025, 1, cuda=True) == \
        MoeReduceRsMethod.XLA
    assert r(MoeReduceRsMethod.AUTO, WORLD * 4, WORLD) == \
        MoeReduceRsMethod.XLA
    assert tiny_qwen3_moe(tp=WORLD).moe_intermediate_size % WORLD == 0
