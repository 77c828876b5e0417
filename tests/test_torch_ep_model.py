"""Qwen3 MoE expert-parallel (``moe_parallel="ep"``) at EP=4 in the
PyTorch port against the JAX package.

Four gloo ranks (tests/torch_ep_worker.py, parts "model" and "engine")
run the port on the CPU; the JAX side runs here on the suite's ``mesh4``
(tests/torch_ep_cases.py), its Pallas kernels in interpret mode. The JAX
model's global f32 parameters reach the ranks through numpy.

Held here: the EP parameter shards of ``params_from_numpy(rank, world=4)``
equal the JAX ``put_params`` shards exactly (w_gate_up and w_down cut on
the experts at full width, the router replicated);
``tiny_qwen3_moe(tp=4, num_experts=8, topk=2)`` logits in mode xla and in
triton_dist under XLA, PALLAS and PALLAS_FUSED within 2e-4 of the JAX
model's in the same mode (the JAX PALLAS_FUSED tier does not run here,
see tests/torch_ep_cases.py: the port's is held to the JAX model's XLA and
PALLAS tiers, which compute the same function); a capacity below the
routing's worst case warns; and the greedy tokens of
``Engine(backend="triton_dist")`` under every transport, of
``Engine(model, params)`` at its defaults (the mega step's xla tier: the
expert slabs all-gathered) and of the mega step's pallas_chain tier (the
EP moe task's fused tier, over the default transport and over
PALLAS_FUSED) identical to the JAX Engine's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from torch_ep_cases import (
    E, EP_GEN, EP_LAYERS, TOPK, WORLD, flatten, jax_ep_model, run,
)
from triton_dist_tpu.kernels.ep_a2a import EpA2AMethod as JMethod
from triton_dist_tpu.models import Engine as JEngine
from triton_dist_tpu.models import Qwen3MoE as JQwen3MoE
from triton_dist_tpu.models import init_random_params as jinit
from triton_dist_tpu.models.weights import put_params as jput
from triton_dist_tpu.runtime.compat import tpu_interpreter_available

TD_METHODS = ("xla", "pallas", "pallas_fused")


def _inputs(mesh4):
    import jax
    from triton_dist_tpu.layers import TPContext as JTPContext
    from triton_dist_tpu.models import tiny_qwen3_moe as jtiny_moe
    arch = dataclasses.replace(
        jtiny_moe(num_layers=EP_LAYERS, tp=WORLD, num_experts=E, topk=TOPK),
        moe_parallel="ep")
    params = jinit(jax.random.PRNGKey(17), arch, JTPContext(mesh4, "tp"),
                   jnp.float32)
    raw = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(19)
    inp = {"ids_model": rng.integers(0, arch.vocab_size, (4, 6)).astype(
               np.int32),
           "prompt": rng.integers(0, arch.vocab_size, (4, 5)).astype(
               np.int32)}
    inp.update({f"param/{k}": v for k, v in flatten(raw).items()})
    return arch, raw, inp


def _check_interpreter():
    if not tpu_interpreter_available():
        pytest.skip("this jax lacks the Pallas TPU interpreter")


@pytest.fixture(scope="module")
def ep_model(mesh4, tmp_path_factory):
    _check_interpreter()
    arch, raw, inp = _inputs(mesh4)

    def jax_side():
        arch_, ctx, model, params = jax_ep_model(mesh4, inp)
        ids = jnp.asarray(inp["ids_model"])
        out = {}
        lg, _ = model.inference(params, model.create_kv_cache(4), ids,
                                mode="xla")
        out["logits/xla"] = np.asarray(lg)
        for method in ("xla", "pallas"):
            m = JQwen3MoE(arch_, dataclasses.replace(
                ctx, ep_a2a_method=JMethod(method)), max_length=32,
                dtype=jnp.float32)
            lg, _ = m.inference(params, m.create_kv_cache(4), ids,
                                mode="triton_dist")
            out[f"logits/triton_dist/{method}"] = np.asarray(lg)
        return out

    want, ranks, checks = run(tmp_path_factory.mktemp("ep_model"), "model",
                              inp, jax_side)
    return {"arch": arch, "raw": raw, "jax": want, "ranks": ranks,
            "checks": checks}


@pytest.fixture(scope="module")
def ep_engine(mesh4, tmp_path_factory):
    _check_interpreter()
    _, _, inp = _inputs(mesh4)

    def jax_side():
        _, _, model, params = jax_ep_model(mesh4, inp)
        prompt = jnp.asarray(inp["prompt"])
        out = {"triton_dist": JEngine(
            model, params, temperature=0.0, backend="triton_dist",
            mega="off").serve(prompt, EP_GEN)}
        out["mega_default"] = JEngine(model, params,
                                      temperature=0.0).serve(prompt, EP_GEN)
        out["mega_fused"] = JEngine(model, params, temperature=0.0,
                                    mega="pallas_chain").serve(prompt, EP_GEN)
        return {k: np.asarray(v) for k, v in out.items()}

    want, ranks, checks = run(tmp_path_factory.mktemp("ep_engine"), "engine",
                              inp, jax_side)
    return {"jax": want, "ranks": ranks, "checks": checks}


def _shards(arr):
    import jax
    by_dev = {s.device.id: np.asarray(s.data) for s in
              arr.addressable_shards}
    return [by_dev[d.id] for d in jax.devices()[:WORLD]]


def test_ep_param_shards_equal_jax_put_params(ep_model, mesh4):
    from triton_dist_tpu.layers import TPContext as JTPContext
    put = jput(ep_model["raw"], ep_model["arch"], JTPContext(mesh4, "tp"))
    names = [(k, put[k]) for k in put if k != "layers"] + \
        [(f"layers/{k}", v) for k, v in put["layers"].items()]
    for name, leaf in names:
        for r, want in enumerate(_shards(leaf)):
            got = ep_model["ranks"][r][f"shard/{name}"]
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)
    e = ep_model["arch"].num_experts
    for r in range(WORLD):
        assert ep_model["ranks"][r]["shard/layers/w_gate_up"].shape[1] == \
            e // WORLD
        assert ep_model["ranks"][r]["shard/layers/w_router"].shape[-1] == e


@pytest.mark.parametrize("method", TD_METHODS)
def test_ep_logits_triton_dist_match_jax(ep_model, method):
    """Each rank's rows of the last-position f32 logits in triton_dist
    (its rows dispatched over the transport) within 2e-4 of the JAX
    model's, against each JAX tier that runs here."""
    for jmethod in ("xla", "pallas"):
        want = ep_model["jax"][f"logits/triton_dist/{jmethod}"]
        b = want.shape[0] // WORLD
        for r in range(WORLD):
            np.testing.assert_allclose(
                ep_model["ranks"][r][f"logits/triton_dist/{method}"],
                want[r * b:(r + 1) * b], rtol=2e-4, atol=2e-4,
                err_msg=f"rank {r} vs JAX {jmethod}")


def test_ep_logits_xla_match_jax_and_capacity_warns(ep_model):
    """Mode xla (the expert slabs all-gathered, the whole batch on every
    rank) within 2e-4 of the JAX model; ep_max_m below the worst case
    warns naming TPContext.ep_max_m."""
    for r in range(WORLD):
        np.testing.assert_allclose(ep_model["ranks"][r]["logits/xla"],
                                   ep_model["jax"]["logits/xla"],
                                   rtol=2e-4, atol=2e-4)
        assert ep_model["checks"][r]["small_max_m_warns"] is True


@pytest.mark.parametrize("method", TD_METHODS)
def test_ep_engine_triton_dist_tokens_equal_jax(ep_engine, method):
    """Engine.serve in triton_dist returns the whole batch's greedy tokens
    on every rank, identical to the JAX Engine's."""
    for r in range(WORLD):
        np.testing.assert_array_equal(
            ep_engine["ranks"][r][f"tokens/triton_dist/{method}"],
            ep_engine["jax"]["triton_dist"], err_msg=f"rank {r}")


@pytest.mark.parametrize("path", ["mega_default", "mega_fused",
                                  "mega_fused_b16"])
def test_ep_engine_mega_tokens_equal_jax(ep_engine, path):
    """Engine(model, params) at its defaults (the mega step's xla tier on
    the CPU, on both sides) and on the pallas_chain tier (the EP moe
    task's fused tier: this rank's rows dispatched over the default
    transport, or over PALLAS_FUSED; B3 and B4 as their plain versions
    here, in interpret mode on the JAX side) give the JAX Engine's greedy
    tokens; no rank's own token differed from rank 0's; the fused tier is
    recorded on every layer's moe task."""
    want = ep_engine["jax"]["mega_fused" if path == "mega_fused_b16"
                            else path]
    for r in range(WORLD):
        np.testing.assert_array_equal(ep_engine["ranks"][r][f"tokens/{path}"],
                                      want, err_msg=f"rank {r}")
        c = ep_engine["checks"][r]
        assert c["mega_default_tier"] == "xla"
        assert c["moe_fused_tiers"] == 1
        assert not ep_engine["ranks"][r]["differs/mega_default"].any()
