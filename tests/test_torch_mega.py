"""The port's mega layer (task graph, scheduler, builder, runtime) against
the JAX package's, on the CPU.

Both sides record the dense Qwen3 decode graph for the same architecture
and must give the same tasks and the same schedule order under every
policy. The dense step runs on the same numpy weights (the JAX side on a
one-device mesh, its Pallas kernels in interpret mode), in f32. Tolerances:
the xla tier 1e-5 (f32, the same ops, library summation orders); the
pallas_chain tier 1e-4 (the JAX fused kernels fold in their own order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import needs_interpreter
from triton_dist_tpu.kernels.gemm_allreduce import (
    GemmArMethod as JaxGemmArMethod,
)
from triton_dist_tpu.layers import TPContext as JaxTPContext
from triton_dist_tpu.mega.builder import ModelBuilder as JaxModelBuilder
from triton_dist_tpu.mega.models.qwen3 import (
    build_qwen3_decode as jax_build_qwen3_decode,
)
from triton_dist_tpu.mega.runtime import MegaDecodeRuntime as JaxMegaRuntime
from triton_dist_tpu.mega.scheduler import POLICIES as JAX_POLICIES
from triton_dist_tpu.mega.scheduler import schedule_tasks as jax_schedule
from triton_dist_tpu.models.config import Qwen3Arch as JaxQwen3Arch
from triton_dist_tpu.models.qwen import Qwen3 as JaxQwen3
from triton_dist_tpu.models.weights import put_params
from triton_dist_tpu.quant import policy as jax_policy
from triton_dist_tpu.runtime import make_comm_mesh

from triton_dist_tpu_torch.kernels.gemm_allreduce import (
    GemmArMethod, gemm_ar_per_device, get_auto_gemm_ar_method,
)
from triton_dist_tpu_torch.mega.builder import ModelBuilder
from triton_dist_tpu_torch.mega.models.qwen3 import build_qwen3_decode
from triton_dist_tpu_torch.mega.runtime import (
    MegaDecodeRuntime, MegaMethod, resolve_mega_method,
)
from triton_dist_tpu_torch.mega.scheduler import POLICIES, schedule_tasks
from triton_dist_tpu_torch.models import Qwen3, Qwen3Arch, params_from_numpy
from triton_dist_tpu_torch.models import tiny_qwen3
from triton_dist_tpu_torch.quant.policy import (
    PolicyState, QuantPolicy, serving_gemm_ar_method,
)

from test_torch_engine import _raw_params

TINY = dict(vars(tiny_qwen3(tp=1)))
MAX_LEN = 24
B, T = 2, 5


def _graph_shape(graph):
    return [(t.task_type, t.layer_id, t.inputs, t.outputs, t.is_comm)
            for t in graph.tasks]


@pytest.mark.parametrize("policy", POLICIES)
def test_schedule_order_matches_jax(policy):
    """The same dense graph (names, kinds, comm marks) and the same
    schedule order as the reference under every policy."""
    assert POLICIES == JAX_POLICIES
    arch_kw = dict(TINY, num_layers=2)
    ours = build_qwen3_decode(Qwen3Arch(**arch_kw), 1, torch.float32)
    ref = jax_build_qwen3_decode(JaxQwen3Arch(**arch_kw), "tp", 1,
                                 jnp.float32)
    assert _graph_shape(ours.graph) == _graph_shape(ref.graph)
    assert ours.inputs == ref.inputs and ours.outputs == ref.outputs
    assert ours.logits_name == ref.logits_name
    assert ours.kv_outputs == ref.kv_outputs
    assert schedule_tasks(ours.graph, policy) == \
        jax_schedule(ref.graph, policy)
    assert ours.metrics() == {
        "tasks": len(ref.graph.tasks),
        "comm_tasks": sum(t.is_comm for t in ref.graph.tasks)}


def _dup_input(b):
    b.add_input("x")
    b.add_input("x")


def _unknown_output(b):
    b.add_input("x")
    b.mark_output("nope")


def _dup_output(b):
    b.add_input("x")
    b.mark_output("x")
    b.mark_output("x")


def _waw(b):
    b.graph.add("a", 0, (), ("y",), lambda: 0)
    b.graph.add("b", 0, (), ("y",), lambda: 0)


def _cycle_greedy(b):
    b.graph.add("a", 0, ("y",), ("x",), lambda y: y)
    b.graph.add("b", 0, ("x",), ("y",), lambda x: x)
    b.mark_output("y")
    b.compile(policy="greedy_width")


def _cycle_program(b):
    b.graph.add("a", 0, ("y",), ("x",), lambda y: y)
    b.graph.add("b", 0, ("x",), ("y",), lambda x: x)
    b.mark_output("y")
    b.compile(policy="program")


@pytest.mark.parametrize("case", [_dup_input, _unknown_output, _dup_output,
                                  _waw, _cycle_greedy, _cycle_program],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_builder_loud_errors_match_jax(case):
    """A duplicate input, an unknown or twice-marked output, a name
    produced twice and a cycle raise the reference's error, word for
    word."""
    with pytest.raises(ValueError) as ours:
        case(ModelBuilder())
    with pytest.raises(ValueError) as ref:
        case(JaxModelBuilder(axis="tp"))
    assert str(ours.value) == str(ref.value)


def _models(arch_kw, raw, max_len=MAX_LEN):
    mesh = make_comm_mesh(axes=[("tp", 1)], devices=jax.devices()[:1])
    jarch = JaxQwen3Arch(**arch_kw)
    jmodel = JaxQwen3(jarch, JaxTPContext(mesh, "tp"), max_length=max_len,
                      dtype=jnp.float32)
    jparams = put_params(raw, jarch, jmodel.ctx)
    arch = Qwen3Arch(**arch_kw)
    model = Qwen3(arch, max_length=max_len, dtype=torch.float32,
                  device="cpu")
    params = params_from_numpy(raw, arch, "cpu", torch.float32)
    return jmodel, jparams, model, params


def _prefilled(arch_kw, seed):
    """Both sides prefilled with the same T-token prompt; returns the
    models, params, caches and the pending decode token."""
    arch = Qwen3Arch(**arch_kw)
    raw = _raw_params(arch, seed)
    rng = np.random.default_rng(seed + 1)
    ids = rng.integers(0, arch.vocab_size, (B, T), dtype=np.int32)
    tok = rng.integers(0, arch.vocab_size, (B, 1), dtype=np.int32)
    jmodel, jparams, model, params = _models(arch_kw, raw)
    jcache = jmodel.create_kv_cache(B)
    _, jcache = jmodel.inference(jparams, jcache, jnp.asarray(ids))
    cache = model.create_kv_cache(B)
    _, cache = model.inference(params, cache, torch.from_numpy(ids))
    return jmodel, jparams, jcache, model, params, cache, tok


def test_dense_xla_tier_matches_jax_and_the_layer_path():
    """The xla tier of the dense mega step against the JAX dense_step_fn
    ("xla") on a one-device mesh: logits and cache slabs within 1e-5,
    offsets equal; and bit-identical to the port's own layer-by-layer
    decode step (the same ops in the same order)."""
    jmodel, jparams, jcache, model, params, cache, tok = _prefilled(TINY, 3)
    jrt = JaxMegaRuntime(jmodel, mode="xla", method="xla")
    jl, jc = jax.jit(jrt.dense_step_fn("xla"))(jparams, jcache,
                                               jnp.asarray(tok))

    layer_cache = model.create_kv_cache(B)
    layer_cache.k.copy_(cache.k)
    layer_cache.v.copy_(cache.v)
    layer_cache.offset.copy_(cache.offset)
    rt = MegaDecodeRuntime(model, mode="xla", method="xla")
    assert rt.kind == "qwen3" and rt.method == MegaMethod.XLA
    logits, cache = rt.dense_step_fn("xla")(params, cache,
                                            torch.from_numpy(tok))
    assert logits.dtype == torch.float32 and logits.shape == (B, 256)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jc.k),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jc.v),
                               atol=1e-5, rtol=1e-5)
    assert int(cache.offset) == int(jc.offset) == T + 1
    assert rt.graph_tasks() == len(jrt.dense_builder().graph.tasks)

    want, layer_cache = model.inference(params, layer_cache,
                                        torch.from_numpy(tok))
    assert torch.equal(logits, want)
    assert torch.equal(cache.k, layer_cache.k)
    assert torch.equal(cache.v, layer_cache.v)


@needs_interpreter()
def test_dense_pallas_chain_tier_matches_jax():
    """The pallas_chain tier on CPU tensors (B3's and B4's plain versions)
    against the JAX pallas_chain tier with GemmArMethod.PALLAS, whose B3
    and B4 run in interpret mode at world 1: logits within 1e-4."""
    jmodel, jparams, jcache, model, params, cache, tok = _prefilled(TINY, 5)
    jrt = JaxMegaRuntime(jmodel, mode="xla", method="pallas_chain",
                         gemm_ar_method=JaxGemmArMethod.PALLAS)
    jl, jc = jax.jit(jrt.dense_step_fn("pallas_chain"))(
        jparams, jcache, jnp.asarray(tok))
    rt = MegaDecodeRuntime(model, method="pallas_chain",
                           gemm_ar_method=GemmArMethod.PALLAS)
    assert rt.method == MegaMethod.PALLAS_CHAIN
    logits, cache = rt.dense_step_fn("pallas_chain")(
        params, cache, torch.from_numpy(tok))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jc.k),
                               atol=1e-4, rtol=1e-4)
    assert int(cache.offset) == int(jc.offset)


def test_runtime_methods_dispatch_and_unported_paths():
    """AUTO resolves by device (pallas_chain on CUDA, xla on the CPU);
    dispatch counts and has no fallback; a graph of world n builds; the
    unported paths raise naming their ROADMAP item."""
    assert resolve_mega_method("auto", "cpu") == MegaMethod.XLA
    assert resolve_mega_method("auto", "cuda") == MegaMethod.PALLAS_CHAIN
    assert resolve_mega_method(MegaMethod.XLA, "cuda") == MegaMethod.XLA
    model = Qwen3(Qwen3Arch(**TINY), max_length=8, dtype=torch.float32,
                  device="cpu")
    rt = MegaDecodeRuntime(model)
    assert rt.method == MegaMethod.XLA and rt.graph_tasks() == 0
    assert rt.dispatch(lambda: 7) == 7 and rt.launches == 1

    def boom():
        raise RuntimeError("tier failed")
    with pytest.raises(RuntimeError, match="tier failed"):
        rt.dispatch(boom)
    assert rt.launches == 2
    with pytest.raises(ValueError, match="dense mega program"):
        MegaDecodeRuntime(model, mode="triton_dist").dense_step_fn("xla")
    # a world-n graph records the same tasks as world 1 (its sums run on
    # the ranks' mesh); B4 at world n needs that mesh
    assert _graph_shape(build_qwen3_decode(Qwen3Arch(**TINY), 2).graph) == \
        _graph_shape(build_qwen3_decode(Qwen3Arch(**TINY), 1).graph)
    a, w = torch.ones((2, 8)), torch.ones((8, 4))
    with pytest.raises(ValueError, match="needs the mesh"):
        gemm_ar_per_device(2, GemmArMethod.XLA, a, w)
    # XLA_RING (ring GEMM + RS, then the RING_1D gather) is the product at
    # world 1, as the reference's
    assert torch.equal(gemm_ar_per_device(1, GemmArMethod.XLA_RING, a, w),
                       torch.full((2, 4), 8.0))
    # XLA_QINT8 at world 1 is the lossless product (the reference's rule:
    # the int8 ring needs n > 1 and rows n divides), counted as such
    before = dict(gemm_ar_per_device.qint8_branches)
    assert torch.equal(gemm_ar_per_device(1, GemmArMethod.XLA_QINT8, a, w),
                       torch.full((2, 4), 8.0))
    assert gemm_ar_per_device.qint8_branches == dict(
        before, lossless=before["lossless"] + 1)
    assert get_auto_gemm_ar_method(1, cuda=True) == \
        GemmArMethod.PALLAS
    assert get_auto_gemm_ar_method(1, cuda=False) == \
        GemmArMethod.XLA
    assert torch.equal(
        gemm_ar_per_device(1, GemmArMethod.AUTO, a, w),
        torch.full((2, 4), 8.0))


@pytest.mark.parametrize("policy,budget", [
    ("off", None), ("always", None), ("error_budget", 0.02),
    ("error_budget", 0.001)])
def test_serving_gemm_ar_method_matches_jax(policy, budget):
    """The TD_QUANT policy's choice for the mega graph's projections, at
    worlds 1, 2 and 4 (the bound grows with the world)."""
    state = PolicyState(QuantPolicy(policy), budget or 0.0)
    try:
        jax_policy.set_quant_policy(policy, budget)
        for world in (1, 2, 4):
            want = jax_policy.serving_gemm_ar_method(world)
            got = serving_gemm_ar_method(world, state)
            assert (got.value if got else None) == \
                (want.value if want else None), world
    finally:
        jax_policy.reset_quant_policy()
