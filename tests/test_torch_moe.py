"""The port's MoE slice and its triton_dist forward against the JAX package.

The JAX side runs on a one-device mesh; its fused tiers (B12
``_pallas_matmul``, B14 ``_ag_group_gemm_kernel``, B15 ``_moe_rs_kernel``)
run in interpret mode. On CPU tensors the port's wrappers run their plain
PyTorch versions. Inputs are made with numpy from a seed and handed to
both. Integer outputs (routing ids, schedules) must be equal; f32 results
agree to rtol 1e-4 / atol 1e-5 (library summation orders differ; the top-k
weights to 1e-6); greedy tokens of whole serves must be IDENTICAL.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conftest import needs_interpreter
from triton_dist_tpu.kernels import moe_utils as jmu
from triton_dist_tpu.kernels.allgather_gemm import (
    AgGemmMethod as JaxAgGemmMethod,
)
from triton_dist_tpu.kernels.allgather_gemm import _pallas_matmul
from triton_dist_tpu.kernels.allgather_group_gemm import (
    AgGroupGemmMethod as JaxAgGroupGemmMethod,
)
from triton_dist_tpu.kernels.allgather_group_gemm import (
    ag_group_gemm_per_device as jax_ag_group_gemm,
)
from triton_dist_tpu.kernels.gemm_reduce_scatter import (
    GemmRsMethod as JaxGemmRsMethod,
)
from triton_dist_tpu.kernels.moe_reduce_rs import (
    MoeReduceRsMethod as JaxMoeReduceRsMethod,
)
from triton_dist_tpu.kernels.moe_reduce_rs import (
    moe_reduce_rs_per_device as jax_moe_reduce_rs,
)
from triton_dist_tpu.layers import TPContext as JaxTPContext
from triton_dist_tpu.layers.tp_moe import moe_fwd as jax_moe_fwd
from triton_dist_tpu.mega.models.qwen3 import (
    build_qwen3_decode as jax_build_qwen3_decode,
)
from triton_dist_tpu.mega.scheduler import schedule_tasks as jax_schedule
from triton_dist_tpu.models.config import Qwen3Arch as JaxQwen3Arch
from triton_dist_tpu.models.config import Qwen3MoEArch as JaxQwen3MoEArch
from triton_dist_tpu.models.engine import Engine as JaxEngine
from triton_dist_tpu.models.qwen import Qwen3 as JaxQwen3
from triton_dist_tpu.models.qwen_moe import Qwen3MoE as JaxQwen3MoE
from triton_dist_tpu.models.weights import init_random_params as jax_init
from triton_dist_tpu.models.weights import put_params
from triton_dist_tpu.runtime import make_comm_mesh
from triton_dist_tpu.runtime.compat import td_shard_map

from triton_dist_tpu_torch.kernels import moe_utils
from triton_dist_tpu_torch.kernels.allgather_gemm import (
    AgGemmMethod, ag_gemm_per_device, matmul_ref, pallas_matmul,
)
from triton_dist_tpu_torch.kernels.allgather_group_gemm import (
    AgGroupGemmMethod, ag_group_gemm_per_device, group_gemm,
    resolve_ag_group_gemm_method,
)
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (
    GemmRsMethod, gemm_rs_per_device,
)
from triton_dist_tpu_torch.kernels.moe_reduce_rs import (
    MoeReduceRsMethod, moe_reduce_rs_per_device, moe_rs,
    resolve_moe_reduce_rs_method,
)
from triton_dist_tpu_torch.layers.common import TPContext
from triton_dist_tpu_torch.layers.tp_moe import moe_fwd
from triton_dist_tpu_torch.layers.tp_mlp import mlp_fwd
from triton_dist_tpu_torch.mega.models.qwen3 import build_qwen3_decode
from triton_dist_tpu_torch.mega.scheduler import POLICIES, schedule_tasks
from triton_dist_tpu_torch.models import (
    QWEN3_ARCHS, AutoLLM, Engine, Qwen3, Qwen3Arch, Qwen3MoE, Qwen3MoEArch,
    init_random_params, params_from_numpy, tiny_qwen3, tiny_qwen3_moe,
)
from triton_dist_tpu_torch.models.weights import param_shapes

TOL = dict(rtol=1e-4, atol=1e-5)
B, T, GEN, MAX_LEN = 2, 8, 6, 32


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mesh1():
    return make_comm_mesh(axes=[("tp", 1)], devices=jax.devices()[:1])


def _per_device(fn, *args):
    """Run a JAX per-device function under a one-device shard_map."""
    mesh = _mesh1()
    out = td_shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                       out_specs=P(), check_vma=False)(
        *jax.tree_util.tree_map(jnp.asarray, args))
    return jax.tree_util.tree_map(np.asarray, out)


def _routing(rng, m, topk, e):
    """Distinct expert ids per token (what top-k gives) and f32 weights."""
    ids = np.stack([rng.permutation(e)[:topk] for _ in range(m)])
    w = rng.uniform(0.1, 1.0, (m, topk)).astype(np.float32)
    return ids.astype(np.int32), w / w.sum(-1, keepdims=True)


# -- routing and schedules ----------------------------------------------------

@pytest.mark.parametrize("m,topk,e,bm,n", [
    (4, 8, 128, 32, 1), (6, 2, 16, 8, 1), (16, 2, 4, 8, 2)],
    ids=["decode_shape", "tiny", "two_chunks"])
def test_schedules_match_jax(m, topk, e, bm, n):
    """aligned_chunk_schedule, arrival_ordered_schedule (every legal block
    count) and combine_matrix: every field exactly equal."""
    ids, w = _routing(np.random.default_rng(m * 7 + e), m, topk, e)
    ours = moe_utils.aligned_chunk_schedule(_t(ids), n, e, bm)
    ref = jmu.aligned_chunk_schedule(jnp.asarray(ids), n, e, bm)
    assert ours._fields == ref._fields
    for name, a, b in zip(ours._fields, ours, ref):
        assert a.dtype == torch.int32, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    mc = m // n
    for cb in sorted({1, moe_utils.legal_comm_blocks(mc, 4), mc}):
        assert cb == jmu.legal_comm_blocks(mc, cb)
        s2, ready = moe_utils.arrival_ordered_schedule(ours, mc, bm, cb)
        js2, jready = jmu.arrival_ordered_schedule(ref, mc, bm, cb)
        np.testing.assert_array_equal(ready.numpy(), np.asarray(jready))
        for name, a, b in zip(s2._fields, s2, js2):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{name} cb={cb}")
    if n == 1:    # one block: the arrival order is the identity
        s1, _ = moe_utils.arrival_ordered_schedule(ours, mc, bm, 1)
        assert all(torch.equal(a, b) for a, b in zip(s1, ours))
    g = moe_utils.combine_matrix(_t(w), ours, n)
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(jmu.combine_matrix(jnp.asarray(w), ref, n)))


@pytest.mark.parametrize("norm", [True, False])
def test_route_topk_and_sort_match_jax(norm):
    """route_topk: ids equal, weights to 1e-6; sort_by_expert fields
    equal; grouped_gemm against ragged_dot in both of its forms (rows <= E
    per row, rows > E per expert); reduce_topk."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((12, 16)).astype(np.float32) * 3
    w, ids = moe_utils.route_topk(_t(logits), 4, norm_topk_prob=norm)
    jw, jids = jmu.route_topk(jnp.asarray(logits), 4, norm_topk_prob=norm)
    assert ids.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)
    for m in (3, 12):                        # 12 rows <= 16, 48 rows > 16
        st = moe_utils.sort_by_expert(ids[:m], 16)
        jst = jmu.sort_by_expert(jids[:m], 16)
        for name, a, b in zip(st._fields, st, jst):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
        x = rng.standard_normal((m, 24)).astype(np.float32)
        ew = rng.standard_normal((16, 24, 40)).astype(np.float32)
        lhs = moe_utils.gather_sorted(_t(x), st)
        got = moe_utils.grouped_gemm(lhs, _t(ew), st.group_sizes)
        want = jmu.grouped_gemm(jmu.gather_sorted(jnp.asarray(x), jst),
                                jnp.asarray(ew), jst.group_sizes)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        flat = moe_utils.unsort(got, st)
        np.testing.assert_allclose(
            moe_utils.reduce_topk(flat, w[:m]).numpy(),
            np.asarray(jmu.reduce_topk(jmu.unsort(want, jst), jw[:m])),
            **TOL)


# -- B12, B14, B15: plain versions against the Pallas kernels -----------------

@needs_interpreter()
@pytest.mark.parametrize("m,k,n", [(4, 256, 384), (130, 512, 256)])
def test_b12_plain_matches_jax_pallas_matmul(m, k, n):
    """matmul_ref (and pallas_matmul on CPU tensors, and the triton_dist
    per-device entries at world 1) against _pallas_matmul in interpret
    mode: f32, rtol 1e-4 / atol 1e-5."""
    rng = np.random.default_rng(m + k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    want = np.asarray(_pallas_matmul(256, 256, 512, None, jnp.asarray(a),
                                     jnp.asarray(b)))
    before = pallas_matmul.launches
    for got in (matmul_ref(_t(a), _t(b)), pallas_matmul(_t(a), _t(b)),
                ag_gemm_per_device(1, AgGemmMethod.PALLAS, _t(a), _t(b))[0],
                ag_gemm_per_device(1, AgGemmMethod.XLA_RING, _t(a),
                                   _t(b))[0],
                gemm_rs_per_device(1, GemmRsMethod.PALLAS, _t(a), _t(b)),
                gemm_rs_per_device(1, GemmRsMethod.XLA_BIDIR, _t(a),
                                   _t(b))):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert pallas_matmul.launches == before      # CPU: no kernel launch


@needs_interpreter()
@pytest.mark.parametrize("m,topk,e", [(4, 4, 8), (2, 2, 4)])
def test_b14_plain_matches_jax_pallas(m, topk, e):
    """ag_group_gemm_per_device(PALLAS) at world 1: group_gemm_ref over the
    port's schedule against the Pallas kernel (interpret) over the JAX
    schedule, and the XLA method against the same."""
    rng = np.random.default_rng(m * 10 + e)
    k, n = 32, 48
    ids, _ = _routing(rng, m, topk, e)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ew = (rng.standard_normal((e, k, n)) / np.sqrt(k)).astype(np.float32)
    want, want_ag = _per_device(
        lambda x_, i_, w_: jax_ag_group_gemm(
            "tp", 1, e, JaxAgGroupGemmMethod.PALLAS, x_, i_, w_),
        x, ids, ew)
    for method in (AgGroupGemmMethod.PALLAS, AgGroupGemmMethod.XLA):
        got, ag = ag_group_gemm_per_device(1, e, method, _t(x), _t(ids),
                                           _t(ew))
        assert got.shape == (m * topk, n)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_array_equal(ag.numpy(), want_ag)


@needs_interpreter()
@pytest.mark.parametrize("m,topk,e", [(4, 4, 8), (2, 2, 4)])
def test_b15_plain_matches_jax_pallas(m, topk, e):
    """moe_reduce_rs_per_device(PALLAS) at world 1: moe_rs_ref against the
    Pallas kernel (interpret), and the XLA method against the same."""
    rng = np.random.default_rng(m * 10 + e + 1)
    i_dim, d = 48, 32
    ids, w = _routing(rng, m, topk, e)
    inter = rng.standard_normal((m * topk, i_dim)).astype(np.float32)
    ew = rng.standard_normal((e, i_dim, d)).astype(np.float32) / 7
    want = _per_device(
        lambda a_, i_, w_, e_: jax_moe_reduce_rs(
            "tp", 1, e, topk, JaxMoeReduceRsMethod.PALLAS, a_, i_, w_, e_),
        inter, ids, w, ew)
    for method in (MoeReduceRsMethod.PALLAS, MoeReduceRsMethod.XLA):
        got = moe_reduce_rs_per_device(1, e, topk, method, _t(inter),
                                       _t(ids), _t(w), _t(ew))
        assert got.shape == (m, d) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@needs_interpreter()
@pytest.mark.parametrize("mode", ["xla", "triton_dist"])
def test_moe_fwd_matches_jax(mode):
    """The MoE layer in both modes (triton_dist with the PALLAS methods:
    the plain versions here, the interpret-mode kernels there)."""
    rng = np.random.default_rng(5)
    d, e, im, topk = 64, 8, 32, 2
    x = rng.standard_normal((2, 3, d)).astype(np.float32)
    w = {"w_router": rng.standard_normal((d, e)).astype(np.float32) / 8,
         "w_gate_up": rng.standard_normal((e, d, 2 * im)).astype(
             np.float32) / 8,
         "w_down": rng.standard_normal((e, im, d)).astype(np.float32) / 6}
    ctx = TPContext(moe_ag_method=AgGroupGemmMethod.PALLAS,
                    moe_rs_method=MoeReduceRsMethod.PALLAS)
    got = moe_fwd(mode, ctx, e, topk, True, {k: _t(v) for k, v in w.items()},
                  _t(x))
    jctx = JaxTPContext(_mesh1(), "tp",
                        moe_ag_method=JaxAgGroupGemmMethod.PALLAS,
                        moe_rs_method=JaxMoeReduceRsMethod.PALLAS)
    want = _per_device(
        lambda w_, x_: jax_moe_fwd(mode, jctx, e, topk, True, w_, x_), w, x)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# -- parameters -----------------------------------------------------------------

def test_moe_params_roundtrip_jax_pytree():
    """The JAX MoE parameter pytree (tiny_qwen3_moe, TP=1) exported to
    numpy comes through params_from_numpy bit for bit, with the shapes of
    param_shapes; the port's own random init has the same shapes and
    dtype and is reproducible from its generator."""
    arch = tiny_qwen3_moe(num_layers=2, tp=1)
    jarch = JaxQwen3MoEArch(**vars(arch))
    jparams = jax_init(jax.random.PRNGKey(0), jarch,
                       JaxTPContext(_mesh1(), "tp"), jnp.float32)
    raw = jax.tree_util.tree_map(np.asarray, jparams)
    shapes = param_shapes(arch)
    assert set(shapes["layers"]) == set(raw["layers"])
    assert shapes["layers"]["w_gate_up"] == (2, 16, 128, 128)
    assert shapes["layers"]["w_router"] == (2, 128, 16)
    params = params_from_numpy(raw, arch, "cpu", torch.float32)
    for k, v in raw["layers"].items():
        assert tuple(params["layers"][k].shape) == shapes["layers"][k] \
            == v.shape
        np.testing.assert_array_equal(params["layers"][k].numpy(), v)
    np.testing.assert_array_equal(params["lm_head"].numpy(), raw["lm_head"])
    a = init_random_params(torch.Generator().manual_seed(4), arch, "cpu")
    b = init_random_params(torch.Generator().manual_seed(4), arch, "cpu")
    for k, s in shapes["layers"].items():
        assert tuple(a["layers"][k].shape) == s
        assert a["layers"][k].dtype == torch.bfloat16
        assert torch.equal(a["layers"][k], b["layers"][k])
    with pytest.raises(ValueError, match="w_down"):
        bad = dict(raw, layers=dict(raw["layers"],
                                    w_down=raw["layers"]["w_down"][:, :1]))
        params_from_numpy(bad, arch, "cpu")


@pytest.mark.parametrize("policy", POLICIES)
def test_moe_mega_graph_matches_jax(policy):
    """The MoE decode graph (one "moe" task per layer in place of the
    dense MLP tasks): the reference's task names, kinds, comm marks,
    inputs and outputs, and its schedule order under every policy."""
    arch = tiny_qwen3_moe(num_layers=2, tp=1)
    ours = build_qwen3_decode(arch, 1, torch.float32)
    ref = jax_build_qwen3_decode(JaxQwen3MoEArch(**vars(arch)), "tp", 1,
                                 jnp.float32)
    shape = [[(t.task_type, t.layer_id, t.inputs, t.outputs, t.is_comm)
              for t in g.tasks] for g in (ours.graph, ref.graph)]
    assert shape[0] == shape[1]
    assert sum(t.task_type == "moe" for t in ours.graph.tasks) == 2
    assert ours.inputs == ref.inputs and ours.outputs == ref.outputs
    assert schedule_tasks(ours.graph, policy) == \
        jax_schedule(ref.graph, policy)


# -- whole serves ----------------------------------------------------------------

_PALLAS = dict(ag_method=AgGemmMethod.PALLAS, rs_method=GemmRsMethod.PALLAS,
               moe_ag_method=AgGroupGemmMethod.PALLAS,
               moe_rs_method=MoeReduceRsMethod.PALLAS)
_JAX_PALLAS = dict(ag_method=JaxAgGemmMethod.PALLAS,
                   rs_method=JaxGemmRsMethod.PALLAS,
                   moe_ag_method=JaxAgGroupGemmMethod.PALLAS,
                   moe_rs_method=JaxMoeReduceRsMethod.PALLAS)
_ARCHS = {"moe": tiny_qwen3_moe(num_layers=2, tp=1),
          "dense": tiny_qwen3(num_layers=2, tp=1)}


def _raw_params(arch, seed=7):
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


def _prompt(arch):
    return np.random.default_rng(8).integers(0, arch.vocab_size, (B, T),
                                             dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _jax_tokens(kind, backend, mega):
    """Greedy tokens of the JAX Engine (one run per configuration)."""
    arch = _ARCHS[kind]
    jarch = (JaxQwen3MoEArch if kind == "moe" else JaxQwen3Arch)(
        **vars(arch))
    ctx = JaxTPContext(_mesh1(), "tp", **(
        _JAX_PALLAS if backend == "triton_dist" else {}))
    cls = JaxQwen3MoE if kind == "moe" else JaxQwen3
    model = cls(jarch, ctx, max_length=MAX_LEN, dtype=jnp.float32)
    eng = JaxEngine(model, put_params(_raw_params(arch), jarch, ctx),
                    backend=backend, mega=mega)
    assert (eng._mega_rt is not None) == (backend == "xla" and mega != "off")
    return np.asarray(eng.serve(jnp.asarray(_prompt(arch)), gen_len=GEN))


@needs_interpreter()
@pytest.mark.parametrize("kind,backend,mega", [
    ("moe", "xla", "auto"), ("moe", "triton_dist", "auto"),
    ("moe", "xla", "off"), ("dense", "triton_dist", "auto")],
    ids=["moe_mega_xla", "moe_triton_dist", "moe_mega_off",
         "dense_triton_dist"])
def test_engine_tokens_match_jax(kind, backend, mega):
    """The port's Engine on tiny_qwen3_moe(num_layers=2, tp=1) and dense
    tiny_qwen3(tp=1), f32: greedy tokens IDENTICAL to the JAX Engine with
    the same backend and mega setting (triton_dist with the PALLAS
    methods on both sides)."""
    arch = _ARCHS[kind]
    cls = Qwen3MoE if kind == "moe" else Qwen3
    ctx = TPContext(**(_PALLAS if backend == "triton_dist" else {}))
    model = cls(arch, ctx, max_length=MAX_LEN, dtype=torch.float32,
                device="cpu")
    params = params_from_numpy(_raw_params(arch), arch, "cpu", torch.float32)
    eng = Engine(model, params, backend=backend, mega=mega)
    assert eng.mega_tier == ("xla" if backend == "xla" and mega != "off"
                             else None)
    toks = eng.serve(torch.from_numpy(_prompt(arch)), gen_len=GEN)
    assert toks.shape == (B, GEN) and toks.dtype == torch.int32
    np.testing.assert_array_equal(toks.numpy(),
                                  _jax_tokens(kind, backend, mega))


def test_mlp_hook_leaves_dense_tokens_unchanged():
    """_decoder_stack goes through Qwen3.mlp once per layer per forward;
    routing it through an override that calls mlp_fwd itself gives the
    same tokens."""
    arch = Qwen3Arch(**vars(tiny_qwen3(num_layers=2, tp=1)))
    params = init_random_params(torch.Generator().manual_seed(9), arch,
                                "cpu", torch.float32)
    calls = []

    class Hooked(Qwen3):
        def mlp(self, mode, lw, x):
            calls.append(mode)
            return mlp_fwd(mode, self.ctx, lw, x)

    ids = torch.from_numpy(_prompt(arch))
    want = Engine(Qwen3(arch, max_length=MAX_LEN, dtype=torch.float32,
                        device="cpu"), params, mega="off").serve(ids, GEN)
    got = Engine(Hooked(arch, max_length=MAX_LEN, dtype=torch.float32,
                        device="cpu"), params, mega="off").serve(ids, GEN)
    assert torch.equal(got, want)
    assert len(calls) == arch.num_layers * GEN     # prefill + GEN-1 steps


def test_auto_rules_and_unported_options_raise(monkeypatch):
    """The port's MoE AUTO rule (kernels on CUDA, plain on the CPU, B15
    only up to 1024 tokens a chunk), the native schedule provider, the
    expert-parallel layout now taken (A10's EP half) and what of it stays
    refused, and what world n > 1 needs (its mesh)."""
    assert resolve_ag_group_gemm_method(AgGroupGemmMethod.AUTO, 4, 8,
                                        cuda=True) == AgGroupGemmMethod.PALLAS
    assert resolve_ag_group_gemm_method(AgGroupGemmMethod.AUTO, 4, 8) == \
        AgGroupGemmMethod.XLA
    r = resolve_moe_reduce_rs_method
    assert r(MoeReduceRsMethod.AUTO, 1024, 1, cuda=True) == \
        MoeReduceRsMethod.PALLAS
    assert r(MoeReduceRsMethod.AUTO, 1025, 1, cuda=True) == \
        MoeReduceRsMethod.XLA
    assert r(MoeReduceRsMethod.AUTO, 4, 1) == MoeReduceRsMethod.XLA
    assert r(MoeReduceRsMethod.XLA_RING, 4, 1) == MoeReduceRsMethod.XLA_RING
    ids = torch.zeros((4, 2), dtype=torch.int32)
    sched = moe_utils.make_chunk_schedule(ids, 1, 4, 8)
    # the native provider (the host C++ schedulers) builds the in-graph
    # schedule's live fields (tests/test_torch_native_sched.py holds it
    # to the JAX native provider)
    host = moe_utils.make_chunk_schedule(ids, 1, 4, 8, provider="native")
    assert all(torch.equal(h, g) for name, h, g in zip(
        sched._fields, host, sched) if name != "tile_expert")
    used = int(sched.used_tiles[0])
    assert torch.equal(host.tile_expert[:, :used],
                       sched.tile_expert[:, :used])
    assert moe_utils.make_chunk_schedule(ids, 1, 4, 8, sched) is sched
    a = torch.ones((2, 8))
    # the bidirectional rings run at n > 1 (B11 / B13b), given the mesh
    with pytest.raises(ValueError, match="needs the mesh"):
        ag_gemm_per_device(2, AgGemmMethod.XLA_BIDIR, a, a.T)
    with pytest.raises(ValueError, match="needs the mesh"):
        gemm_rs_per_device(2, GemmRsMethod.PALLAS_BIDIR, a, a.T)
    with pytest.raises(ValueError, match="unresolved"):
        ag_gemm_per_device(1, AgGemmMethod.AUTO, a, a.T)
    with pytest.raises(ValueError, match="needs the mesh"):
        ag_group_gemm_per_device(2, 4, AgGroupGemmMethod.XLA, a, ids,
                                 torch.ones((4, 8, 8)))
    assert r(MoeReduceRsMethod.AUTO, 4, 2) == MoeReduceRsMethod.XLA
    assert r(MoeReduceRsMethod.AUTO, 4, 2, cuda=True) == \
        MoeReduceRsMethod.PALLAS
    big = torch.zeros((1025, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="1024 tokens"):
        moe_reduce_rs_per_device(1, 4, 1, MoeReduceRsMethod.PALLAS,
                                 torch.ones((1025, 8)), big,
                                 torch.ones((1025, 1)), torch.ones((4, 8, 8)))
    # the expert-parallel layout is taken: the context's transport and
    # capacity, the model at world 1; a dcn_axis names A9 (tail), the
    # the error-budget policy on the EP payload, a capacity below 1 raises
    from triton_dist_tpu_torch.kernels.ep_a2a import (
        EpA2AMethod, create_ep_a2a_context,
    )
    from triton_dist_tpu_torch.quant.policy import (
        PolicyState, QuantPolicy, resolve_ep_payload_dtype,
    )
    ctx = TPContext(ep_max_m=64)
    assert (ctx.ep_max_m, ctx.ep_a2a_method) == (64, EpA2AMethod.XLA)
    ep_model = Qwen3MoE(Qwen3MoEArch(moe_parallel="ep"), device="cpu")
    assert ep_model.arch.moe_parallel == "ep"
    with pytest.raises(ValueError, match="ep_max_m"):
        TPContext(ep_max_m=0)
    with pytest.raises(NotImplementedError, match=r"ROADMAP A9 \(tail\)"):
        create_ep_a2a_context(None, 8, 2, 4, dcn_axis="dcn")
    # error_budget judges the ep_dispatch contract (1/16 of the row amax)
    assert resolve_ep_payload_dtype(None, PolicyState(
        QuantPolicy.ERROR_BUDGET, 0.5)) == torch.float8_e4m3fn
    assert resolve_ep_payload_dtype(None, PolicyState(
        QuantPolicy.ERROR_BUDGET, 0.01)) is None
    assert resolve_ep_payload_dtype(None, PolicyState(
        QuantPolicy.ALWAYS)) == torch.float8_e4m3fn
    assert resolve_ep_payload_dtype(None, PolicyState()) is None
    graph = build_qwen3_decode(_ARCHS["moe"], 2).graph
    assert sum(t.task_type == "moe" for t in graph.tasks) == \
        _ARCHS["moe"].num_layers
    big_arch = QWEN3_ARCHS["Qwen/Qwen3-30B-A3B"]
    n_params = sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(
        param_shapes(big_arch), is_leaf=lambda x: isinstance(x, tuple)))
    assert param_shapes(big_arch)["layers"]["w_gate_up"] == \
        (48, 128, 2048, 1536)
    assert 30.4e9 < n_params < 30.6e9           # 61.1 GB in bf16
    monkeypatch.setitem(QWEN3_ARCHS, "tiny/moe", _ARCHS["moe"])
    model, params = AutoLLM.from_pretrained("tiny/moe", device="cpu")
    assert isinstance(model, Qwen3MoE) and model.model_type == "moe"
    assert tuple(params["layers"]["w_router"].shape) == (2, 128, 16)
    for fn in (group_gemm, moe_rs):
        assert fn.launches == 0          # no kernel has run on the CPU
