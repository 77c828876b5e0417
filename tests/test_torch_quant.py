"""The PyTorch port's quantized-wire host side against the JAX package:
the wire codecs, the counter-based generator behind the dithered codec,
the error contracts, the lossy-tier policy, B27's plain version and the
KV handoff's host logic. One process, no world (the TP=4 tiers are in
tests/test_torch_quant_world.py).

The codec's scale is an IEEE division (s = amax / 127), as the
reference's source says and as it computes run op by op: the port's bytes
are held bitwise to the reference's codecs called eagerly. Compiled, the
reference multiplies by 1/127 instead, so against ``jax.jit`` of the
codec and the interpret-mode staging kernel each scale is held within one
ulp, and the payload equal wherever the scales agree.
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from triton_dist_tpu.kernels.allreduce import _q8
from triton_dist_tpu.kernels.quant_wire import (
    quantize_stage_per_device as j_quantize_stage,
)
from triton_dist_tpu.quant import codec as jcodec_mod
from triton_dist_tpu.quant import contract as jcontract_mod
from triton_dist_tpu.quant import policy as jpolicy
from triton_dist_tpu_torch.kernels.plain import quantize_stage_ref
from triton_dist_tpu_torch.kernels.quant_wire import (
    quantize_stage_per_device,
)
from triton_dist_tpu_torch.quant import codec as codec_mod
from triton_dist_tpu_torch.quant import contract as contract_mod
from triton_dist_tpu_torch.quant import policy as policy_mod
from triton_dist_tpu_torch.quant.contract import contract_for
from triton_dist_tpu_torch.quant.policy import PolicyState, QuantPolicy
from triton_dist_tpu_torch.runtime import prng
from triton_dist_tpu_torch.runtime.mesh import make_comm_mesh

# the packages export functions of these modules' names
jkv = importlib.import_module("triton_dist_tpu.kernels.kv_handoff")
kvh = importlib.import_module("triton_dist_tpu_torch.kernels.kv_handoff")

SHAPES = {"int8_block": [(8, 64), (3, 100), (2, 4, 48)],
          "int8_stochastic": [(8, 64), (3, 100), (2, 4, 48)],
          "fp8_row": [(8, 64), (3, 100), (2, 4, 48)],
          "kv_int8_page": [(4, 8, 16), (2, 3, 16, 32)],
          "kv_int8_row": [(8, 64), (2, 4, 48)]}
CASES = [(name, shape) for name, shapes in SHAPES.items() for shape in shapes]


@pytest.fixture(autouse=True)
def _clean_policy(monkeypatch):
    monkeypatch.delenv("TD_QUANT", raising=False)
    jpolicy.reset_quant_policy()
    policy_mod.reset_quant_policy()
    yield
    jpolicy.reset_quant_policy()
    policy_mod.reset_quant_policy()


def _draw(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 10.0 ** (seed % 3 - 1)).astype(
        np.float32)
    x[(0,) * (len(shape) - 1)] = 0.0      # an all-zero row (and page row)
    if dtype == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
    return x


def _torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _jnp_np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype == ml_dtypes.float8_e4m3fn else a


# -- codecs ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,shape", CASES)
def test_codec_bytes_equal_eager_jax(name, shape, dtype):
    """encode (q, s) and decode bitwise the reference's codec run op by
    op, on random rows with an all-zero one; the f32 round trip within
    the codec's own bound (plus the f32 product q * s's own rounding,
    half an ulp of |x|)."""
    x = _draw(shape, len(shape) + 7, dtype)
    c, jc = codec_mod.codec(name), jcodec_mod.codec(name)
    q, s = c.encode(_torch(x))
    jq, js = jc.encode(jnp.asarray(x))
    np.testing.assert_array_equal(_np(q), _jnp_np(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = c.decode(q, s, _torch(x).dtype)
    np.testing.assert_array_equal(_np(back), np.asarray(
        jc.decode(jq, js, jnp.asarray(x).dtype)))
    xt = _torch(x).float()
    err = (c.decode(q, s, torch.float32) - xt).abs()
    assert bool((err <= c.err_bound(xt, c.scale_of(xt))
                 + xt.abs() * 2.0 ** -24 + 1e-7).all())


@pytest.mark.parametrize("seed", [0, 1, 2, 9])
def test_encode_vs_compiled_codec_and_staging_kernel(seed):
    """B27's plain version (the CPU side of quantize_stage_per_device)
    against ``jax.jit`` of the int8_block codec and the interpret-mode
    staging kernel: each scale within one ulp (compiled, the reference
    multiplies by 1/127), the payload equal wherever the scales agree."""
    x = _draw((16, 128), seed, "f32")
    q, s = quantize_stage_per_device(_torch(x))
    for jq, js in (jax.jit(jcodec_mod.INT8_BLOCK.encode)(jnp.asarray(x)),
                   j_quantize_stage(True, jnp.asarray(x))):
        ulps = np.abs(s.numpy().view(np.int32).astype(np.int64)
                      - np.asarray(js).view(np.int32))
        assert ulps.max() <= 1, ulps.max()
        same = (ulps == 0)[:, 0]
        np.testing.assert_array_equal(q.numpy()[same], np.asarray(jq)[same])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ring_hop_encode_is_the_codec(dtype):
    """The int8 ring's per-hop quantizer (the reference's _q8: no clip,
    its divisions op by op) gives the bytes of the int8_block encode that
    B27 computes, for finite inputs (|x / s| <= 127 once rounded)."""
    x = _draw((12, 80), 5, dtype).astype(np.float32)
    x[3] *= 1e30
    x[4] *= 1e-30
    q, s = quantize_stage_ref(torch.from_numpy(x))
    jq, js = _q8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_codec_tables_match():
    """The registry, each codec's constants, wire bytes and reduction
    equal the reference's; a dithered and a nearest encode share the
    scale and differ by at most one step."""
    assert sorted(codec_mod.CODECS) == sorted(jcodec_mod.CODECS)
    for name, c in codec_mod.CODECS.items():
        jc = jcodec_mod.CODECS[name]
        assert (c.wire_itemsize, c.scale_block, c.worst_rel_err) == \
            (jc.wire_itemsize, jc.scale_block, jc.worst_rel_err)
        for shp in ((8, 64), (2, 4, 16, 32)):
            assert c.wire_bytes(shp, torch.float32) == \
                jc.wire_bytes(shp, jnp.float32)
            assert c.reduction_vs(shp, torch.bfloat16) == \
                jc.reduction_vs(shp, jnp.bfloat16)
    with pytest.raises(KeyError, match="unknown wire codec"):
        codec_mod.codec("int4")
    x = torch.from_numpy(_draw((16, 128), 5, "f32"))
    (qn, sn), (qs, ss) = (codec_mod.INT8_BLOCK.encode(x),
                          codec_mod.INT8_STOCHASTIC.encode(x))
    assert torch.equal(sn, ss)
    assert (qn.int() - qs.int()).abs().max() <= 1
    assert torch.equal(codec_mod.kv_row_encode(x)[0], qn)


# -- the dither's generator --------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 64), (3, 100), (1,), (7, 5, 3)])
def test_threefry_bitwise_equals_jax_random(shape):
    """PRNGKey, fold_in, the raw 32-bit draws and uniform f32 bitwise
    the reference's generator (threefry-2x32, partitionable layout) for
    the dithered codec's key and another."""
    assert jax.config.jax_threefry_partitionable
    for seed, data in ((0x51, 0xC0DEC), (7, 3)):
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed), data)
        key = prng.fold_in(prng.PRNGKey(seed), data)
        assert key == tuple(int(v) for v in jax.random.key_data(jkey))
        np.testing.assert_array_equal(
            prng.random_bits(key, shape, device="cpu").numpy(),
            np.asarray(jax.random.bits(jkey, shape, jnp.uint32)).astype(
                np.int64))
        np.testing.assert_array_equal(
            prng.uniform(key, shape, device="cpu").numpy().view(np.uint32),
            np.asarray(jax.random.uniform(jkey, shape)).view(np.uint32))
    for seed in (2 ** 40 + 5, -1, 0):
        assert prng.PRNGKey(seed) == tuple(
            int(v) for v in jax.random.key_data(jax.random.PRNGKey(seed)))
    key = prng.PRNGKey(1)
    assert prng.cached_uniform(key, shape, "cpu") is \
        prng.cached_uniform(key, shape, "cpu")


# -- contracts ---------------------------------------------------------------

def test_contract_registry_matches():
    """The nine registered contracts: the same (op, method) keys, codecs
    and event counts as the reference's; every lossy tier has one; an
    unknown tier and a second registration raise."""
    ours, ref = contract_mod.contracts(), jcontract_mod.contracts()
    assert sorted(ours) == sorted(ref) and len(ours) == 9
    for key, c in ours.items():
        assert c.codec_name == ref[key].codec_name
        for n in (1, 2, 4, 8):
            assert c.events(n) == ref[key].events(n)
            assert c.rel_bound(n) == ref[key].rel_bound(n)
    for op, methods in policy_mod.LOSSY_TIERS.items():
        for m in methods:
            contract_for(op, "fp8_row" if m == "quantized" else m)
    with pytest.raises(KeyError, match="no QuantContract"):
        contract_for("allreduce", "fp17")
    with pytest.raises(ValueError, match="registered twice"):
        contract_mod.register_contract(contract_for("allreduce", "qint8"))


@pytest.mark.parametrize("key", sorted(jcontract_mod.contracts()))
def test_contract_budget_and_check_match(key):
    """budget() on the same inputs bitwise the reference's (four ranks'
    terms, or one for a transport tier); check() passes the exact sum and
    raises past the budget."""
    shape = (2, 4, 8, 16) if key[0].startswith("kv_handoff") and \
        key[1] == "kv_int8_page" else (8, 64)
    xs = [_draw(shape, s, "f32") for s in range(4)]
    if key[1] in ("fp8_row", "kv_int8_page", "kv_int8_row"):
        xs = xs[:1]
    c = contract_for(*key)
    got = c.budget([torch.from_numpy(x) for x in xs])
    want = jcontract_mod.contract_for(*key).budget(
        [jnp.asarray(x) for x in xs])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    exact = torch.from_numpy(sum(xs))
    c.check(exact, exact + 0.5 * got, [torch.from_numpy(x) for x in xs])
    with pytest.raises(AssertionError, match="exceeds the contract"):
        c.check(exact, exact + 2.0 * got + 1e-3,
                [torch.from_numpy(x) for x in xs])


# -- policy ------------------------------------------------------------------

STATES = [("off", None), ("always", None), ("error_budget", None),
          ("error_budget", 0.5), ("error_budget", 1e-6),
          ("error_budget", 0.03)]


@pytest.mark.parametrize("policy,budget", STATES)
def test_policy_decisions_match(policy, budget):
    """Every decision of the policy under every state equals the
    reference's on the same call: the upgrade chooser for every lossy
    tier at worlds 1-8 (with and without predicted times), the fallback
    rule, the eligible methods, and the serving paths' choices (GEMM+AR,
    KV page codec, resident pool, EP payload), the state given as an
    argument and installed for the process."""
    jpolicy.set_quant_policy(policy, budget)
    installed = policy_mod.set_quant_policy(policy, budget)
    state = PolicyState(QuantPolicy(policy), installed.error_budget)
    assert installed == state and policy_mod.get_quant_policy() == state
    assert state.error_budget == jpolicy.get_quant_policy().error_budget
    assert policy_mod.LOSSY_TIERS == jpolicy.LOSSY_TIERS
    for op, methods in policy_mod.LOSSY_TIERS.items():
        if op == "ep_dispatch":
            continue
        every = ["auto", "xla", *sorted(methods)]
        assert policy_mod.wire_eligible_methods(op, every) == \
            jpolicy.wire_eligible_methods(op, every)
        for m in sorted(methods):
            for sel in (False, True):
                assert policy_mod.lossy_fallback_ok(
                    op, m, policy_selected=sel) == \
                    jpolicy.lossy_fallback_ok(op, m, policy_selected=sel)
            for world in (1, 2, 4, 8):
                for eligible, pred in ((True, {}), (False, {}), (True, {
                        "predicted_lossless_ms": 1.0,
                        "predicted_quantized_ms": 2.0})):
                    kw = dict(world=world, eligible=eligible, **pred)
                    want = jpolicy.auto_wire_method(op, m, **kw)
                    assert policy_mod.auto_wire_method(
                        op, m, state=state, **kw) == want
                    assert policy_mod.auto_wire_method(op, m, **kw) == want
    for world in (1, 2, 4, 8):
        want = jpolicy.serving_gemm_ar_method(world)
        got = policy_mod.serving_gemm_ar_method(world, state)
        assert (got and got.value) == (want and want.value), world
    for req in (None, "kv_int8_row"):
        assert policy_mod.resolve_kv_page_codec(req, state) == \
            jpolicy.resolve_kv_page_codec(req)
    for req in (None, "auto", "int8", "off"):
        assert policy_mod.resolve_kv_resident(req, state) == \
            jpolicy.resolve_kv_resident(req)
    want = jpolicy.resolve_ep_payload_dtype(None)
    got = policy_mod.resolve_ep_payload_dtype(None, state)
    assert (got is None) == (want is None)
    if got is not None:
        assert got == torch.float8_e4m3fn
    assert policy_mod.resolve_ep_payload_dtype(torch.float8_e5m2, state) \
        == torch.float8_e5m2


def test_policy_process_state_and_env(monkeypatch):
    """With none installed, TD_QUANT is read at each call; an installed
    policy wins until reset; an unknown lossy tier raises."""
    assert policy_mod.get_quant_policy() == PolicyState()
    monkeypatch.setenv("TD_QUANT", "error_budget:0.05")
    assert policy_mod.get_quant_policy() == PolicyState(
        QuantPolicy.ERROR_BUDGET, 0.05)
    policy_mod.set_quant_policy("off")
    assert policy_mod.get_quant_policy() == PolicyState()
    policy_mod.reset_quant_policy()
    assert policy_mod.get_quant_policy().policy == QuantPolicy.ERROR_BUDGET
    monkeypatch.setenv("TD_QUANT", "sorta")
    with pytest.raises(ValueError, match="TD_QUANT"):
        policy_mod.get_quant_policy()
    with pytest.raises(ValueError, match="not a registered lossy"):
        policy_mod.auto_wire_method("allreduce", "fp17", world=4,
                                    state=PolicyState(QuantPolicy.ALWAYS))


# -- the KV handoff's host logic, and the world-1 mesh -----------------------

def test_kv_handoff_host_logic():
    """legalize_comm_blocks exactly the reference's; AUTO is PALLAS on the
    card and XLA on the CPU; methods by value."""
    for rows in range(1, 40):
        for cb in range(0, 12):
            assert kvh.legalize_comm_blocks(rows, cb) == \
                jkv.legalize_comm_blocks(rows, cb)
    assert kvh.resolve_kv_handoff_method("auto", cuda=True) == \
        kvh.KVHandoffMethod.PALLAS
    assert kvh.resolve_kv_handoff_method("auto", cuda=False) == \
        kvh.KVHandoffMethod.XLA
    assert kvh.resolve_kv_handoff_method(kvh.KVHandoffMethod.XLA) == \
        kvh.KVHandoffMethod.XLA
    assert [m.value for m in kvh.KVHandoffMethod] == \
        [m.value for m in jkv.KVHandoffMethod]


def test_world1_mesh_is_on_the_card_unless_asked():
    """make_comm_mesh at world 1 (no process group) takes the card; the
    CPU only when the caller asks for it; without a card the default
    raises instead of falling back."""
    assert make_comm_mesh(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert make_comm_mesh().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_comm_mesh()
