"""The quantized wire of the PyTorch port at TP=4 against the JAX package:
the int8 all-reduce tiers (QINT8_OS, QINT8, QINT8_OS_STOCHASTIC), gemm_ar
XLA_QINT8, the KV page handoff ops and ``tiny_qwen3(tp=4)`` in mode
triton_dist_AR under QINT8_OS.

Four gloo ranks (tests/torch_quant_worker.py) run the port on their shards
of numpy inputs made from a seed; the JAX side runs meanwhile in this
process on ``mesh4`` (its Pallas kernels in interpret mode, every call
once per configuration).

What "equal" means for the lossy tiers, and why. Run op by op, the
reference's math is what its source says: s = amax / 127 as a division,
then q * s and the sum as separate operations. The port computes exactly
that, so each rank's output is held BITWISE to the reference's math run
eagerly (jnp op by op) on the gathered inputs: the codec's encode, the
rank-order fold of B28, the ring's hop order. The reference's own tiers
run compiled (inside shard_map, B28 in interpret mode), and there XLA
computes the scale as amax * (1/127), which moves some scales by one ulp,
and reassociates B28's fold; so against them each rank's output is held
within the tier's QuantContract budget (and the port's output within that
budget of the exact sum). gemm_ar's inputs are integer-valued, so its f32
partials are exact on both sides and only the ring's arithmetic is
compared. The KV moves are pure data movement: byte-equal to the JAX XLA
tier and the interpret-mode PALLAS kernels, at comm_blocks 1 and 4, the
int8 wire's decoded pages included (its encode runs eagerly in the
reference).
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from torch_quant_worker import (
    AR_DTYPES,
    AR_METHODS,
    FANOUTS,
    GAR_ROWS,
    GEN,
    HANDOFF_PAIRS,
    KV_BLOCKS,
    KV_DTYPES,
    KV_METHODS,
    LAYERS,
    MAX_LEN,
)
from torch_world import run_world
from triton_dist_tpu.kernels.allreduce import (
    AllReduceMethod as JArMethod,
    _dq8,
    _q8,
    all_reduce_per_device as j_all_reduce,
)
from triton_dist_tpu.kernels.gemm_allreduce import (
    GemmArMethod as JGarMethod,
    gemm_ar_per_device as j_gemm_ar,
)
from triton_dist_tpu.layers import TPContext as JTPContext
from triton_dist_tpu.models import Qwen3 as JQwen3
from triton_dist_tpu.models import init_random_params as jinit
from triton_dist_tpu.models import tiny_qwen3 as jtiny
from triton_dist_tpu.quant.codec import codec as jcodec
from triton_dist_tpu.runtime.compat import td_shard_map
from triton_dist_tpu_torch.quant.contract import contract_for

# the packages export functions of these modules' names
jkv = importlib.import_module("triton_dist_tpu.kernels.kv_handoff")

WORLD = 4
ROWS = 8                    # rows of each rank's all-reduce x (8 x 64)
CONTRACT = {"qint8_os": ("allreduce", "qint8_os"),
            "qint8": ("allreduce", "qint8"),
            "qint8_os_stochastic": ("allreduce", "qint8_os_stochastic")}


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    return x.astype(ml_dtypes.bfloat16).view(np.uint16)


def _jnp(a: np.ndarray):
    if a.dtype == np.uint16:
        return jnp.asarray(a.view(ml_dtypes.bfloat16))
    return jnp.asarray(a)


def _f32(a) -> np.ndarray:
    """An output as f32 values (uint16 arrays are bf16 bits)."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        a = a.view(ml_dtypes.bfloat16)
    return a.astype(np.float32)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _inputs(params) -> dict:
    rng = np.random.default_rng(1213)
    x = rng.standard_normal((WORLD * ROWS, 64)).astype(np.float32)
    inp = {"ar/f32": x * 3.0,
           "ar/bf16": _bf16_bits(rng.standard_normal((WORLD * ROWS, 64))),
           "gar/b": rng.integers(-2, 3, (WORLD * 16, 32)).astype(np.float32),
           "kv/f32": rng.standard_normal((WORLD * 4, 8, 16)).astype(
               np.float32),
           "kv/bf16": _bf16_bits(rng.standard_normal((WORLD * 4, 8, 16)))}
    for m in GAR_ROWS:
        inp[f"gar/a{m}"] = rng.integers(-2, 3, (m, WORLD * 16)).astype(
            np.float32)
    arch = jtiny(num_layers=LAYERS, tp=WORLD)
    inp["ids"] = rng.integers(0, arch.vocab_size, (4, 6)).astype(np.int32)
    inp.update({f"param/{k}": v for k, v in _flatten(
        jax.tree_util.tree_map(np.asarray, params)).items()})
    return inp


def _ar_tier(mesh4, meth: str, x):
    fn = functools.partial(j_all_reduce, "tp", WORLD, JArMethod(meth), True)
    return jax.jit(td_shard_map(fn, mesh=mesh4, in_specs=P("tp"),
                                out_specs=P("tp"), check_vma=False))(x)


def _gar_tier(mesh4, a, b):
    fn = functools.partial(j_gemm_ar, "tp", WORLD, JGarMethod.XLA_QINT8, 8,
                           128, None)
    return jax.jit(td_shard_map(lambda a_, b_: fn(a_, b_)[None], mesh=mesh4,
                                in_specs=(P(None, "tp"), P("tp", None)),
                                out_specs=P("tp"), check_vma=False))(a, b)


def _jax_side(mesh4, inp, arch, params) -> dict:
    """Every case of the worker through the JAX package on mesh4, once."""
    want = {}
    for dt in AR_DTYPES:
        x = _jnp(inp[f"ar/{dt}"])
        for meth in AR_METHODS:
            want[f"ar/{meth}/{dt}"] = np.asarray(_ar_tier(mesh4, meth, x))
    b = jnp.asarray(inp["gar/b"])
    for m in GAR_ROWS:
        want[f"gar/{m}"] = np.asarray(_gar_tier(
            mesh4, jnp.asarray(inp[f"gar/a{m}"]), b))
    for dt in KV_DTYPES:
        x = _jnp(inp[f"kv/{dt}"])
        for cb in KV_BLOCKS:
            for meth in ("xla", "pallas"):
                kw = dict(method=jkv.KVHandoffMethod(meth), comm_blocks=cb,
                          interpret=True)
                tag = f"{dt}/cb{cb}/{meth}"
                # the moves under jit (one compilation each); the int8
                # wire as the reference runs it, its codec op by op
                for src, dst in HANDOFF_PAIRS:
                    want[f"kv/{src}_{dst}/{tag}"] = _bits(jax.jit(
                        lambda x_, s_=src, d_=dst: jkv.kv_handoff(
                            mesh4, "tp", x_, s_, d_, **kw))(x))
                for i, (src, dsts) in enumerate(FANOUTS):
                    want[f"fan/{i}/{tag}"] = _bits(jax.jit(
                        lambda x_, s_=src, d_=dsts: jkv.kv_handoff_fanout(
                            mesh4, "tp", x_, s_, d_, **kw))(x))
                    want[f"qkv/{i}/{tag}"] = _bits(
                        jkv.kv_handoff_quantized(mesh4, "tp", x, src, dsts,
                                                 **kw))
    ctx = JTPContext(mesh4, "tp", interpret=True,
                     ar_method=JArMethod.QINT8_OS)
    model = JQwen3(arch, ctx, max_length=MAX_LEN, dtype=jnp.float32)
    logits, _ = model.inference(params, model.create_kv_cache(4),
                                jnp.asarray(inp["ids"]),
                                mode="triton_dist_AR")
    want["logits/qint8_os"] = np.asarray(logits)
    lossless = JQwen3(arch, JTPContext(mesh4, "tp"), max_length=MAX_LEN,
                      dtype=jnp.float32)
    logits, _ = lossless.inference(params, lossless.create_kv_cache(4),
                                   jnp.asarray(inp["ids"]),
                                   mode="triton_dist_AR")
    want["logits/xla"] = np.asarray(logits)
    return want


@pytest.fixture(scope="module")
def world4(mesh4, tmp_path_factory):
    """(the inputs, the JAX outputs, the four ranks' outputs and
    checks)."""
    arch = jtiny(num_layers=LAYERS, tp=WORLD)
    params = jinit(jax.random.PRNGKey(12), arch, JTPContext(mesh4, "tp"),
                   jnp.float32)
    inp = _inputs(params)
    want, ranks, checks = run_world(
        "torch_quant_worker.py", tmp_path_factory.mktemp("quant4"), WORLD,
        inp, side=lambda: _jax_side(mesh4, inp, arch, params))
    return inp, want, ranks, checks


# -- the reference's math, op by op ------------------------------------------

def _eager_one_shot(xs, codec_name: str, dtype):
    """B28's definition: every rank's encode, the f32 fold in rank order,
    one cast; the same on every rank."""
    c = jcodec(codec_name)
    acc = jnp.zeros(xs[0].shape, jnp.float32)
    for x in xs:
        q, s = c.encode(x)
        acc = acc + q.astype(jnp.float32) * s
    return [acc.astype(dtype)] * len(xs)


def _eager_ring(xs, dtype):
    """The int8 ring's definition (the reference's _qint8_ring_rs /
    _qint8_ring_ag, each rank's hops written out), with its _q8 / _dq8."""
    n = len(xs)
    rows, d = xs[0].shape
    chunks = [x.astype(jnp.float32).reshape(n, rows // n, d) for x in xs]
    cur = [chunks[r][r] for r in range(n)]
    for s in range(n - 1):
        sent = [_q8(c) for c in cur]
        cur = [_dq8(*sent[(r - 1) % n]) + chunks[r][(r - s - 1) % n]
               for r in range(n)]
    outs = [[None] * n for _ in range(n)]
    q = [_q8(c) for c in cur]
    for r in range(n):
        outs[r][(r + 1) % n] = _dq8(*q[r])
    for s in range(n - 1):
        q = [q[(r - 1) % n] for r in range(n)]
        for r in range(n):
            outs[r][(r - s) % n] = _dq8(*q[r])
    return [jnp.concatenate(o).astype(dtype) for o in outs]


def _eager_ar(meth: str, xs, dtype):
    if meth == "qint8":
        return _eager_ring(xs, dtype)
    return _eager_one_shot(xs, "int8_stochastic" if meth.endswith(
        "stochastic") else "int8_block", dtype)


def _rank_rows(a: np.ndarray, r: int, m: int) -> np.ndarray:
    return a[r * m:(r + 1) * m]


@pytest.mark.parametrize("dt", AR_DTYPES)
@pytest.mark.parametrize("meth", AR_METHODS)
def test_int8_all_reduce_tiers(world4, meth, dt):
    """Each rank's output bitwise the reference's math run eagerly on the
    four ranks' x, the same bytes on every rank, within the tier's
    contract budget of the exact sum and of the compiled JAX tier (in
    bf16 plus the output's own rounding, half a bf16 ulp)."""
    inp, want, ranks, _ = world4
    xs_np = [_rank_rows(inp[f"ar/{dt}"], r, ROWS) for r in range(WORLD)]
    xs = [_jnp(x) for x in xs_np]
    dtype = xs[0].dtype
    eager = _eager_ar(meth, xs, dtype)
    xs_t = [torch.from_numpy(_f32(x)) for x in xs_np]
    exact = sum(xs_t)
    ct = contract_for(*CONTRACT[meth])
    jitted = _f32(want[f"ar/{meth}/{dt}"])
    # a bf16 output carries its final rounding (half a bf16 ulp) on top
    cast = exact.abs() * 2.0 ** -8 if dt == "bf16" else 0.0
    budget = ct.budget(xs_t) + cast + 1e-7
    for r in range(WORLD):
        got = ranks[r][f"ar/{meth}/{dt}"]
        np.testing.assert_array_equal(got, _bits(eager[r]),
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(got, ranks[0][f"ar/{meth}/{dt}"])
        got = torch.from_numpy(_f32(got))
        for ref in (exact, torch.from_numpy(_rank_rows(jitted, r, ROWS))):
            assert bool(((got - ref).abs() <= budget).all()), (
                r, float(((got - ref).abs() - budget).max()))


@pytest.mark.parametrize("m", GAR_ROWS)
def test_gemm_ar_xla_qint8(world4, m):
    """gemm_ar XLA_QINT8 on integer-valued inputs: at M = 16 the f32
    partials ride the int8 ring, bitwise the ring's eager math on the
    exact partials and within the gemm_ar contract of the compiled JAX
    tier; at M = 6 (the world does not divide it) the lossless sum, exact
    on both sides. Each branch counted once a rank."""
    inp, want, ranks, checks = world4
    a, b = inp[f"gar/a{m}"], inp["gar/b"]
    parts = [a[:, r * 16:(r + 1) * 16] @ b[r * 16:(r + 1) * 16]
             for r in range(WORLD)]
    for r in range(WORLD):
        got = ranks[r][f"gar/{m}"]
        if m % WORLD:
            np.testing.assert_array_equal(got, sum(parts))
            np.testing.assert_array_equal(got, want[f"gar/{m}"][r])
            continue
        eager = _eager_ring([jnp.asarray(p) for p in parts], jnp.float32)
        np.testing.assert_array_equal(got, np.asarray(eager[r]))
        contract_for("gemm_ar", "xla_qint8").check(
            torch.tensor(want[f"gar/{m}"][r]), torch.tensor(got),
            [torch.tensor(p) for p in parts])
    assert all(c["gar_branches"] == {"ring": 1, "lossless": 1}
               for c in checks)


@pytest.mark.parametrize("cb", KV_BLOCKS)
@pytest.mark.parametrize("dt", KV_DTYPES)
@pytest.mark.parametrize("op", ["kv", "fan", "qkv"])
def test_kv_handoff_ops_byte_exact(world4, op, dt, cb):
    """kv_handoff (pairs 0 -> 3, 2 -> 1), kv_handoff_fanout and
    kv_handoff_quantized (0 -> {1, 2, 3}; 2 -> {3, 0, 3, 2}, a duplicate
    and src dropped) on every rank, every method: byte-equal to the JAX
    XLA tier and to its interpret-mode PALLAS kernels."""
    _, want, ranks, _ = world4
    cases = ([f"{s}_{d}" for s, d in HANDOFF_PAIRS] if op == "kv"
             else [str(i) for i in range(len(FANOUTS))])
    for case in cases:
        for jmeth in ("xla", "pallas"):
            ref = want[f"{op}/{case}/{dt}/cb{cb}/{jmeth}"]
            for meth in KV_METHODS:
                for r in range(WORLD):
                    np.testing.assert_array_equal(
                        ranks[r][f"{op}/{case}/{dt}/cb{cb}/{meth}"],
                        _rank_rows(ref, r, 4),
                        err_msg=f"{case} {meth} vs JAX {jmeth}, rank {r}")


def test_kv_quantized_within_contract(world4):
    """The int8 wire's destinations hold src's pages within the
    kv_handoff/kv_int8_page contract; every other shard is x, bit for
    bit."""
    inp, _, ranks, _ = world4
    x = inp["kv/f32"]
    ct = contract_for("kv_handoff", "kv_int8_page")
    for i, (src, dsts) in enumerate(FANOUTS):
        page = torch.from_numpy(_rank_rows(x, src, 4))
        for r in range(WORLD):
            got = ranks[r][f"qkv/{i}/f32/cb4/auto"]
            if r in dsts and r != src:
                ct.check(page, torch.from_numpy(got), [page])
            else:
                np.testing.assert_array_equal(got, _rank_rows(x, r, 4))


def test_refusals(world4):
    """QINT8 refuses rows the world does not divide; ranks outside the
    world, an empty fan-out, a rank-2 payload on the int8 wire and a codec
    without a kv_handoff contract raise; src == dst returns x."""
    for c in world4[3]:
        assert all(c["refusals"].values()), c["refusals"]


def test_tiny_qwen3_under_qint8_os(world4):
    """tiny_qwen3(tp=4) f32 in mode triton_dist_AR under QINT8_OS: the
    logits on every rank the same bytes. Against the JAX model in that
    mode (its B28 compiled: scales an ulp apart, a reassociated fold) an
    element of a sum may land one int8 step apart where x / s sits at a
    rounding boundary, and two layers carry that on; so the port's logits
    are held within a quarter of the distance that the int8 wire itself
    puts between the JAX model's logits and its lossless ones (XLA sums),
    elementwise at most, and the same argmax. The Engine serving the same
    ids (its prefill lossless, in mode xla) takes the lossless logits'
    argmax as its first token and decodes through B28's plain version;
    every rank serves the same tokens, and no rank's own token ever
    differed from rank 0's (B28's same bytes make the broadcast a
    no-op)."""
    _, want, ranks, _ = world4
    wire = np.abs(want["logits/qint8_os"] - want["logits/xla"]).max()
    assert wire > 0
    for r in range(WORLD):
        got = ranks[r]["logits/qint8_os"]
        np.testing.assert_array_equal(got, ranks[0]["logits/qint8_os"])
        assert np.abs(got - want["logits/qint8_os"]).max() <= wire / 4, (
            np.abs(got - want["logits/qint8_os"]).max(), wire)
        np.testing.assert_array_equal(got.argmax(-1),
                                      want["logits/qint8_os"].argmax(-1))
        toks = ranks[r]["tokens/qint8_os"]
        assert toks.shape == (4, GEN)
        np.testing.assert_array_equal(toks[:, 0],
                                      want["logits/xla"].argmax(-1))
        np.testing.assert_array_equal(toks, ranks[0]["tokens/qint8_os"])
        differs = ranks[r]["differs/qint8_os"]
        assert differs.shape == (GEN,) and not differs.any()
