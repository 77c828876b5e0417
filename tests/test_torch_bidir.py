"""The bidirectional rings of the PyTorch port against the JAX package.

Four gloo ranks (tests/torch_bidir_worker.py, part "bidir") run
``ag_gemm_per_device`` and ``gemm_rs_per_device`` under XLA_BIDIR and
PALLAS_BIDIR (B11 and B13b, whose plain versions serve CPU tensors),
``gemm_ar_per_device`` under XLA_RING, and ``tiny_qwen3(tp=4)``'s greedy
Engine tokens; two more ranks (part "bidir2") run the BIDIR tiers at
world 2, where they are the unidirectional ones. The JAX side runs here on
the suite's ``mesh4`` and on a 2-device mesh of ``jax.devices()[:2]``,
its Pallas kernels in interpret mode. Inputs are made with numpy from
seeds: integer-valued ones compare exactly, random f32 to rtol = atol =
1e-5 (the products are summed in other orders). B13b's plain version
folds the reference kernel's arcs, so it equals the JAX PALLAS_BIDIR
kernel exactly on integer-valued inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triton_dist_tpu.kernels.allgather_gemm import (
    AgGemmMethod as JAgMethod, ag_gemm, create_ag_gemm_context,
)
from triton_dist_tpu.kernels.gemm_allreduce import (
    GemmArMethod as JArMethod, create_gemm_ar_context, gemm_ar,
)
from triton_dist_tpu.kernels.gemm_reduce_scatter import (
    GemmRsMethod as JRsMethod, create_gemm_rs_context, gemm_rs,
)
from triton_dist_tpu.layers import TPContext as JTPContext
from triton_dist_tpu.models import Engine as JEngine
from triton_dist_tpu.models import Qwen3 as JQwen3
from triton_dist_tpu.models import init_random_params as jinit
from triton_dist_tpu.models import tiny_qwen3 as jtiny
from triton_dist_tpu.runtime import make_comm_mesh

from torch_bidir_cases import check, join, op_inputs, spawn
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
from triton_dist_tpu_torch.kernels.plain import bidir_rs_fold

WORLD = 4
LAYERS, MAX_LEN, GEN = 2, 32, 4       # as tests/torch_bidir_worker.py
KINDS = ("int", "rand")


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


_JITTED = {}


def _jitted(mesh, op, method):
    """The JAX mesh-level op under jit, one per (mesh, op, method): the
    integer-valued and random inputs share a shape, so they share one
    compilation."""
    key = (id(mesh), op, method)
    if key not in _JITTED:
        if op == "ag":
            kw = {"bm": 16, "bn": 64} if method == JAgMethod.PALLAS_BIDIR \
                else {}
            ctx = create_ag_gemm_context(mesh, "tp", method=method, **kw)
            _JITTED[key] = jax.jit(lambda a, b: ag_gemm(ctx, a, b))
        elif op == "rs":
            kw = {"bn": 128} if method == JRsMethod.PALLAS_BIDIR else {}
            ctx = create_gemm_rs_context(mesh, "tp", method=method, **kw)
            _JITTED[key] = jax.jit(lambda a, b: gemm_rs(ctx, a, b))
        else:
            ctx = create_gemm_ar_context(mesh, "tp", method=method)
            _JITTED[key] = jax.jit(lambda a, b: gemm_ar(ctx, a, b))
    return _JITTED[key]


def _jax(mesh, op, method, a, b):
    out = _jitted(mesh, op, method)(jnp.asarray(a), jnp.asarray(b))
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def bidir(mesh4, tmp_path_factory):
    """The four ranks' and the two ranks' results, the JAX model on mesh4
    and the JAX tiers on a 2-device mesh."""
    arch = jtiny(num_layers=LAYERS, tp=WORLD)
    ctx = JTPContext(mesh4, "tp", ag_method=JAgMethod.XLA_BIDIR,
                     rs_method=JRsMethod.XLA_BIDIR)
    model = JQwen3(arch, ctx, max_length=MAX_LEN, dtype=jnp.float32)
    params = jinit(jax.random.PRNGKey(13), arch, ctx, jnp.float32)
    rng = np.random.default_rng(8)
    inp = op_inputs(rng, WORLD)
    inp["prompt"] = rng.integers(0, arch.vocab_size, (4, 5)).astype(np.int32)
    raw = jax.tree_util.tree_map(np.asarray, params)
    inp.update({f"param/{k}": v for k, v in _flatten(raw).items()})
    inp2 = op_inputs(np.random.default_rng(9), 2)
    tmp = tmp_path_factory.mktemp("bidir")
    procs4 = spawn(tmp / "w4", "bidir", inp, WORLD)
    procs2 = spawn(tmp / "w2", "bidir2", inp2, 2)
    mesh2 = make_comm_mesh(axes=[("tp", 2)], devices=jax.devices()[:2])
    jx = {}
    for kind in KINDS:
        for m in (JAgMethod.XLA_BIDIR, JAgMethod.PALLAS_BIDIR):
            jx[f"ag/{kind}/{m.value}"] = _jax(
                mesh4, "ag", m, inp[f"ag_a_{kind}"], inp[f"ag_b_{kind}"])
            jx[f"ag2/{kind}/{m.value}"] = _jax(
                mesh2, "ag", m, inp2[f"ag_a_{kind}"], inp2[f"ag_b_{kind}"])
        for m in (JRsMethod.XLA_BIDIR, JRsMethod.PALLAS_BIDIR):
            jx[f"rs/{kind}/{m.value}"] = _jax(
                mesh4, "rs", m, inp[f"rs_a_{kind}"], inp[f"rs_b_{kind}"])
            jx[f"rs2/{kind}/{m.value}"] = _jax(
                mesh2, "rs", m, inp2[f"rs_a_{kind}"], inp2[f"rs_b_{kind}"])
        jx[f"ar/{kind}"] = _jax(mesh4, "ar", JArMethod.XLA_RING,
                                inp[f"ar_a_{kind}"], inp[f"ar_b_{kind}"])
    prompt = jnp.asarray(inp["prompt"])
    jx["tokens/triton_dist"] = np.asarray(JEngine(
        model, params, temperature=0.0, backend="triton_dist",
        mega="off").serve(prompt, GEN))
    jx["tokens/xla"] = np.asarray(JEngine(
        model, params, temperature=0.0, backend="xla",
        mega="off").serve(prompt, GEN))
    ranks, checks = join(procs4, tmp / "w4")
    ranks2, checks2 = join(procs2, tmp / "w2")
    return {"inp": inp, "inp2": inp2, "jax": jx, "ranks": ranks,
            "checks": checks, "ranks2": ranks2, "checks2": checks2}


def _cols(full, r, n):
    w = full.shape[1] // n
    return full[:, r * w:(r + 1) * w]


def _rows(full, r, n):
    m = full.shape[0] // n
    return full[r * m:(r + 1) * m]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("jax_method", ["xla_bidir", "pallas_bidir"])
def test_ag_gemm_bidir_tiers_equal_jax(bidir, kind, jax_method):
    """Per rank, XLA_BIDIR and PALLAS_BIDIR (B11's plain version) equal the
    JAX tier: the gathered A exactly, the product exactly on
    integer-valued inputs, else within 1e-5."""
    c, ag = bidir["jax"][f"ag/{kind}/{jax_method}"]
    for r in range(WORLD):
        for meth in ("xla_bidir", "pallas_bidir"):
            got = bidir["ranks"][r]
            np.testing.assert_array_equal(got[f"ag/{kind}/{meth}/ag"], ag)
            check(got[f"ag/{kind}/{meth}/out"], _cols(c, r, WORLD), kind,
                  f"rank {r} {meth}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("jax_method", ["xla_bidir", "pallas_bidir"])
def test_gemm_rs_bidir_tiers_equal_jax(bidir, kind, jax_method):
    """Per rank, XLA_BIDIR and PALLAS_BIDIR (B13b's plain version, the
    reference kernel's arcs and fold) equal the JAX tier: exactly on
    integer-valued inputs, else within 1e-5."""
    want = bidir["jax"][f"rs/{kind}/{jax_method}"]
    for r in range(WORLD):
        for meth in ("xla_bidir", "pallas_bidir"):
            check(bidir["ranks"][r][f"rs/{kind}/{meth}"],
                  _rows(want, r, WORLD), kind, f"rank {r} {meth}")


@pytest.mark.parametrize("kind", KINDS)
def test_one_card_world_bidir_plain_version_equals_jax_kernel(bidir, kind):
    """``gemm_rs_bidir_ref_shards``, B13b's plain version over every rank's
    shards in one process (the one-card world's), equals the JAX
    PALLAS_BIDIR kernel on mesh4: exactly on integer-valued inputs."""
    inp = bidir["inp"]
    a, b = inp[f"rs_a_{kind}"], inp[f"rs_b_{kind}"]
    kl = a.shape[1] // WORLD
    got = grs.gemm_rs_bidir_ref_shards(
        [torch.from_numpy(a[:, s * kl:(s + 1) * kl].copy())
         for s in range(WORLD)],
        [torch.from_numpy(b[s * kl:(s + 1) * kl].copy())
         for s in range(WORLD)])
    want = bidir["jax"][f"rs/{kind}/pallas_bidir"]
    for r in range(WORLD):
        check(got[r].numpy(), _rows(want, r, WORLD), kind, f"rank {r}")


@pytest.mark.parametrize("n", [3, 4, 5])
def test_bidir_fold_is_the_reference_arcs(n):
    """``bidir_rs_fold`` adds, for rank d's chunk, the right arc's partials
    of ranks d-kr .. d-1 as ((p_{d-kr}) + ...) and the left arc's of
    ranks d+kl .. d+1, then own + right + left: checked on powers of two
    (each rank's partial a distinct bit, so the sum names the ranks) and
    on the order of the adds (a float case where order matters)."""
    m = 2
    parts = [torch.full((n * m, 3), float(2 ** r)) for r in range(n)]
    for d in range(n):
        got = bidir_rs_fold(parts, d)
        assert torch.equal(got, torch.full((m, 3), float(2 ** n - 1)))
    # 1e8 + (-1e8) + 1 in three different orders: the fold's order shows
    big = [torch.full((n * m, 1), v) for v in
           ([1.0, 1e8, -1e8] + [0.0] * (n - 3))]
    kr, kl = n // 2, (n - 1) // 2
    for d in range(n):
        own = big[d][0, 0].item()
        right = [big[(d - kr + j) % n][0, 0].item() for j in range(kr)]
        left = [big[(d + kl - j) % n][0, 0].item() for j in range(kl)]

        def f32(x):
            return np.float32(x)
        acc_r = f32(right[0])
        for v in right[1:]:
            acc_r = f32(v) + acc_r
        want = f32(own) + acc_r
        if left:
            acc_l = f32(left[0])
            for v in left[1:]:
                acc_l = f32(v) + acc_l
            want = want + acc_l
        assert bidir_rs_fold(big, d)[0, 0].item() == float(want)


@pytest.mark.parametrize("kind", KINDS)
def test_gemm_ar_xla_ring_equals_jax(bidir, kind):
    """gemm_ar XLA_RING (the ring GEMM + RS, then the RING_1D all-gather)
    equals the JAX XLA_RING op on every rank; M that the world does not
    divide raises the reference's ValueError."""
    want = bidir["jax"][f"ar/{kind}"]
    for r in range(WORLD):
        check(bidir["ranks"][r][f"ar/{kind}/xla_ring"], want, kind,
              f"rank {r}")
        assert bidir["checks"][r]["ar_xla_ring_odd_m_raises"] is True


@pytest.mark.parametrize("meth", ["xla_bidir", "pallas_bidir"])
def test_engine_bidir_tokens_equal_jax(bidir, meth):
    """``tiny_qwen3(tp=4)`` served in triton_dist with both BIDIR methods
    (B11 and B13b's plain versions for PALLAS_BIDIR) gives every rank the
    JAX Engine's greedy tokens (triton_dist over XLA_BIDIR on mesh4)."""
    want = bidir["jax"]["tokens/triton_dist"]
    for r in range(WORLD):
        np.testing.assert_array_equal(bidir["ranks"][r][f"tokens/{meth}"],
                                      want, err_msg=f"rank {r}")


def test_triton_dist_ar_with_gemm_ar_xla_ring_serves(bidir):
    """triton_dist_AR with gemm_ar_method XLA_RING is a working
    configuration: its greedy tokens equal the JAX Engine's xla tokens
    (the same f32 sums), on every rank; no kernel launched on the CPU."""
    want = bidir["jax"]["tokens/xla"]
    for r in range(WORLD):
        np.testing.assert_array_equal(
            bidir["ranks"][r]["tokens/ar_xla_ring"], want,
            err_msg=f"rank {r}")
        assert bidir["checks"][r]["no_launch_on_cpu"] is True


@pytest.mark.parametrize("kind", KINDS)
def test_world2_pallas_bidir_takes_unidirectional(bidir, kind):
    """At world 2 PALLAS_BIDIR runs B10 / B13a (the BIDIR wrappers are
    never reached) and XLA_BIDIR the right chain alone; both equal the
    JAX tiers on a 2-device mesh."""
    inp2 = bidir["inp2"]
    for r in range(2):
        got = bidir["ranks2"][r]
        assert bidir["checks2"][r]["n2_takes_unidirectional"] is True
        for meth in ("xla_bidir", "pallas_bidir"):
            c, ag = bidir["jax"][f"ag2/{kind}/{meth}"]
            np.testing.assert_array_equal(got[f"ag/{kind}/{meth}/ag"], ag)
            check(got[f"ag/{kind}/{meth}/out"], _cols(c, r, 2), kind, meth)
            want = bidir["jax"][f"rs2/{kind}/{meth}"]
            check(got[f"rs/{kind}/{meth}"], _rows(want, r, 2), kind, meth)
    assert inp2["ag_a_int"].shape[0] == 32
