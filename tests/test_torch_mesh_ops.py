"""The port's mesh-level collective ops against the JAX package's.

Four gloo ranks (tests/torch_bidir_worker.py, part "mesh") call
``all_gather_op`` for every method and ``ag_gemm(ctx)`` / ``gemm_rs(ctx)``
through their contexts for every method, each rank on its own shards (the
port's mesh-level ops are called by every rank, as its per-device bodies
are); the JAX side runs the same ops here on the suite's ``mesh4``, its
Pallas kernels in interpret mode, under jit. The gathers move bytes, so
they compare exactly; the products exactly on integer-valued f32 inputs,
to rtol = atol = 1e-5 on random ones. The contexts resolve AUTO as the
reference's do (platform-neutral: XLA at world 1, XLA_RING above), and a
context with ``dcn_axis`` (the 2-D schedule) raises naming ROADMAP A9
(tail).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from triton_dist_tpu.kernels.allgather import (
    AllGatherMethod as JGatherMethod, all_gather_op as j_all_gather_op,
)
from triton_dist_tpu.kernels.allgather_gemm import (
    AgGemmMethod as JAgMethod, ag_gemm, create_ag_gemm_context,
)
from triton_dist_tpu.kernels.gemm_reduce_scatter import (
    GemmRsMethod as JRsMethod, create_gemm_rs_context, gemm_rs,
)
from triton_dist_tpu.runtime import make_comm_mesh

from torch_bidir_cases import check, join, op_inputs, spawn
from triton_dist_tpu_torch.kernels import allgather as agk
from triton_dist_tpu_torch.kernels import allgather_gemm as agm
from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
from triton_dist_tpu_torch.runtime import mesh as tp_mesh

WORLD = 4
KINDS = ("int", "rand")
# every method of the port; AUTO resolves to XLA_RING at world 4 on both
# sides (test_contexts_resolve_as_the_reference), so it is held to the
# JAX XLA_RING op
METHODS = ("auto", "xla", "xla_ring", "xla_bidir", "pallas", "pallas_bidir")
GATHER_METHODS = ("xla", "ring_1d", "full_mesh", "auto")


def _jax_op(mesh, op, method):
    jm = "xla_ring" if method == "auto" else method
    if op == "ag":
        kw = {"bm": 16, "bn": 64} if jm.startswith("pallas") else {}
        ctx = create_ag_gemm_context(mesh, "tp", method=JAgMethod(jm), **kw)
        return jax.jit(lambda a, b: ag_gemm(ctx, a, b))
    kw = {"bn": 128} if jm.startswith("pallas") else {}
    ctx = create_gemm_rs_context(mesh, "tp", method=JRsMethod(jm), **kw)
    return jax.jit(lambda a, b: gemm_rs(ctx, a, b))


@pytest.fixture(scope="module")
def ops(mesh4, tmp_path_factory):
    rng = np.random.default_rng(21)
    inp = op_inputs(rng, WORLD)
    inp["gather_x"] = rng.standard_normal((8 * WORLD, 96)).astype(np.float32)
    inp["gather_x3"] = rng.standard_normal((8 * WORLD, 2, 48)).astype(
        np.float32)
    tmp = tmp_path_factory.mktemp("mesh_ops")
    procs = spawn(tmp, "mesh", inp, WORLD)
    jx = {}
    for name in ("x", "x3"):
        x = inp[f"gather_{name}"]
        for meth in GATHER_METHODS:
            # the JAX ring kernels take 2-D shards: 3-D rows go flat
            flat = meth in ("ring_1d", "full_mesh")
            got = np.asarray(j_all_gather_op(
                mesh4, "tp", jnp.asarray(x.reshape(x.shape[0], -1) if flat
                                         else x), JGatherMethod(meth)))
            jx[f"gather/{name}/{meth}"] = got.reshape(x.shape)
    for op in ("ag", "rs"):
        for meth in METHODS:
            fn = _jax_op(mesh4, op, meth)
            for kind in KINDS:
                res = fn(jnp.asarray(inp[f"{op}_a_{kind}"]),
                         jnp.asarray(inp[f"{op}_b_{kind}"]))
                jx[f"{op}/{kind}/{meth}"] = jax.tree_util.tree_map(
                    np.asarray, res)
    ranks, checks = join(procs, tmp)
    return {"inp": inp, "jax": jx, "ranks": ranks, "checks": checks}


@pytest.mark.parametrize("meth", GATHER_METHODS)
def test_all_gather_op_equals_jax(ops, meth):
    """Every rank's ``all_gather_op`` (XLA: the process group's gather;
    RING_1D: B7's plain version; FULL_MESH: B8's; AUTO: XLA on the CPU)
    returns the JAX op's rows exactly, for 2-D and 3-D shards."""
    for name in ("x", "x3"):
        want = ops["jax"][f"gather/{name}/{meth}"]
        for r in range(WORLD):
            got = ops["ranks"][r][f"gather/{name}/{meth}"]
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("meth", METHODS)
def test_ag_gemm_ctx_equals_jax(ops, meth, kind):
    """``ag_gemm(ctx, a, b)`` on every rank's shards: the gathered A the
    JAX op's exactly, the rank's columns of the product exactly on
    integer-valued inputs, else within 1e-5."""
    c, ag = ops["jax"][f"ag/{kind}/{meth}"]
    nl = c.shape[1] // WORLD
    for r in range(WORLD):
        got = ops["ranks"][r]
        np.testing.assert_array_equal(got[f"ag/{kind}/{meth}/ag"], ag)
        check(got[f"ag/{kind}/{meth}/out"], c[:, r * nl:(r + 1) * nl], kind,
              f"rank {r}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("meth", METHODS)
def test_gemm_rs_ctx_equals_jax(ops, meth, kind):
    """``gemm_rs(ctx, a, b)`` on every rank's shards: the rank's rows of
    the JAX op's output, exactly on integer-valued inputs, else within
    1e-5."""
    want = ops["jax"][f"rs/{kind}/{meth}"]
    m = want.shape[0] // WORLD
    for r in range(WORLD):
        check(ops["ranks"][r][f"rs/{kind}/{meth}"],
              want[r * m:(r + 1) * m], kind, f"rank {r}")


@pytest.mark.parametrize("world", [1, WORLD])
def test_contexts_resolve_as_the_reference(ops, mesh4, world):
    """AgGemmContext / GemmRsContext resolve AUTO as the reference's do, at
    world 1 and 4; resolve_for keeps the context's tiles (no tuned table
    until ROADMAP A16)."""
    if world == 1:
        jmesh = make_comm_mesh(axes=[("tp", 1)], devices=jax.devices()[:1])
        mesh = tp_mesh.make_comm_mesh(device="cpu")
        assert mesh.world == 1
        got = [agm.create_ag_gemm_context(mesh).resolve().value,
               grs.create_gemm_rs_context(mesh).resolve().value]
        assert agm.create_ag_gemm_context(
            mesh, method=agm.AgGemmMethod.PALLAS_BIDIR).resolve() == \
            agm.AgGemmMethod.PALLAS_BIDIR
        assert agm.create_ag_gemm_context(mesh, bn=96).resolve_for(
            4, 8, 16)[2] == 96
    else:
        jmesh = mesh4
        got = ops["checks"][0]["resolve"]
        for c in ops["checks"]:
            assert c["resolve"] == got
            assert c["resolve_for"] == ["pallas", 512]
    want = [create_ag_gemm_context(jmesh, "tp").resolve().value,
            create_gemm_rs_context(jmesh, "tp").resolve().value]
    assert got == want


def test_dcn_axis_and_uneven_rows_raise(ops):
    """A context with dcn_axis (the 2-D schedules over a multi-axis mesh)
    raises naming ROADMAP A9 (tail); gemm_rs with M the world does not
    divide raises the reference's ValueError before any work."""
    for c in ops["checks"]:
        assert c["dcn_axis_raises"] is True
        assert c["gemm_rs_odd_m_raises"] is True


def test_auto_all_gather_rule():
    """AUTO: XLA off CUDA; on CUDA the reference's shape (FULL_MESH for a
    small shard or a world of at most 2, RING_1D above) with the port's
    own crossover, agk.FULL_MESH_MAX_SHARD_BYTES."""
    rule, cap = agk.get_auto_all_gather_method, agk.FULL_MESH_MAX_SHARD_BYTES
    M = agk.AllGatherMethod
    assert rule(1024, 4, cuda=False) == M.XLA
    assert rule(cap, 4, cuda=True) == M.FULL_MESH
    assert rule(cap + 1, 4, cuda=True) == M.RING_1D
    assert rule(cap + 1, 2, cuda=True) == M.FULL_MESH
