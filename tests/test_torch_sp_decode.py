"""Distributed flash-decode of the PyTorch port against the JAX package,
four ranks.

Four gloo ranks (tests/torch_sp_worker.py, part "decode") each hold a
160-key shard of a 640-key cache (B=2, Hq 4, Hkv 2, D 128; 160 % 128 != 0)
and decode the query at position 301, so rank 1's shard is partly live
and ranks 2 and 3 hold none of the keys: ``flash_decode`` under the XLA
combine (the process group's all-gather + ``lse_merge``) and the PALLAS
combine (B20's plain version), with the local pass "xla" (the masked
einsum), "pallas" (B19's plain version) and "auto", kv_splits 1, 2 and 3
(3 clamps to 2), the position an int and a 0-d tensor;
``paged_flash_decode_dist`` over each rank's own f32 and int8 page pool
(B2's plain version, its dequant epilogue) under both combines; and B20's
unnormalized form. The JAX package runs the same on ``mesh4``: its B19,
B2 and B20 kernels in interpret mode.

Held within 1e-5 (f32): every rank's replicated (B, Hq, D) output against
the JAX tier of the same configuration and against dense attention over
the whole cache; B20's merged triple against the JAX ``lse_partial_merge``
of every rank's triple (an empty rank's m = -1e30, l = 0 among them);
the refusals; no kernel launched on CPU tensors.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_sp_cases import (
    DEC_CASES, DEC_OFFSET, WORLD, decode_inputs, run,
)
from triton_dist_tpu.layers.attention_core import gqa_attend
from triton_dist_tpu.runtime.compat import tpu_interpreter_available

# the package exports a function of the module's name
jfd = importlib.import_module("triton_dist_tpu.kernels.flash_decode")
TOL = dict(rtol=1e-5, atol=1e-5)
CASE_IDS = [f"{c}-{m}-s{s}" for c, m, s in DEC_CASES]


@pytest.fixture(scope="module")
def dec(mesh4, tmp_path_factory):
    if not tpu_interpreter_available():
        pytest.skip("this jax lacks the Pallas TPU interpreter")
    inp = decode_inputs()

    def jax_side():
        out = {}
        q, k, v = (jnp.asarray(inp[x]) for x in "qkv")
        for combine, local, splits in DEC_CASES:
            ctx = jfd.create_flash_decode_context(
                mesh4, axis="tp", combine=jfd.FlashDecodeCombine(combine),
                local_method=local, kv_splits=splits)
            out[f"dense/{combine}/{local}/s{splits}"] = np.asarray(jax.jit(
                lambda q, k, v, o, ctx=ctx: jfd.flash_decode(ctx, q, k, v,
                                                             o))(
                q, k, v, jnp.int32(DEC_OFFSET)))
        out["reference"] = np.asarray(jax.jit(
            lambda q, k, v: gqa_attend(q[:, None], k, v,
                                       jnp.int32(DEC_OFFSET), 1)[:, 0])(
            q, k, v))
        pq = jnp.asarray(inp["pq"])
        tab, ln = jnp.asarray(inp["table"]), jnp.asarray(inp["lengths"])
        for combine in ("xla", "pallas"):
            ctx = jfd.create_flash_decode_context(
                mesh4, axis="tp", combine=jfd.FlashDecodeCombine(combine))
            out[f"paged/{combine}"] = np.asarray(jax.jit(
                lambda q, kp, vp, ctx=ctx: jfd.paged_flash_decode_dist(
                    ctx, q, kp, vp, tab, ln))(
                pq, jnp.asarray(inp["kp"]), jnp.asarray(inp["vp"])))
            out[f"paged_int8/{combine}"] = np.asarray(jax.jit(
                lambda q, kp, vp, ks, vs, ctx=ctx: jfd.paged_flash_decode_dist(
                    ctx, q, kp, vp, tab, ln, k_scales=ks, v_scales=vs))(
                pq, jnp.asarray(inp["kp_i8"]), jnp.asarray(inp["vp_i8"]),
                jnp.asarray(inp["ks"]), jnp.asarray(inp["vs"])))
        return out

    want, ranks, checks = run(tmp_path_factory.mktemp("sp_dec"), "decode",
                              inp, jax_side)
    return {"inp": inp, "jax": want, "ranks": ranks, "checks": checks}


@pytest.mark.parametrize("combine,local,splits", DEC_CASES, ids=CASE_IDS)
def test_flash_decode_equals_jax_per_rank(dec, combine, local, splits):
    """Every rank's output (the position an int, then a 0-d tensor) against
    the JAX tier of the same combine, local method and kv_splits, and
    against dense attention over the whole cache."""
    key = f"{combine}/{local}/s{splits}"
    for r in range(WORLD):
        for form in ("dense", "dense_t"):
            got = dec["ranks"][r][f"{form}/{key}"]
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, dec["jax"][f"dense/{key}"],
                                       err_msg=f"rank {r} {form}", **TOL)
            np.testing.assert_allclose(got, dec["jax"]["reference"],
                                       err_msg=f"rank {r} {form}", **TOL)


@pytest.mark.parametrize("pool", ["paged", "paged_int8"])
@pytest.mark.parametrize("combine", ["xla", "pallas"])
def test_paged_decode_dist_equals_jax_per_rank(dec, combine, pool):
    """Each rank's pages (its own table, lengths 0..64, some ranks empty
    for a row) merged across ranks: every rank's output the JAX one."""
    for r in range(WORLD):
        got = dec["ranks"][r][f"{pool}/{combine}"]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, dec["jax"][f"{pool}/{combine}"],
                                   err_msg=f"rank {r}", **TOL)


def test_pallas_combine_partial_equals_jax_merge(dec):
    """B20's plain version, partial=True: the merged (acc, m, l) of every
    rank's triple (rank 0 alone live on row (0, 0)), on every rank."""
    ins = [[np.asarray(dec["ranks"][r][f"partial_in/{x}"])
            for r in range(WORLD)] for x in ("acc", "m", "l")]
    want = jfd.lse_partial_merge(*(jnp.asarray(np.stack(x)) for x in ins))
    for r in range(WORLD):
        for i, w in enumerate(want):
            np.testing.assert_allclose(dec["ranks"][r][f"partial/{i}"],
                                       np.asarray(w), err_msg=f"rank {r}",
                                       **TOL)


@pytest.mark.parametrize("check", ["fd_dcn_axis_a9", "tree_merge_a9",
                                   "decode_2d_a9", "unknown_local_method",
                                   "wrong_axis", "no_launch_on_cpu"])
def test_decode_refusals_and_no_launch(dec, check):
    """The 2-D paths name ROADMAP A9 (tail); an unknown local method and a
    mesh axis the mesh lacks raise ValueError; no kernel ran on CPU."""
    for r in range(WORLD):
        assert dec["checks"][r][check] is True, (r, check)
