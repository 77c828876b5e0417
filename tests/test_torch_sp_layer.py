"""SpGQAFlashDecodeAttention of the PyTorch port against the JAX package,
four ranks.

Four gloo ranks (tests/torch_sp_worker.py, part "layer") build the layer
under the XLA and PALLAS decode combines and the AUTO and XLA_BLOCK
prefill methods (B=2, Hq 8, Hkv 4, D 16, the reference's test shapes),
run ``prefill`` over 16 tokens (4 a rank) and ``decode`` of token 16 over
a 20-key cache (5 a rank), each also through its per-device twin, and
``decode_paged`` with each rank's keys of a sequence as one page. The JAX
layer runs the same on ``mesh4``. Held within 1e-5 (f32): each rank's
prefill rows and its decode output against the JAX layer's; the decode
output against dense attention over the 17 tokens at their last position
(the reference's test_sp_layer_prefill_decode_consistency); the paged
decode against the dense one; a dcn_axis names ROADMAP A9 (tail).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_sp_cases import LAYER, WORLD, blocks, layer_inputs, run
from triton_dist_tpu.kernels.flash_decode import FlashDecodeCombine
from triton_dist_tpu.kernels.sp_ag_attention import SpAttnMethod
from triton_dist_tpu.layers.attention_core import gqa_attend
from triton_dist_tpu.layers.sp_flash_decode_layer import (
    SpGQAFlashDecodeAttention,
)

TOL = dict(rtol=1e-5, atol=1e-5)
CONFIGS = [("xla", "auto"), ("xla", "xla_block"), ("pallas", "auto"),
           ("pallas", "xla_block")]
IDS = [f"{c}-{p}" for c, p in CONFIGS]


@pytest.fixture(scope="module")
def lay(mesh4, tmp_path_factory):
    inp = layer_inputs()
    t = LAYER["t"]

    def jax_side():
        out = {}
        q, k, v = (jnp.asarray(inp[x]) for x in "qkv")
        kc, vc = jnp.asarray(inp["k_cache"]), jnp.asarray(inp["v_cache"])
        for combine, prefill in CONFIGS:
            layer = SpGQAFlashDecodeAttention.create(
                mesh4, axis="tp", combine=FlashDecodeCombine(combine),
                prefill=SpAttnMethod(prefill))
            out[f"prefill/{combine}/{prefill}"] = np.asarray(jax.jit(
                lambda q, k, v, ly=layer: ly.prefill(q, k, v))(
                q[:, :t], k[:, :t], v[:, :t]))
            out[f"decode/{combine}/{prefill}"] = np.asarray(jax.jit(
                lambda q, kc, vc, ly=layer: ly.decode(q, kc, vc,
                                                      jnp.int32(t)))(
                q[:, t], kc, vc))
        out["dense"] = np.asarray(jax.jit(
            lambda q, k, v: gqa_attend(q, k, v, jnp.int32(0),
                                       q.shape[1]))(q, k, v))
        return out

    want, ranks, checks = run(tmp_path_factory.mktemp("sp_layer"), "layer",
                              inp, jax_side)
    return {"jax": want, "ranks": ranks, "checks": checks}


@pytest.mark.parametrize("combine,prefill", CONFIGS, ids=IDS)
def test_layer_equals_jax_per_rank(lay, combine, prefill):
    key = f"{combine}/{prefill}"
    want_p = blocks(lay["jax"][f"prefill/{key}"], axis=1)
    for r in range(WORLD):
        for form in ("prefill", "prefill_pd"):
            np.testing.assert_allclose(lay["ranks"][r][f"{form}/{key}"],
                                       want_p[r], err_msg=f"rank {r} {form}",
                                       **TOL)
        for form in ("decode", "decode_pd"):
            np.testing.assert_allclose(lay["ranks"][r][f"{form}/{key}"],
                                       lay["jax"][f"decode/{key}"],
                                       err_msg=f"rank {r} {form}", **TOL)


@pytest.mark.parametrize("combine,prefill", CONFIGS, ids=IDS)
def test_sp_layer_prefill_decode_consistency(lay, combine, prefill):
    """Prefill of T tokens then decode of token T equals dense attention
    over T + 1 tokens: the prefill rows at positions < T, the decode
    output at position T."""
    t, key = LAYER["t"], f"{combine}/{prefill}"
    dense = lay["jax"]["dense"]
    got = np.concatenate([lay["ranks"][r][f"prefill/{key}"]
                          for r in range(WORLD)], axis=1)
    np.testing.assert_allclose(got, dense[:, :t], **TOL)
    for r in range(WORLD):
        np.testing.assert_allclose(lay["ranks"][r][f"decode/{key}"],
                                   dense[:, t], err_msg=f"rank {r}", **TOL)


@pytest.mark.parametrize("combine", ["xla", "pallas"])
def test_layer_decode_paged_equals_dense(lay, combine):
    t = LAYER["t"]
    for r in range(WORLD):
        for form in ("paged", "paged_pd"):
            np.testing.assert_allclose(lay["ranks"][r][f"{form}/{combine}"],
                                       lay["jax"]["dense"][:, t],
                                       err_msg=f"rank {r} {form}", **TOL)


def test_layer_dcn_axis_names_a9_and_no_launch(lay):
    for r in range(WORLD):
        assert lay["checks"][r]["layer_dcn_axis_a9"] is True
        assert lay["checks"][r]["no_launch_on_cpu"] is True
