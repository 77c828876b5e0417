"""Packed-varlen sequence-parallel prefill and the refusals, the PyTorch
port against the JAX package, four ranks.

Four gloo ranks (tests/torch_sp_worker.py, part "varlen") run the port's
``sp_attention`` with ``cu_seqlens`` (three segments over 128 rows, once
filling them and once leaving 8 rows of padding) under XLA (B1's varlen
form over the gathered keys, its plain version on CPU tensors), XLA_RING
and FLASH_RING (B1's fold form with segments), and at head_dim 32 under
XLA (the masked fold) and XLA_RING. The JAX package runs the same on
``mesh4``, its flash kernels in interpret mode. Held per rank within 1e-5
(f32); every refusal of the reference raises the same class of error in
both packages, and a 2-D (dcn_axis) context raises naming ROADMAP A9
(tail) in the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_sp_cases import (
    VAR_CU, VAR_METHODS, WORLD, blocks, jax_sp, run, varlen_inputs,
)
from triton_dist_tpu.kernels import sp_ag_attention as jsp
from triton_dist_tpu.runtime.compat import tpu_interpreter_available

TOL = dict(rtol=1e-5, atol=1e-5)
REFUSALS = ("flash_ring_head_dim", "pallas_head_dim", "pallas_zigzag",
            "pallas_cu_seqlens", "zigzag_xla", "zigzag_xla_block",
            "zigzag_odd_rows", "xla_block_cu_seqlens", "unknown_layout")


@pytest.fixture(scope="module")
def var(mesh4, tmp_path_factory):
    if not tpu_interpreter_available():
        pytest.skip("this jax lacks the Pallas TPU interpreter")
    inp = varlen_inputs()

    def jax_side():
        out = {}
        for name in VAR_CU:
            for method in VAR_METHODS:
                out[f"{name}/{method}"] = jax_sp(mesh4, inp, "big/", method,
                                                 cu=inp[f"cu/{name}"])
        for method in ("xla", "xla_ring"):
            out[f"small/{method}"] = jax_sp(mesh4, inp, "small/", method,
                                            cu=inp["cu/small"])
        return out

    want, ranks, checks = run(tmp_path_factory.mktemp("sp_var"), "varlen",
                              inp, jax_side)
    return {"inp": inp, "jax": want, "ranks": ranks, "checks": checks}


@pytest.mark.parametrize("method", VAR_METHODS)
@pytest.mark.parametrize("cu", list(VAR_CU))
def test_varlen_equals_jax_per_rank(var, cu, method):
    want = blocks(var["jax"][f"{cu}/{method}"], axis=1)
    for r in range(WORLD):
        np.testing.assert_allclose(var["ranks"][r][f"{cu}/{method}"],
                                   want[r], err_msg=f"rank {r}", **TOL)


@pytest.mark.parametrize("method", ["xla", "xla_ring"])
def test_varlen_unaligned_head_equals_jax_per_rank(var, method):
    want = blocks(var["jax"][f"small/{method}"], axis=1)
    for r in range(WORLD):
        np.testing.assert_allclose(var["ranks"][r][f"small/{method}"],
                                   want[r], err_msg=f"rank {r}", **TOL)


def _jax_raises(mesh, inp, prefix, method, layout="contiguous", cu=None,
                rows=None):
    q, k, v = (jnp.asarray(inp[f"{prefix}{x}"]) for x in "qkv")
    if rows is not None:
        q, k, v = (x[:, :rows] for x in (q, k, v))
    ctx = jsp.create_sp_attn_context(mesh, axis="tp",
                                     method=jsp.SpAttnMethod(method),
                                     layout=layout)
    with pytest.raises(ValueError):
        jsp.sp_attention(ctx, q, k, v, cu_seqlens=cu)
    return True


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_same_class_as_jax(var, mesh4, case):
    """The port raises ValueError on every rank where the reference does
    (checked here on the JAX package with the global arrays)."""
    inp = var["inp"]
    cu = jnp.asarray(inp["cu/small"])
    jax_case = {
        "flash_ring_head_dim": ("small/", "flash_ring", "contiguous", None),
        "pallas_head_dim": ("small/", "pallas", "contiguous", None),
        "pallas_zigzag": ("big/", "pallas", "zigzag", None),
        "pallas_cu_seqlens": ("big/", "pallas", "contiguous", cu),
        "zigzag_xla": ("big/", "xla", "zigzag", None),
        "zigzag_xla_block": ("big/", "xla_block", "zigzag", None),
        "zigzag_odd_rows": ("big/", "xla_ring", "zigzag", None),
        "xla_block_cu_seqlens": ("big/", "xla_block", "contiguous", cu),
        "unknown_layout": ("big/", "xla_ring", "striped", None),
    }[case]
    prefix, method, layout, c = jax_case
    rows = 12 if case == "zigzag_odd_rows" else None
    assert _jax_raises(mesh4, inp, prefix, method, layout, c, rows)
    for r in range(WORLD):
        assert var["checks"][r][case] is True, (r, case)


def test_dcn_axis_names_a9_and_no_launch(var):
    for r in range(WORLD):
        assert var["checks"][r]["sp_dcn_axis_a9"] is True
        assert var["checks"][r]["no_launch_on_cpu"] is True
