"""Sequence-parallel prefill of the PyTorch port against the JAX package,
four ranks.

Four gloo ranks (tests/torch_sp_worker.py, part "prefill") run the port's
``sp_attention`` on the CPU, each on its shards of q, k and v (B=2, Hq 4,
Hkv 2, D 128, 16 rows a rank): XLA (all-gather + the attention core),
XLA_RING (the process group's ring), FLASH_RING (B1's fold form, its plain
version on CPU tensors), XLA_BLOCK and PALLAS (B21's plain version) at
comm_blocks 1 and 4, and AUTO. The JAX package runs the same tiers here
on the suite's ``mesh4`` (its Pallas kernels in interpret mode; its PALLAS
ring kernel at comm_blocks 4, whose puts stay at 8 KiB). Inputs are made
with numpy from a seed.

Held here, per rank, within 1e-5 (f32): every tier against the JAX tier
of the same name; B21's plain version (the port's PALLAS on CPU tensors)
against the JAX XLA_BLOCK tier, the reference's bit-exactness twin of its
PALLAS kernel, at both comm_blocks, and against the JAX PALLAS kernel;
every tier against one device's dense causal attention; AUTO equal to
XLA_RING; no kernel launched on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_sp_cases import (
    PRE, PRE_METHODS, WORLD, blocks, jax_sp, prefill_inputs, run,
)
from triton_dist_tpu.layers.attention_core import gqa_attend
from triton_dist_tpu.runtime.compat import tpu_interpreter_available

TOL = dict(rtol=1e-5, atol=1e-5)
CASES = [("xla", 4), ("xla_ring", 4), ("flash_ring", 4), ("xla_block", 1),
         ("xla_block", 4), ("pallas", 1), ("pallas", 4)]


@pytest.fixture(scope="module")
def pre(mesh4, tmp_path_factory):
    if not tpu_interpreter_available():
        pytest.skip("this jax lacks the Pallas TPU interpreter")
    inp = prefill_inputs()

    def jax_side():
        out = {}
        for method in PRE_METHODS:
            if method == "pallas":
                continue
            for cb in ((1, 4) if method == "xla_block" else (4,)):
                out[f"{method}/cb{cb}"] = jax_sp(mesh4, inp, "", method,
                                                 comm_blocks=cb)
        out["pallas/cb4"] = jax_sp(mesh4, inp, "", "pallas", comm_blocks=4)
        q, k, v = (jnp.asarray(inp[x]) for x in "qkv")
        out["dense"] = np.asarray(jax.jit(
            lambda q, k, v: gqa_attend(q, k, v, jnp.int32(0),
                                       q.shape[1]))(q, k, v))
        return out

    want, ranks, checks = run(tmp_path_factory.mktemp("sp_pre"), "prefill",
                              inp, jax_side)
    return {"jax": want, "ranks": ranks, "checks": checks}


@pytest.mark.parametrize("method,cb", CASES,
                         ids=[f"{m}-cb{c}" for m, c in CASES])
def test_sp_prefill_equals_jax_per_rank(pre, method, cb):
    """Each rank's (B, T_loc, Hq, D) rows against the JAX tier of the same
    name (PALLAS: the JAX XLA_BLOCK tier at the same comm_blocks, the
    reference's twin of its kernel)."""
    ref_key = f"xla_block/cb{cb}" if method == "pallas" else \
        f"{method}/cb{cb}"
    want = blocks(pre["jax"][ref_key], axis=1)
    for r in range(WORLD):
        np.testing.assert_allclose(pre["ranks"][r][f"{method}/cb{cb}"],
                                   want[r], err_msg=f"rank {r}", **TOL)


def test_b21_plain_equals_jax_pallas_kernel(pre):
    """B21's plain version at comm_blocks 4 against the JAX PALLAS ring
    kernel run in interpret mode."""
    want = blocks(pre["jax"]["pallas/cb4"], axis=1)
    for r in range(WORLD):
        np.testing.assert_allclose(pre["ranks"][r]["pallas/cb4"], want[r],
                                   err_msg=f"rank {r}", **TOL)


@pytest.mark.parametrize("method,cb", CASES,
                         ids=[f"{m}-cb{c}" for m, c in CASES])
def test_sp_prefill_equals_dense(pre, method, cb):
    """Every tier's rows against one device's dense causal attention over
    the whole sequence."""
    want = blocks(pre["jax"]["dense"], axis=1)
    for r in range(WORLD):
        np.testing.assert_allclose(pre["ranks"][r][f"{method}/cb{cb}"],
                                   want[r], err_msg=f"rank {r}", **TOL)


def test_auto_is_xla_ring_and_no_launch(pre):
    """AUTO resolves to XLA_RING (the reference's rule), and no kernel ran
    on CPU tensors."""
    for r in range(WORLD):
        np.testing.assert_array_equal(pre["ranks"][r]["auto"],
                                      pre["ranks"][r]["xla_ring/cb4"])
        assert pre["checks"][r]["no_launch_on_cpu"] is True
    assert pre["ranks"][0]["auto"].shape == (PRE["b"], PRE["t_loc"],
                                             PRE["hq"], PRE["d"])
