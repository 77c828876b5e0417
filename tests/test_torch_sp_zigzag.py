"""Sequence-parallel prefill over the zigzag layout, the PyTorch port
against the JAX package, four ranks.

Four gloo ranks (tests/torch_sp_worker.py, part "zigzag") shard q, k and
v with the port's ``zigzag_shard`` (rank r holds blocks r and 2n-1-r) and
run ``sp_attention`` under the two ring methods that take the layout,
XLA_RING and FLASH_RING (B1's fold form, its plain version on CPU
tensors): the dense prefill inputs (16 rows a rank) and a packed varlen
batch whose last boundary leaves 8 rows of padding (32 rows a rank). The
JAX package runs the same under ``mesh4`` (its flash kernel in interpret
mode). Held per rank within 1e-5 (f32), the outputs left in zigzag
order; and the zigzag output, unsharded, equals the contiguous tier's.
"""

import numpy as np
import pytest

from torch_sp_cases import (
    WORLD, ZIGZAG_METHODS, blocks, jax_sp, run, zigzag_inputs,
)
from triton_dist_tpu.kernels.sp_ag_attention import zigzag_unshard
from triton_dist_tpu.runtime.compat import tpu_interpreter_available

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def zz(mesh4, tmp_path_factory):
    if not tpu_interpreter_available():
        pytest.skip("this jax lacks the Pallas TPU interpreter")
    inp = zigzag_inputs()

    def jax_side():
        out = {}
        for method in ZIGZAG_METHODS:
            out[f"zigzag/{method}"] = jax_sp(mesh4, inp, "pre/", method,
                                             layout="zigzag")
            out[f"varlen/{method}"] = jax_sp(mesh4, inp, "big/", method,
                                             layout="zigzag",
                                             cu=inp["cu/padded"])
        out["contiguous"] = jax_sp(mesh4, inp, "pre/", "xla_ring")
        return out

    want, ranks, checks = run(tmp_path_factory.mktemp("sp_zz"), "zigzag",
                              inp, jax_side)
    return {"jax": want, "ranks": ranks, "checks": checks}


@pytest.mark.parametrize("case", ["zigzag", "varlen"])
@pytest.mark.parametrize("method", ZIGZAG_METHODS)
def test_zigzag_equals_jax_per_rank(zz, method, case):
    want = blocks(zz["jax"][f"{case}/{method}"], axis=1)
    for r in range(WORLD):
        np.testing.assert_allclose(zz["ranks"][r][f"{case}/{method}"],
                                   want[r], err_msg=f"rank {r}", **TOL)


@pytest.mark.parametrize("method", ZIGZAG_METHODS)
def test_zigzag_unsharded_equals_contiguous(zz, method):
    """The ranks' zigzag rows, concatenated and unsharded, are the
    contiguous layout's attention; no kernel ran on CPU tensors."""
    got = np.concatenate([zz["ranks"][r][f"zigzag/{method}"]
                          for r in range(WORLD)], axis=1)
    np.testing.assert_allclose(np.asarray(zigzag_unshard(got, WORLD)),
                               zz["jax"]["contiguous"], **TOL)
    assert all(c["no_launch_on_cpu"] is True for c in zz["checks"])
