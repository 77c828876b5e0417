"""The tensor-parallel ContinuousEngine slice against the JAX package at
world 4: four gloo ranks against a 4-device mesh.

Held (tests/torch_continuous_tp_cases.py): every rank's B9, B7 and
TWO_SHOT output equals the JAX kernels' (``reduce_scatter_per_device`` /
``all_gather_per_device`` RING_1D, ``all_reduce_per_device`` TWO_SHOT) to
the bit in f32, and the process-group tiers equal the sums and the rows;
rows the world does not divide raise a ValueError in the port where the
JAX per-device body fails; the ContinuousEngine's paged cache state, slots
and counters after every step and its greedy tokens equal the JAX
ContinuousEngine's in modes xla (the mega default) and triton_dist_AR
under TWO_SHOT (a chunked prompt, a prefix adopted from the index, a
request arriving mid-stream, two decode steps per program), every rank
serving rank 0's tokens with no rank's own sample differing; under
TWO_SHOT, 1- and 2-token chunks (padded to a multiple of the world) leave
the same state and tokens as mode xla, and a max_batch the world does
not divide is refused; and the paged Engine's greedy tokens equal the JAX
paged Engine's.
"""

import pytest

from conftest import needs_interpreter
from torch_continuous_tp_cases import (  # noqa: F401 (collected cases)
    test_continuous_equals_jax, test_paged_engine_equals_jax,
    test_process_group_tiers_and_refusals,
    test_ring_kernels_equal_jax_per_rank,
    test_two_shot_short_chunks_pad_to_the_world, tp_results,
)

pytestmark = needs_interpreter()


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    return tp_results(4, tmp_path_factory.mktemp("continuous_tp4"))
