"""The port's native schedule provider against its in-graph one and the
JAX package's native provider, and the mesh-level MoE ops.

``make_chunk_schedule(provider="native")`` builds the MoE tile schedule on
the host from the port's own copies of the C++ tile swizzle and
block-aligned sort (triton_dist_tpu_torch/csrc/host/, built with g++ at
first use); it must equal, field by field, the in-graph
``aligned_chunk_schedule`` (past used_tiles the dead tile_expert entries
are never read: 0 on the host, the clipped search in the graph) and the
JAX ``native_chunk_schedule`` on seeded and hypothesis-drawn routings at
1 and 4 chunks. Four gloo ranks (tests/torch_bidir_worker.py, part "moe")
call ``ag_group_gemm(ctx)`` / ``moe_reduce_rs(ctx)`` with the schedule
"auto" and "native" in every tier; their outputs must be the per-device
tiers' bits on the same inputs.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from triton_dist_tpu.kernels.moe_utils import (
    native_chunk_schedule as j_native_chunk_schedule,
)

from torch_bidir_cases import join, spawn
from torch_moe_tp_cases import ops_inputs
from triton_dist_tpu_torch.kernels import moe_utils
from triton_dist_tpu_torch.runtime import native

WORLD = 4


def _check_schedules(ids: np.ndarray, n: int, e: int, bm: int) -> None:
    t = torch.from_numpy(ids)
    host = moe_utils.make_chunk_schedule(t, n, e, bm, provider="native")
    graph = moe_utils.make_chunk_schedule(t, n, e, bm)
    ref = j_native_chunk_schedule(ids, n, e, bm)
    for name, h, g, j in zip(host._fields, host, graph, ref):
        assert h.dtype == torch.int32 and h.is_contiguous(), name
        np.testing.assert_array_equal(h.numpy(), np.asarray(j),
                                      err_msg=name)
        if name == "tile_expert":
            for c in range(n):
                used = int(host.used_tiles[c])
                assert torch.equal(h[c, :used], g[c, :used]), name
        else:
            assert torch.equal(h, g), name


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [1, WORLD])
def test_native_schedule_equals_in_graph_and_jax(n, seed):
    """Seeded top-2 routings of 8 experts over 4 tokens a chunk, tile rows
    8 (the MoE TP tests' shape) and 4."""
    rng = np.random.default_rng(seed)
    ids = np.stack([rng.permutation(8)[:2] for _ in range(4 * n)]).astype(
        np.int32)
    for bm in (8, 4):
        _check_schedules(ids, n, 8, bm)


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_native_schedule_on_drawn_routings(data):
    """Drawn routings: 1 or 4 chunks of 1-6 tokens, top-1..3 of 3-10
    experts (repeats allowed), tile rows 2, 4 or 8."""
    n = data.draw(st.sampled_from([1, WORLD]))
    mc = data.draw(st.integers(1, 6))
    topk = data.draw(st.integers(1, 3))
    e = data.draw(st.integers(3, 10))
    bm = data.draw(st.sampled_from([2, 4, 8]))
    flat = data.draw(st.lists(st.integers(0, e - 1), min_size=n * mc * topk,
                              max_size=n * mc * topk))
    ids = np.asarray(flat, np.int32).reshape(n * mc, topk)
    _check_schedules(ids, n, e, bm)


def test_native_library_loads_once_and_counts():
    """The host library loads once per process (its sources and build
    place: tests/test_torch_boundary.py) and its histogram ignores ids
    outside the experts, as the reference's does."""
    assert native.load_native() is native.load_native()
    counts = native.expert_histogram(np.array([0, 2, 2, 5, 6, -1],
                                              np.int32), 6)
    assert counts.tolist() == [1, 0, 2, 0, 0, 1]


@pytest.fixture(scope="module")
def moe(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_mesh_ops")
    return join(spawn(tmp, "moe", ops_inputs(), WORLD), tmp)


@pytest.mark.parametrize("op", ["b14", "b15"])
def test_mesh_level_moe_ops_equal_per_device_tiers(moe, op):
    """ag_group_gemm(ctx) (B14's op) and moe_reduce_rs(ctx) (B15's) with
    the schedule built "auto" (in the graph) and "native" (on the host)
    return the per-device tiers' bits, in every tier, on every rank;
    moe_reduce_rs with M the world does not divide raises."""
    _, checks = moe
    for r, c in enumerate(checks):
        same = {k: v for k, v in c["equal_per_device"].items()
                if k.startswith(op)}
        assert len(same) == 2 * 3 * 2, same
        assert all(same.values()), (r, same)
        assert c["odd_m_raises"] is True
