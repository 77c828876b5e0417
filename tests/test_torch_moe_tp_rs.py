"""B15 across ranks of the PyTorch port against the JAX package, TP=4.

Four gloo ranks (tests/torch_moe_tp_worker.py, part "ops") run
``moe_reduce_rs_per_device`` on the CPU in every tier (XLA, XLA_RING, and
PALLAS, whose plain version serves CPU tensors: each chunk's f32
partial, ``all_to_all_single``, the fold in ascending sender, at
comm_blocks 1 and 4); the JAX ``moe_reduce_rs`` runs here on the suite's
``mesh4`` in its XLA tier and its PALLAS tier (the ring reduce-scatter,
in interpret mode) at comm_blocks 1 and 4 (tests/torch_moe_tp_cases.py).
Inputs are made with numpy from seeds: 4 tokens per rank, 8 experts,
top-2, tile rows 8.

Held here: every port tier equals every JAX tier per rank, exactly on
integer-valued f32 (the fold orders differ: the reference's ring starts at
a rank-dependent chunk, the port adds the senders in ascending order) and
within rtol = atol = 1e-5 on random f32; and the one-card world's plain
version of B15 equals the JAX XLA tier.
"""

import pytest
import torch

from torch_moe_tp_cases import (
    BM, E, JAX_TIERS, M_LOC, PORT_TIERS, TOPK, WORLD, check, jax_b15,
    ops_inputs, run,
)

from triton_dist_tpu_torch.kernels import moe_reduce_rs as mrs
from triton_dist_tpu_torch.kernels import moe_utils


@pytest.fixture(scope="module")
def b15(mesh4, tmp_path_factory):
    inp = ops_inputs()

    def jax_side():
        return {(kind, tier): jax_b15(mesh4, inp, kind, tier)
                for kind in ("int", "rand") for tier in JAX_TIERS}

    want, ranks, _ = run(tmp_path_factory.mktemp("moe_tp_b15"), "ops", inp,
                         jax_side)
    return {"inp": inp, "jax": want, "ranks": ranks}


@pytest.mark.parametrize("jax_tier", JAX_TIERS)
@pytest.mark.parametrize("kind", ["int", "rand"])
def test_b15_tiers_equal_jax_per_rank(b15, kind, jax_tier):
    want = b15["jax"][(kind, jax_tier)]
    mc = want.shape[0] // WORLD
    for r in range(WORLD):
        for tier in PORT_TIERS:
            check(b15["ranks"][r][f"b15/{kind}/{tier}"],
                  want[r * mc:(r + 1) * mc], kind,
                  f"rank {r} {tier} vs JAX {jax_tier}")


@pytest.mark.parametrize("kind", ["int", "rand"])
def test_one_card_world_plain_b15_equals_jax(b15, kind):
    """The plain version that holds B15 in the one-card world (every
    rank's intermediate columns and weight rows in one process):
    ``moe_reduce_rs_ref_shards`` (each rank's chunk partials, each owner's
    fold in ascending sender, one cast) equals the JAX XLA tier, and its
    chunk partials are the world-1 plain version's f32 sums."""
    inp = b15["inp"]
    want = b15["jax"][(kind, "xla")]
    inter, wd = inp[f"b15_inter_{kind}"], inp[f"b15_w_{kind}"]
    ids = torch.from_numpy(inp["ids"])
    tw = torch.from_numpy(inp[f"topk_w_{kind}"])
    il = inter.shape[1] // WORLD
    bm = min(BM, max(8, M_LOC * TOPK))
    sched = moe_utils.aligned_chunk_schedule(ids, WORLD, E, bm)
    inters = [torch.from_numpy(inter[:, r * il:(r + 1) * il].copy())
              for r in range(WORLD)]
    wds = [torch.from_numpy(wd[:, r * il:(r + 1) * il].copy())
           for r in range(WORLD)]
    got = mrs.moe_reduce_rs_ref_shards(inters, wds, ids, tw, sched)
    assert len(got) == WORLD
    for r in range(WORLD):
        check(got[r].numpy(), want[r * M_LOC:(r + 1) * M_LOC], kind,
              f"rank {r}")
    parts = mrs.chunk_partials_ref(inters[0], wds[0], ids, tw, sched)
    c = 2
    nf = M_LOC * TOPK
    one = mrs.moe_rs_partial_ref(
        inters[0][c * nf:(c + 1) * nf], wds[0], ids[c * M_LOC:(c + 1) * M_LOC],
        tw[c * M_LOC:(c + 1) * M_LOC],
        moe_utils.aligned_chunk_schedule(ids[c * M_LOC:(c + 1) * M_LOC], 1,
                                         E, bm))
    assert torch.equal(parts[c], one)
