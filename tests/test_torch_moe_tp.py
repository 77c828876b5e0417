"""B14 across ranks of the PyTorch port against the JAX package, TP=4.

Four gloo ranks (tests/torch_moe_tp_worker.py, part "ops") run
``ag_group_gemm_per_device`` on the CPU in every tier (XLA, XLA_RING, and
PALLAS, whose plain version serves CPU tensors, at comm_blocks 1 and 4);
the JAX ``ag_group_gemm`` runs here on the suite's ``mesh4`` in its XLA
tier and its PALLAS tier (the token ring, in interpret mode) at
comm_blocks 1 and 4 (tests/torch_moe_tp_cases.py). Inputs are made with
numpy from seeds: 4 tokens per rank, 8 experts, top-2, tile rows 8.

Held here: every port tier equals every JAX tier per rank, exactly on
integer-valued f32 and within rtol = atol = 1e-5 on random f32, with the
gathered tokens exact; the n-chunk schedules (aligned, arrival-ordered at
every legal block count, the release counts) equal the reference's
exactly; and the one-card world's plain version of B14 (the gathered
tokens through the world-1 plain version chunk by chunk) equals the JAX
XLA tier. B15 is held in tests/test_torch_moe_tp_rs.py, the model in
tests/test_torch_moe_tp_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_moe_tp_cases import (
    BM, E, JAX_TIERS, M_LOC, PORT_TIERS, TOPK, WORLD, check, jax_b14,
    ops_inputs, routing, run,
)
from triton_dist_tpu.kernels import moe_utils as jmu

from triton_dist_tpu_torch.kernels import allgather_group_gemm as agg
from triton_dist_tpu_torch.kernels import moe_utils


# the JAX schedules, jitted over their static sizes (integer outputs,
# exact either way; eager, every op dispatches on its own)
_jax_aligned_schedule = jax.jit(jmu.aligned_chunk_schedule,
                                static_argnums=(1, 2, 3))
_jax_arrival_schedule = jax.jit(jmu.arrival_ordered_schedule,
                                static_argnums=(1, 2, 3))


@pytest.fixture(scope="module")
def b14(mesh4, tmp_path_factory):
    inp = ops_inputs()

    def jax_side():
        return {(kind, tier): jax_b14(mesh4, inp, kind, tier)
                for kind in ("int", "rand") for tier in JAX_TIERS}

    want, ranks, _ = run(tmp_path_factory.mktemp("moe_tp_b14"), "ops", inp,
                         jax_side)
    return {"inp": inp, "jax": want, "ranks": ranks}


@pytest.mark.parametrize("jax_tier", JAX_TIERS)
@pytest.mark.parametrize("kind", ["int", "rand"])
def test_b14_tiers_equal_jax_per_rank(b14, kind, jax_tier):
    out, ag = b14["jax"][(kind, jax_tier)]
    nl = out.shape[1] // WORLD
    for r in range(WORLD):
        for tier in PORT_TIERS:
            got = b14["ranks"][r][f"b14/{kind}/{tier}/out"]
            check(got, out[:, r * nl:(r + 1) * nl], kind,
                  f"rank {r} {tier} vs JAX {jax_tier}")
            np.testing.assert_array_equal(
                b14["ranks"][r][f"b14/{kind}/{tier}/ag"], ag)


@pytest.mark.parametrize("seed,m_loc,topk,e,bm,reorders", [
    (1, 4, 2, 8, 8, False), (4, 16, 2, 4, 8, True),
    (2, 4, 8, 128, 32, False), (3, 16, 8, 128, 128, False)],
    ids=["tiny", "full_tiles", "qwen3_30b_decode_b16",
         "qwen3_30b_decode_b64"])
def test_n_chunk_schedules_equal_jax(seed, m_loc, topk, e, bm, reorders):
    """aligned_chunk_schedule over n = 4 chunks and
    arrival_ordered_schedule at block counts 2 and 4: every field and the
    release counts exactly the reference's. A tile with padding reads the
    clamped last row, so it waits for the last block: where every tile is
    padded (the decode shapes) the order stays the identity, and it moves
    only where full tiles need earlier blocks alone ("full_tiles")."""
    ids = routing(np.random.default_rng(seed), WORLD * m_loc, topk, e)
    ours = moe_utils.aligned_chunk_schedule(torch.from_numpy(ids), WORLD, e,
                                            bm)
    ref = _jax_aligned_schedule(jnp.asarray(ids), WORLD, e, bm)
    for name, a, b in zip(ours._fields, ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    moved = False
    for cb in (2, 4):
        nblk = moe_utils.legal_comm_blocks(m_loc, cb)
        assert nblk == jmu.legal_comm_blocks(m_loc, cb) == cb
        s2, ready = moe_utils.arrival_ordered_schedule(ours, m_loc, bm, nblk)
        js2, jready = _jax_arrival_schedule(ref, m_loc, bm, nblk)
        np.testing.assert_array_equal(ready.numpy(), np.asarray(jready))
        for name, a, b in zip(s2._fields, s2, js2):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{name} cb={cb}")
        np.testing.assert_array_equal(ready[:, -1].numpy(),
                                      ours.used_tiles.numpy())
        moved |= not torch.equal(s2.tile_expert, ours.tile_expert)
    assert moved == reorders


@pytest.mark.parametrize("kind", ["int", "rand"])
def test_one_card_world_plain_b14_equals_jax(b14, kind):
    """The plain version that holds B14 in the one-card world (every
    rank's tokens in one process): ``ag_group_gemm_ref_chunks`` on the
    concatenated shards, with each rank's weight columns, equals the JAX
    XLA tier; ``group_gemm_ref`` per chunk is the world-1 plain version,
    so B14's rows are held to the world-1 function."""
    inp = b14["inp"]
    out, _ = b14["jax"][(kind, "xla")]
    tok = torch.from_numpy(inp[f"b14_tok_{kind}"])
    w = inp[f"b14_w_{kind}"]
    nl = w.shape[-1] // WORLD
    bm = min(BM, max(8, M_LOC * TOPK))
    sched = moe_utils.aligned_chunk_schedule(torch.from_numpy(inp["ids"]),
                                             WORLD, E, bm)
    for r in range(WORLD):
        got = agg.ag_group_gemm_ref_chunks(
            tok, torch.from_numpy(w[..., r * nl:(r + 1) * nl].copy()), sched,
            TOPK)
        check(got.numpy(), out[:, r * nl:(r + 1) * nl], kind, f"rank {r}")
