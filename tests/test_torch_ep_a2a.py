"""Expert-parallel dispatch and combine of the PyTorch port against the JAX
package, EP=4.

Four gloo ranks (tests/torch_ep_worker.py, part "ops") run the port on the
CPU: ``dispatch`` and ``combine`` under XLA (the process group's
all-to-all) and PALLAS (B17, whose plain version serves CPU tensors) at
the routing's worst-case capacity and below it, ``dispatch_gg`` (B16's
plain version) at comm_blocks 1 and 4, and the fp8 transport (B18's plain
version). The JAX package runs here on the suite's ``mesh4``: its XLA
and PALLAS tiers (the low-latency kernels in interpret mode); B16 is held
to the JAX dispatch and the reference's definition of its fused kernel
(tests/torch_ep_cases.py says why that kernel does not run here).
Inputs are made with numpy from seeds: 4 tokens a rank, 8 experts, top-2,
hidden 32, slots of at most 8 KiB.

Held here: the routing layout exactly; every rank's received payload
bitwise, its ids, counts and overflow exactly, its combine within 1e-5
(the top-k fold in f32, choices in top-k order); the dropped pairs at
max_m 2 the same as the reference's; B16's received rows and gate/up rows
bitwise on integer-valued inputs, and the tile schedule of the received
ids (ready and used tables, every field) exactly, as JAX builds it; the fp8 bytes of ``quantize_rows``,
the scale packing, and the quantized exchange bitwise; the refusals.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ep_cases import (
    E, MAX_M, METHODS, SMALL_M, TOPK, WORLD, blocks, ops_inputs, routing, run,
)
from triton_dist_tpu.kernels import ep_a2a as jep
from triton_dist_tpu.kernels import low_latency_all_to_all as jll
from triton_dist_tpu.runtime.compat import tpu_interpreter_available

from triton_dist_tpu_torch.kernels import ep_a2a
from triton_dist_tpu_torch.kernels import low_latency_all_to_all as ll
from triton_dist_tpu_torch.kernels import plain

DISPATCH_FIELDS = ("x", "ids", "counts", "overflow", "dest", "pos",
                   "send_counts")


def _jax_dispatched(d) -> dict:
    return {"x": np.asarray(d.x), "ids": np.asarray(d.expert_ids),
            "counts": np.asarray(d.counts),
            "overflow": np.asarray(d.overflow),
            "dest": np.asarray(d.layout.dest), "pos": np.asarray(d.layout.pos),
            "send_counts": np.asarray(d.layout.send_counts)}


@pytest.fixture(scope="module")
def ops(mesh4, tmp_path_factory):
    if not tpu_interpreter_available():
        pytest.skip("this jax lacks the Pallas TPU interpreter")
    inp = ops_inputs()
    tmp = tmp_path_factory.mktemp("ep_ops")

    def jax_side():
        # the dispatch and combine calls under jax.jit: eager, each op of
        # the interpret-mode kernels dispatches on its own (~15x slower)
        out = {}
        ids, tw = jnp.asarray(inp["ids"]), jnp.asarray(inp["topk_w"])
        for method in METHODS:
            for mm in (MAX_M, SMALL_M):
                ctx = jep.create_ep_a2a_context(
                    mesh4, E, TOPK, mm, axis="tp",
                    method=jep.EpA2AMethod(method))
                d = jax.jit(functools.partial(jep.dispatch, ctx))(
                    jnp.asarray(inp["tok_int"]), ids)
                out[f"disp/{method}/m{mm}"] = _jax_dispatched(d)
                out[f"comb/{method}/m{mm}"] = np.asarray(jax.jit(
                    functools.partial(jep.combine, ctx))(
                    jnp.asarray(inp[f"expert_out_m{mm}"]), d, tw))
        ctx = jep.create_ep_a2a_context(
            mesh4, E, TOPK, MAX_M, axis="tp", method=jep.EpA2AMethod.PALLAS,
            payload_dtype=jnp.float8_e4m3fn)
        # the fp8 calls eager: compiled, XLA folds the dequantizing scale
        # in another order and the rows differ from the port's in the
        # last bit
        out["fp8/disp"] = np.asarray(
            jep.dispatch(ctx, jnp.asarray(inp["tok"]), ids).x)
        out["fp8/a2a_q"] = np.asarray(jll.fast_all_to_all_quantized(
            mesh4, "tp", jnp.asarray(inp["q_slots"])))
        return out

    want, ranks, checks = run(tmp, "ops", inp, jax_side)
    return {"inp": inp, "jax": want, "ranks": ranks, "checks": checks}


@pytest.mark.parametrize("seed,m,topk,e,n", [
    (1, 16, 2, 8, 4), (2, 4, 8, 128, 4), (3, 64, 8, 128, 4),
    (4, 6, 2, 4, 2)], ids=["tiny", "qwen3_30b_decode", "qwen3_30b_b64",
                           "world2"])
def test_dispatch_layout_equals_jax(seed, m, topk, e, n):
    """dest, pos and send_counts of every (token, choice), exactly."""
    ids = routing(np.random.default_rng(seed), m, topk, e)
    ours = ep_a2a.dispatch_layout(torch.from_numpy(ids), n, e // n)
    ref = jep.dispatch_layout(jnp.asarray(ids), n, e // n)
    for name, a, b in zip(ours._fields, ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


@pytest.mark.parametrize("mm", [MAX_M, SMALL_M], ids=["worst_case",
                                                      "drops"])
@pytest.mark.parametrize("method", METHODS)
def test_dispatch_equals_jax_per_rank(ops, method, mm):
    """Each rank's received payload bitwise, its local ids, counts,
    overflow and home-rank layout exactly, against the JAX tier of the
    same name and the other JAX tier (their bytes agree). At max_m 2 the
    over-capacity pairs are dropped and counted as the reference does."""
    for jmethod in METHODS:
        want = ops["jax"][f"disp/{jmethod}/m{mm}"]
        for r in range(WORLD):
            for f in DISPATCH_FIELDS:
                got = ops["ranks"][r][f"disp/{method}/m{mm}/{f}"]
                ref = want[f]
                if f in ("x", "ids", "counts"):
                    ref = blocks(ref)[r]
                elif f == "overflow":
                    ref = ref[r:r + 1]
                else:
                    ref = blocks(ref)[r]
                np.testing.assert_array_equal(
                    got, ref, err_msg=f"rank {r} {f} vs JAX {jmethod}")
    total = sum(int(ops["ranks"][r][f"disp/{method}/m{mm}/overflow"][0])
                for r in range(WORLD))
    assert (total > 0) == (mm == SMALL_M)


@pytest.mark.parametrize("mm", [MAX_M, SMALL_M], ids=["worst_case",
                                                      "drops"])
@pytest.mark.parametrize("method", METHODS)
def test_combine_equals_jax_per_rank(ops, method, mm):
    """Each rank's (M_local, d) f32 rows within 1e-5 of the JAX combine
    on the same expert outputs; a dropped choice adds nothing."""
    want = blocks(ops["jax"][f"comb/{method}/m{mm}"])
    for r in range(WORLD):
        np.testing.assert_allclose(ops["ranks"][r][f"comb/{method}/m{mm}"],
                                   want[r], rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("cb", [1, 4])
def test_dispatch_gg_equals_jax_fused(ops, cb):
    """B16's plain version (the port's PALLAS_FUSED on CPU tensors) at
    comm_blocks 1 and 4, on integer-valued tokens and weights: the
    received rows, ids and counts bitwise the JAX dispatch's, and the
    gate/up rows (slot order, pad slots 0) bitwise the JAX PALLAS_FUSED
    kernel's definition, which the reference's own check of that kernel
    holds it to: each live slot's row times its expert's weight. (The
    JAX kernel itself does not run here: tests/torch_ep_cases.py.)"""
    want = ops["jax"][f"disp/xla/m{MAX_M}"]
    w = ops["inp"]["w_gate_up_int"]
    e_loc = E // WORLD
    for r in range(WORLD):
        got = ops["ranks"][r]
        for f in ("x", "ids", "counts"):
            np.testing.assert_array_equal(got[f"gg/cb{cb}/{f}"],
                                          blocks(want[f])[r], err_msg=f)
        rows = blocks(want["x"])[r].reshape(-1, w.shape[1])
        ids = blocks(want["ids"])[r].reshape(-1)
        live = ids < e_loc
        ref = np.zeros((rows.shape[0], w.shape[2]), np.float32)
        ref[live] = np.einsum("rk,rkn->rn", rows[live],
                              w[r * e_loc + ids[live]])
        np.testing.assert_array_equal(got[f"gg/cb{cb}/inter"], ref)
        assert live.sum() == blocks(want["counts"])[r].sum()


@pytest.mark.parametrize("cb", [1, 2, 4])
@pytest.mark.parametrize("seed", [5, 6])
def test_recv_tile_schedule_equals_jax(seed, cb):
    """The arrival-ordered schedule of received ids (the pad sentinel
    binned past the live tiles): the ready and used tables and every
    field exactly."""
    rng = np.random.default_rng(seed)
    e_loc, max_m, bm = 2, 16, 8
    ids = rng.integers(0, e_loc + 1, (WORLD, max_m)).astype(np.int32)
    sched, ready = ep_a2a._recv_tile_schedule(torch.from_numpy(ids), WORLD,
                                              e_loc, bm, cb)
    jsched, jready = jax.jit(jep._recv_tile_schedule,
                             static_argnums=(1, 2, 3, 4))(
        jnp.asarray(ids), WORLD, e_loc, bm, cb)
    np.testing.assert_array_equal(ready.numpy(), np.asarray(jready))
    for name, a, b in zip(sched._fields, sched, jsched):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


def test_quantize_rows_bytes_equal_jax(ops):
    """quantize_rows gives the reference's fp8 e4m3 bytes and f32 scales
    (compared as uint8 / bitwise), pack_scales / unpack_scales its
    layout, dequantize_rows its values."""
    x = ops["inp"]["q_slots"]
    q, s = ll.quantize_rows(torch.from_numpy(x), torch.float8_e4m3fn)
    jq, js = jll.quantize_rows(jnp.asarray(x), jnp.float8_e4m3fn)
    np.testing.assert_array_equal(q.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    flat = s.reshape(x.shape[0], -1)[:, :5]
    packed = ll.pack_scales(flat)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(
        jll.pack_scales(jnp.asarray(flat.numpy()))))
    assert torch.equal(ll.unpack_scales(packed, 5), flat)
    np.testing.assert_array_equal(
        ll.dequantize_rows(q, s, torch.float32).numpy(),
        np.asarray(jll.dequantize_rows(jq, js, jnp.float32)))


def test_fp8_transport_equals_jax(ops):
    """The quantized exchange (B18's plain version) bitwise the JAX
    PALLAS tier's, and the fp8 dispatch under XLA and PALLAS, explicit and
    through TD_QUANT=always, bitwise the JAX PALLAS tier's dequantized
    payload (random tokens)."""
    want = blocks(ops["jax"]["fp8/a2a_q"])
    for r in range(WORLD):
        got = ops["ranks"][r]
        np.testing.assert_array_equal(got["fp8/a2a_q"], want[r])
        jwant = blocks(ops["jax"]["fp8/disp"])[r]
        for method in METHODS:
            np.testing.assert_array_equal(got[f"fp8/disp/{method}"], jwant)
        np.testing.assert_array_equal(got["fp8/policy_always"], jwant)


def test_refusals_and_no_launch_on_cpu(ops):
    """TD_QUANT=error_budget on the EP payload judges the ep_dispatch
    contract (a budget of 0.5 takes the fp8 wire, bitwise TD_QUANT=always's
    dispatch; 0.01 the full width, bitwise the lossless dispatch), a
    dcn_axis names A9 (tail), an expert count the world does not divide
    raises; on CPU tensors no kernel launched."""
    for r, c in enumerate(ops["checks"]):
        for key in ("error_budget_judges_contract", "dcn_axis_raises_a9",
                    "odd_experts_raise", "no_launch_on_cpu"):
            assert c[key] is True, (r, key)


def test_one_card_world_plain_versions():
    """The plain versions that hold B17 and B16 in the one-card world
    (every rank's slots in one process): slot r of every rank stacked,
    and the expert product of the stacked slots, equal the exchange's
    definition on four ranks' random slots."""
    rng = np.random.default_rng(9)
    xs = [torch.from_numpy(rng.standard_normal((WORLD, 3, 16)).astype(
        np.float32)) for _ in range(WORLD)]
    outs = plain.all_to_all_slots_shards(xs)
    for r in range(WORLD):
        for s in range(WORLD):
            assert torch.equal(outs[r][s], xs[s][r])
    ids = torch.from_numpy(rng.integers(0, 3, (WORLD, 3)).astype(np.int32))
    counts = torch.tensor([3, 1, 0, 2], dtype=torch.int32)
    w = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32))
    ids = torch.where(torch.arange(3)[None] < counts[:, None], ids % 2, 2)
    got = plain.slot_expert_product(outs[0], ids, counts, w)
    for s in range(WORLD):
        for j in range(3):
            row = got[s * 3 + j]
            if j < counts[s]:
                torch.testing.assert_close(row, outs[0][s, j] @ w[ids[s, j]],
                                           rtol=1e-6, atol=1e-6)
            else:
                assert not row.any()
