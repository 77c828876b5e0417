"""One rank of the bidirectional-ring and mesh-level op parity tests
(tests/test_torch_bidir.py, test_torch_mesh_ops.py,
test_torch_native_sched.py).

    python tests/torch_bidir_worker.py RANK WORLD STORE INPUTS OUTDIR PART

Joins a gloo process group of WORLD ranks through a FileStore at STORE,
runs the cases of PART on the CPU over the inputs in INPUTS (an .npz the
test writes) and writes this rank's results to OUTDIR/rank<RANK>.npz and
its checks to OUTDIR/rank<RANK>.json. PART "bidir": ``ag_gemm_per_device``
and ``gemm_rs_per_device`` under XLA_BIDIR and PALLAS_BIDIR (whose plain
versions serve CPU tensors), ``gemm_ar_per_device`` under XLA_RING, and
``tiny_qwen3(tp=n)``'s greedy Engine tokens in triton_dist over both
bidirectional tiers and in triton_dist_AR with gemm_ar XLA_RING; "bidir2"
(world 2): the two BIDIR tiers, which take the unidirectional ones there;
"mesh": ``all_gather_op`` and ``ag_gemm`` / ``gemm_rs`` through their
contexts for every method; "moe": ``ag_group_gemm`` / ``moe_reduce_rs``
through their contexts (schedule "auto" and "native") against the
per-device tiers. Imports torch and the port, never JAX.
"""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_world import finish  # noqa: E402
from triton_dist_tpu_torch import kernels as kern  # noqa: E402
from triton_dist_tpu_torch.kernels import allgather as agk  # noqa: E402
from triton_dist_tpu_torch.kernels import allgather_gemm as agm  # noqa: E402
from triton_dist_tpu_torch.kernels import (  # noqa: E402
    gemm_reduce_scatter as grs,
)
from triton_dist_tpu_torch.kernels import moe_reduce_rs as mrs  # noqa: E402
from triton_dist_tpu_torch.kernels.allgather_group_gemm import (  # noqa: E402
    AgGroupGemmMethod, ag_group_gemm, ag_group_gemm_per_device,
    create_ag_group_gemm_context,
)
from triton_dist_tpu_torch.kernels.gemm_allreduce import (  # noqa: E402
    GemmArMethod, gemm_ar_per_device,
)
from triton_dist_tpu_torch.layers import TPContext  # noqa: E402
from triton_dist_tpu_torch.models import (  # noqa: E402
    Engine, Qwen3, params_from_numpy, tiny_qwen3,
)
from triton_dist_tpu_torch.runtime import mesh as tp_mesh  # noqa: E402
from torch_tp_worker import _raises, _unflatten  # noqa: E402

BIDIR = ("xla_bidir", "pallas_bidir")
AG_METHODS = ("auto", "xla", "xla_ring", "xla_bidir", "pallas",
              "pallas_bidir")
GATHER_METHODS = ("xla", "ring_1d", "full_mesh", "auto")
MOE_TIERS = ("xla", "xla_ring", "pallas")
LAYERS, MAX_LEN, GEN = 2, 32, 4
BM = 8


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _ag_shards(inp, kind, r, n):
    """This rank's rows of A and columns of B of the AG + GEMM case."""
    a, b = _t(inp[f"ag_a_{kind}"]), _t(inp[f"ag_b_{kind}"])
    m, nl = a.shape[0] // n, b.shape[1] // n
    return a[r * m:(r + 1) * m], b[:, r * nl:(r + 1) * nl].contiguous()


def _k_shards(inp, name, kind, r, n):
    """This rank's K columns of A and K rows of B (GEMM + RS / AR)."""
    a, b = _t(inp[f"{name}_a_{kind}"]), _t(inp[f"{name}_b_{kind}"])
    kl = a.shape[1] // n
    return a[:, r * kl:(r + 1) * kl].contiguous(), b[r * kl:(r + 1) * kl]


def _bidir(inp, mesh, out: dict, checks: dict) -> None:
    r, n = mesh.rank, mesh.world
    for kind in ("int", "rand"):
        a, b = _ag_shards(inp, kind, r, n)
        for meth in BIDIR:
            c, ag = agm.ag_gemm_per_device(n, agm.AgGemmMethod(meth), a, b,
                                           mesh=mesh)
            out[f"ag/{kind}/{meth}/out"] = c.numpy()
            out[f"ag/{kind}/{meth}/ag"] = ag.numpy()
        a, b = _k_shards(inp, "rs", kind, r, n)
        for meth in BIDIR:
            out[f"rs/{kind}/{meth}"] = grs.gemm_rs_per_device(
                n, grs.GemmRsMethod(meth), a, b, mesh=mesh).numpy()
        if "ar_a_int" in inp:
            a, b = _k_shards(inp, "ar", kind, r, n)
            out[f"ar/{kind}/xla_ring"] = gemm_ar_per_device(
                n, GemmArMethod.XLA_RING, a, b, mesh=mesh).numpy()
    odd = torch.ones((n + 2, 8))
    checks["ar_xla_ring_odd_m_raises"] = _raises(
        lambda: gemm_ar_per_device(n, GemmArMethod.XLA_RING, odd,
                                   torch.ones((8, 4)), mesh=mesh),
        ValueError, "divisible by the axis size")
    if n <= 2:
        # PALLAS_BIDIR takes the unidirectional tiers here: the BIDIR
        # wrappers are never reached
        def refuse(*_):
            raise AssertionError("a BIDIR wrapper ran at world <= 2")
        agm.pallas_ag_gemm_bidir, saved_ag = refuse, agm.pallas_ag_gemm_bidir
        grs.pallas_gemm_rs_bidir, saved_rs = refuse, grs.pallas_gemm_rs_bidir
        a, b = _ag_shards(inp, "int", r, n)
        agm.ag_gemm_per_device(n, agm.AgGemmMethod.PALLAS_BIDIR, a, b,
                               mesh=mesh)
        a, b = _k_shards(inp, "rs", "int", r, n)
        grs.gemm_rs_per_device(n, grs.GemmRsMethod.PALLAS_BIDIR, a, b,
                               mesh=mesh)
        agm.pallas_ag_gemm_bidir, grs.pallas_gemm_rs_bidir = saved_ag, \
            saved_rs
        checks["n2_takes_unidirectional"] = True
    checks["no_launch_on_cpu"] = not any(kern.launch_counts().values())


def _model(inp, mesh, out: dict) -> None:
    arch = tiny_qwen3(num_layers=LAYERS, tp=mesh.world)
    raw = _unflatten({k: inp[k] for k in inp.files}, "param/")
    params = params_from_numpy(raw, arch, "cpu", torch.float32,
                               rank=mesh.rank, world=mesh.world)
    prompt = _t(inp["prompt"]).long()
    for meth in BIDIR:
        ctx = TPContext(mesh, ag_method=agm.AgGemmMethod(meth),
                        rs_method=grs.GemmRsMethod(meth))
        model = Qwen3(arch, ctx, max_length=MAX_LEN, dtype=torch.float32,
                      device="cpu")
        out[f"tokens/{meth}"] = Engine(
            model, params, backend="triton_dist").serve(prompt, GEN).numpy()
    ctx = TPContext(mesh, gemm_ar_method=GemmArMethod.XLA_RING)
    model = Qwen3(arch, ctx, max_length=MAX_LEN, dtype=torch.float32,
                  device="cpu")
    out["tokens/ar_xla_ring"] = Engine(
        model, params, backend="triton_dist_AR").serve(prompt, GEN).numpy()


def _mesh_ops(inp, mesh, out: dict, checks: dict) -> None:
    r, n = mesh.rank, mesh.world
    for name in ("x", "x3"):
        x = _t(inp[f"gather_{name}"])
        m = x.shape[0] // n
        for meth in GATHER_METHODS:
            out[f"gather/{name}/{meth}"] = agk.all_gather_op(
                mesh, x[r * m:(r + 1) * m],
                agk.AllGatherMethod(meth)).numpy()
    for kind in ("int", "rand"):
        a, b = _ag_shards(inp, kind, r, n)
        ra, rb = _k_shards(inp, "rs", kind, r, n)
        for meth in AG_METHODS:
            ctx = agm.create_ag_gemm_context(
                mesh, method=agm.AgGemmMethod(meth))
            c, ag = agm.ag_gemm(ctx, a, b)
            out[f"ag/{kind}/{meth}/out"] = c.numpy()
            out[f"ag/{kind}/{meth}/ag"] = ag.numpy()
            ctx = grs.create_gemm_rs_context(
                mesh, method=grs.GemmRsMethod(meth))
            out[f"rs/{kind}/{meth}"] = grs.gemm_rs(ctx, ra, rb).numpy()
    checks["resolve"] = [agm.create_ag_gemm_context(mesh).resolve().value,
                         grs.create_gemm_rs_context(mesh).resolve().value]
    checks["resolve_for"] = [
        agm.create_ag_gemm_context(mesh, method=agm.AgGemmMethod.PALLAS,
                                   bm=64).resolve_for(8, 16, 32)[0].value,
        grs.create_gemm_rs_context(mesh).resolve_for(8, 16, 32)[1]]
    a, b = _ag_shards(inp, "int", r, n)
    ra, rb = _k_shards(inp, "rs", "int", r, n)
    checks["dcn_axis_raises"] = all([
        _raises(lambda: agm.ag_gemm(agm.create_ag_gemm_context(
            mesh, dcn_axis="dcn"), a, b), NotImplementedError,
            "ROADMAP A9 (tail)"),
        _raises(lambda: grs.gemm_rs(grs.create_gemm_rs_context(
            mesh, dcn_axis="dcn"), ra, rb), NotImplementedError,
            "ROADMAP A9 (tail)")])
    checks["gemm_rs_odd_m_raises"] = _raises(
        lambda: grs.gemm_rs(grs.create_gemm_rs_context(mesh),
                            ra[:n + 1], rb), ValueError,
        "divisible by the total axis size")


def _moe(inp, mesh, out: dict, checks: dict) -> None:
    """The mesh-level MoE ops through their contexts (schedule "auto" and
    "native") against the per-device tiers on the same inputs."""
    r, n = mesh.rank, mesh.world
    e = int(inp["num_experts"])
    ids = _t(inp["ids"])
    topk = ids.shape[1]
    same = {}
    for kind in ("int", "rand"):
        tok, w = _t(inp[f"b14_tok_{kind}"]), _t(inp[f"b14_w_{kind}"])
        m, nl = tok.shape[0] // n, w.shape[-1] // n
        tok_loc = tok[r * m:(r + 1) * m]
        w_loc = w[..., r * nl:(r + 1) * nl].contiguous()
        inter, wd = _t(inp[f"b15_inter_{kind}"]), _t(inp[f"b15_w_{kind}"])
        tw = _t(inp[f"topk_w_{kind}"])
        il = inter.shape[1] // n
        inter_loc = inter[:, r * il:(r + 1) * il].contiguous()
        wd_loc = wd[:, r * il:(r + 1) * il].contiguous()
        for tier in MOE_TIERS:
            want_o, want_ag = ag_group_gemm_per_device(
                n, e, AgGroupGemmMethod(tier), tok_loc, ids, w_loc, bm=BM,
                mesh=mesh)
            want_rs = mrs.moe_reduce_rs_per_device(
                n, e, topk, mrs.MoeReduceRsMethod(tier), inter_loc, ids, tw,
                wd_loc, bm=BM, mesh=mesh)
            for sched in ("auto", "native"):
                key = f"{kind}/{tier}/{sched}"
                ctx = create_ag_group_gemm_context(
                    mesh, e, topk, method=AgGroupGemmMethod(tier), bm=BM,
                    schedule=sched)
                o, ag = ag_group_gemm(ctx, tok_loc, ids, w_loc)
                rctx = mrs.create_moe_reduce_rs_context(
                    mesh, e, topk, method=mrs.MoeReduceRsMethod(tier),
                    bm=BM, schedule=sched)
                y = mrs.moe_reduce_rs(rctx, inter_loc, ids, tw, wd_loc)
                out[f"b14/{key}"], out[f"b15/{key}"] = o.numpy(), y.numpy()
                same[f"b14/{key}"] = bool(torch.equal(o, want_o)
                                          and torch.equal(ag, want_ag))
                same[f"b15/{key}"] = bool(torch.equal(y, want_rs))
    checks["equal_per_device"] = same
    checks["odd_m_raises"] = _raises(
        lambda: mrs.moe_reduce_rs(
            mrs.create_moe_reduce_rs_context(mesh, e, topk), inter_loc,
            ids[:n + 1], tw[:n + 1], wd_loc),
        ValueError, "not divisible")


def main(rank: str, world: str, store: str, inputs: str, outdir: str,
         part: str):
    rank, world = int(rank), int(world)
    torch.manual_seed(0)
    checks: dict = {}
    out: dict = {}
    try:
        tp_mesh.initialize_distributed(f"file://{store}", world, rank,
                                       device="cpu")
        mesh = tp_mesh.make_comm_mesh()
        inp = np.load(inputs)
        if part in ("bidir", "bidir2"):
            _bidir(inp, mesh, out, checks)
            if part == "bidir":
                _model(inp, mesh, out)
        elif part == "mesh":
            _mesh_ops(inp, mesh, out, checks)
        else:
            _moe(inp, mesh, out, checks)
        dist.barrier()
        checks["error"] = None
    except BaseException:
        checks["error"] = traceback.format_exc()
    finish(rank, outdir, out, checks)


if __name__ == "__main__":
    main(*sys.argv[1:])
