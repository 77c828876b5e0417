#!/usr/bin/env python3
"""Times B6 (rhd_all_reduce) and B19 (flash_decode_partial), or with
``--gemm`` B4 at world 1 (gemm_ar) and B12 (pallas_matmul), or with
``--bidir`` B13b (pallas_gemm_rs_bidir), B17 and B18 on four cards, or
with ``--ar`` B4 across ranks (pallas_gemm_ar) and B5
(one_shot_all_reduce) on four cards, or with ``--paged`` B2
(paged_flash_decode_partial), B19 and the ContinuousEngine's harvest
by kernel, or with ``--sp`` / ``--sp4`` the sequence-parallel kernels on
one card / four, of one checkout of the port, with chip_smoke.py's timing
methods, so that two checkouts can be compared in one call on the same
card(s):

    python3 chip_compare.py [--root DIR]
                            [--four | --gemm | --bidir | --ar | --paged |
                             --sp | --sp4]
                            [--sweep]

``--root`` is the checkout whose ``triton_dist_tpu_torch`` is timed
(default: the one beside this script; an older commit unpacked with
``git archive`` works as long as it has both kernels). One card: B6 in
the one-card world (four logical ranks, the four calls together,
queued_ms, and 20 calls a rank in a graph per rank) at 16 and 512 rows
of 5,120 bf16, and B19 at B=4 over S_loc 32,768 and 4,096 of Qwen3-32B's
heads, bf16 (time_ms and graph_time_ms). ``--four``: B6 on four cards,
one process a card, 16 and 512 rows (queued_ms and graph_time_ms, the
slowest rank). ``--gemm``: B4 at Qwen3-8B's o and down, B12 at Qwen3-8B's
QKV, o, gate_up and down and Qwen3-30B-A3B's QKV and o, bf16, at M = 4
and 8, each warm (20 calls on one weight in a graph: the weight stays in
L2) and cold (the calls rotate over weight copies that exceed twice the
L2), torch.mm beside each in the same two states. ``--bidir``: one
process a card, Qwen3-32B's TP=4 o (K 2,048) and down (K 6,400) -> N
5,120 in bf16 at 4 rows a rank (warm: queued calls on one weight; cold:
queued calls rotating over weight copies larger than twice the L2) and
at the static serve's prefill (2,048 rows a rank), beside
``_fused_matmul_reduce_scatter`` and torch.mm + NCCL reduce-scatter; B17
and B18 at Qwen3-30B-A3B's EP=4 slots (4, 32, 2,048) and (4, 4,096,
2,048) beside NCCL all_to_all_single; the slowest rank. ``--ar``: one
process a card, B4 across ranks at Qwen3-32B's TP=4 o (K 2,048) and down
(K 6,400) -> N 5,120, 16 rows bf16, warm (queued calls on one weight)
and cold (queued calls rotating over weight copies larger than twice
the L2), beside torch.mm + NCCL all-reduce in the same states; B5 at 16
and 512 rows of 5,120 bf16 (queued and in a graph of 20 calls) beside
NCCL all-reduce and B6 (rhd_all_reduce) forced into its one-shot regime
on the same x; the slowest rank. ``--paged``: B2 in bf16 at the static
paged Engine's B=4 x 528 keys (Qwen3-8B's heads, a (4, 8) table of
128-key pages; the host's microseconds to issue a call, eager, and in
graphs of 20 calls warm and cold: the calls
rotate over pool copies whose live pages exceed twice the L2), at the
ContinuousEngine's Qwen3-8B batch (8 ragged rows of a 16-page table) and
a TP=4 rank of Qwen3-32B (16 rows, Hq 16, Hkv 2), warm and cold, and at
tp4_sp's paged decode on one card (B=4, Hq 64, Hkv 8, 256 pages a row:
537 MB), each held against its plain version and beside its bound; B19
at its two shapes (as the default mode); then Qwen3-8B (36 layers,
random bf16 weights, seed 0) in the ContinuousEngine at its defaults
(max_batch 8, page 128, K = 4) with eight requests decoding: one
harvest's device time by kernel name under torch.profiler (the mean of 3
harvests), B2's share of it, and the harvest's wall and replay ms by
CUDA events; the static paged Engine's graph-replayed step by kernel
and its step run eagerly (the host's wall ms a step, four rounds of
eight steps). ``--sp``: B21 (pallas_ring_attn_per_device) in the one-card
world at 8,192 tokens of Qwen3-32B's heads (chip_smoke's b21_ring_attn:
every case held, the four ranks' calls queued, beside its plain version,
torch.cat + SDPA and B1's prefill form on the same work), B1's prefill,
T=1, continuation, fold and varlen forms (chip_smoke's phases), B19, B2's
cases as ``--paged`` times them, and B20 in the one-card world; the
ptxas report of flash_prefill and sp_attention (kept beside each
library, so a cached build reports it too). ``--sp4``: chip_smoke's
tp4_sp on four cards, one process a card (every SP tier's 32,768-token
prefill, the decode steps' graph replays, each kernel at the paths'
shapes against its plain version and NCCL yardsticks), the slowest rank.
``--sweep`` (a checkout with the plans'
``bidir_layout`` / ``a2a_layout``, or with ``--ar`` ``ar_layout`` and
``one_shot_plan``) adds each protocol forced at more rows, the sweep
that sets RS_LL_MAX_SLOT_BYTES and A2A_LL_MAX_SLOT_BYTES (with
``--bidir``) or AR_LL_MAX_SLOT_BYTES and ONE_SHOT_LL_MAX_SLOT_BYTES
(with ``--ar``). Prints one JSON line with the checkout's root and the
card's name and power limit. Run it on the card: without one it exits
non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (the timing helpers; stdlib only)

ROWS = (16, 512)
S_LOCS = (32768, 4096)
# (entry, shape name, K, N): the decode projections B4 and B12 serve
GEMMS = (("b4", "o", 4096, 4096), ("b4", "down", 12288, 4096),
         ("b12", "qkv", 4096, 6144), ("b12", "o", 4096, 4096),
         ("b12", "gate_up", 4096, 24576), ("b12", "down", 12288, 4096),
         ("b12", "moe_qkv", 2048, 5120), ("b12", "moe_o", 4096, 2048))
GEMM_ROWS = (4, 8)


def _import_port(root: str):
    sys.path.insert(0, os.path.abspath(root))
    import triton_dist_tpu_torch  # noqa: F401
    from triton_dist_tpu_torch.kernels import allreduce as arm
    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.runtime import build, symm
    return arm, fa, build, symm


def _ptxas(build, reports, name: str) -> list[str]:
    """ptxas' report of csrc/<name>.cu, each kernel's entry line, then its
    register and spill lines: from this run's build, else from the report
    kept beside the library (csrc/build/<name>-<hash>.ptxas; a checkout
    whose builder does not keep it gets it kept here)."""
    kept = build.library_path(name).with_suffix(".ptxas")
    if name in reports:
        kept.write_text(reports[name])
    text = kept.read_text() if kept.exists() else ""
    return [ln.strip() for ln in text.splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]


def b19_times(torch, fa, g) -> dict:
    """B19 at B=4 over S_loc 32,768 and 4,096 of Qwen3-32B's heads, bf16:
    ms a call eagerly and in a graph of 20 calls."""
    out = {}
    hq, hkv, d = cs.SP_HEADS
    i32 = dict(dtype=torch.int32, device="cuda")
    q = torch.randn((4, hq, d), generator=g, device="cuda").to(torch.bfloat16)
    for s_loc in S_LOCS:
        k = torch.randn((4, s_loc, hkv, d), generator=g, device="cuda").to(
            torch.bfloat16)
        v = torch.randn((4, s_loc, hkv, d), generator=g, device="cuda").to(
            torch.bfloat16)
        st = torch.tensor(3 * s_loc, **i32)
        qp = torch.tensor(4 * s_loc - 1, **i32)

        def call():
            return fa.flash_decode_partial(q, k, v, st, qp)
        out[f"b19_s_loc{s_loc}"] = {"ms": cs.time_ms(call),
                                    "graph_ms": cs.graph_time_ms(call)}
        del k, v
        torch.cuda.empty_cache()
    return out


def one_card(torch, arm, fa, symm) -> dict:
    """B6 in the one-card world and B19, ms a call."""
    out = {}
    world = symm.OneCardWorld(cs.TP)
    g = torch.Generator(device="cuda").manual_seed(47)
    for m in ROWS:
        xs = [torch.randn((m, 5120), generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(cs.TP)]
        outs = world.run(lambda r: arm.rhd_all_reduce(world.mesh(r), xs[r]))
        torch.cuda.synchronize()
        ok = all(torch.equal(o, ref) for o, ref in
                 zip(outs, arm.rhd_ref_shards(xs)))
        ms = cs.queued_ms(torch, lambda: world.run(
            lambda r: arm.rhd_all_reduce(world.mesh(r), xs[r])))[0]
        _, replay = cs._world_graphs(torch, world, lambda r: [
            arm.rhd_all_reduce(world.mesh(r), xs[r]) for _ in range(20)])
        replay()
        out[f"b6_one_card_m{m}"] = {"ms": ms, "graph_ms": replay() / 20,
                                    "bitwise": ok}
    del world
    torch.cuda.empty_cache()
    out.update(b19_times(torch, fa, g))
    return out


def gemm(torch, ga, agm) -> dict:
    """B4 (world 1) and B12 in bf16, ms a call, warm and cold, with
    torch.mm in the same states."""
    out = {}
    g = torch.Generator(device="cuda").manual_seed(53)
    entry = {"b4": ga.gemm_ar, "b12": agm.pallas_matmul}
    for which, name, k, n in GEMMS:
        ws = cs.weight_copies(torch, g, k, n, torch.bfloat16)
        for m in GEMM_ROWS:
            a = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            fn = entry[which]
            out[f"{which}_{name}_m{m}"] = {
                "warm": cs.cold_graph_ms(torch, lambda w: fn(a, w), ws[:1]),
                "cold": cs.cold_graph_ms(torch, lambda w: fn(a, w), ws),
                "mm_warm": cs.cold_graph_ms(
                    torch, lambda w: torch.mm(a, w), ws[:1]),
                "mm_cold": cs.cold_graph_ms(
                    torch, lambda w: torch.mm(a, w), ws),
                "bound": cs.bound_ms(2 * (m * k + k * n + m * n),
                                     2.0 * m * k * n)[0]}
        del ws
        torch.cuda.empty_cache()
    return out


def four_cards(root: str, mode: str = "four") -> dict:
    import multiprocessing as mp
    import socket
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_rank, args=(r, port, root, queue, mode))
             for r in range(cs.TP)]
    for p in procs:
        p.start()
    per = {}
    try:
        while len(per) < cs.TP:
            rank, res = queue.get(timeout=300)
            if "error" in res:
                raise RuntimeError(f"rank {rank}: {res['error']}")
            per[rank] = res
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return _slowest(per)


def _timer(torch, dist):
    """timed(fn[, ws]): queued ms of fn() (or of fn(w), w rotating over ws)
    with every rank in step; try_timed: the same, or why a yardstick
    could not run."""
    def timed(fn, ws=None):
        fn() if ws is None else fn(ws[0])
        torch.cuda.synchronize()
        dist.barrier()
        ms = (cs.queued_ms(torch, fn)[0] if ws is None
              else cs.queued_cold_ms(torch, fn, ws))
        dist.barrier()
        return ms

    def try_timed(fn, ws=None):
        try:
            return timed(fn, ws)
        except Exception as exc:     # a yardstick only
            dist.barrier()
            return f"{type(exc).__name__}: {str(exc)[:200]}"
    return timed, try_timed


def _bidir_rank(mesh, root, sweep):
    """--bidir on this rank: {key: {"ms", ... , "ok"}}."""
    import torch
    import torch.distributed as dist
    from torch.distributed import _symmetric_memory as symm_mem
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.kernels import low_latency_all_to_all as ll
    from triton_dist_tpu_torch.kernels import plain
    if hasattr(symm_mem, "enable_symm_mem_for_group"):
        symm_mem.enable_symm_mem_for_group(mesh.group.group_name)
    tp, bf, dev = cs.TP, torch.bfloat16, mesh.device
    g = torch.Generator(device=dev).manual_seed(60 + mesh.rank)
    res = {}
    timed, try_timed = _timer(torch, dist)

    def held(out, ref, tol=1e-2):
        return cs._held(torch, "", out, ref, tol)["ok"]

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, k in (("o", 2048), ("down", 6400)):
        for m in (4, 2048):
            a = torch.randn((tp * m, k), generator=g, device=dev).to(bf)
            b = (torch.randn((k, 5120), generator=g, device=dev)
                 * k ** -0.5).to(bf)

            def mm_rs(w, a=a, m=m):
                part = torch.mm(a, w)
                y = part.new_empty((m, 5120))
                dist.reduce_scatter_tensor(y, part, group=mesh.group)
                return y

            def fused(w, a=a):
                return symm_mem._fused_matmul_reduce_scatter(
                    a, w, "sum", scatter_dim=0,
                    group_name=mesh.group.group_name)
            rec = {"ok": held(grs.pallas_gemm_rs_bidir(mesh, a, b),
                              grs.gemm_rs_bidir_ref(mesh, a, b)),
                   "ms": timed(lambda: grs.pallas_gemm_rs_bidir(mesh, a, b)),
                   "fused_mm_rs_ms": try_timed(lambda: fused(b)),
                   "mm_nccl_rs_ms": timed(lambda: mm_rs(b))}
            if m == 4:
                ws = cs.weight_copies(torch, g, k, 5120, bf)
                rec["cold_ms"] = timed(
                    lambda w: grs.pallas_gemm_rs_bidir(mesh, a, w), ws)
                rec["fused_mm_rs_cold_ms"] = try_timed(fused, ws)
                rec["mm_nccl_rs_cold_ms"] = timed(mm_rs, ws)
                del ws
            if sweep and m == 4 and name == "o":
                for mm in (4, 8, 16, 32):
                    am = torch.randn((tp * mm, k), generator=g,
                                     device=dev).to(bf)
                    for proto in (True, False):
                        plan = grs.bidir_layout(tp, mm, k, 5120, True, sms,
                                                mesh.ranks_per_device, proto)
                        run = (lambda am=am, plan=plan:
                               grs._launch_bidir(mesh, am, b, plan))
                        res[f"sweep_b13b_o_m{mm}_"
                            f"{'ll' if proto else 'flags'}"] = {
                            "ok": held(run(),
                                       grs.gemm_rs_bidir_ref(mesh, am, b)),
                            "ms": timed(run),
                            "slot_bytes": mm * 5120 * 4}
            res[f"b13b_{name}_m{m}"] = rec
            del a, b
            torch.cuda.empty_cache()

    def nccl(x):
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=mesh.group)
        return y
    for shp, mm in (("decode_m32", 32), ("chunk_m4096", 4096)):
        x = torch.randn((tp, mm, 2048), generator=g, device=dev).to(bf)
        res[f"b17_{shp}"] = {
            "ok": cs._bitwise(ll.fast_all_to_all_per_device(mesh, x),
                              plain.all_to_all_slots(mesh, x)),
            "ms": timed(lambda: ll.fast_all_to_all_per_device(mesh, x)),
            "nccl_ms": timed(lambda: nccl(x))}
        q, s = ll.quantize_rows(x, torch.float8_e4m3fn)
        s = ll.pack_scales(s)
        rq, rs = ll.fast_all_to_all_q_per_device(mesh, q, s)
        res[f"b18_{shp}"] = {
            "ok": cs._bitwise(rq, plain.all_to_all_slots(mesh, q))
            and cs._bitwise(rs, plain.all_to_all_slots(mesh, s)),
            "ms": timed(lambda: ll.fast_all_to_all_q_per_device(mesh, q, s)),
            "nccl_ms": timed(lambda: (nccl(q.view(torch.uint8)), nccl(s)))}
        del x, q, s, rq, rs
        torch.cuda.empty_cache()
    if sweep:
        for mm in (16, 32, 64, 128, 256):
            x = torch.randn((tp, mm, 2048), generator=g, device=dev).to(bf)
            per = sms // mesh.ranks_per_device
            grids = {True: min(-(-mm * 256 // ll._NT), per),     # a2a_plan
                     False: min(-(-tp * mm * 4096 // ll._BLOCK_BYTES),
                                ll._BLOCKS_PER_SM * per)}
            for proto in (True, False):
                plan = ll.a2a_layout(tp, mm, 4096, 0, 0, grids[proto], proto)
                run = (lambda x=x, plan=plan:
                       ll._launch(mesh, x, None, plan)[0])
                res[f"sweep_b17_m{mm}_{'ll' if proto else 'flags'}"] = {
                    "ok": cs._bitwise(run(), plain.all_to_all_slots(mesh, x)),
                    "ms": timed(run), "slot_bytes": mm * 4096,
                    "grid": plan.grid}
    return res


# rows of x (B5) and of A (B4's o) in --ar --sweep: 4-64 rows of 5,120
AR_SWEEP_ROWS = (4, 8, 16, 32, 64)


# (case, B, Hq, Hkv, table width, lengths): B2's bf16 shapes on the paths
PAGED_CASES = (
    ("static_b4_528", 4, 32, 8, 8, [528] * 4),
    ("continuous_8b_b8", 8, 32, 8, 16,
     [1600, 0, 1, 128, 129, 777, 1536, 1023]),
    ("continuous_tp4_rank_b16", 16, 16, 2, 16,
     [2048] * 12 + [1, 0, 1000, 2047]),
    ("tp4_sp_paged_one_card", 4, 64, 8, 256, [32768] * 4))


def b2_times(torch, pfd, g) -> dict:
    """B2's bf16 cases (PAGED_CASES), each held against its plain version
    and timed eagerly, in a graph of 20 calls warm and cold."""
    out = {}
    ps, d = 128, 128
    for case, b, hq, hkv, npg, lens in PAGED_CASES:
        table = torch.randperm(b * npg, generator=g, device="cuda").reshape(
            b, npg).to(torch.int32).contiguous()
        q = torch.randn((b, hq, d), generator=g, device="cuda").to(
            torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        nbytes, flops = cs._b2_bytes(lens, hq, hkv, d, 2, npg, ps)
        if nbytes < 2 * cs.L2_BYTES:
            copies = cs._b2_pool_copies(torch, g, hkv, b * npg, ps, d,
                                        nbytes)
        else:                 # the live pages alone exceed twice the L2
            copies = [tuple(torch.randn((hkv, b * npg, ps, d), generator=g,
                                        device="cuda").to(torch.bfloat16)
                            for _ in range(2))]

        def call(w, q=q, table=table, lengths=lengths):
            return pfd.paged_flash_decode_partial(q, w[0], w[1], table,
                                                  lengths)
        acc, _, l = call(copies[0])
        racc, _, rl = pfd.paged_flash_decode_partial_ref(
            q, *copies[0], table, lengths)
        err = (acc / l.clamp_min(1e-30)[..., None]
               - racc / rl.clamp_min(1e-30)[..., None]).abs().max().item()
        rec = {"ok": err <= 2e-3, "max_abs_err": err,
               "host_us": host_us(torch, lambda: call(copies[0])),
               "ms": cs.time_ms(lambda: call(copies[0])),
               "graph_ms": cs.graph_time_ms(lambda: call(copies[0])),
               "bound_ms": cs.bound_ms(nbytes, flops)[0], "bytes": nbytes}
        if nbytes < 2 * cs.L2_BYTES:
            rec["cold_ms"] = cs.cold_graph_ms(torch, call, copies)
        out[f"b2_{case}"] = rec
        del copies, acc, racc
        torch.cuda.empty_cache()
    return out


def paged(torch, root: str) -> dict:
    """--paged: B2's bf16 cases (b2_times), B19 (b19_times) and the
    ContinuousEngine's harvest by kernel (harvest_by_kernel)."""
    sys.path.insert(0, os.path.abspath(root))
    from triton_dist_tpu_torch import models
    from triton_dist_tpu_torch.kernels import flash_attention as fa
    pfd = importlib.import_module(
        "triton_dist_tpu_torch.kernels.paged_flash_decode")
    g = torch.Generator(device="cuda").manual_seed(71)
    out = b2_times(torch, pfd, g)
    out.update(b19_times(torch, fa, g))
    out["harvest"] = harvest_by_kernel(torch, models)
    return out


def _row(row: dict) -> dict:
    """A chip_smoke kernels-line row's times and verdict."""
    keys = ("ms", "graph_ms", "cold_ms", "plain_ms", "library_ms",
            "bound_ms", "max_abs_err")
    rec = {k: row[k] for k in keys if isinstance(row.get(k), (int, float))}
    rec["ok"] = True          # the phase exits non-zero on a failed case
    return rec


def sp_one_card(torch, root: str) -> dict:
    """--sp: B21 in the one-card world at 8,192 tokens (phase
    b21_ring_attn's timed case, with cat + SDPA and B1's prefill form on
    the same work), B1's prefill, T=1, continuation, fold and varlen forms
    (chip_smoke's phases), B19 (b19_times), B2 (b2_times) and B20 in the
    one-card world, ms a call."""
    sys.path.insert(0, os.path.abspath(root))
    from triton_dist_tpu_torch.kernels import flash_attention as fa
    from triton_dist_tpu_torch.kernels import plain
    from triton_dist_tpu_torch.runtime import symm
    spm = importlib.import_module(
        "triton_dist_tpu_torch.kernels.sp_ag_attention")
    fdm = importlib.import_module("triton_dist_tpu_torch.kernels.flash_decode")
    pfd = importlib.import_module(
        "triton_dist_tpu_torch.kernels.paged_flash_decode")
    out = {}
    b21 = cs.phase_b21(torch, symm, spm, plain)
    out["b21_t8192_cb4"] = {**_row(b21), **{
        k: b21["shapes"]["t8192_cb4"][k]
        for k in ("b1_prefill_same_work_ms",)
        if k in b21["shapes"]["t8192_cb4"]}}
    torch.cuda.empty_cache()
    out["b1_prefill"] = _row(cs.phase_b1(torch, fa))
    out["b1_decode_t1"] = _row(cs.phase_b1_decode(torch, fa))
    cont = cs._b1_continuation(torch, fa)
    out["b1_continuation"] = {**_row(cont), "ok": cont["ok"]}
    for row in cs.phase_b1_fold(torch, fa):
        out[f"b1_{row['name']}"] = _row(row)
    torch.cuda.empty_cache()
    g = torch.Generator(device="cuda").manual_seed(71)
    out.update(b19_times(torch, fa, g))
    out.update(b2_times(torch, pfd, g))
    out["b20_one_card"] = _row(cs.phase_b20(torch, symm, fdm))
    return out


def _sp_flat(res: dict) -> dict:
    """tp4_sp's record of one rank as {key: {field: number or verdict}}:
    each tier's prefill ms, each decode path's ms a step, each kernel's
    times and verdict (chip_smoke's _tp4_sp)."""
    out = {}
    for tier, r in res["prefill"].items():
        out[f"prefill_{tier}"] = {"ms": r["ms"], "finite_ok": r["finite"]}
    for label, r in res["decode"].items():
        out[f"decode_{label}"] = {
            "ms_per_step": r["ms_per_step"],
            "replays_per_step": r["replays_per_step"],
            "graph_equals_eager_ok": r["graph_equals_eager"],
            "finite_ok": r["finite"]}
    for name, r in res["kernels"].items():
        out[f"kernel_{name}"] = {k: r[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err", "ok")
            if isinstance(r.get(k), (int, float, bool))}
    out["peak"] = {"bytes": res["peak_bytes"]}
    return out


def host_us(torch, fn, calls: int = 200) -> float:
    """Host microseconds a call of fn() takes to issue, over `calls`
    calls with no synchronization between them (the device queue keeps
    up where the kernel is shorter than its launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


# kernel-name pieces of B2 (the Hopper kernel's source, the FMA body)
B2_KERNEL_NAMES = ("PagedSrc", "paged_decode_kernel")


def harvest_by_kernel(torch, models, harvests: int = 3) -> dict:
    """Qwen3-8B (all 36 layers, random bf16 weights from seed 0) in the
    ContinuousEngine at its defaults (max_batch 8, page 128, max_length
    2,048, prefill chunk 512, K = 4, prefix cache) with eight requests
    of the continuous phase's kind (seed 11, two sharing a prefix)
    admitted and prefilled: `harvests` harvests of every row decoding
    under torch.profiler, their device time by kernel name (ms a
    harvest) and B2's share of it; before that, without the profiler,
    as many harvests' host wall ms and device span (CUDA events around
    them) a harvest. Then the static paged Engine's graph-replayed step
    (B=4 x 512, page 128) under torch.profiler as chip_smoke.py's
    profile phase takes it (4 steps), with B2's share."""
    from torch.profiler import ProfilerActivity, profile
    arch = models.QWEN3_ARCHS["Qwen/Qwen3-8B"]
    params = models.init_random_params(
        torch.Generator(device="cuda").manual_seed(0), arch, "cuda",
        torch.bfloat16)
    model = models.Qwen3(arch, max_length=2048, dtype=torch.bfloat16,
                         device="cuda")
    eng = models.ContinuousEngine(model, params, max_batch=8, page_size=128,
                                  prefill_chunk=512, decode_steps=4,
                                  prefix_cache=True)
    for prompt, _ in cs._traffic(torch, arch.vocab_size, 8, 11,
                                 n_shared=2):
        eng.submit(prompt, max_new_tokens=256)
    while eng.queue or any(r is None or r.prefilling for r in eng.slots):
        eng.step()
    for _ in range(2):                     # graph captured, warm
        eng.step()
    torch.cuda.synchronize()

    def window():
        chunks = eng.stats()["prefill_chunks"]
        for _ in range(harvests):
            eng.step()
        torch.cuda.synchronize()
        return eng.stats()["prefill_chunks"] == chunks
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    ev[0].record()
    clean = window()
    ev[1].record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / harvests
    span_ms = ev[0].elapsed_time(ev[1]) / harvests
    replays = eng.graph_replays
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        clean = window() and clean
    replays = eng.graph_replays - replays

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    ev_dev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and dev_us(e) > 0]
    total = sum(dev_us(e) for e in ev_dev) / 1e3 / harvests
    by_name = sorted(([e.key[:120], dev_us(e) / 1e3 / harvests,
                       e.count // harvests] for e in ev_dev),
                     key=lambda r: -r[1])
    b2_ms = sum(ms for name, ms, _ in by_name
                if any(p in name for p in B2_KERNEL_NAMES))
    rows = [r for r in eng.slots if r is not None]
    res = {"ok": clean and replays == harvests, "harvests": harvests,
           "rows_decoding": len(rows),
           "row_lengths": [len(r.prompt) + len(r.out) for r in rows],
           "wall_ms": wall_ms, "events_span_ms": span_ms,
           "device_ms_by_profiler": total, "b2_ms": b2_ms,
           "b2_share": b2_ms / total if total else None,
           "by_kernel": by_name[:25]}
    del eng, model
    torch.cuda.empty_cache()
    # the static paged Engine's step
    model = models.Qwen3(arch, max_length=1024, dtype=torch.bfloat16,
                         device="cuda")
    engine = models.Engine(model, params, cache_mode="paged", page_size=128)
    ids = torch.randint(0, arch.vocab_size, (4, 513), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(3))
    engine.serve(ids[:, :512], gen_len=4)          # captures the step
    _, step = cs._profile_engine(torch, engine, ids, 4)
    b2_step = sum(ms for name, ms, _ in step["top"]
                  if any(p in name for p in B2_KERNEL_NAMES))
    res["paged_step"] = {**step, "b2_ms_in_top": b2_step,
                         "b2_share": b2_step / step["device_ms"],
                         "eager_step_ms": eager_paged_step(
                             torch, model, params, ids)}
    del engine, model, params
    torch.cuda.empty_cache()
    return res


def eager_paged_step(torch, model, params, ids, rounds: int = 4,
                     steps: int = 8) -> list:
    """The paged Engine's decode step run eagerly (Qwen3.inference on a
    paged cache, no graph; B=4 prompts of 512, page 128), as chip_smoke.py's
    paged_graph phase times it: after one warm step, `rounds` rounds of
    `steps` steps, the host's wall ms a step in each round."""
    cache = model.create_paged_kv_cache(4, page_size=128)
    logits, _ = model.inference(params, cache, ids[:, :512])
    tok = logits.argmax(-1).to(torch.int32)
    model.inference(params, cache, tok[:, None])
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, _ = model.inference(params, cache, tok[:, None])
            tok = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / steps)
    return out


# rows of x (B5) and of A (B4's o) in --ar --sweep: 4-64 rows of 5,120
AR_SWEEP_ROWS = (4, 8, 16, 32, 64)


def _ar_rank(mesh, sweep):
    """--ar on this rank: {key: {"ms", ..., "ok"}}."""
    import torch
    import torch.distributed as dist
    from triton_dist_tpu_torch.kernels import allreduce as arm
    from triton_dist_tpu_torch.kernels import gemm_allreduce as ga
    tp, bf, dev = cs.TP, torch.bfloat16, mesh.device
    g = torch.Generator(device=dev).manual_seed(90 + mesh.rank)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rpd = mesh.ranks_per_device
    timed, _ = _timer(torch, dist)
    res = {}

    def held(out, ref, tol=1e-2):
        return cs._held(torch, "", out, ref, tol)["ok"]

    def same_everywhere(out):
        outs = [torch.empty_like(out) for _ in range(tp)]
        dist.all_gather(outs, out, group=mesh.group)
        return all(cs._bitwise(o, out) for o in outs)

    for name, k in (("o", 2048), ("down", 6400)):
        a = torch.randn((16, k), generator=g, device=dev).to(bf)
        b = (torch.randn((k, 5120), generator=g, device=dev)
             * k ** -0.5).to(bf)

        def mm_ar(w, a=a):
            y = torch.mm(a, w)
            dist.all_reduce(y, group=mesh.group)
            return y
        out = ga.pallas_gemm_ar(mesh, a, b)
        ws = cs.weight_copies(torch, g, k, 5120, bf)
        res[f"b4_{name}_m16"] = {
            "ok": held(out, ga.gemm_ar_ref_tp(mesh, a, b))
            and same_everywhere(out),
            "ms": timed(lambda: ga.pallas_gemm_ar(mesh, a, b)),
            "cold_ms": timed(lambda w: ga.pallas_gemm_ar(mesh, a, w), ws),
            "mm_nccl_ar_ms": timed(lambda: mm_ar(b)),
            "mm_nccl_ar_cold_ms": timed(mm_ar, ws),
            "bound_ms": cs.tp_bound_ms(*cs._tp_bound("ar", 16, k, 5120))[0]}
        del ws
        if sweep and name == "o":
            for mm in AR_SWEEP_ROWS:
                am = torch.randn((mm, k), generator=g, device=dev).to(bf)
                for proto in (True, False):
                    plan = ga.ar_layout(tp, mm, k, 5120, True, sms, rpd,
                                        proto)
                    run = (lambda am=am, plan=plan:
                           ga._launch_ar(mesh, am, b, plan))
                    res[f"sweep_b4_o_m{mm}_{'ll' if proto else 'flags'}"] = {
                        "ok": held(run(), ga.gemm_ar_ref_tp(mesh, am, b)),
                        "ms": timed(run), "slot_bytes": mm * 5120 * 4}
        del a, b
        torch.cuda.empty_cache()

    def nccl(x):
        y = x.clone()
        dist.all_reduce(y, group=mesh.group)
        return y

    def b6_one_shot(x):
        """B6 in its one-shot regime on x, its protocol by its own rule."""
        from triton_dist_tpu_torch.kernels.reduce_scatter import (
            LL_MAX_SLOT_BYTES,
        )
        kv = x.shape[1] * x.element_size() // 16
        plan = arm.rhd_layout(tp, x.shape[0], kv,
                              arm.rhd_grid(x.shape[0], kv, sms, rpd),
                              x.shape[0] * kv * 16 <= LL_MAX_SLOT_BYTES,
                              False)
        return arm._launch_rhd(mesh, x, plan)
    for m in (16, 512):
        x = torch.randn((m, 5120), generator=g, device=dev).to(bf)
        run = (lambda x=x: arm.one_shot_all_reduce(mesh, x))
        res[f"b5_m{m}"] = {
            "ok": cs._bitwise(run(), arm.one_shot_ref(mesh, x)),
            "ms": timed(run), "graph_ms": cs.graph_time_ms(run),
            "nccl_ms": timed(lambda: nccl(x)),
            "b6_one_shot_ms": timed(lambda: b6_one_shot(x)),
            "b6_one_shot_ok": cs._bitwise(b6_one_shot(x),
                                          arm.rhd_ref(mesh, x)),
            "bound_ms": cs.tp_bound_ms(*cs._tp_bound("one_shot", m, 5120,
                                                     0))[0]}
        dist.barrier()
    if sweep:
        for mm in AR_SWEEP_ROWS:
            x = torch.randn((mm, 5120), generator=g, device=dev).to(bf)
            kv = 5120 * 2 // 16
            for proto in (True, False):
                plan = arm.rhd_layout(tp, mm, kv, arm.rhd_grid(mm, kv, sms,
                                                               rpd),
                                      proto, False)
                run = (lambda x=x, plan=plan:
                       arm._launch_one_shot(mesh, x, plan))
                res[f"sweep_b5_m{mm}_{'ll' if proto else 'flags'}"] = {
                    "ok": cs._bitwise(run(), arm.one_shot_ref(mesh, x)),
                    "ms": timed(run), "graph_ms": cs.graph_time_ms(run),
                    "slot_bytes": mm * kv * 16}
                dist.barrier()
    return res


SPLIT_SOURCE = os.path.join(HERE, "triton_dist_tpu_torch", "csrc", "measure",
                            "b5_split.cu")


def _split_library(build) -> str:
    """csrc/measure/b5_split.cu built with the port's nvcc flags into its
    build directory (once a call, before the ranks start)."""
    out = build.BUILD_DIR / "b5_split.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                        SPLIT_SOURCE], check=True, capture_output=True,
                       timeout=build.NVCC_TIMEOUT_S)
    return str(out)


def _b5_split_rank(mesh, lib_path, m=16, calls=32):
    """B5's one-launch kernel as it stood before the one-shot regime
    (csrc/measure/b5_split.cu, stamped), on this rank at m rows of 5,120
    bf16, its calls queued back to back as chip_smoke.py times B5: the
    device ms a call, and each call split by the stamps into the gap
    between calls (the launch), begin_call, the store loop (with the
    fence), the serial wait, the fold and end_call, ns, the mean over the
    timed calls of the mean over the blocks."""
    import ctypes
    import torch
    import torch.distributed as dist
    from triton_dist_tpu_torch.runtime import build
    from triton_dist_tpu_torch.runtime.symm import op_workspace
    fn = ctypes.CDLL(lib_path).td_b5_split
    fn.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p)
    tp, dev = cs.TP, mesh.device
    g = torch.Generator(device=dev).manual_seed(95 + mesh.rank)
    x = torch.randn((m, 5120), generator=g, device=dev).to(torch.bfloat16)
    kv = 5120 * 2 // 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # the grid and layout of the kernel's own launcher (8 KiB of x a
    # block; landing (2, world, m, K), then the flags)
    grid = max(1, min(-(-m * kv * 16 // 8192), kv,
                      sms // mesh.ranks_per_device))
    flag_off = -(-2 * tp * m * 5120 * 2 // 256) * 256
    ws = op_workspace(mesh, ("b5_split", m), (flag_off + grid * tp * 8,),
                      torch.uint8)
    stamps = torch.zeros((calls, grid, 8), dtype=torch.int64, device=dev)
    out = torch.empty_like(x)
    turn = iter(range(1 << 30))

    def call():
        i = next(turn) % calls
        with torch.cuda.device(dev):
            err = fn(x.data_ptr(), out.data_ptr(), mesh.rank, tp,
                     ws.buf.table.data_ptr(), ws.ctl.data_ptr(), m, kv, 0,
                     flag_off, grid, stamps[i].data_ptr(),
                     build.stream_of(x))
        build.check(err, "b5_split")
    call()
    torch.cuda.synchronize()
    dist.barrier()
    ms = cs.queued_ms(torch, call)[0]     # 1 + 2 warm + 20 timed calls
    dist.barrier()
    st = stamps.cpu().numpy().astype("float64")
    timed = st[4:23]          # the timed calls whose next call is timed
    nxt = st[5:24]
    ns_a_cycle = ((timed[:, :, 7] - timed[:, :, 0]).sum()
                  / (timed[:, :, 6] - timed[:, :, 1]).sum())
    phases = ("begin_call", "stores_and_fence", "serial_wait", "fold",
              "end_call")
    rec = {"ms": ms, "grid": grid, "ns_a_cycle": float(ns_a_cycle),
           "ok": bool(ns_a_cycle > 0)}
    for j, name in enumerate(phases):
        rec[f"{name}_ns"] = float(
            (timed[:, :, j + 2] - timed[:, :, j + 1]).mean() * ns_a_cycle)
    rec["span_ns"] = float((timed[:, :, 7].max(1)
                            - timed[:, :, 0].min(1)).mean())
    rec["gap_ns"] = float((nxt[:, :, 0].min(1) - timed[:, :, 7].max(1))
                          .mean())
    rec["block_entry_spread_ns"] = float(
        (timed[:, :, 0].max(1) - timed[:, :, 0].min(1)).mean())
    return rec


def _rank(rank, port, root, queue, mode="four"):
    """One rank process of --four (B6 at ROWS on cuda:rank), --bidir or
    --ar."""
    import traceback
    try:
        import torch
        import torch.distributed as dist
        arm, _, _, _ = _import_port(root)
        from triton_dist_tpu_torch.runtime import mesh as tp_mesh
        tp_mesh.initialize_distributed(f"tcp://localhost:{port}", cs.TP,
                                       rank, device="cuda")
        mesh = tp_mesh.make_comm_mesh()
        if mode.startswith("split:"):
            res = {"b5_before_split_m16": _b5_split_rank(mesh, mode[6:])}
            dist.barrier()
            queue.put((rank, res))
            dist.destroy_process_group()
            return
        if mode == "sp":
            from triton_dist_tpu_torch import kernels as kern
            res = _sp_flat(cs._tp4_sp(torch, dist, mesh, kern))
            dist.barrier()
            queue.put((rank, res))
            dist.destroy_process_group()
            return
        if mode in ("ar", "ar_sweep"):
            res = _ar_rank(mesh, mode == "ar_sweep")
            dist.barrier()
            queue.put((rank, res))
            dist.destroy_process_group()
            return
        if mode != "four":
            res = _bidir_rank(mesh, root, mode == "sweep")
            dist.barrier()
            queue.put((rank, res))
            dist.destroy_process_group()
            return
        g = torch.Generator(device=mesh.device).manual_seed(50 + rank)
        res = {}
        for m in ROWS:
            x = torch.randn((m, 5120), generator=g, device=mesh.device).to(
                torch.bfloat16)
            ok = bool(torch.equal(arm.rhd_all_reduce(mesh, x),
                                  arm.rhd_ref(mesh, x)))
            dist.barrier()
            ms = cs.queued_ms(torch, lambda: arm.rhd_all_reduce(mesh, x))[0]
            dist.barrier()
            gms = cs.graph_time_ms(lambda: arm.rhd_all_reduce(mesh, x))
            dist.barrier()
            res[f"b6_four_cards_m{m}"] = {"ms": ms, "graph_ms": gms,
                                          "bitwise": ok}
        dist.barrier()
        queue.put((rank, res))
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, {"error": traceback.format_exc()}))


def _slowest(per: dict) -> dict:
    """Each key's numbers, the slowest rank's; "ok" / "bitwise" on every
    rank; a yardstick's note where some rank could not time it."""
    out = {}
    for key, row in per[0].items():
        rec = {}
        for f, v in row.items():
            vals = [per[r][key][f] for r in per]
            if f in ("ok", "bitwise") or f.endswith("_ok"):
                rec[f] = all(vals)
            elif all(isinstance(x, (int, float)) for x in vals):
                rec[f] = max(vals)
            else:
                rec[f] = next(x for x in vals
                              if not isinstance(x, (int, float)))
        out[key] = rec
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--four", action="store_true")
    mode.add_argument("--gemm", action="store_true")
    mode.add_argument("--bidir", action="store_true")
    mode.add_argument("--ar", action="store_true")
    mode.add_argument("--paged", action="store_true")
    mode.add_argument("--sp", action="store_true")
    mode.add_argument("--sp4", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--split", action="store_true",
                    help="with --ar: only the stamped split of B5's "
                    "kernel as it stood before the one-shot regime "
                    "(csrc/measure/b5_split.cu, built from this script's "
                    "checkout)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_compare: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    arm, fa, build, symm = _import_port(args.root)
    reports = build.build(build.all_sources())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    rec = {"root": os.path.abspath(args.root), "cards": smi}
    if args.sp or args.sp4:       # the attention libraries' registers
        rec["ptxas"] = {name: _ptxas(build, reports, name)
                        for name in ("flash_prefill", "sp_attention")}
    if args.four:
        rec.update(four_cards(args.root))
    elif args.bidir:
        rec.update(four_cards(args.root, "sweep" if args.sweep else "bidir"))
    elif args.ar and args.split:
        rec.update(four_cards(args.root, "split:" + _split_library(build)))
    elif args.ar:
        rec.update(four_cards(args.root, "ar_sweep" if args.sweep else "ar"))
    elif args.paged:
        rec.update(paged(torch, args.root))
    elif args.sp:
        rec.update(sp_one_card(torch, args.root))
    elif args.sp4:
        rec.update(four_cards(args.root, "sp"))
    elif args.gemm:
        from triton_dist_tpu_torch.kernels import allgather_gemm as agm
        from triton_dist_tpu_torch.kernels import gemm_allreduce as ga
        rec.update(gemm(torch, ga, agm))
    else:
        rec.update(one_card(torch, arm, fa, symm))
    print(json.dumps(rec), flush=True)
    if not all(v.get("bitwise", True) and v.get("ok", True)
               and v.get("b6_one_shot_ok", True)
               for v in rec.values() if isinstance(v, dict)):
        sys.exit(1)


if __name__ == "__main__":
    main()
