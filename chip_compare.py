#!/usr/bin/env python3
"""Times B6 (rhd_all_reduce) and B19 (flash_decode_partial), or with
``--gemm`` B4 at world 1 (gemm_ar) and B12 (pallas_matmul), or with
``--bidir`` B13b (pallas_gemm_rs_bidir), B17 and B18 on four cards, or
with ``--ar`` B4 across ranks (pallas_gemm_ar) and B5
(one_shot_all_reduce) on four cards, of one checkout of the port, with
chip_smoke.py's timing methods, so that two checkouts can be compared in
one call on the same card(s):

    python3 chip_compare.py [--root DIR]
                            [--four | --gemm | --bidir | --ar] [--sweep]

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
on the same x; the slowest rank. ``--sweep`` (a checkout with the plans'
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
import json
import os
import subprocess
import sys

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
    build.build(build.all_sources())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    rec = {"root": os.path.abspath(args.root), "cards": smi}
    if args.four:
        rec.update(four_cards(args.root))
    elif args.bidir:
        rec.update(four_cards(args.root, "sweep" if args.sweep else "bidir"))
    elif args.ar and args.split:
        rec.update(four_cards(args.root, "split:" + _split_library(build)))
    elif args.ar:
        rec.update(four_cards(args.root, "ar_sweep" if args.sweep else "ar"))
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
