#!/usr/bin/env python3
"""Times B6 (rhd_all_reduce) and B19 (flash_decode_partial), or with
``--gemm`` B4 at world 1 (gemm_ar) and B12 (pallas_matmul), or with
``--bidir`` B13b (pallas_gemm_rs_bidir), B17 and B18 on four cards, of
one checkout of the port, with chip_smoke.py's timing methods, so that
two checkouts can be compared in one call on the same card(s):

    python3 chip_compare.py [--root DIR] [--four | --gemm | --bidir [--sweep]]

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
2,048) beside NCCL all_to_all_single; the slowest rank. ``--sweep``
(a checkout with the plans' ``bidir_layout`` / ``a2a_layout``) adds each
protocol forced at more rows, the sweep that sets RS_LL_MAX_SLOT_BYTES
and A2A_LL_MAX_SLOT_BYTES. Prints one JSON line with the checkout's root
and the card's name and power limit. Run it on the card: without one it
exits non-zero.
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


def _rank(rank, port, root, queue, mode="four"):
    """One rank process of --four (B6 at ROWS on cuda:rank) or --bidir."""
    import traceback
    try:
        import torch
        import torch.distributed as dist
        arm, _, _, _ = _import_port(root)
        from triton_dist_tpu_torch.runtime import mesh as tp_mesh
        tp_mesh.initialize_distributed(f"tcp://localhost:{port}", cs.TP,
                                       rank, device="cuda")
        mesh = tp_mesh.make_comm_mesh()
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
            if f in ("ok", "bitwise"):
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
    ap.add_argument("--sweep", action="store_true")
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
    elif args.gemm:
        from triton_dist_tpu_torch.kernels import allgather_gemm as agm
        from triton_dist_tpu_torch.kernels import gemm_allreduce as ga
        rec.update(gemm(torch, ga, agm))
    else:
        rec.update(one_card(torch, arm, fa, symm))
    print(json.dumps(rec), flush=True)
    if not all(v.get("bitwise", True) and v.get("ok", True)
               for v in rec.values() if isinstance(v, dict)):
        sys.exit(1)


if __name__ == "__main__":
    main()
