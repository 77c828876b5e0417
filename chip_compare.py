#!/usr/bin/env python3
"""Times B6 (rhd_all_reduce) and B19 (flash_decode_partial), or with
``--gemm`` B4 at world 1 (gemm_ar) and B12 (pallas_matmul), of one
checkout of the port, with chip_smoke.py's timing methods, so that two
checkouts can be compared in one call on the same card(s):

    python3 chip_compare.py [--root DIR] [--four | --gemm]

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
L2), torch.mm beside each in the same two states. Prints one JSON line
with the checkout's root and the card's name and power limit. Run it on
the card: without one it exits non-zero.
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


def _rank(rank, port, root, queue):
    """One rank process of --four: B6 at ROWS on cuda:rank."""
    import traceback
    try:
        import torch
        import torch.distributed as dist
        arm, _, _, _ = _import_port(root)
        from triton_dist_tpu_torch.runtime import mesh as tp_mesh
        tp_mesh.initialize_distributed(f"tcp://localhost:{port}", cs.TP,
                                       rank, device="cuda")
        mesh = tp_mesh.make_comm_mesh()
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


def four_cards(root: str) -> dict:
    import multiprocessing as mp
    import socket
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [ctx.Process(target=_rank, args=(r, port, root, queue))
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
    return {key: {"ms": max(per[r][key]["ms"] for r in per),
                  "graph_ms": max(per[r][key]["graph_ms"] for r in per),
                  "bitwise": all(per[r][key]["bitwise"] for r in per)}
            for key in per[0]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--four", action="store_true")
    mode.add_argument("--gemm", action="store_true")
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
    elif args.gemm:
        from triton_dist_tpu_torch.kernels import allgather_gemm as agm
        from triton_dist_tpu_torch.kernels import gemm_allreduce as ga
        rec.update(gemm(torch, ga, agm))
    else:
        rec.update(one_card(torch, arm, fa, symm))
    print(json.dumps(rec), flush=True)
    if not all(v.get("bitwise", True) for v in rec.values()
               if isinstance(v, dict)):
        sys.exit(1)


if __name__ == "__main__":
    main()
