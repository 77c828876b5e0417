#!/usr/bin/env python3
"""Chip smoke run of the PyTorch + CUDA port on NVIDIA H100s.

    python3 chip_smoke.py [phase ...]

Builds every CUDA kernel of the port from csrc/ (one nvcc per source, all
started together) and holds each against its plain PyTorch version on the
card. Serves Qwen3-8B (published widths, all 36 layers, random bf16
weights from a seed) down its paths: ``Engine.serve`` on the paged cache
(eager decode, B1 + B2), ``Engine(model, params)`` at its defaults (the
dense cache, each decode step one CUDA-graph replay of the mega task
graph: B1 at T=1, B3, B4) and ``Engine(backend="triton_dist")`` (B12).
Then, with the 8B model freed, serves Qwen3-30B-A3B (published widths,
all 48 layers, 61.1 GB of random bf16 weights) in the triton_dist mode
(B1, B12, B14, B15, graph-replayed) and on the default mega step. It
counts each path's kernel launches in one serve, checks prefill against
prefill + one decode step, the graph-replayed steps against the eager xla
steps, and small f32 models (dense and MoE) served on the card against
the CPU. Then the tensor-parallel kernels: tutorial 01's notify / wait,
B10 (AllGather + GEMM), B13a (GEMM + ReduceScatter), B4 across ranks
(GEMM + AllReduce), B5 (one-shot all-reduce), B6 (recursive
halving-doubling all-reduce), B9 / B7 (the reduce-scatter and
all-gather of TWO_SHOT, one hop each on NVSwitch, with a flag's round
trip as their latency floor) and B14 / B15 across ranks (the MoE token all-gather + gate/up
grouped GEMM, the down grouped GEMM + top-k combine + reduce-scatter, at
Qwen3-30B-A3B's TP=4 shapes) against their plain versions with four
logical ranks on one card (the one-card world); and, when four cards are
present, Qwen3-32B (published widths, all 64 layers, bf16) served at TP=4
by four rank processes from one weight draw (prefill in xla, every decode
step one graph replay): in triton_dist (128 B10 and 128 B13a per replay),
through ``Engine(model, params)`` at its defaults (the mega step: 128 B4,
64 B3, 64 B1 per replay) and in triton_dist_AR under ONE_SHOT (128 B5)
and RHD (128 B6); the f32 4-layer gate across every TP=4 path and world
1; B10 / B13a / B4 / B5 / B6 timed on each card; then Qwen3-30B-A3B
(published widths, all 48 layers, bf16, ~15.3 GB per card) served at
TP=4 in triton_dist (48 B14 and 48 B15 across ranks per replay) and at
the Engine's defaults (the mega step, its moe task with NCCL's f32
all-reduce), B14 / B15 timed on each card, and its f32 4-layer gate
(tokens identical across both TP=4 paths, the eager xla step and world
1). Then expert parallelism: B17 (the low-latency all-to-all), B18 (its
fp8 form) and B16 (the EP dispatch fused with the gate/up grouped GEMM)
against their plain versions in the one-card world, and with four cards
Qwen3-30B-A3B at EP=4 (each rank 32 experts at full width) in
triton_dist over PALLAS, PALLAS_FUSED and PALLAS under TD_QUANT=always and
at the Engine's defaults (also with the mega step on PALLAS_FUSED), the
kernels timed on each card against NCCL, and the f32 4-layer gate (every
lossless EP path's tokens identical to the eager xla step's and world
1's). Then sequence parallelism at Qwen3-32B's attention widths: B1's
fold and varlen forms and B19 (the split-KV decode partial) against
their plain versions, B20 (the cross-rank LSE combine) and B21 (the
fused ring attention) in the one-card world, and the layer
SpGQAFlashDecodeAttention's main path on one card (world-1 prefill under
FLASH_RING and varlen XLA, decode captured in one CUDA graph, the
one-card world's PALLAS prefill, decode and paged decode, every kernel
counted); with four cards its prefill of 32,768 tokens under every tier,
its decode over a 131,072-token cache (one graph replay a step, combine
XLA and PALLAS, dense and paged), every kernel of those paths (B1's
prefill and fold forms, B2, B19, B20, B21) held on each card against its
plain version at the shapes the paths give it and timed against NCCL +
lse_merge or NCCL all-gather + SDPA, and the f32 gate of every
tier and combine against one card's dense attention. Then the small
collectives and pipeline point-to-point at Qwen3-32B's hidden (5,120
bf16): B22 (the bidirectional-ring all-gather) and B23 (the 2-D ring)
at 1-2,048 rows a rank, B24 (the point-to-point put) for every (src,
dst) pair, B25 (the device barrier) and B26 (the ring shift) in the
one-card world, each bitwise its plain version and timed, the mesh-level
ops counted; with four cards (phase tp4_comm, no model) every entry
point under every method on every card, bitwise its plain version and
counted, B22-B26 timed against NCCL, and the sweep that sets the LL
all-gather's AUTO rule. Then the quantized wire and the KV handoff: B27
(the int8 staging encode) at the int8 ring's hop shapes and B28 (the
int8 one-shot all-reduce) at 16 and 512 rows of 5,120 in the one-card
world, B29 (the KV page handoff) for every pair and B30 (its fan-out) on
128 KiB and 128 MiB of Qwen3-32B's pages, each bitwise its plain version,
B28 and the int8 KV wire within their error contracts; with four cards
Qwen3-32B at TP=4 served in triton_dist_AR under QINT8_OS (B28, 128 a
replay) and QINT8 (the int8 ring, B27 at every hop) and at the defaults
under TD_QUANT=always (the mega o/down through the ring), the
ContinuousEngine under QINT8_OS, and phase tp4_quant (B28, the ring and
the KV moves on every card against NCCL). With fewer than four cards
those phases print that they did not run. Named phases run alone (see ``main``). One JSON
line per phase; the line before the last lists
every kernel with its times and bound; the last line is the device
record. Any failed check exits non-zero. Imports nothing of JAX. Needs
one card; without one it exits non-zero and prints no result.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import time

MEM_BW = 3.35e12          # H100 SXM HBM3 bytes/s (data sheet)
BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core FLOP/s
F32_FLOPS = 67e12         # H100 SXM f32 FLOP/s outside the tensor cores
DEV = "cuda"
MOE_MODEL = "Qwen/Qwen3-30B-A3B"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA
    events, after `warmup` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def warm_side_stream(torch, fn):
    """A side stream on which fn() has run once: a capture on it keeps the
    workspaces that kernels keep per stream (B2's), made by that call, as
    the engines capture their steps on their warm-up stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    return side


def graph_time_ms(fn, iters: int = 20) -> float:
    """Device time per call of fn(): `iters` calls captured in one CUDA
    graph (after a warm-up call on the capturing stream), the graph
    replayed under CUDA events. For kernels shorter than the host's launch
    cost, which back-to-back eager calls would time instead; it is also
    how the dense decode step runs them."""
    import torch
    side = warm_side_stream(torch, fn)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


L2_BYTES = 50 * 2 ** 20    # H100 SXM L2 cache (data sheet)


def weight_copies(torch, g, k: int, n: int, dtype) -> list:
    """Copies of a random (K, N) weight, enough that together they exceed
    twice the L2 (at least two): a graph that calls a kernel on them in
    turn finds each call's weights out of L2, as a model's step finds each
    layer's weights."""
    count = max(2, -(-2 * L2_BYTES // (k * n * 2)) + 1)
    return [(torch.randn((k, n), generator=g, device=DEV)
             * k ** -0.5).to(dtype) for _ in range(count)]


def cold_graph_ms(torch, fn, ws: list, rounds: int = 6) -> float:
    """Device time per call of fn(w) with w taken in turn from ws (see
    weight_copies): rounds x len(ws) calls captured in one CUDA graph,
    replayed under CUDA events after a warm-up replay. With one w it is
    graph_time_ms: the weights stay in L2 (warm)."""
    iters = max(20, rounds * len(ws))
    side = warm_side_stream(torch, lambda: fn(ws[0]))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(ws[i % len(ws)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_or_none(torch, fn, iters: int = 10):
    """graph_time_ms of fn, or None where a library call refuses capture
    (for the yardsticks only: a kernel of the port is timed by
    graph_time_ms itself, so a capture that fails fails its phase).
    Beside an eager time_ms it gives the device time without each call's
    Python and launch cost, which a kernel of ~0.05 ms may approach."""
    try:
        return graph_time_ms(fn, iters)
    except RuntimeError:
        torch.cuda.synchronize()
        return None


def bound_ms(nbytes: float, flops: float,
             peak: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / MEM_BW, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    import torch
    _, e = torch.frexp(x.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


# -- B1: flash prefill -------------------------------------------------------

# what B1's bf16 forms run on (csrc/flash_prefill.cu, attn_tile_sm90.cuh)
B1_INSTRUCTIONS = ("bf16: wgmma.mma_async bf16->f32, m64n128k16 for QK^T "
                   "(Q, K from shared memory) and m64n64k16 for P.V (P "
                   "from registers, V transposed); 128-key K/V tiles by "
                   "TMA into a 2-stage ring (3 at T=1); f32: FMA")

def phase_b1(torch, fa):
    """Kernel vs plain version on the main-path shape, a ragged T=200, an
    offset > 0, and f32 at both head dims; the bf16 kernel's packing at
    its edges: D=64, GQA groups g = 1, 2, 8 and 16 (rows a tile 128 // g,
    or 64 // g at T * g <= 64), ragged T = 7 and T = 200 at g = 8 over a
    cache with an offset and room past it. Tolerances: bf16 2e-2
    absolute (outputs round to bf16, 2^-9 relative, and the kernel's
    128-key steps round P to bf16 against another running max than the
    plain version's, which a (query, head) row of the packed tile shares
    with the tile's other rows); f32 1e-4 (summation order only). B1 is
    also timed inside a CUDA graph, and a capture that fails fails the
    phase."""
    g = torch.Generator(device=DEV).manual_seed(1)
    cases = [  # (name, dtype, B, T, S, Hq, Hkv, D, offset, tol)
        ("main", torch.bfloat16, 4, 512, 512, 32, 8, 128, 0, 2e-2),
        ("ragged_t200", torch.bfloat16, 4, 200, 200, 32, 8, 128, 0, 2e-2),
        ("offset384", torch.bfloat16, 2, 128, 512, 32, 8, 128, 384, 2e-2),
        ("moe_hkv4_g8", torch.bfloat16, 4, 512, 512, 32, 4, 128, 0, 2e-2),
        ("f32_offset70", torch.float32, 2, 130, 200, 4, 2, 128, 70, 1e-4),
        ("f32_d64", torch.float32, 1, 100, 100, 8, 8, 64, 0, 1e-4),
        ("bf16_d64_g4", torch.bfloat16, 2, 300, 300, 32, 8, 64, 0, 2e-2),
        ("bf16_d64_g8_offset100", torch.bfloat16, 2, 200, 400, 16, 2, 64,
         100, 2e-2),
        ("bf16_g1", torch.bfloat16, 2, 256, 256, 8, 8, 128, 0, 2e-2),
        ("bf16_g2_offset60", torch.bfloat16, 2, 190, 300, 8, 4, 128, 60,
         2e-2),
        ("bf16_g8_t7_offset60", torch.bfloat16, 3, 7, 100, 16, 2, 128, 60,
         2e-2),
        ("bf16_g8_t200_offset640", torch.bfloat16, 2, 200, 900, 32, 4, 128,
         640, 2e-2),
        ("bf16_g16_t30_offset50", torch.bfloat16, 1, 30, 90, 32, 2, 128, 50,
         2e-2),
    ]
    rows, main = [], None
    for name, dt, b, t, s, hq, hkv, d, off, tol in cases:
        q = torch.randn((b, t, hq, d), generator=g, device=DEV).to(dt)
        k = torch.randn((b, s, hkv, d), generator=g, device=DEV).to(dt)
        v = torch.randn((b, s, hkv, d), generator=g, device=DEV).to(dt)
        out = fa.flash_prefill(q, k, v, off)
        ref = fa.flash_prefill_ref(q, k, v, off)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        rows.append({"case": name, "max_abs_err": err, "tol": tol,
                     "ok": finite and err <= tol})
        if name == "main":
            main = (q, k, v, off)
    emit({"phase": "b1_flash_prefill", "cases": rows})
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        fail(f"B1 disagrees with its plain version: {bad}")

    q, k, v, off = main
    b, t, hq, d = q.shape
    s = k.shape[1]
    ms = time_ms(lambda: fa.flash_prefill(q, k, v, off))
    plain_ms = time_ms(lambda: fa.flash_prefill_ref(q, k, v, off), iters=5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    library_ms = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True,
                                      enable_gqa=True))
    graph_ms = graph_time_ms(lambda: fa.flash_prefill(q, k, v, off), 10)
    library_graph_ms = graph_or_none(torch, lambda: sdpa(
        qh, kh, vh, is_causal=True, enable_gqa=True))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    pairs = sum(min(off + i + 1, s) for i in range(t))   # causal (q, k)
    flops = 4.0 * b * hq * d * pairs
    bms, by = bound_ms(nbytes, flops)
    return {"name": "flash_prefill", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/flash_prefill.cu",
            "replaces": "triton_dist_tpu/kernels/flash_attention.py:63",
            "instructions": B1_INSTRUCTIONS,
            "max_abs_err": rows[0]["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "graph_ms": graph_ms,
            "library_graph_ms": library_graph_ms,
            "shape": [b, t, hq, int(k.shape[2]), d],
            "bytes": nbytes, "flops": flops}


# -- B2: paged flash decode --------------------------------------------------

# what B2's bf16 form runs on (csrc/paged_flash_decode.cu on
# csrc/decode_tile_sm90.cuh, shared with B19)
B2_INSTRUCTIONS = ("bf16: mma.sync m16n8k16 bf16->f32 (QK^T and P.V, the g "
                   "heads padded to 16 rows), 64-key K/V tiles by TMA from "
                   "the pool's pages through a 4-stage mbarrier ring, a "
                   "grid of page splits from paged_plan, the splits merged "
                   "in the launch by a ticket; f32 / int8: FMA")


def _b2_bytes(lengths, hq, hkv, d, kv_bytes, np_table, ps=128,
              scales=False):
    """(bytes, flops) one B2 call needs: each live key and value row read
    once (with its f32 row scale for int8 pools), q, the table, the
    lengths, the f32 outputs written once."""
    tokens = sum(min(max(n, 0), np_table * ps) for n in lengths)
    row = d * kv_bytes + (4 if scales else 0)
    b = len(lengths)
    nbytes = (2 * tokens * hkv * row + b * hq * d * 2 + b * np_table * 4
              + b * 4 + (b * hq * d + 2 * b * hq) * 4)
    return nbytes, 4.0 * hq * d * tokens


def _b2_pool_copies(torch, g, hkv, pages, ps, d, live_bytes):
    """(k, v) bf16 pool pairs, enough that the live bytes of the calls
    that rotate over them exceed twice the L2 (at least two): a graph of
    calls finds each call's pages out of L2, as a model's step finds each
    layer's."""
    count = max(2, -(-2 * L2_BYTES // max(live_bytes, 1)) + 1)
    return [tuple(torch.randn((hkv, pages, ps, d), generator=g,
                              device=DEV).to(torch.bfloat16)
                  for _ in range(2)) for _ in range(count)]


def phase_b2(torch, pfd, codec, models, kern):
    """Kernel vs plain version at B=4, Hq=32, Hkv=8, D=128, page 128, a
    shuffled table with garbage in dead slots, ragged lengths with 0, 1 and
    a page boundary, NaN in four unused pages and in the rows past the
    length of each row's last live page (K and V); bf16, f32 and int8
    pools (the f32 and int8 forms are the FMA body). The bf16 kernel's
    page sizes under a tile (8, 16, 32; _b2_small_pages) likewise; its
    addressing at every edge of tiles, pages and splits with every score
    0 (_b2_uniform_scores: 1e-5, no rounding of P to blur a key); and
    four ranks of a one-card world launching at once, eagerly and in
    per-rank graphs (_b2_concurrent), and a graph captured where no
    workspace was made (_b2_graph_own_scratch). Then the
    ContinuousEngine's shapes (bf16, page 128, 16-page rows of max_length
    2048): Qwen3-8B at max_batch 8 (Hq 32, Hkv 8, ragged lengths up to
    1600) and one rank of Qwen3-32B at TP=4, max_batch 16 (Hq 16, Hkv 2: a
    GQA group of 8, rows of 2048 tokens and four ragged ones), and
    tp4_sp's paged decode on one card (B=4, Qwen3-32B's Hq 64, Hkv 8,
    32,768 keys a row in 256 pages: 537 MB of pages). The 8B batch also
    inside one captured CUDA graph replayed while its lengths advance on
    the card (across pages and splits, an empty row starting). Compared
    on the normalized output acc/l and on m and l. Tolerance 2e-3
    absolute on acc/l (P is rounded to bf16 in both, against other
    running maxima: the kernel's per warp and split; f32 summation order
    otherwise), 1e-4 relative on m and l; an empty row must give m =
    -1e30, l = 0, acc = 0 exactly. The bf16 kernel is timed eagerly and in
    graphs of calls, warm (one pool: what fits stays in the L2) and cold
    (the calls rotate over pool copies whose live pages exceed twice the
    L2, as a model's layers do); each case beside its bound. bf16 pools
    of 24, 48 and 96-key pages (the FMA body's route) as the small pages
    are, and a ContinuousEngine on 48-key pages (_b2_engine_odd_page)."""
    g = torch.Generator(device=DEV).manual_seed(2)
    b, hq, hkv, d, ps, npg = 4, 32, 8, 128, 128, 8
    spare = 4                                    # unused pages, NaN below
    num_pages = b * npg + spare
    perm = torch.randperm(b * npg, generator=g, device=DEV)
    table = perm.reshape(b, npg).to(torch.int32).contiguous()
    k16 = torch.randn((hkv, num_pages, ps, d), generator=g,
                      device=DEV).to(torch.bfloat16)
    v16 = torch.randn((hkv, num_pages, ps, d), generator=g,
                      device=DEV).to(torch.bfloat16)
    k8, ks = codec.kv_row_encode(k16)
    v8, vs = codec.kv_row_encode(v16)
    ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    q = torch.randn((b, hq, d), generator=g, device=DEV).to(torch.bfloat16)
    check_lens = torch.tensor([543, 0, 256, 1], dtype=torch.int32,
                              device=DEV)
    dead = table.clone()
    dead[1] = torch.tensor([-7, 99, 5, 3, 1000, -1, 2, 0])   # len-0 row
    main_lens = torch.full((b,), 528, dtype=torch.int32, device=DEV)
    # NaN garbage: the unused pages, and each ragged row's last live page
    # past its length
    k_nan, v_nan = k16.clone(), v16.clone()
    for pool in (k_nan, v_nan):
        pool[:, b * npg:] = float("nan")
        for row, n in enumerate(check_lens.tolist()):
            if n % ps:
                pool[:, int(dead[row, n // ps]), n % ps:] = float("nan")

    def check(mode, case, q, kp, vp, tab, lens, kw):
        acc, m, l = pfd.paged_flash_decode_partial(q, kp, vp, tab, lens,
                                                   **kw)
        racc, rm, rl = pfd.paged_flash_decode_partial_ref(
            q, kp, vp, tab, lens, **kw)
        torch.cuda.synchronize()
        return held(mode, case, (acc, m, l), (racc, rm, rl), lens,
                    [q.shape[0], q.shape[1], kp.shape[0], tab.shape[1]])

    def held(mode, case, got, ref, lens, shape):
        acc, m, l = got
        racc, rm, rl = ref
        out = acc / l.clamp_min(1e-30)[..., None]
        rout = racc / rl.clamp_min(1e-30)[..., None]
        err = (out - rout).abs().max().item()
        m_err = ((m - rm).abs() / rm.abs().clamp_min(1)).max().item()
        l_err = ((l - rl).abs() / rl.abs().clamp_min(1)).max().item()
        empty = lens == 0
        empty_ok = bool((m[empty] == -1e30).all() and (l[empty] == 0).all()
                        and (acc[empty] == 0).all())
        ok = (err <= 2e-3 and m_err <= 1e-4 and l_err <= 1e-4
              and empty_ok and bool(torch.isfinite(acc).all()))
        return {"mode": mode, "case": case, "shape": shape,
                "max_abs_err": err, "tol": 2e-3, "m_rel_err": m_err,
                "l_rel_err": l_err, "ok": ok}

    # mode: (ragged k / v pools, kwargs, q, main k / v pools)
    modes = {"bf16": (k_nan, v_nan, {}, q, k16, v16),
             "f32": (k_nan.float(), v_nan.float(), {}, q.float(),
                     k16.float(), v16.float()),
             "int8": (k8, v8, {"k_scales": ks, "v_scales": vs}, q, k8, v8)}
    rows, timed = [], {}
    for mode, (kr, vr, kw, qm, kp, vp) in modes.items():
        rows.append(check(mode, "ragged_nan_garbage" if mode != "int8"
                          else "ragged", qm, kr, vr, dead, check_lens, kw))
        rows.append(check(mode, "main", qm, kp, vp, table, main_lens, kw))
        ms = time_ms(lambda: pfd.paged_flash_decode_partial(
            qm, kp, vp, table, main_lens, **kw), iters=50)
        plain_ms = time_ms(lambda: pfd.paged_flash_decode_partial_ref(
            qm, kp, vp, table, main_lens, **kw), iters=5)
        nbytes, flops = _b2_bytes(main_lens.tolist(), hq, hkv, d,
                                  kp.element_size(), npg, ps, bool(kw))
        bms, by = bound_ms(nbytes, flops,
                           F32_FLOPS if mode == "f32" else BF16_FLOPS)
        timed[mode] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                       "bound_by": by, "bytes": nbytes, "flops": flops}
    del k_nan, v_nan, modes
    # bf16 page sizes under a tile, page sizes no TMA box cuts (the FMA
    # body's route), and ranks launching at once
    for sps, shq, shkv, sd in ((8, 32, 8, 128), (16, 32, 8, 128),
                               (32, 32, 8, 128), (16, 16, 2, 64),
                               (24, 32, 8, 128), (48, 32, 8, 128),
                               (96, 32, 8, 128), (48, 16, 2, 64)):
        rows.append(_b2_small_pages(torch, pfd, check, g, sps, shq, shkv,
                                    sd))
    rows.append(_b2_uniform_scores(torch, pfd, g))
    rows.append(_b2_concurrent(torch, pfd, held, g))
    rows.append(_b2_graph_own_scratch(torch, pfd, held, g))
    main_call = (lambda w: pfd.paged_flash_decode_partial(
        q, w[0], w[1], table, main_lens))
    timed["bf16"]["graph_ms"] = graph_time_ms(lambda: main_call((k16, v16)))
    copies = _b2_pool_copies(torch, g, hkv, num_pages, ps, d,
                             timed["bf16"]["bytes"])
    timed["bf16"]["cold_ms"] = cold_graph_ms(torch, main_call, copies)
    del copies
    torch.cuda.empty_cache()

    # the continuous shapes (max_length 2048: 16 pages a row) and tp4_sp's
    # paged decode on one card (32,768 keys a row: 256 pages)
    cases = []
    for case, pb, phq, phkv, pnp, plens in (
            ("continuous_8b_b8", 8, 32, 8, 16,
             [1600, 0, 1, 128, 129, 777, 1536, 1023]),
            ("continuous_tp4_rank_b16", 16, 16, 2, 16,
             [2048] * 12 + [1, 0, 1000, 2047]),
            ("tp4_sp_paged_one_card", 4, 64, 8, 256, [32768] * 4)):
        ptab = torch.randperm(pb * pnp, generator=g, device=DEV).reshape(
            pb, pnp).to(torch.int32).contiguous()
        pk = torch.randn((phkv, pb * pnp, ps, d), generator=g,
                         device=DEV).to(torch.bfloat16)
        pv = torch.randn((phkv, pb * pnp, ps, d), generator=g,
                         device=DEV).to(torch.bfloat16)
        pq = torch.randn((pb, phq, d), generator=g,
                         device=DEV).to(torch.bfloat16)
        plen = torch.tensor(plens, dtype=torch.int32, device=DEV)
        rows.append(check("bf16", case, pq, pk, pv, ptab, plen, {}))
        nbytes, flops = _b2_bytes(plens, phq, phkv, d, 2, pnp, ps)
        bms, by = bound_ms(nbytes, flops)
        call = (lambda w, pq=pq, ptab=ptab, plen=plen:
                pfd.paged_flash_decode_partial(pq, w[0], w[1], ptab, plen))
        rec = {"case": case, "shape": [pb, phq, phkv, pnp],
               "lengths": plens, "bytes": nbytes, "bound_ms": bms,
               "bound_by": by,
               "plan": vars(pfd.paged_plan(
                   pb, phkv, pnp, ps, torch.cuda.get_device_properties(
                       0).multi_processor_count)),
               "ms": time_ms(lambda: call((pk, pv)), iters=20),
               "graph_ms": graph_time_ms(lambda: call((pk, pv)))}
        if nbytes < 2 * L2_BYTES:
            copies = _b2_pool_copies(torch, g, phkv, pb * pnp, ps, d,
                                     nbytes)
            rec["cold_ms"] = cold_graph_ms(torch, call, copies)
            del copies
        if case == "continuous_8b_b8":
            rows.append(_b2_graph_advance(torch, pfd, held, pq, pk, pv,
                                          ptab, plens))
        cases.append(rec)
        del pk, pv
        torch.cuda.empty_cache()
    for mode in timed:
        timed[mode]["max_abs_err"] = max(r["max_abs_err"] for r in rows
                                         if r["mode"] == mode)
    rows.append(_b2_engine_odd_page(torch, models, kern, check))
    emit({"phase": "b2_paged_flash_decode", "cases": rows, "timed": cases})
    bad = [(r["mode"], r["case"]) for r in rows if not r["ok"]]
    if bad:
        fail(f"B2 disagrees with its plain version: {bad}")
    # the main path's pools are full width (bf16); the f32 and int8 forms
    # (the FMA body) ride along as sub-records
    return {"name": "paged_flash_decode_partial", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/paged_flash_decode.cu",
            "replaces": "triton_dist_tpu/kernels/paged_flash_decode.py:38",
            "instructions": B2_INSTRUCTIONS,
            **timed["bf16"], "library_ms": None,
            "shape": [b, hq, hkv, d, ps, 528], "shapes": cases,
            "f32": timed["f32"], "int8": timed["int8"]}


def _b2_graph_advance(torch, pfd, held, q, kp, vp, table, lengths):
    """B2 captured once in a CUDA graph over device lengths, replayed
    while the lengths advance on the card between replays (the
    ContinuousEngine's use): each replay against the plain version at the
    lengths it ran with. The advances cross pages and splits; the empty
    row stays empty for three replays, then starts. The graph is captured
    on its warm-up stream, as the engines capture theirs, so it keeps that
    stream's workspace (no scratch of its own is made under capture), and
    the replays must leave its tickets zero."""
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    steps = [[0] * 8, [1, 0, 1, 1, 127, 1, 64, 1],
             [1, 0, 126, 383, 1, 640, 0, 0], [447, 1, 1, 1, 1, 1, 448, 1]]
    cap = table.shape[1] * kp.shape[2]
    side = warm_side_stream(torch, lambda: pfd.paged_flash_decode_partial(
        q, kp, vp, table, lens))
    made = set(pfd._WORKSPACES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = pfd.paged_flash_decode_partial(q, kp, vp, table, lens)
    kept = set(pfd._WORKSPACES) == made
    tickets = [t for key, (_, t) in pfd._WORKSPACES.items()
               if key[1] == side.cuda_stream]
    worst, ok, seen = None, kept and len(tickets) == 1, []
    for step in steps:
        lens.add_(torch.tensor(step, dtype=torch.int32, device=DEV))
        lens.clamp_(max=cap)
        graph.replay()
        ref = pfd.paged_flash_decode_partial_ref(q, kp, vp, table, lens)
        torch.cuda.synchronize()
        rec = held("bf16", "graph", got, ref, lens, [])
        seen.append(lens.tolist())
        ok = ok and rec["ok"]
        if worst is None or rec["max_abs_err"] > worst["max_abs_err"]:
            worst = rec
    zero = all(int(t.abs().sum()) == 0 for t in tickets)
    return {**worst, "case": "graph_lengths_advanced_on_card",
            "shape": [q.shape[0], q.shape[1], kp.shape[0], table.shape[1]],
            "replays": len(steps), "lengths": seen,
            "stream_workspace_kept": kept, "tickets_left_zero": zero,
            "ok": ok and zero}


def _b2_graph_own_scratch(torch, pfd, held, g, replays: int = 3):
    """B2 captured on a stream where no call ran before, at a shape no
    other call has (B=3): no workspace exists, so the graph takes scratch
    of its own (its tickets zeroed by a fill node each replay) and the
    cache of workspaces must not grow under capture; each replay, the
    lengths advanced on the card, against the plain version."""
    b, hq, hkv, d, ps, npg = 3, 32, 8, 128, 128, 8
    table = torch.randperm(b * npg, generator=g, device=DEV).reshape(
        b, npg).to(torch.int32).contiguous()
    kp, vp = (torch.randn((hkv, b * npg, ps, d), generator=g,
                          device=DEV).to(torch.bfloat16) for _ in range(2))
    q = torch.randn((b, hq, d), generator=g, device=DEV).to(torch.bfloat16)
    lens = torch.tensor([700, 0, 129], dtype=torch.int32, device=DEV)
    made = set(pfd._WORKSPACES)
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = pfd.paged_flash_decode_partial(q, kp, vp, table, lens)
    kept = set(pfd._WORKSPACES) == made
    rows = []
    for _ in range(replays):
        graph.replay()
        ref = pfd.paged_flash_decode_partial_ref(q, kp, vp, table, lens)
        torch.cuda.synchronize()
        rows.append(held("bf16", "graph_own_scratch", got, ref, lens, []))
        lens.add_(57).clamp_(max=npg * ps)
    worst = max(rows, key=lambda rec: rec["max_abs_err"])
    return {**worst, "shape": [b, hq, hkv, npg], "replays": replays,
            "no_workspace_made_under_capture": kept,
            "ok": kept and all(rec["ok"] for rec in rows)}


def _b2_uniform_scores(torch, pfd, g):
    """B2's addressing with no rounding slack: q = 0, so every score is 0
    and every probability exactly 1 (in bf16 too); acc / l is the mean of
    the row's live V rows, which the kernel and the plain version compute
    alike up to f32 summation order (tolerance 1e-5 absolute, where a key
    dropped or taken past the length moves the mean of unit-variance rows
    by ~1/len: ~1e-3 at 1,000 keys), l must equal the row's keys and m 0
    exactly (an empty row: -1e30, 0 and acc 0). Lengths at every edge: 0-4
    keys, a tile and a page +-1 and their multiples, the plan's split
    boundaries (2 pages of 128 at B=4, Hkv 8) and the full table, four rows
    a launch, at pages of 128 keys and of 8, 16 and 32; shuffled tables
    with out-of-range values in dead slots, NaN in every page no live slot
    names and past each row's length."""
    lens_all = [0, 1, 2, 3, 4, 63, 64, 65, 127, 128, 129, 255, 256, 257,
                383, 384, 385, 511, 512, 513, 700, 17, 1023, 1024]
    b, hq, hkv, d = 4, 32, 8, 128
    worst, ok = 0.0, True
    for ps in (128, 32, 16, 8):
        npg = 1024 // ps
        num_pages = b * npg + 4
        for i in range(0, len(lens_all), b):
            lens = lens_all[i:i + b]
            table = torch.randperm(b * npg, generator=g, device=DEV).reshape(
                b, npg).to(torch.int32)
            kp, vp = (torch.randn((hkv, num_pages, ps, d), generator=g,
                                  device=DEV).to(torch.bfloat16)
                      for _ in range(2))
            live = torch.zeros(num_pages, dtype=torch.bool, device=DEV)
            for row, n in enumerate(lens):
                used = -(-n // ps)
                live[table[row, :used].long()] = True
                table[row, used:] = torch.tensor(
                    [(-7, num_pages, 10 ** 6, -1)[j % 4]
                     for j in range(npg - used)], dtype=torch.int32)
                if n % ps:
                    for pool in (kp, vp):
                        pool[:, int(table[row, n // ps]), n % ps:] = \
                            float("nan")
            for pool in (kp, vp):
                pool[:, ~live] = float("nan")
            table = table.contiguous()
            q = torch.zeros((b, hq, d), dtype=torch.bfloat16, device=DEV)
            lt = torch.tensor(lens, dtype=torch.int32, device=DEV)
            acc, m, l = pfd.paged_flash_decode_partial(q, kp, vp, table, lt)
            racc, _, rl = pfd.paged_flash_decode_partial_ref(q, kp, vp,
                                                             table, lt)
            torch.cuda.synchronize()
            err = (acc / l.clamp_min(1e-30)[..., None]
                   - racc / rl.clamp_min(1e-30)[..., None]).abs().max().item()
            keys = lt.float()[:, None].expand_as(l)
            empty = (lt == 0)[:, None].expand_as(l)
            worst = max(worst, err)
            ok = ok and err <= 1e-5 and bool(
                torch.equal(l, keys)
                and (m[~empty] == 0).all() and (m[empty] == -1e30).all()
                and (acc[lt == 0] == 0).all() and torch.isfinite(acc).all())
    return {"mode": "bf16", "case": "uniform_scores_every_edge",
            "lengths": lens_all, "page_sizes": [128, 32, 16, 8],
            "max_abs_err": worst, "tol": 1e-5, "ok": ok}


def _b2_engine_odd_page(torch, models, kern, check, ps: int = 48):
    """A ContinuousEngine on a bf16 pool of ``ps``-key pages (no TMA box
    cuts them: B2 takes the FMA body, paged_route): Qwen3-8B's widths, 2
    layers, random bf16 weights (seed 7), max_batch 4, decode_steps 1,
    four requests of 37-190 prompt tokens and 8 new tokens each, against
    the same engine at 64-key pages (the Hopper kernel). Held: B2 launched
    on every decode step (its count zeroed after a warm-up request), every
    request's 8 tokens in the vocabulary, each request's first token
    (from the prefill, which reads no page through B2) the same at both
    page sizes, and B2 on the engine's own cache against the plain
    version (``check``, 2e-3): layer 0's pools, table and lengths copied
    once every request decodes, with a random q, run after the counts are
    read. The later tokens' agreement is recorded (random weights give
    near-flat logits, where bf16 rounding in two kernels may flip an
    argmax)."""
    import dataclasses
    arch = dataclasses.replace(models.QWEN3_ARCHS["Qwen/Qwen3-8B"],
                               num_layers=2)
    params = models.init_random_params(
        torch.Generator(device=DEV).manual_seed(7), arch, DEV,
        torch.bfloat16)
    model = models.Qwen3(arch, max_length=576, dtype=torch.bfloat16,
                         device=DEV)
    rng = torch.Generator().manual_seed(8)
    prompts = [torch.randint(0, arch.vocab_size, (n,), generator=rng
                             ).tolist() for n in (37, 96, 150, 190)]
    outs, launches, snap = {}, {}, None
    for page in (ps, 64):
        eng = models.ContinuousEngine(model, params, max_batch=4,
                                      page_size=page, prefill_chunk=192,
                                      decode_steps=1)
        eng.submit([1, 2, 3], max_new_tokens=2)
        eng.run()
        eng.finished.clear()
        replays0 = eng.graph_replays
        kern.reset_launch_counts()
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        for _ in range(8 if page == ps else 0):
            eng.step()
            if all(r is not None and not r.prefilling for r in eng.slots):
                c = eng.cache
                snap = [c.k_pages[0].clone(), c.v_pages[0].clone(),
                        c.block_table.clone(), c.lengths.clone()]
                break
        done = eng.run()
        eager = kern.launch_counts()
        per = eng.graph_launches.get("paged_flash_decode_partial", 0)
        launches[page] = (eager["paged_flash_decode_partial"]
                          + (eng.graph_replays - replays0) * per)
        outs[page] = [r.out for r in sorted(done, key=lambda r: r.uid)]
        del eng
        torch.cuda.empty_cache()
    del params, model
    torch.cuda.empty_cache()
    cache_rec = {"ok": False, "max_abs_err": float("nan")}
    if snap is not None:
        kp, vp, tab, lens = snap
        q = torch.randn((tab.shape[0], arch.num_heads, kp.shape[-1]),
                        generator=torch.Generator(device=DEV).manual_seed(9),
                        device=DEV).to(torch.bfloat16)
        cache_rec = check("bf16", f"continuous_engine_page{ps}_cache", q, kp,
                          vp, tab, lens, {})
    sane = all(len(o) == 8 and all(0 <= t < arch.vocab_size for t in o)
               for o in outs[ps])
    first = [o[0] for o in outs[ps]] == [o[0] for o in outs[64]]
    agree = sum(a == b for x, y in zip(outs[ps], outs[64])
                for a, b in zip(x, y)) / max(1, sum(map(len, outs[64])))
    return {"mode": "bf16", "case": f"continuous_engine_page{ps}",
            "route": "fma", "launches": launches[ps],
            "launches_page64": launches[64], "tokens_sane": sane,
            "first_tokens_equal_page64": first,
            "token_agreement_page64": agree,
            "cache_lengths": snap[3].tolist() if snap is not None else None,
            "max_abs_err": cache_rec["max_abs_err"], "tol": 2e-3,
            "cache_ok": cache_rec["ok"],
            "ok": (sane and first and cache_rec["ok"]
                   and launches[ps] >= 7 * arch.num_layers)}


def _b2_small_pages(torch, pfd, check, g, ps, hq, hkv, d):
    """B2's bf16 kernel at a page size under a tile (8, 16 or 32: a tile
    is 64 / ps TMA boxes, a box a page, boxes past the length not
    issued), or at one no TMA box cuts (24, 48, 96: the FMA body): six
    ragged rows (543, 0, 5 ps + 1, ps - 1, ps and 1 keys) over
    a shuffled table with out-of-range values in every dead slot, NaN in
    every page no live slot names and in the rows past each row's length
    of its last live page (K and V); against the plain version."""
    lens = [543, 0, 5 * ps + 1, ps - 1, ps, 1]
    b, npg = len(lens), 600 // ps + 4
    num_pages = b * npg + 4
    table = torch.randperm(b * npg, generator=g, device=DEV).reshape(
        b, npg).to(torch.int32)
    kp = torch.randn((hkv, num_pages, ps, d), generator=g,
                     device=DEV).to(torch.bfloat16)
    vp = torch.randn((hkv, num_pages, ps, d), generator=g,
                     device=DEV).to(torch.bfloat16)
    live = torch.zeros(num_pages, dtype=torch.bool, device=DEV)
    for row, n in enumerate(lens):
        used = -(-n // ps)
        live[table[row, :used].long()] = True
        table[row, used:] = torch.tensor(
            [(-7, num_pages, 10 ** 6, -1)[i % 4] for i in range(npg - used)],
            dtype=torch.int32)
    for pool in (kp, vp):
        pool[:, ~live] = float("nan")
        for row, n in enumerate(lens):
            if n % ps:
                pool[:, int(table[row, n // ps]), n % ps:] = float("nan")
    q = torch.randn((b, hq, d), generator=g, device=DEV).to(torch.bfloat16)
    return check("bf16", f"ragged_nan_garbage_ps{ps}_hq{hq}_hkv{hkv}_d{d}",
                 q, kp, vp, table.contiguous(),
                 torch.tensor(lens, dtype=torch.int32, device=DEV), {})


def _b2_concurrent(torch, pfd, held, g, ranks: int = 4, calls: int = 8,
                   replays: int = 3):
    """B2 on the four ranks of a one-card world at once, as phase
    sp_layer's paged decode runs it: each rank its own q, pools, shuffled
    table and ragged lengths (B=4, Hq 32, Hkv 8, 8-page rows: a plan of 4
    splits of 2 pages; every row spans 2-4 live splits, so every (row, kv
    head) merges on its ticket), `calls` calls a rank on the rank's
    stream, eagerly and captured in a graph a rank (_world_graphs)
    replayed `replays` times at once, the lengths advanced on the card
    between replays. The ranks' launches overlap on the card; none may
    count on another's ticket (the workspace is the stream's). Every
    output must equal, bit for bit, the same rank's call made alone on
    the same inputs (the kernel is deterministic: the splits merge in
    ascending order whichever arrives last), and that call is held
    against the plain version (held: 2e-3 on acc / l)."""
    from triton_dist_tpu_torch.runtime import symm
    world = symm.OneCardWorld(ranks)
    b, hq, hkv, d, ps, npg = 4, 32, 8, 128, 128, 8
    ins = []
    for r in range(ranks):
        table = torch.randperm(b * npg, generator=g, device=DEV).reshape(
            b, npg).to(torch.int32).contiguous()
        kp, vp = (torch.randn((hkv, b * npg, ps, d), generator=g,
                              device=DEV).to(torch.bfloat16)
                  for _ in range(2))
        q = torch.randn((b, hq, d), generator=g, device=DEV).to(
            torch.bfloat16)
        lens = torch.tensor([1000 - 37 * r, 529 + r, 300 + 128 * r,
                             700 + 5 * r], dtype=torch.int32, device=DEV)
        ins.append((q, kp, vp, table, lens))

    def fn(r):
        return [pfd.paged_flash_decode_partial(*ins[r])
                for _ in range(calls)]

    def held_all(outs, case):
        alone = [pfd.paged_flash_decode_partial(*x) for x in ins]
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for r in range(ranks)
                   for got in outs[r] for a, c in zip(got, alone[r]))
        recs = []
        for r, x in enumerate(ins):
            ref = pfd.paged_flash_decode_partial_ref(*x)
            rec = held("bf16", case, alone[r], ref, x[4], [])
            acc, _, l = alone[r]
            row = ((acc / l.clamp_min(1e-30)[..., None]
                    - ref[0] / ref[2].clamp_min(1e-30)[..., None]).abs()
                   .amax(dim=(1, 2)).argmax().item())
            recs.append({**rec, "worst_row_keys": int(x[4][row])})
        worst = max(recs, key=lambda rec: rec["max_abs_err"])
        return {**worst, "bitwise_as_alone": same,
                "ok": same and all(rec["ok"] for rec in recs)}

    eager = world.run(fn)
    torch.cuda.synchronize()
    rows = [held_all(eager, "eager")]
    outs, replay = _world_graphs(torch, world, fn)
    for i in range(replays):
        for x in ins:
            x[4].add_(7 * i).clamp_(max=npg * ps)
        replay()
        rows.append(held_all(outs, f"graph_replay{i}"))
    worst = max(rows, key=lambda rec: rec["max_abs_err"])
    return {**worst, "case": f"world{ranks}_concurrent_eager_and_graphs",
            "shape": [b, hq, hkv, npg], "calls_a_rank": calls,
            "replays": replays,
            "bitwise_as_alone": all(rec["bitwise_as_alone"] for rec in rows),
            "ok": all(rec["ok"] for rec in rows)}


# -- B1 in its decode form ---------------------------------------------------

def phase_b1_decode(torch, fa):
    """B1 at T=1 over the dense cache, the dense decode step's attention:
    B=4, Hq 32, Hkv 8, D 128, S=1024, offset 540 as a 0-d int32 tensor on
    the card. Checked against the plain version eagerly and inside a
    captured CUDA graph replayed after the offset moved to 777 (the graph
    must read the offset on the device); Hkv 4 (g = 8); one TP=4 rank's
    heads of Qwen3-32B (Hq 16, Hkv 2, B=16) captured with the offset on
    the device and replayed at 540 and 1,000; D=64. Tolerance 2e-2
    absolute (bf16, as B1's prefill form)."""
    g = torch.Generator(device=DEV).manual_seed(11)
    b, hq, hkv, d, s, off = 4, 32, 8, 128, 1024, 540
    q = torch.randn((b, 1, hq, d), generator=g, device=DEV).to(torch.bfloat16)
    k = torch.randn((b, s, hkv, d), generator=g, device=DEV).to(torch.bfloat16)
    v = torch.randn((b, s, hkv, d), generator=g, device=DEV).to(torch.bfloat16)
    off_t = torch.tensor(off, dtype=torch.int32, device=DEV)
    rows = []
    out = fa.flash_prefill(q, k, v, off_t)
    ref = fa.flash_prefill_ref(q, k, v, off)
    torch.cuda.synchronize()
    rows.append({"case": "eager_offset540",
                 "max_abs_err": (out.float() - ref.float()).abs().max().item()})
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gout = fa.flash_prefill(q, k, v, off_t)
    off_t.fill_(777)
    graph.replay()
    ref2 = fa.flash_prefill_ref(q, k, v, 777)
    torch.cuda.synchronize()
    rows.append({"case": "graph_replay_offset777",
                 "max_abs_err": (gout.float() - ref2.float()).abs().max().item()})
    off_t.fill_(off)
    # Hkv 4 (g = 8), the attention of Qwen3-30B-A3B's decode step
    k4, v4 = k[:, :, :4].contiguous(), v[:, :, :4].contiguous()
    out4 = fa.flash_prefill(q, k4, v4, off_t)
    ref4 = fa.flash_prefill_ref(q, k4, v4, off)
    torch.cuda.synchronize()
    rows.append({"case": "eager_hkv4_g8_offset540",
                 "max_abs_err": (out4.float() - ref4.float()).abs().max()
                 .item()})
    # one TP=4 rank of Qwen3-32B's static decode step (Hq 16, Hkv 2, a
    # group of 8, B=16), captured with its offset on the device and
    # replayed after it moved
    qr = torch.randn((16, 1, 16, d), generator=g, device=DEV).to(
        torch.bfloat16)
    kr = torch.randn((16, s, 2, d), generator=g, device=DEV).to(
        torch.bfloat16)
    vr = torch.randn((16, s, 2, d), generator=g, device=DEV).to(
        torch.bfloat16)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rout = fa.flash_prefill(qr, kr, vr, off_t)
    for moved in (540, 1000):
        off_t.fill_(moved)
        graph.replay()
        rref = fa.flash_prefill_ref(qr, kr, vr, moved)
        torch.cuda.synchronize()
        rows.append({"case": f"graph_tp4_rank_b16_offset{moved}",
                     "max_abs_err": (rout.float() - rref.float()).abs()
                     .max().item()})
    off_t.fill_(off)
    del graph, kr, vr
    # D = 64 (g = 4)
    q64, k64, v64 = (x[..., :64].contiguous() for x in (q, k, v))
    out64 = fa.flash_prefill(q64, k64, v64, off_t)
    ref64 = fa.flash_prefill_ref(q64, k64, v64, off)
    torch.cuda.synchronize()
    rows.append({"case": "eager_d64_offset540",
                 "max_abs_err": (out64.float() - ref64.float()).abs().max()
                 .item()})
    for r in rows:
        r["tol"] = 2e-2
        r["ok"] = r["max_abs_err"] <= 2e-2
    emit({"phase": "b1_decode_form", "cases": rows})
    if not all(r["ok"] for r in rows):
        fail(f"B1's decode form disagrees with its plain version: {rows}")

    ms = graph_time_ms(lambda: fa.flash_prefill(q, k, v, off_t))
    plain_ms = graph_time_ms(lambda: fa.flash_prefill_ref(q, k, v, off_t),
                             iters=3)
    live = off + 1                       # keys the one query attends
    kh = k[:, :live].transpose(1, 2)
    vh = v[:, :live].transpose(1, 2)
    qh = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = graph_time_ms(lambda: sdpa(qh, kh, vh, enable_gqa=True))
    nbytes = (2 * q.numel() + 2 * b * live * hkv * d) * q.element_size()
    flops = 4.0 * b * hq * d * live
    bms, by = bound_ms(nbytes, flops)
    return {"name": "flash_prefill[decode]", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/flash_prefill.cu",
            "replaces": "triton_dist_tpu/kernels/flash_attention.py:63",
            "instructions": B1_INSTRUCTIONS,
            "max_abs_err": max(r["max_abs_err"] for r in rows), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "shape": [b, 1, hq, hkv, d, s, off],
            "bytes": nbytes, "flops": flops}


# -- B3: fused add + RMSNorm -------------------------------------------------

def phase_b3(torch, fc):
    """Kernel vs plain version, bf16 and f32, d 4096 (Qwen3-8B), 5120
    (Qwen3-32B) and 128, at 4, 8 and 16 rows (the decode batches of the
    static and continuous engines) and 2048. s must be bitwise equal (one rounding of h + a in both). The
    f32 square sums are taken in another order, so the normalized value
    x * rsqrt(var + eps), rounded to bf16 before the multiply by w, may
    take the neighbouring bf16 value: bf16 normed must lie within
    |w| x ulp(normed / w) (that one step carried through w) + ulp(normed)
    (the product's own rounding) of the plain version, elementwise; f32
    within 1e-5 relative. Timed at the decode shape (4 x 4096 bf16)."""
    g = torch.Generator(device=DEV).manual_seed(12)
    rows, main = [], None
    for dt in (torch.bfloat16, torch.float32):
        for d in (4096, 5120, 128):
            for n in (4, 8, 16, 2048):
                h = torch.randn((n, d), generator=g, device=DEV).to(dt)
                a = torch.randn((n, d), generator=g, device=DEV).to(dt)
                w = (torch.rand((d,), generator=g, device=DEV) + 0.5).to(dt)
                s, o = fc.fused_add_rms(h, a, w, 1e-6)
                rs, ro = fc.add_rms_norm_xla(h, a, w, 1e-6)
                torch.cuda.synchronize()
                diff = (o.float() - ro.float()).abs()
                if dt == torch.bfloat16:
                    wf = w.float().abs()
                    allowed = wf * bf16_ulp(ro.float() / wf) + bf16_ulp(ro)
                    worst = (diff / allowed).max().item()
                    ok = worst <= 1.0
                else:
                    worst = (diff / ro.float().abs().clamp_min(1e-30)
                             ).max().item()
                    ok = worst <= 1e-5
                rows.append({"dtype": str(dt).split(".")[-1], "d": d,
                             "rows": n, "s_bitwise": bool(torch.equal(s, rs)),
                             "normed_max_abs_err": diff.max().item(),
                             "normed_max_ulps": (diff / bf16_ulp(ro)).max()
                             .item() if dt == torch.bfloat16 else None,
                             "normed_err_in_tol_units": worst,
                             "ok": ok and bool(torch.equal(s, rs))})
                if dt == torch.bfloat16 and d == 4096 and n == 4:
                    main = (h, a, w)
    emit({"phase": "b3_fused_add_rms", "cases": rows})
    if not all(r["ok"] for r in rows):
        fail("B3 disagrees with its plain version: "
             f"{[r for r in rows if not r['ok']]}")
    h, a, w = main
    n, d = h.shape
    rms = torch.nn.functional.rms_norm
    ms = graph_time_ms(lambda: fc.fused_add_rms(h, a, w, 1e-6))
    plain_ms = graph_time_ms(lambda: fc.add_rms_norm_xla(h, a, w, 1e-6))
    library_ms = graph_time_ms(lambda: rms(h + a, (d,), w, 1e-6))
    nbytes = (4 * n * d + d) * h.element_size()
    flops = 6.0 * n * d
    bms, by = bound_ms(nbytes, flops, F32_FLOPS)
    return {"name": "fused_add_rms", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/fused_add_rms.cu",
            "replaces": "triton_dist_tpu/kernels/fused_chain.py:51",
            "max_abs_err": max(r["normed_max_abs_err"] for r in rows
                               if r["rows"] <= 16 and r["d"] != 128),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "shape": [n, d], "bytes": nbytes,
            "flops": flops}


def _held(torch, name, out, ref, tol):
    """One kernel-vs-plain case: max abs error against tol x max|ref|."""
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return {"case": name, "max_abs_err": err, "ref_absmax": scale,
            "tol": tol * scale,
            "ok": err <= tol * scale and bool(torch.isfinite(out).all())}


# -- B4: GEMM + AR at world 1, and B12: the same function ---------------------

# what B4's world-1 body and B12 run in bf16 (csrc/gemm_stream_sm90.cuh)
GEMM_INSTRUCTIONS = ("bf16: mma.sync m16n8k16 bf16->f32 with the operands "
                     "swapped (16 weight columns the MMA's rows, the batch "
                     "its n side), 128 x 128 weight tiles by TMA through a "
                     "5-stage mbarrier ring, a persistent stream-K grid, "
                     "the split-K fold in the same launch; f32: FMA")


def _device_kernels(torch, fn):
    """Device kernels that one call of fn() launches, by torch.profiler;
    None where the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(ev) or None


def _gemm_held(torch, g, entry, ref, cases):
    """Each (name, dtype, M, K, N, tol) case: the kernel against its plain
    version (max abs error <= tol x max|ref|), and in bf16 two calls the
    same bytes; A's address 2 bytes off 16 where the name says so."""
    rows = []
    for name, dt, m, k, n, tol in cases:
        if name.startswith("misaligned"):
            a = torch.randn((m * k + 1,), generator=g, device=DEV).to(dt)
            a = a[1:].view(m, k)
        else:
            a = torch.randn((m, k), generator=g, device=DEV).to(dt)
        b = (torch.randn((k, n), generator=g, device=DEV) * k ** -0.5).to(dt)
        out, again = entry(a, b), entry(a, b)
        want = ref(a, b)
        torch.cuda.synchronize()
        rows.append(_held(torch, name, out, want, tol))
        rows[-1]["same_bytes"] = bool(torch.equal(out, again))
        rows[-1]["ok"] = rows[-1]["ok"] and rows[-1]["same_bytes"]
    return rows


def _gemm_timed(torch, g, entry, ref, library, m, k, n):
    """bf16 (M, K) @ (K, N) timed in graphs of calls, warm (one weight:
    it stays in L2) and cold (weight_copies in turn, as a model's step
    finds each layer's), kernel, plain version and library call alike."""
    ws = weight_copies(torch, g, k, n, torch.bfloat16)
    a = torch.randn((m, k), generator=g, device=DEV).to(torch.bfloat16)
    rec = {"shape": [m, k, n]}
    for key, fn in (("", entry), ("plain_", ref), ("library_", library)):
        rec[f"{key}ms"] = cold_graph_ms(torch, lambda w: fn(a, w), ws[:1])
        rec[f"{key}cold_ms"] = cold_graph_ms(torch, lambda w: fn(a, w), ws)
    rec["bytes"] = (m * k + k * n + m * n) * 2
    rec["bound_ms"], rec["bound_by"] = bound_ms(rec["bytes"], 2.0 * m * k * n)
    del ws
    torch.cuda.empty_cache()
    return rec


def _gemm_row(rows, timed, row_shapes):
    """The kernels-line fields: the mean over the main path's launches
    (``row_shapes``, one each a layer) of each time, warm and cold."""
    keys = ("ms", "cold_ms", "plain_ms", "plain_cold_ms", "library_ms",
            "library_cold_ms", "bound_ms")
    return {"max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["case"] in row_shapes),
            **{key: sum(timed[s][key] for s in row_shapes) / len(row_shapes)
               for key in keys},
            "bound_by": "bytes", "instructions": GEMM_INSTRUCTIONS,
            "shapes": timed}


def phase_b4(torch, ga):
    """Kernel vs plain version at the decode path's o (K = N = 4096) and
    down (K = 12288, N = 4096) shapes at M = 1, 4 (the static Engine's
    batch), 8 (the ContinuousEngine's max_batch) and 16, 17 and 2048, at
    an odd K with A's address 2 bytes off 16 (the kernel's scalar copy of
    A) and K 4097, bf16; o at M = 4 in f32. Max abs error <= 1e-2 x
    max|ref| for bf16 (one bf16 rounding of the output, 2^-9, and another
    f32 summation order), 1e-4 relative for f32; in bf16 two calls give
    the same bytes. Timed at o and down, M = 4 and 8, warm and cold
    (weights out of L2, as the model reads them), beside the plain
    version and torch.mm in the same states; one call's device kernels
    counted by the profiler (one). The row's times are the mean over the
    main path's launches at M = 4 (one o and one down a layer); warm as
    in earlier runs, cold beside it."""
    g = torch.Generator(device=DEV).manual_seed(13)
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("o_m4", bf, 4, 4096, 4096, 1e-2),
             ("down_m4", bf, 4, 12288, 4096, 1e-2),
             ("o_m8", bf, 8, 4096, 4096, 1e-2),
             ("down_m8", bf, 8, 12288, 4096, 1e-2),
             ("o_m1", bf, 1, 4096, 4096, 1e-2),
             ("o_m16", bf, 16, 4096, 4096, 1e-2),
             ("o_m17", bf, 17, 4096, 4096, 1e-2),
             ("o_m2048", bf, 2048, 4096, 4096, 1e-2),
             ("misaligned_k100_m8", bf, 8, 100, 64, 1e-2),
             ("k4097_m3", bf, 3, 4097, 136, 1e-2),
             ("o_m4_f32", f32, 4, 4096, 4096, 1e-4)]
    rows = _gemm_held(torch, g, ga.gemm_ar, ga.gemm_ar_ref, cases)
    a = torch.randn((4, 4096), generator=g, device=DEV).to(bf)
    b = torch.randn((4096, 4096), generator=g, device=DEV).to(bf)
    kernels = _device_kernels(torch, lambda: ga.gemm_ar(a, b))
    timed = {}
    for name, k, n in (("o", 4096, 4096), ("down", 12288, 4096)):
        for m in (4, 8):
            timed[f"{name}_m{m}"] = _gemm_timed(
                torch, g, ga.gemm_ar, ga.gemm_ar_ref,
                lambda x, w: torch.mm(x, w, out_dtype=torch.float32),
                m, k, n)
    emit({"phase": "b4_gemm_ar", "cases": rows,
          "device_kernels_per_call": kernels, "timed": timed})
    if not all(r["ok"] for r in rows):
        fail(f"B4 disagrees with its plain version or repeats differ: "
             f"{[r for r in rows if not r['ok']]}")
    if kernels not in (None, 1):
        fail(f"B4: one call launched {kernels} device kernels, not 1")
    return {"name": "gemm_ar", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/gemm_ar.cu",
            "replaces": "triton_dist_tpu/kernels/gemm_allreduce.py:101",
            **_gemm_row(rows, timed, ("o_m4", "down_m4")),
            "library_ms_call": "torch.mm(a, b, out_dtype=torch.float32)",
            "device_kernels_per_call": kernels}


# -- B12: the tiled local GEMM of the triton_dist projections ----------------

def phase_b12(torch, agm):
    """Kernel vs plain version at the triton_dist decode step's shapes of
    both models at M = 4 and 8 (Qwen3-30B-A3B: QKV K 2048 / N 5120, o K
    4096 / N 2048; Qwen3-8B: QKV K 4096 / N 6144, o K = N = 4096, gate_up
    K 4096 / N 24576, down K 12288 / N 4096), at M = 2048, and at an odd
    shape, in bf16 and f32. Tolerance as B4's (the same function): max
    abs error <= 1e-2 x max|ref| in bf16 (one bf16 rounding of the output
    and another f32 summation order), 1e-4 x max|ref| in f32; in bf16 two
    calls give the same bytes. Timed at every decode shape at M = 4 and 8,
    warm and cold, beside the plain version and torch.mm in the same
    states; one call's device kernels counted (one). The row's times are
    the mean over Qwen3-30B-A3B's launches at M = 4 (one QKV and one o a
    layer), warm as in earlier runs, cold beside it. Library call:
    torch.mm in the inputs' dtype (f32 accumulation, one rounding)."""
    g = torch.Generator(device=DEV).manual_seed(14)
    bf, f32 = torch.bfloat16, torch.float32
    shapes = (("moe_qkv", 2048, 5120), ("moe_o", 4096, 2048),
              ("dense_qkv", 4096, 6144), ("dense_o", 4096, 4096),
              ("dense_gate_up", 4096, 24576), ("dense_down", 12288, 4096))
    cases = [(f"{name}_m{m}", bf, m, k, n, 1e-2)
             for name, k, n in shapes for m in (4, 8)]
    cases += [("moe_qkv_m2048", bf, 2048, 2048, 5120, 1e-2),
              ("dense_o_m2048", bf, 2048, 4096, 4096, 1e-2),
              ("odd_k1000_m5", bf, 5, 1000, 8, 1e-2),
              ("moe_o_m4_f32", f32, 4, 4096, 2048, 1e-4),
              ("moe_qkv_m2048_f32", f32, 2048, 2048, 5120, 1e-4)]
    rows = _gemm_held(torch, g, agm.pallas_matmul, agm.matmul_ref, cases)
    a = torch.randn((4, 2048), generator=g, device=DEV).to(bf)
    b = torch.randn((2048, 5120), generator=g, device=DEV).to(bf)
    kernels = _device_kernels(torch, lambda: agm.pallas_matmul(a, b))
    timed = {f"{name}_m{m}": _gemm_timed(
        torch, g, agm.pallas_matmul, agm.matmul_ref, torch.mm, m, k, n)
        for name, k, n in shapes for m in (4, 8)}
    emit({"phase": "b12_matmul", "cases": rows,
          "device_kernels_per_call": kernels, "timed": timed})
    if not all(r["ok"] for r in rows):
        fail(f"B12 disagrees with its plain version or repeats differ: "
             f"{[r for r in rows if not r['ok']]}")
    if kernels not in (None, 1):
        fail(f"B12: one call launched {kernels} device kernels, not 1")
    return {"name": "pallas_matmul", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/matmul.cu",
            "replaces": "triton_dist_tpu/kernels/allgather_gemm.py:452",
            **_gemm_row(rows, timed, ("moe_qkv_m4", "moe_o_m4")),
            "library_ms_call": "torch.mm(a, b)",
            "device_kernels_per_call": kernels}


# -- B14 / B15: the MoE expert grouped GEMMs ---------------------------------

def _moe_routing(torch, mu, plain, g, m, d, e, topk):
    """Random bf16 tokens through a random router of Qwen3-30B-A3B's
    widths: (tokens, topk_ids, topk_weights)."""
    x = torch.randn((m, d), generator=g, device=DEV).to(torch.bfloat16)
    wr = (torch.randn((d, e), generator=g, device=DEV)
          * d ** -0.5).to(torch.bfloat16)
    w, ids = mu.route_topk(plain.dot_f32(x, wr), topk)
    return x, ids, w


def _randn_bf16(torch, g, shape, scale):
    """A large bf16 tensor drawn in chunks (no f32 copy of all of it)."""
    out = torch.empty(shape, dtype=torch.bfloat16, device=DEV)
    flat = out.view(-1)
    step = 1 << 26
    for s in range(0, flat.numel(), step):
        n = min(step, flat.numel() - s)
        flat[s:s + n] = (torch.randn(n, generator=g, device=DEV)
                         * scale).to(torch.bfloat16)
    return out


def _grouped_mm_fn(torch, mu, lhs_flat, ids, w, num_experts):
    """(one torch._grouped_mm over the expert-sorted rows, how), or (None,
    why) where this torch has none that takes these inputs."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, "torch._grouped_mm missing"
    st = mu.sort_by_expert(ids, num_experts)
    lhs = lhs_flat[st.sort_idx.long()].contiguous()
    offs = torch.cumsum(st.group_sizes, 0).to(torch.int32)
    why = []
    for label, wb in (("row-major", w),
                      ("column-major", w.transpose(-2, -1).contiguous()
                       .transpose(-2, -1))):
        try:
            fn(lhs, wb, offs=offs)
            torch.cuda.synchronize()
            return (lambda: fn(lhs, wb, offs=offs)), label
        except Exception as exc:  # noqa: BLE001 - recorded, not hidden
            why.append(f"{label}: {str(exc).splitlines()[0][:160]}")
    return None, "; ".join(why)


def _grouped_mm_ms(torch, mu, lhs_flat, ids, w, num_experts):
    """library_ms of one torch._grouped_mm over the expert-sorted rows, or
    (None, why) where this torch has none that takes these inputs."""
    fn, how = _grouped_mm_fn(torch, mu, lhs_flat, ids, w, num_experts)
    return (None if fn is None else graph_time_ms(fn)), how


def phase_b14_b15(torch, agg, mrs, mu, plain):
    """B14 (gate/up) and B15 (down + top-k combine) against their plain
    versions on Qwen3-30B-A3B's widths (d 2048, 128 experts, expert width
    768, top-8) with one layer's random expert weights: the decode routing
    (B = 4 tokens through a random router: bm 32, 125 tiles, R 4000) and
    a prefill-sized chunk of 1024 tokens (bm 128), in bf16 and f32.
    Tolerance as B4's: max abs error <= 1e-2 x max|ref| in bf16 (one bf16
    rounding, another f32 summation order), 1e-4 x max|ref| in f32. Timed
    at the decode routing in bf16 (inside a captured graph of 20 calls);
    the bound counts the live experts' weights only (each read once) and
    the real rows' FLOPs. Library call: torch._grouped_mm over the
    expert-sorted rows where this torch has it for these inputs (B15's
    combine excluded), else null. Also times the xla tier's MoE block
    (dense_grouped_moe) at both sizes."""
    d, e, im, topk = 2048, 128, 768, 8
    g = torch.Generator(device=DEV).manual_seed(15)
    w_gu = _randn_bf16(torch, g, (e, d, 2 * im), d ** -0.5)
    w_dn = _randn_bf16(torch, g, (e, im, d), im ** -0.5)
    rows14, rows15, rec = [], [], {}
    for m in (4, 1024):
        x, ids, w = _moe_routing(torch, mu, plain, g, m, d, e, topk)
        bm = min(128, max(8, m * topk))
        sched = mu.aligned_chunk_schedule(ids, 1, e, bm)
        inter = (torch.randn((m * topk, im), generator=g, device=DEV)
                 ).to(torch.bfloat16)
        for dt in (torch.bfloat16, torch.float32):
            tol = 1e-2 if dt == torch.bfloat16 else 1e-4
            tag = f"m{m}_{str(dt).split('.')[-1]}"
            wgu, wdn = w_gu.to(dt), w_dn.to(dt)
            xd, interd = x.to(dt), inter.to(dt)
            out = agg.group_gemm(xd, wgu, sched, topk)
            ref = agg.group_gemm_ref(xd, wgu, sched, topk)
            torch.cuda.synchronize()
            rows14.append(_held(torch, tag, out, ref, tol))
            out = mrs.moe_rs(interd, wdn, ids, w, sched)
            ref = mrs.moe_rs_ref(interd, wdn, ids, w, sched)
            torch.cuda.synchronize()
            rows15.append(_held(torch, tag, out, ref, tol))
            del wgu, wdn
        if m != 4:
            continue
        live = int(torch.unique(ids).numel())
        common = {"tokens": m, "topk": topk, "experts": e, "bm": bm,
                  "tiles": int(sched.tile_expert.shape[1]),
                  "live_tiles": int(sched.used_tiles[0]),
                  "live_experts": live}
        nb14 = (live * d * 2 * im + m * d + m * topk * 2 * im) * 2
        fl14 = 2.0 * m * topk * d * 2 * im
        nb15 = ((live * im * d + m * topk * im + m * d) * 2
                + m * topk * 8)
        fl15 = 2.0 * m * topk * im * d + 2.0 * m * topk * d
        lib14, how14 = _grouped_mm_ms(torch, mu, x[(torch.arange(
            m * topk, device=DEV) // topk)], ids, w_gu, e)
        lib15, how15 = _grouped_mm_ms(torch, mu, inter, ids, w_dn, e)
        for key, nb, fl, fn, plain_fn, lib, how in (
                ("b14", nb14, fl14,
                 lambda: agg.group_gemm(x, w_gu, sched, topk),
                 lambda: agg.group_gemm_ref(x, w_gu, sched, topk),
                 lib14, how14),
                ("b15", nb15, fl15,
                 lambda: mrs.moe_rs(inter, w_dn, ids, w, sched),
                 lambda: mrs.moe_rs_ref(inter, w_dn, ids, w, sched),
                 lib15, how15)):
            bms, by = bound_ms(nb, fl)
            # the plain versions read used_tiles on the host: timed eagerly
            rec[key] = {"ms": graph_time_ms(fn),
                        "plain_ms": time_ms(plain_fn, iters=5),
                        "bound_ms": bms, "bound_by": by, "bytes": nb,
                        "flops": fl, "library_ms": lib,
                        "library_ms_call": f"torch._grouped_mm ({how})",
                        **common}
    # the xla tier's MoE block (dense_grouped_moe: gate/up, silu * up,
    # down, top-k reduce), which the mega step and the eager xla step run:
    # per-row gathered weights at decode (inside a graph), one product per
    # expert with a host read at the prefill-sized chunk
    from triton_dist_tpu_torch.layers.tp_moe import dense_grouped_moe
    x, ids, w = _moe_routing(torch, mu, plain, g, 4, d, e, topk)
    xb, idsb, wb = _moe_routing(torch, mu, plain, g, 1024, d, e, topk)
    emit({"phase": "xla_moe_block", "decode_4_tokens_graph_ms": graph_time_ms(
        lambda: dense_grouped_moe(x, ids, w, w_gu, w_dn, e), iters=5),
        "chunk_1024_tokens_eager_ms": time_ms(
        lambda: dense_grouped_moe(xb, idsb, wb, w_gu, w_dn, e), iters=3,
        warmup=1)})
    emit({"phase": "b14_group_gemm", "cases": rows14,
          "decode": rec["b14"]})
    emit({"phase": "b15_moe_rs", "cases": rows15, "decode": rec["b15"]})
    bad = [r for r in rows14 + rows15 if not r["ok"]]
    if bad:
        fail(f"B14/B15 disagree with their plain versions: {bad}")
    err14 = [r["max_abs_err"] for r in rows14 if r["case"] == "m4_bfloat16"]
    err15 = [r["max_abs_err"] for r in rows15 if r["case"] == "m4_bfloat16"]
    return ({"name": "group_gemm", "route": "cuda",
             "source": "triton_dist_tpu_torch/csrc/moe_group_gemm.cu",
             "replaces": "triton_dist_tpu/kernels/allgather_group_gemm.py:146",
             "max_abs_err": err14[0], **rec["b14"]},
            {"name": "moe_rs", "route": "cuda",
             "source": "triton_dist_tpu_torch/csrc/moe_group_gemm.cu",
             "replaces": "triton_dist_tpu/kernels/moe_reduce_rs.py:130",
             "max_abs_err": err15[0], **rec["b15"]})


# -- the main paths ----------------------------------------------------------

def _qwen3_8b(torch, models, shared):
    """Qwen3-8B's random bf16 weights from seed 0, drawn once per run and
    kept in ``shared`` for the phases that serve it (dropped before the
    MoE model is loaded)."""
    if "8b" not in shared:
        arch = models.QWEN3_ARCHS["Qwen/Qwen3-8B"]
        t0 = time.perf_counter()
        params = models.init_random_params(
            torch.Generator(device=DEV).manual_seed(0), arch, DEV,
            torch.bfloat16)
        torch.cuda.synchronize()
        shared["8b"] = (arch, params, time.perf_counter() - t0)
    return shared["8b"]


def phase_main(torch, models, kern, shared):
    """Qwen3-8B at its published widths, all 36 layers, random bf16
    weights; Engine(cache_mode="paged", page_size=128) serves B=4 prompts
    of T=512 for gen_len=32 (the decode crosses the page boundary at 512),
    each decode step one CUDA-graph replay. One warm-up serve first (it
    captures the graph); the counts are zeroed just before the measured
    serve and read just after it (_serve_counted)."""
    arch, params, init_s = _qwen3_8b(torch, models, shared)
    model = models.Qwen3(arch, max_length=1024, dtype=torch.bfloat16,
                         device=DEV)
    b, t, gen = 4, 512, 32
    ids = torch.randint(0, arch.vocab_size, (b, t + 1), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(3))
    engine = models.Engine(model, params, cache_mode="paged", page_size=128)
    out, launches, per_step, eager, replays = _serve_counted(
        torch, kern, engine, ids[:, :t], gen)
    steps = engine.last_decode_steps
    rec = {"phase": "main_path", "model": "Qwen/Qwen3-8B",
           "layers": arch.num_layers, "hidden": arch.hidden_size,
           "batch": b, "prompt": t, "gen_len": gen, "page_size": 128,
           "init_s": init_s, "prefill_ms": engine.last_prefill_s * 1e3,
           "decode_ms_per_step": engine.last_decode_s * 1e3 / steps,
           "decode_tok_per_s": b * steps / engine.last_decode_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "graph_replays": replays, "launches_per_replay": per_step,
           "eager_launches": eager, "launches": launches,
           "overflow": int(engine.kv_cache.overflow),
           "tokens_shape": list(out.shape)}
    emit(rec)
    L = arch.num_layers
    want_step = _only(per_step, paged_flash_decode_partial=L)
    if per_step != want_step or replays != gen - 1 or \
            eager != _only(eager, flash_prefill=L):
        fail(f"paged path: {per_step} per replay x {replays} + {eager} "
             f"eager; want {want_step} x {gen - 1} + {L} B1")
    if tuple(out.shape) != (b, gen) or not bool(
            ((out >= 0) & (out < arch.vocab_size)).all()) or rec["overflow"]:
        fail("served tokens out of range or the page pool overflowed")
    return model, params, ids, launches, engine


def phase_main_dense(torch, models, kern, model, params, ids):
    """The same Qwen3-8B weights and prompts through Engine(model, params)
    at its defaults: the dense max-length cache (max_length 1024), prefill
    layer by layer (B1), each decode step the mega task graph on its
    pallas_chain tier captured once as a CUDA graph and replayed. One
    warm-up serve first (it captures the graph); the counts are zeroed
    just before the measured serve and read just after it. A replay runs
    no Python, so a kernel's launches in the serve are its eager wrapper
    count (prefill) plus replays x its launches recorded per captured
    step."""
    arch = model.arch
    b, t, gen = ids.shape[0], ids.shape[1] - 1, 32
    engine = models.Engine(model, params)
    if engine.cache_mode != "dense" or engine.mega_tier != "pallas_chain":
        fail(f"Engine defaults: cache {engine.cache_mode}, mega tier "
             f"{engine.mega_tier}")
    engine.serve(ids[:, :t], gen_len=2)                       # warm-up
    torch.cuda.reset_peak_memory_stats()

    kern.reset_launch_counts()
    out = engine.serve(ids[:, :t], gen_len=gen)
    eager = kern.launch_counts()
    per_step = dict(engine.graph_launches)
    replays = engine.graph_replays
    launches = {k: eager[k] + replays * per_step[k] for k in eager}

    steps = engine.last_decode_steps
    rec = {"phase": "main_dense", "model": "Qwen/Qwen3-8B",
           "layers": arch.num_layers, "hidden": arch.hidden_size,
           "batch": b, "prompt": t, "gen_len": gen,
           "max_length": model.max_length, "cache_mode": engine.cache_mode,
           "mega_tier": engine.mega_tier,
           "graph_tasks": engine._mega_rt.graph_tasks(),
           "prefill_ms": engine.last_prefill_s * 1e3,
           "decode_ms_per_step": engine.last_decode_s * 1e3 / steps,
           "decode_tok_per_s": b * steps / engine.last_decode_s,
           "graph_replays": replays, "launches_per_replay": per_step,
           "eager_launches": eager, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "tokens_shape": list(out.shape)}
    emit(rec)
    L = arch.num_layers
    want_step = _only(per_step, flash_prefill=L, fused_add_rms=L,
                      gemm_ar=2 * L)
    want_eager = _only(eager, flash_prefill=L)
    if per_step != want_step or eager != want_eager or replays != gen - 1:
        fail(f"dense path: {per_step} per replay x {replays} replays + "
             f"{eager} eager; want {want_step} x {gen - 1} + {want_eager}")
    if tuple(out.shape) != (b, gen) or not bool(
            ((out >= 0) & (out < arch.vocab_size)).all()):
        fail("dense path: served tokens out of range")
    return engine, {"prefill": eager["flash_prefill"],
                    "decode": replays * per_step["flash_prefill"],
                    **{k: launches[k] for k in ("fused_add_rms", "gemm_ar")}}


def _prefill_vs_decode(torch, model, params, ids):
    """(prefill(T+1) last logits, prefill(T) + one decode step logits)."""
    t = ids.shape[1] - 1
    with torch.no_grad():
        c1 = model.create_paged_kv_cache(ids.shape[0], page_size=128)
        full, _ = model.inference(params, c1, ids)
        c2 = model.create_paged_kv_cache(ids.shape[0], page_size=128)
        _, c2 = model.inference(params, c2, ids[:, :t])
        step, _ = model.inference(params, c2, ids[:, t:])
    torch.cuda.synchronize()
    return full, step


def phase_consistency(torch, models, model, params, ids):
    """Last-position logits of prefill(T+1) (B1 over all 513 tokens) vs
    prefill(T) then one decode step with token T (B2 over 513 keys), at
    Qwen3-8B's widths, two ways:

    * bf16, all 36 layers (the main path's model). The two paths round
      differently (GEMMs of 2,052 vs 4 rows take other cuBLAS tilings,
      B1's and B2's blocking differ) and random weights amplify that
      through 36 layers, so the check is on the whole logit vector:
      relative RMS error <= 0.1 and max abs error <= 10% of the largest
      logit; a decode at a wrong position or from wrong pages gives
      uncorrelated logits (relative RMS ~1.4). Argmax must agree on rows
      whose top-2 margin exceeds the max-abs tolerance; on the others the
      decode argmax must be within it of the top logit.
    * f32, the first 4 layers' worth of fresh random weights (TF32 off):
      the same comparison must hold to relative RMS 1e-4 (summation order
      only), which pins the bf16 gap on rounding.

    Returns the f32 4-layer model and its parameters for the dense
    consistency phase."""
    rows = []
    full, step = _prefill_vs_decode(torch, model, params, ids)
    rows.append(_compare_logits(torch, f"bf16_{model.arch.num_layers}_layers",
                                full, step, rel_tol=0.1, abs_frac=0.1))
    import dataclasses
    arch4 = dataclasses.replace(model.arch, num_layers=4)
    m32 = models.Qwen3(arch4, max_length=model.max_length,
                       dtype=torch.float32, device=DEV)
    p32 = models.init_random_params(
        torch.Generator(device=DEV).manual_seed(5), arch4, DEV,
        torch.float32)
    full, step = _prefill_vs_decode(torch, m32, p32, ids)
    rows.append(_compare_logits(torch, "f32_4_layers", full, step,
                                rel_tol=1e-4, abs_frac=1e-3))
    emit({"phase": "consistency", "cases": rows})
    if not all(r["ok"] for r in rows):
        fail("prefill(T+1) and prefill(T) + decode disagree")
    return m32, p32


def _dense_three_ways(torch, models, model, params, ids, engine, gen):
    """After prefill(T), the decode logits and greedy tokens of (a) the
    graph-replayed pallas_chain step of ``engine`` (Engine defaults),
    (b) the eager xla tier of the mega step on its own dense cache, (c)
    the paged Engine's eager step (B2). Returns ({way: first-step logits},
    {way: (B, gen) tokens})."""
    from triton_dist_tpu_torch.mega.runtime import MegaDecodeRuntime
    t = ids.shape[1] - 1
    prompt = ids[:, :t]
    logits, toks = {}, {}

    toks["graph_pallas_chain"] = engine.serve(prompt, gen_len=gen)
    engine.serve(prompt, gen_len=1)
    logits["graph_pallas_chain"] = engine.decode_logits(ids[:, t]).clone()

    rt = MegaDecodeRuntime(model, method="xla")
    step = rt.dense_step_fn("xla")
    cache = model.create_kv_cache(ids.shape[0])
    first, cache = model.inference(params, cache, prompt)
    saved_k, saved_v = cache.k.clone(), cache.v.clone()
    tok = first.argmax(-1).to(torch.int32)
    out = [tok]
    for _ in range(gen - 1):
        lg, cache = step(params, cache, tok[:, None])
        tok = lg.argmax(-1).to(torch.int32)
        out.append(tok)
    toks["eager_xla"] = torch.stack(out, dim=1)
    cache.k.copy_(saved_k)
    cache.v.copy_(saved_v)
    cache.offset.fill_(t)
    logits["eager_xla"], _ = step(params, cache, ids[:, t:])
    del saved_k, saved_v, cache

    paged = models.Engine(model, params, cache_mode="paged", page_size=128)
    toks["paged"] = paged.serve(prompt, gen_len=gen)
    paged.serve(prompt, gen_len=1)
    logits["paged"] = paged.decode_logits(ids[:, t]).clone()
    torch.cuda.synchronize()
    return logits, toks


def phase_consistency_dense(torch, models, model, params, ids, engine,
                            m32, p32):
    """The graph-replayed pallas_chain decode step (B1 at T=1, B3, B4)
    against the eager xla tier (plain ops, B1) and the paged Engine (B2),
    after the same prefill, on the same weights: bf16 Qwen3-8B with all
    36 layers held to _compare_logits' bf16 bounds (relative RMS 0.1, max
    abs 10% of the largest logit: the three round at other places), and
    a 4-layer f32 model at the same widths (TF32 off) held to the f32
    bounds (relative RMS 1e-4), whose 8 greedy tokens per row must be
    IDENTICAL across the three."""
    rows, tokens = [], {}
    for label, mdl, prm, gen, rel, frac in (
            (f"bf16_{model.arch.num_layers}_layers", model, params, 2, 0.1,
             0.1),
            (f"f32_{m32.arch.num_layers}_layers", m32, p32, 8, 1e-4,
             1e-3)):
        eng = engine if mdl is model else models.Engine(mdl, prm)
        logits, toks = _dense_three_ways(torch, models, mdl, prm, ids, eng,
                                         gen)
        ref = logits["graph_pallas_chain"]
        for other in ("eager_xla", "paged"):
            rows.append(_compare_logits(
                torch, f"{label}:graph_pallas_chain_vs_{other}", ref,
                logits[other], rel_tol=rel, abs_frac=frac))
        if mdl is m32:
            tokens = {k: v.tolist() for k, v in toks.items()}
            same = all(torch.equal(toks["graph_pallas_chain"], v)
                       for v in toks.values())
            rows.append({"case": f"{label}:greedy_tokens_identical",
                         "ok": same})
    emit({"phase": "consistency_dense", "cases": rows,
          "f32_tokens": tokens})
    if not all(r["ok"] for r in rows):
        fail("the graph-replayed dense step disagrees with the eager xla "
             "tier or the paged step")


def _compare_logits(torch, name, full, step, rel_tol, abs_frac):
    finite = bool(torch.isfinite(full).all() and torch.isfinite(step).all())
    err = (full - step).abs().max().item()
    rel_rms = ((full - step).norm() / full.norm()).item()
    tol = abs_frac * full.abs().max().item()
    top2 = full.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    a_step = step.argmax(-1)
    agree = full.argmax(-1) == a_step
    near = (top2[:, 0] - full.gather(1, a_step[:, None])[:, 0]) <= tol
    argmax_ok = bool(torch.where(margin > tol, agree, near).all())
    return {"case": name, "logits_shape": list(full.shape),
            "rel_rms_err": rel_rms, "rel_rms_tol": rel_tol,
            "max_abs_err": err, "tol": tol,
            "logit_absmax": full.abs().max().item(),
            "argmax_agree": int(agree.sum()), "rows": int(agree.numel()),
            "top2_margin": margin.tolist(), "finite": finite,
            "ok": finite and err <= tol and rel_rms <= rel_tol
            and argmax_ok}


def _profile_engine(torch, engine, ids, steps):
    """torch.profiler over one prefill (serve with gen_len=1) and over
    `steps` decode steps of ``engine``: wall ms (profiled), the summed
    device time of all kernels, the device-idle share (one stream, so
    1 - device/wall) and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    def self_dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def summarize(prof, wall_s, per):
        # device-side events only (kernels, copies): the CPU ops that
        # launched them carry the same time again
        ev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and self_dev_us(e) > 0]
        dev_ms = sum(self_dev_us(e) for e in ev) / 1e3 / per
        top = sorted(ev, key=self_dev_us, reverse=True)[:8]
        return {"wall_ms": wall_s * 1e3 / per, "device_ms": dev_ms,
                "idle_share": 1 - dev_ms / (wall_s * 1e3 / per),
                "top": [[e.key[:160], self_dev_us(e) / 1e3 / per, e.count]
                        for e in top]}

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t = ids.shape[1] - 1
    torch.cuda.synchronize()
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        out = engine.serve(ids[:, :t], gen_len=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    pre = summarize(prof, wall, 1)
    tok = out[:, -1].contiguous()
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok = engine.step(tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return pre, summarize(prof, wall, steps)


def _replay_idle(torch, engine, ids, steps):
    """Without the profiler: the host's wall ms per decode step of a
    graph-replaying ``engine`` over `steps` back-to-back steps, and the
    device ms of one bare replay (CUDA events around graph.replay());
    1 - replay / wall is a reading of the device-idle share."""
    t = ids.shape[1] - 1
    out = engine.serve(ids[:, :t], gen_len=1)
    tok = out[:, -1].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        tok = engine.step(tok)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    graph = engine._graph
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return wall_ms, start.elapsed_time(end) / steps


def phase_profile(torch, engine, dense_engine, ids, steps: int = 4):
    """Where each main path's time goes (_profile_engine), the paged and
    the dense engines' graph-replayed steps; for the dense step also the
    idle share by CUDA events (_replay_idle; the paged step's is in phase
    paged_graph)."""
    pre, dec = _profile_engine(torch, engine, ids, steps)
    dpre, ddec = _profile_engine(torch, dense_engine, ids, steps)
    wall_ms, replay_ms = _replay_idle(torch, dense_engine, ids, steps)
    emit({"phase": "profile", "prefill": pre, "decode_step": dec,
          "dense_prefill": dpre, "dense_decode_step": ddec,
          "dense_step_wall_ms": wall_ms, "dense_replay_device_ms": replay_ms,
          "dense_idle_share_by_events": 1 - replay_ms / wall_ms})


def phase_paged_graph(torch, models, kern, shared, gen: int = 32,
                      steps: int = 8):
    """Engine(cache_mode="paged") on Qwen3-8B (36 layers, bf16, B=4
    prompts of 512, page 128): the decode step captured once as a CUDA
    graph and replayed (B2 per layer); its serve's launches
    (_serve_counted), the host's wall ms per step against one bare
    replay's device ms (CUDA events, _replay_idle), and in the same call
    the eager step (Qwen3.inference on the paged cache, no graph) over
    `steps` steps after the same prefill: the comparison with slice 1's
    eager paged step."""
    arch, params, _ = _qwen3_8b(torch, models, shared)
    model = models.Qwen3(arch, max_length=1024, dtype=torch.bfloat16,
                         device=DEV)
    b, t = 4, 512
    ids = torch.randint(0, arch.vocab_size, (b, t + 1), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(3))
    engine = models.Engine(model, params, cache_mode="paged", page_size=128)
    out, launches, per_step, eager, replays = _serve_counted(
        torch, kern, engine, ids[:, :t], gen)
    graph_ms = engine.last_decode_s * 1e3 / engine.last_decode_steps
    wall_ms, replay_ms = _replay_idle(torch, engine, ids, steps)
    cache = model.create_paged_kv_cache(b, page_size=128)
    logits, _ = model.inference(params, cache, ids[:, :t])
    tok = logits.argmax(-1).to(torch.int32)
    model.inference(params, cache, tok[:, None])               # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, _ = model.inference(params, cache, tok[:, None])
        tok = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    eager_ms = (time.perf_counter() - t0) * 1e3 / steps
    L = arch.num_layers
    rec = {"phase": "paged_graph", "model": "Qwen/Qwen3-8B", "layers": L,
           "batch": b, "prompt": t, "gen_len": gen, "page_size": 128,
           "decode_ms_per_step": graph_ms,
           "decode_tok_per_s": b / graph_ms * 1e3,
           "step_wall_ms": wall_ms, "replay_device_ms": replay_ms,
           "idle_share_by_events": 1 - replay_ms / wall_ms,
           "eager_step_ms_same_call": eager_ms,
           "eager_over_graph": eager_ms / graph_ms,
           "graph_replays": replays, "launches_per_replay": per_step,
           "launches": launches}
    emit(rec)
    if per_step != _only(per_step, paged_flash_decode_partial=L) or \
            replays != gen - 1 or tuple(out.shape) != (b, gen):
        fail(f"paged graph: {per_step} per replay x {replays}")
    return launches


def _traffic(torch, vocab, n_req, seed, *, n_shared=8, prefix_len=384,
             lo=16, hi=1536):
    """The continuous phases' requests: [(prompt, max_new_tokens)], prompt
    lengths drawn in [lo, hi] and budgets in [16, 64] from a seeded
    generator; n_shared of them (spread over the waves) start with one
    prefix_len-token prefix."""
    g = torch.Generator().manual_seed(seed)

    def draw(lo_, hi_):
        return int(torch.randint(lo_, hi_ + 1, (1,), generator=g))

    prefix = torch.randint(0, vocab, (prefix_len,), generator=g).tolist()
    shared = set(range(1, n_req, n_req // n_shared))
    out = []
    for i in range(n_req):
        n = draw(lo, hi)
        if i in shared:
            n = max(n, prefix_len + 16)
        body = torch.randint(0, vocab, (n,), generator=g).tolist()
        if i in shared:
            body = prefix + body[prefix_len:]
        out.append((body, draw(16, 64)))
    return out


def _drive_waves(torch, eng, traffic, wave: int = 8, every: int = 4):
    """Serve ``traffic`` through ``eng`` in waves of ``wave`` requests,
    the next wave submitted every `every` harvests (or at once when the
    engine ran dry). Every harvest is timed: its host wall ms (it ends
    with the one device read) and, with CUDA events around the mega
    dispatch, the device ms of its graph replay. Returns (finished
    requests in uid order, harvest records, run wall s)."""
    harvests, events = [], []
    decode_once, dispatch = eng._decode_once, eng._mega.dispatch

    def timed_dispatch(launch):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        res = dispatch(launch)
        ev[1].record()
        events.append(ev)
        return res

    def timed_decode():
        tokens = eng.stats()["tokens_out"]
        t0 = time.perf_counter()
        res = decode_once()
        harvests.append({"wall_ms": (time.perf_counter() - t0) * 1e3,
                         "tokens": eng.stats()["tokens_out"] - tokens})
        return res

    eng._decode_once, eng._mega.dispatch = timed_decode, timed_dispatch
    submitted, mark = 0, 0
    t0 = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.slots) or \
            submitted < len(traffic):
        idle = not eng.queue and all(r is None for r in eng.slots)
        if submitted < len(traffic) and (
                submitted == 0 or idle
                or eng.stats()["decode_batches"] - mark >= every):
            for prompt, gen in traffic[submitted:submitted + wave]:
                eng.submit(prompt, max_new_tokens=gen)
            submitted += len(traffic[submitted:submitted + wave])
            mark = eng.stats()["decode_batches"]
        eng.step()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    # drop the instance overrides (assigning the bound methods back would
    # keep the engine, its graph and its NCCL work alive in a cycle)
    del eng._decode_once, eng._mega.dispatch
    for h, ev in zip(harvests, events):
        h["replay_ms"] = ev[0].elapsed_time(ev[1])
    return sorted(eng.finished, key=lambda r: r.uid), harvests, wall_s


def _pct(xs, q):
    xs = sorted(xs)
    return xs[int(q * (len(xs) - 1))] if xs else None


def _serve_continuous(torch, kern, models, model, params, traffic, *,
                      decode_steps, max_batch, label, **kw):
    """One ContinuousEngine serve of ``traffic`` (model at its mode's
    defaults: the paged mega step, pallas_chain on the card). A one-token
    warm-up request first (it captures the decode graph); the counts are
    zeroed just before the measured traffic and read just after it, and a
    kernel's launches are its eager count (the prefill chunks) plus the
    replays times its launches recorded per captured program. Returns
    (record, finished requests, the engine)."""
    eng = models.ContinuousEngine(model, params, max_batch=max_batch,
                                  page_size=128, prefill_chunk=512,
                                  decode_steps=decode_steps,
                                  prefix_cache=True, **kw)
    eng.submit([1, 2, 3], max_new_tokens=2)
    eng.run()
    eng.finished.clear()
    before = eng.stats()
    replays0 = eng.graph_replays
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launch_counts()
    done, harvests, wall_s = _drive_waves(torch, eng, traffic, wave=8)
    eager = kern.launch_counts()
    after = eng.stats()
    replays = eng.graph_replays - replays0
    per = {k: eng.graph_launches.get(k, 0) for k in eager}
    launches = {k: eager[k] + replays * per[k] for k in eager}
    hv = harvests[1:] or harvests
    wall = sum(h["wall_ms"] for h in hv)
    dev = sum(h["replay_ms"] for h in hv)
    toks = sum(h["tokens"] for h in hv)
    ttft = [(r.t_first - r.t_submit) * 1e3 for r in done]
    gen_total = sum(len(r.out) for r in done)
    rec = {"phase": label, "decode_steps": decode_steps,
           "max_batch": max_batch, "requests": len(traffic),
           "prompt_tokens": sum(len(p) for p, _ in traffic),
           "generated_tokens": gen_total, "mode": eng.mode,
           "mega_tier": after["mega"],
           "harvests": after["decode_batches"] - before["decode_batches"],
           "graph_replays": replays,
           "replays_per_harvest": replays / max(
               after["decode_batches"] - before["decode_batches"], 1),
           "harvest_wall_ms_mean": wall / len(hv),
           "harvest_wall_ms_p50": _pct([h["wall_ms"] for h in hv], 0.5),
           "replay_device_ms_mean": dev / len(hv),
           "idle_share_by_events": 1 - dev / wall,
           "ms_per_generated_token_in_harvests": wall / max(toks, 1),
           "decode_tok_s_in_harvests": toks / wall * 1e3,
           "run_wall_s": wall_s, "run_tok_s": gen_total / wall_s,
           "ttft_ms_p50": _pct(ttft, 0.5), "ttft_ms_p95": _pct(ttft, 0.95),
           "prefix_pages_adopted": after["prefix_pages_adopted"]
           - before["prefix_pages_adopted"],
           "prefill_chunks": after["prefill_chunks"]
           - before["prefill_chunks"],
           "admission_deferrals": after["admission_deferrals"]
           - before["admission_deferrals"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches_per_replay": per, "eager_launches": eager,
           "launches": launches,
           "overflow": int(eng.cache.overflow),
           "own_token_differs": eng.own_token_differs}
    return rec, done, eng


def _check_continuous(rec, done, traffic, vocab, per_replay_want):
    """The gates of a continuous serve: one replay per harvest, every
    request its whole budget of in-range tokens, no overflow, a prefix
    adopted, the launches per replay."""
    bad = []
    if rec["graph_replays"] != rec["harvests"]:
        bad.append("not one graph replay per harvest")
    if len(done) != len(traffic) or any(
            len(r.out) != g or not all(0 <= x < vocab for x in r.out)
            for r, (_, g) in zip(done, traffic)):
        bad.append("a request's tokens are missing or out of range")
    if rec["overflow"] or rec["prefix_pages_adopted"] <= 0:
        bad.append("pool overflow or no prefix adopted")
    if rec["launches_per_replay"] != per_replay_want:
        bad.append(f"launches per replay {rec['launches_per_replay']}, want "
                   f"{per_replay_want}")
    if bad:
        fail(f"{rec['phase']}: " + "; ".join(bad))


def _b1_continuation(torch, fa):
    """B1 in its continuation form: one 512-token chunk of a row at
    offset 1024 (a 0-d int32 tensor on the card) over the row's 2048
    gathered keys, at Qwen3-8B's heads (Hq 32, Hkv 8) and one TP=4 rank's
    of Qwen3-32B (Hq 16, Hkv 2), bf16 and f32, against its plain version.
    Tolerances relative to max|ref|: bf16 2e-2 (the output's bf16
    rounding, 2^-9, and P rounded to bf16 at other running maxima), f32
    1e-4 (summation order). The f32 error must also lie 10x below the
    gap between the plain version at offset 1024 and at 1025, so a kernel
    off by one key at the causal boundary fails. Timed at Qwen3-8B's
    heads, bf16, beside SDPA with the same causal-with-offset mask."""
    g = torch.Generator(device=DEV).manual_seed(61)
    b, t, s, d, off = 1, 512, 2048, 128, 1024
    offset = torch.tensor(off, dtype=torch.int32, device=DEV)
    cases, timed = [], None
    for heads, hq, hkv in (("8b", 32, 8), ("tp4_rank", 16, 2)):
        q = torch.randn((b, t, hq, d), generator=g, device=DEV)
        k = torch.randn((b, s, hkv, d), generator=g, device=DEV)
        v = torch.randn((b, s, hkv, d), generator=g, device=DEV)
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
            out = fa.flash_prefill(qd, kd, vd, offset)
            ref = fa.flash_prefill_ref(qd, kd, vd, off)
            torch.cuda.synchronize()
            row = _held(torch, f"{heads}_{str(dt).split('.')[-1]}", out,
                        ref, tol)
            if dt == torch.float32:
                gap = (fa.flash_prefill_ref(qd, kd, vd, off + 1).float()
                       - ref.float()).abs().max().item()
                row["off_by_one_gap"] = gap
                row["ok"] = row["ok"] and row["max_abs_err"] * 10 < gap
            cases.append(row)
            if heads == "8b" and dt == torch.bfloat16:
                timed = (qd, kd, vd)
    q, k, v = timed
    hq, hkv = q.shape[2], k.shape[2]
    ms = time_ms(lambda: fa.flash_prefill(q, k, v, offset))
    plain_ms = time_ms(lambda: fa.flash_prefill_ref(q, k, v, off), iters=5)
    mask = (torch.arange(s, device=DEV)[None, :]
            <= off + torch.arange(t, device=DEV)[:, None])
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    # the yardstick: SDPA over the off + t live keys, causal aligned to
    # the last query (the flash backend); the dense mask over every key
    # kept beside it as a note
    library_ms = time_ms(lambda: _sdpa_causal_offset(torch, q, k, v,
                                                     off + t))
    library_err = (_sdpa_causal_offset(torch, q, k, v, off + t).transpose(
        1, 2).float() - fa.flash_prefill_ref(q, k, v, off).float()
    ).abs().max().item()
    library_mask_ms = time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask,
                                           enable_gqa=True))
    graph_ms = graph_time_ms(lambda: fa.flash_prefill(q, k, v, offset), 10)
    library_graph_ms = graph_or_none(
        torch, lambda: _sdpa_causal_offset(torch, q, k, v, off + t))
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    pairs = sum(min(off + i + 1, s) for i in range(t))
    bms, by = bound_ms(nbytes, 4.0 * b * hq * d * pairs)
    return {"case": "continuation_t512_s2048_offset1024", "cases": cases,
            "max_abs_err": max(c["max_abs_err"] for c in cases
                               if "bfloat16" in c["case"]),
            "ok": all(c["ok"] for c in cases),
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_call": "scaled_dot_product_attention over the "
                            "offset + T live keys, causal_lower_right, "
                            "enable_gqa",
            "library_max_abs_err": library_err,
            "library_mask_ms": library_mask_ms,
            "graph_ms": graph_ms, "library_graph_ms": library_graph_ms,
            "bound_ms": bms, "bound_by": by}


def phase_continuous(torch, models, kern, fa, shared):
    """The north star's main path on one card: Qwen3-8B at its published
    widths, all 36 layers, bf16, through ContinuousEngine(mode="xla") at
    its defaults (the paged mega step on the pallas_chain tier: B2, B3
    and B4 per layer; each harvest of decode_steps=4 steps one CUDA-graph
    replay), max_batch 8, page 128, max_length 2048, prefill_chunk 512
    (prefill chunks eager: B1, its continuation form past the first
    chunk), prefix cache on. Traffic: 24 requests (_traffic, seed 11),
    three waves of 8, one wave every 4 harvests. Then the same traffic at
    decode_steps=1, whose greedy tokens must equal the K=4 run's; B1 at
    its continuation shape against its plain version; and the f32 gate:
    4 layers of these widths, ContinuousEngine tokens per request equal to
    the static Engine's for the same prompt (the reference's ground
    truth)."""
    import dataclasses
    arch, params, _ = _qwen3_8b(torch, models, shared)
    model = models.Qwen3(arch, max_length=2048, dtype=torch.bfloat16,
                         device=DEV)
    traffic = _traffic(torch, arch.vocab_size, 24, 11)
    L = arch.num_layers
    runs, outs = {}, {}
    for k_steps in (4, 1):
        rec, done, eng = _serve_continuous(
            torch, kern, models, model, params, traffic,
            decode_steps=k_steps, max_batch=8, label="continuous")
        want = _only(rec["launches_per_replay"],
                     paged_flash_decode_partial=L * k_steps,
                     fused_add_rms=L * k_steps, gemm_ar=2 * L * k_steps)
        _check_continuous(rec, done, traffic, arch.vocab_size, want)
        runs[k_steps], outs[k_steps] = rec, [r.out for r in done]
        del eng
        torch.cuda.empty_cache()
    same_k = outs[4] == outs[1]
    b1 = _b1_continuation(torch, fa)
    # the f32 gate
    arch4 = dataclasses.replace(arch, num_layers=4)
    m32 = models.Qwen3(arch4, max_length=1024, dtype=torch.float32,
                       device=DEV)
    p32 = models.init_random_params(
        torch.Generator(device=DEV).manual_seed(5), arch4, DEV,
        torch.float32)
    small = _traffic(torch, arch4.vocab_size, 6, 12, n_shared=2,
                     prefix_len=256, lo=40, hi=700)
    small = [(p, 8) for p, _ in small]
    eng = models.ContinuousEngine(m32, p32, max_batch=4, page_size=128,
                                  prefill_chunk=256, decode_steps=4,
                                  prefix_cache=True)
    for p, g in small:
        eng.submit(p, max_new_tokens=g)
    cont = [r.out for r in eng.run()]
    static = models.Engine(m32, p32)
    want = [static.serve(torch.tensor([p], device=DEV), g)[0].tolist()
            for p, g in small]
    gate = {"requests": len(small), "identical": cont == want,
            "prefix_pages_adopted": eng.stats()["prefix_pages_adopted"],
            "continuous": cont, "static": want}
    del eng, static, m32, p32
    torch.cuda.empty_cache()
    emit({"phase": "continuous", "model": "Qwen/Qwen3-8B", "layers": L,
          "page_size": 128, "max_length": 2048, "prefill_chunk": 512,
          "runs": {f"decode_steps_{k}": r for k, r in runs.items()},
          "tokens_equal_k4_k1": same_k, "b1_continuation": b1,
          "f32_gate": gate})
    if not same_k:
        fail("continuous: decode_steps=4 and =1 served different tokens")
    if not b1["ok"]:
        fail(f"B1 continuation form disagrees with its plain version: {b1}")
    if not gate["identical"]:
        fail("continuous f32 gate: ContinuousEngine tokens differ from the "
             "static Engine's")
    return {"continuous": runs[4]["launches"],
            "continuous_k1": runs[1]["launches"]}, b1


def _pallas_ctx():
    """TPContext with B12 on the triton_dist projections (the MoE methods
    stay AUTO: B14 / B15 on the card)."""
    from triton_dist_tpu_torch.kernels.allgather_gemm import AgGemmMethod
    from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (
        GemmRsMethod,
    )
    from triton_dist_tpu_torch.layers.common import TPContext
    return TPContext(ag_method=AgGemmMethod.PALLAS,
                     rs_method=GemmRsMethod.PALLAS)


def _serve_counted(torch, kern, engine, prompt, gen):
    """Warm-up serve (it captures the graph), then the counts zeroed, one
    measured serve, the counts read: (tokens, launches in the serve,
    launches per replay, eager launches, replays). A replay runs no
    Python, so a serve's count is eager + replays x per replay."""
    engine.serve(prompt, gen_len=2)
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launch_counts()
    out = engine.serve(prompt, gen_len=gen)
    eager = kern.launch_counts()
    per_step = {k: engine.graph_launches.get(k, 0) for k in eager}
    replays = engine.graph_replays
    launches = {k: eager[k] + replays * per_step[k] for k in eager}
    return out, launches, per_step, eager, replays


def _only(counts, **nonzero):
    """Every kernel 0 but the named ones."""
    return {k: nonzero.get(k, 0) for k in counts}


def phase_dense_triton_dist(torch, models, kern, model, params, ids,
                            gen: int = 8):
    """The loaded Qwen3-8B (same weights and prompts) in mode triton_dist:
    Engine(backend="triton_dist") over Qwen3 with TPContext(ag_method=
    PALLAS, rs_method=PALLAS); prefill in mode xla (B1), each decode step
    the captured triton_dist forward replayed: B12 for the QKV, o, gate/up
    and down projections (4 per layer) and B1 at T=1."""
    td = models.Qwen3(model.arch, _pallas_ctx(), max_length=model.max_length,
                      dtype=model.dtype, device=DEV)
    engine = models.Engine(td, params, backend="triton_dist")
    t = ids.shape[1] - 1
    out, launches, per_step, eager, replays = _serve_counted(
        torch, kern, engine, ids[:, :t], gen)
    L = model.arch.num_layers
    rec = {"phase": "dense_triton_dist", "model": "Qwen/Qwen3-8B",
           "layers": L, "batch": ids.shape[0], "prompt": t, "gen_len": gen,
           "decode_ms_per_step": engine.last_decode_s * 1e3
           / engine.last_decode_steps,
           "graph_replays": replays, "launches_per_replay": per_step,
           "launches": launches}
    emit(rec)
    want = _only(per_step, flash_prefill=L, pallas_matmul=4 * L)
    if per_step != want or replays != gen - 1 or eager != _only(
            eager, flash_prefill=L):
        fail(f"dense triton_dist path: {per_step} per replay x {replays} "
             f"+ {eager} eager; want {want}")
    if tuple(out.shape) != (ids.shape[0], gen):
        fail("dense triton_dist path: wrong token shape")
    return launches, eager


def phase_main_moe(torch, models, kern, gen: int = 32):
    """Qwen3-30B-A3B at its published widths (hidden 2048, 32 q / 4 kv
    heads, 128 experts, top-8, expert width 768, vocab 151936), all 48
    layers, random bf16 weights from a seed, max_length 1024; B=4 prompts
    of 512 tokens, 32 generated. Two engines on the same model:

    * Engine(model, params, backend="triton_dist") with TPContext(
      ag_method=PALLAS, rs_method=PALLAS) and the MoE AUTO rule: prefill
      in mode xla (B1; the experts per expert), each decode step one
      replay of the captured triton_dist forward (B1 at T=1, B12 x 2,
      B14, B15 per layer);
    * Engine(model, params) at its defaults: the mega step on its
      pallas_chain tier (B1, B3 and B4 on the o projection; the MoE task
      runs its xla tier).

    For each: the launches in one serve (counts zeroed just before it),
    prefill ms, decode ms/step, tok/s, peak memory, and the device-idle
    share by CUDA events (_replay_idle) and by torch.profiler."""
    cfg = models.ModelConfig(model_name=MOE_MODEL, max_length=1024,
                             dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model, params = models.AutoLLM.from_pretrained(
        cfg, _pallas_ctx(), device=DEV,
        generator=torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    arch = model.arch
    if model.model_type != "moe":
        fail(f"{MOE_MODEL} built {type(model).__name__}")
    L, b, t = arch.num_layers, 4, 512
    ids = torch.randint(0, arch.vocab_size, (b, t + 1), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(3))
    engines, counts = {}, {}
    for label, kw, want_step in (
            ("triton_dist", {"backend": "triton_dist"},
             dict(flash_prefill=L, pallas_matmul=2 * L, group_gemm=L,
                  moe_rs=L)),
            ("mega_default", {},
             dict(flash_prefill=L, fused_add_rms=L, gemm_ar=L))):
        engine = models.Engine(model, params, **kw)
        out, launches, per_step, eager, replays = _serve_counted(
            torch, kern, engine, ids[:, :t], gen)
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps = engine.last_decode_steps
        prefill_s, decode_s = engine.last_prefill_s, engine.last_decode_s
        wall_ms, replay_ms = _replay_idle(torch, engine, ids, 4)
        pre, dec = _profile_engine(torch, engine, ids, 4)
        emit({"phase": f"main_moe_{label}", "model": MOE_MODEL,
              "layers": L, "hidden": arch.hidden_size,
              "experts": arch.num_experts, "topk": arch.num_experts_per_tok,
              "batch": b, "prompt": t, "gen_len": gen,
              "max_length": model.max_length, "init_s": init_s,
              "mega_tier": engine.mega_tier,
              "prefill_ms": prefill_s * 1e3,
              "decode_ms_per_step": decode_s * 1e3 / steps,
              "decode_tok_per_s": b * steps / decode_s,
              "graph_replays": replays, "launches_per_replay": per_step,
              "eager_launches": eager, "launches": launches,
              "peak_mem_gb": peak, "step_wall_ms": wall_ms,
              "replay_device_ms": replay_ms,
              "idle_share_by_events": 1 - replay_ms / wall_ms,
              "profile_prefill": pre, "profile_decode_step": dec,
              "tokens_shape": list(out.shape)})
        want = _only(per_step, **want_step)
        if per_step != want or replays != gen - 1 or eager != _only(
                eager, flash_prefill=L):
            fail(f"{label} MoE path: {per_step} per replay x {replays} + "
                 f"{eager} eager; want {want}")
        if tuple(out.shape) != (b, gen) or not bool(
                ((out >= 0) & (out < arch.vocab_size)).all()):
            fail(f"{label} MoE path: served tokens out of range")
        engines[label], counts[label] = engine, (launches, eager)
    return model, params, ids, engines, counts


def _moe_three_ways(torch, model, params, ids, engines, gen):
    """After prefill(T), the decode logits and greedy tokens of the
    graph-replayed triton_dist step, the graph-replayed mega step and the
    eager xla-mode step (Qwen3MoE.inference on its own dense cache)."""
    t = ids.shape[1] - 1
    prompt = ids[:, :t]
    logits, toks = {}, {}
    for label, engine in (("graph_triton_dist", engines["triton_dist"]),
                          ("graph_mega", engines["mega_default"])):
        toks[label] = engine.serve(prompt, gen_len=gen)
        engine.serve(prompt, gen_len=1)
        logits[label] = engine.decode_logits(ids[:, t]).clone()
    cache = model.create_kv_cache(ids.shape[0])
    first, cache = model.inference(params, cache, prompt)
    saved_k, saved_v = cache.k.clone(), cache.v.clone()
    tok = first.argmax(-1).to(torch.int32)
    out = [tok]
    for _ in range(gen - 1):
        lg, cache = model.inference(params, cache, tok[:, None])
        tok = lg.argmax(-1).to(torch.int32)
        out.append(tok)
    toks["eager_xla"] = torch.stack(out, dim=1)
    cache.k.copy_(saved_k)
    cache.v.copy_(saved_v)
    cache.offset.fill_(t)
    logits["eager_xla"], _ = model.inference(params, cache, ids[:, t:])
    del saved_k, saved_v, cache
    torch.cuda.synchronize()
    return logits, toks


def _moe_consistency_rows(torch, label, logits, rel, frac):
    ref = logits["graph_triton_dist"]
    return [_compare_logits(torch, f"{label}:graph_triton_dist_vs_{other}",
                            ref, logits[other], rel_tol=rel, abs_frac=frac)
            for other in ("graph_mega", "eager_xla")]


def phase_consistency_moe(torch, models, model, params, ids, engines):
    """The graph-replayed triton_dist step (B1, B12, B14, B15) against the
    graph-replayed mega step (B1, B3, B4, the MoE task's xla tier) and the
    eager xla-mode step, after the same prefill: bf16 Qwen3-30B-A3B with
    all 48 layers held to _compare_logits' bf16 bounds (relative RMS 0.1,
    max abs 10% of the largest logit: the three round at other places).
    Returns the rows; the f32 gate follows once the bf16 model is freed
    (phase_consistency_moe_f32)."""
    logits, _ = _moe_three_ways(torch, model, params, ids, engines, 2)
    return _moe_consistency_rows(torch, f"bf16_{model.arch.num_layers}_"
                                 "layers", logits, 0.1, 0.1)


def phase_consistency_moe_f32(torch, models, ids, rows):
    """The gate of consistency_moe: Qwen3-30B-A3B's widths with 4 layers
    of fresh random f32 weights (about 12.5 GB; TF32 off), the three
    decode steps held to the f32 bounds (relative RMS 1e-4: summation
    order only), and their 8 greedy tokens per row IDENTICAL."""
    import dataclasses
    arch4 = dataclasses.replace(models.QWEN3_ARCHS[MOE_MODEL], num_layers=4)
    m32 = models.Qwen3MoE(arch4, _pallas_ctx(), max_length=1024,
                          dtype=torch.float32, device=DEV)
    p32 = models.init_random_params(
        torch.Generator(device=DEV).manual_seed(5), arch4, DEV,
        torch.float32)
    engines = {"triton_dist": models.Engine(m32, p32, backend="triton_dist"),
               "mega_default": models.Engine(m32, p32)}
    logits, toks = _moe_three_ways(torch, m32, p32, ids, engines, 8)
    ran = {k: engines["triton_dist"].graph_launches[k]
           for k in ("group_gemm", "moe_rs", "pallas_matmul")}
    rows = rows + _moe_consistency_rows(torch, "f32_4_layers", logits, 1e-4,
                                        1e-3)
    same = all(torch.equal(toks["graph_triton_dist"], v)
               for v in toks.values())
    rows.append({"case": "f32_4_layers:greedy_tokens_identical",
                 "ok": same and all(ran.values())})
    emit({"phase": "consistency_moe", "cases": rows,
          "f32_launches_per_replay": ran,
          "f32_tokens": {k: v.tolist() for k, v in toks.items()}})
    if not all(r["ok"] for r in rows):
        fail("the MoE triton_dist step disagrees with the mega step or the "
             "eager xla step")


def phase_small_reference(torch, models):
    """A small f32 model (head_dim 128, 2 layers, T=128 so B1 runs) on the
    card against the same weights on the CPU (plain versions): the CPU
    Engine serves 8 greedy tokens, then both sides are teacher-forced on
    them (prefill + 7 decode steps through the cache) and every step's
    logits are compared. The paged cache is forced through
    Qwen3.inference; the dense cache through the Engine at its defaults
    (on the card the graph-replayed pallas_chain step with B1, B3 and B4,
    on the CPU the eager xla tier), after a prefill on a second cache.
    Tolerance 1e-3 for full-width caches (f32 on both
    sides, TF32 off; only summation orders differ) and 1e-2 for int8
    pools (a K/V element whose x/s sits on a rounding tie may take the
    neighbouring int8 code on one side: one code step, amax/127, moves a
    score by ~1e-3). Token identity of the two Engines' own greedy runs
    is reported, not required: with random weights the top logit can
    change on rounding."""
    import numpy as np
    arch = models.Qwen3Arch(vocab_size=256, hidden_size=256,
                            intermediate_size=512, num_layers=2,
                            num_heads=4, num_kv_heads=2, head_dim=128)
    from triton_dist_tpu_torch.models.weights import param_shapes
    rng = np.random.default_rng(7)

    def make(name, shape):
        if "norm" in name:
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        return rng.standard_normal(shape, np.float32) * 256 ** -0.5

    shapes = param_shapes(arch)
    raw = {k: make(k, s) for k, s in shapes.items() if k != "layers"}
    raw["layers"] = {k: make(k, s) for k, s in shapes["layers"].items()}
    ids = torch.from_numpy(rng.integers(0, 256, (2, 128)))
    rows = []
    for mode, resident, tol in (("paged", None, 1e-3),
                                ("paged", "int8", 1e-2),
                                ("dense", None, 1e-3)):
        toks, logits = {}, {}
        for dev in ("cpu", DEV):
            model = models.Qwen3(arch, max_length=160, dtype=torch.float32,
                                 device=dev)
            params = models.params_from_numpy(raw, arch, dev, torch.float32)
            eng = models.Engine(model, params, cache_mode=mode, page_size=32,
                                kv_resident=resident)
            toks[dev] = eng.serve(ids, gen_len=8).cpu()
            forced = toks["cpu"].to(dev)
            if mode == "dense":
                cache = model.create_kv_cache(2)
                out, _ = model.inference(params, cache, ids.to(dev))
                eng.serve(ids, gen_len=1)
                steps = [out.cpu()]
                for j in range(forced.shape[1] - 1):
                    steps.append(eng.decode_logits(forced[:, j]).cpu())
            else:
                cache = model.create_paged_kv_cache(2, page_size=32,
                                                    kv_resident=resident)
                out, cache = model.inference(params, cache, ids.to(dev))
                steps = [out.cpu()]
                for j in range(forced.shape[1] - 1):
                    out, cache = model.inference(params, cache,
                                                 forced[:, j:j + 1])
                    steps.append(out.cpu())
            logits[dev] = torch.stack(steps)
            if dev == DEV and mode == "dense" and (
                    eng.mega_tier != "pallas_chain" or not eng.graph_replays):
                fail(f"small dense Engine on the card ran tier "
                     f"{eng.mega_tier}, {eng.graph_replays} replays")
        err = (logits["cpu"] - logits[DEV]).abs().max().item()
        rows.append({"cache_mode": mode, "kv_resident": resident,
                     "tokens_identical": bool(torch.equal(toks["cpu"],
                                                          toks[DEV])),
                     "logits_max_abs_err": err, "tol": tol,
                     "ok": err <= tol})
    rows.append(_small_moe_reference(torch, models, rng, make))
    emit({"phase": "small_reference", "cases": rows})
    if not all(r["ok"] for r in rows):
        fail("the small model on the card disagrees with the CPU")


def _small_moe_reference(torch, models, rng, make):
    """A small f32 Qwen3MoE (head_dim 128, 2 layers, 16 experts, top-4,
    expert width 128) served by Engine(backend="triton_dist") on the card
    (B1, B12, B14, B15, the step graph-replayed) and on the CPU (plain
    versions): 8 greedy tokens each, which must be IDENTICAL, and the
    teacher-forced logits of prefill + 7 decode steps within 1e-3 (f32,
    TF32 off: summation orders only)."""
    from triton_dist_tpu_torch.models.weights import param_shapes
    arch = models.Qwen3MoEArch(
        vocab_size=256, hidden_size=256, intermediate_size=512,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
        num_experts=16, num_experts_per_tok=4, moe_intermediate_size=128)
    shapes = param_shapes(arch)
    raw = {k: make(k, s) for k, s in shapes.items() if k != "layers"}
    raw["layers"] = {k: make(k, s) for k, s in shapes["layers"].items()}
    ids = torch.from_numpy(rng.integers(0, 256, (2, 128)))
    toks, logits = {}, {}
    for dev in ("cpu", DEV):
        model = models.Qwen3MoE(arch, _pallas_ctx(), max_length=160,
                                dtype=torch.float32, device=dev)
        params = models.params_from_numpy(raw, arch, dev, torch.float32)
        eng = models.Engine(model, params, backend="triton_dist")
        toks[dev] = eng.serve(ids, gen_len=8).cpu()
        forced = toks["cpu"].to(dev)
        out, _ = model.inference(params, model.create_kv_cache(2),
                                 ids.to(dev))
        eng.serve(ids, gen_len=1)
        steps = [out.cpu()] + [eng.decode_logits(forced[:, j]).cpu()
                               for j in range(forced.shape[1] - 1)]
        logits[dev] = torch.stack(steps)
        if dev == DEV and not (eng.graph_replays and all(
                eng.graph_launches[k]
                for k in ("pallas_matmul", "group_gemm", "moe_rs"))):
            fail(f"small MoE Engine on the card: {eng.graph_replays} "
                 f"replays of {eng.graph_launches}")
    err = (logits["cpu"] - logits[DEV]).abs().max().item()
    same = bool(torch.equal(toks["cpu"], toks[DEV]))
    return {"cache_mode": "dense", "model": "Qwen3MoE, triton_dist",
            "tokens_identical": same, "logits_max_abs_err": err,
            "tol": 1e-3, "ok": err <= 1e-3 and same}


# -- across ranks: the one-card world (B10, B13a, notify / wait) -------------

TP = 4                    # ranks of the tensor-parallel phases
NVLINK_BW = 450e9         # H100 NVLink bytes/s each way (data sheet)
SLEEP_CYCLES = 300_000_000  # ~0.15 s at the H100's clock: holds the stream
TP_MODEL = "Qwen/Qwen3-32B"
FOUR_CARD_PHASES = ("tp4_serve", "tp4_consistency", "tp4_continuous",
                    "tp4_continuous_consistency", "tp4_moe",
                    "tp4_moe_consistency", "tp4_ep", "tp4_ep_consistency",
                    "tp4_sp", "tp4_sp_consistency", "tp4_comm", "tp4_quant",
                    "tp4_ring")
ONE_CARD_TP_PHASES = ("dist_notify_wait", "b10_ag_gemm", "b13_gemm_rs",
                      "b4_gemm_ar_tp", "b5_one_shot", "b6_rhd",
                      "b9_ring_rs", "b7_ring_ag", "two_shot", "ring_floor",
                      "b14_b15_tp",
                      "b8_full_mesh_ag", "b11_ag_gemm_bidir",
                      "b13b_gemm_rs_bidir", "b17_ll_a2a", "b18_ll_a2a_q",
                      "b16_ep_dispatch_gg", "b1_fold",
                      "b19_flash_decode_partial", "b20_decode_combine",
                      "b21_ring_attn", "sp_layer", "b22_b23_ll_ag",
                      "b24_b25_b26_p2p", "b27_b28_qint8",
                      "b29_b30_kv_handoff")


def queued_ms(torch, fn, iters: int = 20, warm: int = 2):
    """Device ms per call of fn() with no host gaps between calls: the
    current stream is held by a sleep kernel while the host enqueues
    `warm` + `iters` calls (the timed ones between CUDA events), so the
    card runs them back to back. For calls whose launch costs more host
    time than the card spends, and for work that spans streams or ranks
    (a CUDA graph of spinning kernels on several streams is not used).
    Returns (ms, host enqueue s, whether the sleep outlasted the
    enqueue)."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(warm):
        fn()
    ev[2].record()
    for _ in range(iters):
        fn()
    ev[3].record()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return (ev[2].elapsed_time(ev[3]) / iters, host_s,
            host_s * 1e3 < ev[0].elapsed_time(ev[1]))


def tp_bound_ms(hbm_bytes: float, link_bytes: float, flops: float,
                peak: float = BF16_FLOPS) -> tuple[float, str]:
    """The least time: HBM bytes at 3.35 TB/s, NVLink bytes at 450 GB/s
    each way, FLOPs at the dtype's peak; the largest of the three."""
    t = {"bytes": hbm_bytes / MEM_BW, "nvlink_bytes": link_bytes / NVLINK_BW,
         "operations": flops / peak}
    by = max(t, key=t.get)
    return t[by] * 1e3, by


def phase_dist_notify_wait(torch, symm, lang, calls: int = 3):
    """tutorials/01-distributed-notify-wait.py on four logical ranks of
    one card: after a barrier rank 0 puts its tensor into every rank's
    symmetric buffer and raises a flag there; each rank waits and returns
    what landed. Every rank must return rank 0's tensor, bit for bit, on
    every call (fresh tensors each call: the flags' epochs advance)."""
    world = symm.OneCardWorld(TP)
    g = torch.Generator(device=DEV).manual_seed(21)
    ok = []
    for _ in range(calls):
        xs = [torch.randn(4096, generator=g, device=DEV) for _ in range(TP)]
        outs = world.run(lambda r: lang.notify_wait(world.mesh(r), xs[r]))
        torch.cuda.synchronize()
        ok.append(all(torch.equal(o, xs[0]) for o in outs))
    emit({"phase": "dist_notify_wait", "ranks": TP, "calls": calls,
          "identical": ok, "ok": all(ok)})
    if not all(ok):
        fail(f"notify/wait: ranks did not all receive rank 0's data: {ok}")


def _tp_shards(torch, g, dt, m, k, n, a_scale=1.0):
    a = [(torch.randn((m, k), generator=g, device=DEV) * a_scale).to(dt)
         for _ in range(TP)]
    b = [(torch.randn((k, n), generator=g, device=DEV) * k ** -0.5).to(dt)
         for _ in range(TP)]
    return a, b


def _tp_tol(torch, dt):
    return 1e-2 if dt == torch.bfloat16 else 1e-4


def _one_card_kernel_row(torch, world, name, run, plain, nbytes, flops):
    ms, host_s, covered = queued_ms(torch, lambda: world.run(run))
    plain_ms, _, _ = queued_ms(torch, plain)
    bms, by = bound_ms(nbytes, flops)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bms, "bound_by": by, "bytes": nbytes,
            "host_enqueue_s": host_s, "queued_ahead": covered, "case": name}


# what B10 and B11 run on (csrc/ag_gemm.cu)
AG_INSTRUCTIONS = ("bf16 at one 16-row M group of gathered rows, or up to "
                   "128 while the card's weights fit its L2 (ag_plan): "
                   "gemm_stream_sm90.cuh's mma.sync m16n8k16 stream-K GEMM "
                   "(128 x 128 weight tiles by TMA, 5 stages) over the "
                   "landed rows, the one-hop push between the first weight "
                   "loads and the first wait; bf16 above: "
                   "gemm_tile_sm90.cuh's wgmma m64n256k16 tile GEMM (128 x "
                   "256 tiles, 4 TMA stages of A and W, setmaxnreg), the "
                   "push on the producer warpgroup's spare warps; f32: FMA")
# (name, dtype, m a rank, K, N_loc): Qwen3-32B at TP=4, decode (B=16: 4
# rows a rank; B=128: 32), 512 rows a rank, the static serve's prefill
# (2,048 rows a rank), ragged m (3: a decode M group of 12 rows; 130: row
# tiles across shards; 17 of a small W: five stream M groups across
# shards)
AG_CASES = (("qkv_m4", "bf16", 4, 5120, 2560),
            ("gate_up_m4", "bf16", 4, 5120, 12800),
            ("qkv_m512", "bf16", 512, 5120, 2560),
            ("qkv_m2048", "bf16", 2048, 5120, 2560),
            ("gate_up_m2048", "bf16", 2048, 5120, 12800),
            ("qkv_m3", "bf16", 3, 5120, 2560),
            ("qkv_m32", "bf16", 32, 5120, 2560),
            ("qkv_m130", "bf16", 130, 5120, 2560),
            ("small_m17", "bf16", 17, 1024, 1024),
            ("qkv_m4_f32", "f32", 4, 5120, 2560),
            ("gate_up_m4_f32", "f32", 4, 5120, 12800))


def _ag_plan(torch, agm, mesh, m, k, n):
    """B10 / B11's bf16 plan on this mesh's card."""
    prop = torch.cuda.get_device_properties(mesh.device)
    return agm.ag_plan(TP, m, k, n, prop.multi_processor_count,
                       mesh.ranks_per_device, prop.L2_cache_size)


def _ag_nan_slots(torch, agm, world, m, k, n, bidir):
    """Makes B10's (bidir False) or B11's bf16 workspace of (m, K, N)'s
    regime on every rank of the one-card world (it must not exist yet) and
    fills the landing rows of both parities with NaN (0xFF bytes), as
    memory no call wrote may hold. The flags stay 0. Returns the regime."""
    for r in range(TP):
        mesh = world.mesh(r)
        plan = _ag_plan(torch, agm, mesh, m, k, n)
        agm.ag_workspace(mesh, plan, bidir).buf.tensor[:plan.flag_off].fill_(
            255)
    return plan.regime


def _ag_phase(torch, symm, agm, bidir, calls):
    """B10 (bidir False) or B11 in the one-card world: AG_CASES, each bf16
    (m, K, regime)'s landing rows NaN-filled before its first call, every
    call held to ag_gemm_ref_shards (the product within 1e-2 x max|ref| in
    bf16, 1e-4 in f32; the gathered A exact) and B11's out to B10's bits
    on the same inputs (small_m17: the stream over five 16-row M groups
    across ragged shards; qkv_m32: the tile GEMM on one row tile); both
    parities eagerly and graph-replayed at 4, 17 (small), 130 and 2,048
    rows a rank (_world_parity_calls); `calls` successive calls
    at the decode QKV. Timed: the four ranks' calls together (queued_ms)
    at 4 and 2,048 rows a rank, beside the plain version (and B10 beside
    B11)."""
    bf, f32 = torch.bfloat16, torch.float32
    world = symm.OneCardWorld(TP)
    g = torch.Generator(device=DEV).manual_seed(61 if bidir else 31)
    fn = agm.pallas_ag_gemm_bidir if bidir else agm.pallas_ag_gemm
    rows, timed, parity = [], {}, {}
    filled = set()

    def run(a, b, f=fn):
        return world.run(lambda r: f(world.mesh(r), a[r], b[r]))

    def check(name, a, b, tol):
        outs = run(a, b)
        b10 = run(a, b, agm.pallas_ag_gemm) if bidir else None
        torch.cuda.synchronize()
        res = []
        for r in range(TP):
            ref, ref_ag = agm.ag_gemm_ref_shards(a, b[r])
            row = _held(torch, f"{name}/rank{r}", outs[r][0], ref, tol)
            row["gathered_exact"] = bool(torch.equal(outs[r][1], ref_ag))
            ok = row["ok"] and row["gathered_exact"]
            if bidir:
                row["b10_bits"] = bool(torch.equal(outs[r][0], b10[r][0]))
                ok = ok and row["b10_bits"]
            row["ok"] = ok
            res.append(row)
        return res

    def parity_calls(m, k, n, sets):
        def draw():
            a, b = _tp_shards(torch, g, bf, m, k, n)
            return [(a[r], b[r]) for r in range(TP)]

        def plain(xs):
            return [agm.ag_gemm_ref_shards([x[0] for x in xs], xs[r][1])
                    for r in range(TP)]

        def held(o, ref):
            return (_held(torch, "", o[0], ref[0], 1e-2)["ok"]
                    and bool(torch.equal(o[1], ref[1])))
        return _world_parity_calls(torch, world, fn, draw, plain, held,
                                   calls=sets, replays=2)

    for name, dts, m, k, n in AG_CASES:
        dt = bf if dts == "bf16" else f32
        regime = _ag_plan(torch, agm, world.mesh(0), m, k, n).regime
        if dt == bf and (m, k, regime) not in filled:
            _ag_nan_slots(torch, agm, world, m, k, n, bidir)
            if bidir:
                _ag_nan_slots(torch, agm, world, m, k, n, False)
            filled.add((m, k, regime))
        a, b = _tp_shards(torch, g, dt, m, k, n)
        rows += check(name, a, b, _tp_tol(torch, dt))
        if dt == bf and m in (4, 2048):
            es = a[0].element_size()
            nbytes = TP * (m * k + k * n + TP * m * n + TP * m * k) * es
            timed[name] = _one_card_kernel_row(
                torch, world, name, lambda r: fn(world.mesh(r), a[r], b[r]),
                lambda: [agm.ag_gemm_ref_shards(a, b[r]) for r in range(TP)],
                nbytes, TP * 2.0 * TP * m * k * n)
            if bidir:
                timed[name]["b10_ms"] = queued_ms(torch, lambda: run(
                    a, b, agm.pallas_ag_gemm))[0]
            timed[name]["max_abs_err"] = max(
                x["max_abs_err"] for x in rows
                if x["case"].startswith(name + "/"))
        if name in ("qkv_m4", "small_m17", "qkv_m130", "qkv_m2048"):
            parity[name] = parity_calls(m, k, n, 4 if m < 2048 else 2)
        del a, b
        torch.cuda.empty_cache()
    seq_ok = []
    for _ in range(calls):
        a, b = _tp_shards(torch, g, bf, 4, 5120, 2560)
        seq_ok.append(all(x["ok"] for x in check("seq", a, b, 1e-2)))
    phase = "b11_ag_gemm_bidir" if bidir else "b10_ag_gemm"
    emit({"phase": phase, "world": "one card, 4 logical ranks",
          "instructions": AG_INSTRUCTIONS, "cases": rows,
          "successive_calls_ok": seq_ok, "parity": parity, "timed": timed})
    if not all(x["ok"] for x in rows) or not all(seq_ok) or \
            not all(_parity_ok(v) for v in parity.values()):
        fail(f"{'B11' if bidir else 'B10'} disagrees with its plain version"
             f"{' or B10' if bidir else ''}: "
             f"{[x for x in rows if not x['ok']]}; successive {seq_ok}; "
             f"parity {parity}")
    decode = {k: v for k, v in timed.items() if k.endswith("_m4")}
    rec = _tp_kernel_record(
        "pallas_ag_gemm_bidir" if bidir else "pallas_ag_gemm", "ag_gemm.cu",
        "triton_dist_tpu/kernels/allgather_gemm.py:"
        + ("498" if bidir else "293"), decode, "one card, 4 logical ranks")
    rec["instructions"] = AG_INSTRUCTIONS
    rec["prefill_shape"] = {k: v for k, v in timed.items()
                            if k.endswith("_m2048")}
    return rec


def phase_b10(torch, symm, agm, calls: int = 20):
    """B10 against its plain version (torch.cat of the ranks' shards, then
    matmul_ref) in the one-card world: four logical ranks, each its own
    stream and symmetric buffer, the peer-pointer tables the four-card
    world uses (_ag_phase)."""
    return _ag_phase(torch, symm, agm, False, calls)


def phase_b13(torch, symm, grs, calls: int = 20):
    """B13a against its plain version (every rank's f32 partial of the
    destination's rows added in ascending rank, the kernel's fold order,
    cast once) in the one-card world. Qwen3-32B at TP=4, B=16 decode
    (m_loc 4, A (16, K_loc)): o K_loc 2048 -> N 5120 and down K_loc 6400
    -> N 5120, bf16 and f32; the prefill-sized m_loc 512 (o, bf16); then
    `calls` successive calls with fresh inputs, every one checked.
    Tolerance and timing as B10's."""
    bf, f32 = torch.bfloat16, torch.float32
    world = symm.OneCardWorld(TP)
    g = torch.Generator(device=DEV).manual_seed(41)
    cases = [("o_m4", bf, 4, 2048, 5120), ("down_m4", bf, 4, 6400, 5120),
             ("o_m512", bf, 512, 2048, 5120), ("o_m4_f32", f32, 4, 2048, 5120),
             ("down_m4_f32", f32, 4, 6400, 5120)]
    rows, timed = [], {}

    def check(name, a, b, outs, tol):
        refs = grs.gemm_rs_ref_shards(a, b)
        return [_held(torch, f"{name}/rank{r}", outs[r], refs[r], tol)
                for r in range(TP)]

    for name, dt, m, k, n in cases:
        a, b = _tp_shards(torch, g, dt, TP * m, k, n)
        outs = world.run(lambda r: grs.pallas_gemm_rs(world.mesh(r), a[r],
                                                       b[r]))
        torch.cuda.synchronize()
        rows += check(name, a, b, outs, _tp_tol(torch, dt))
        if name in ("o_m4", "down_m4"):
            es = a[0].element_size()
            nbytes = TP * (TP * m * k + k * n + m * n) * es
            timed[name] = _one_card_kernel_row(
                torch, world, name,
                lambda r: grs.pallas_gemm_rs(world.mesh(r), a[r], b[r]),
                lambda: grs.gemm_rs_ref_shards(a, b),
                nbytes, TP * 2.0 * TP * m * k * n)
            timed[name]["max_abs_err"] = max(
                x["max_abs_err"] for x in rows if x["case"].startswith(name))
    seq_ok = []
    for _ in range(calls):
        a, b = _tp_shards(torch, g, bf, TP * 4, 2048, 5120)
        outs = world.run(lambda r: grs.pallas_gemm_rs(world.mesh(r), a[r],
                                                       b[r]))
        torch.cuda.synchronize()
        seq_ok.append(all(x["ok"] for x in check("seq", a, b, outs, 1e-2)))
    emit({"phase": "b13_gemm_rs", "world": "one card, 4 logical ranks",
          "cases": rows, "successive_calls_ok": seq_ok, "timed": timed})
    if not all(x["ok"] for x in rows) or not all(seq_ok):
        fail(f"B13a disagrees with its plain version: "
             f"{[x for x in rows if not x['ok']]}; successive {seq_ok}")
    return _tp_kernel_record(
        "pallas_gemm_rs", "gemm_rs.cu",
        "triton_dist_tpu/kernels/gemm_reduce_scatter.py:321", timed,
        "one card, 4 logical ranks")


def _same_bytes(torch, outs):
    """Every rank's output equal to rank 0's, bit for bit."""
    return all(torch.equal(o, outs[0]) for o in outs)


def _mm_f32(torch, a, b):
    """torch.mm with f32 output (cuBLAS, f32 accumulation)."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    return torch.mm(a, b, out_dtype=torch.float32)


# what B4 across ranks runs on (csrc/gemm_ar.cu)
B4_TP_INSTRUCTIONS = ("bf16: gemm_stream_sm90.cuh's mma.sync m16n8k16 "
                      "stream-K GEMM, one pass over the weight shard (128 x "
                      "128 weight tiles by TMA, 5 stages), each tile's f32 "
                      "rows landed in this rank's slot on every rank (LL "
                      "lines up to AR_LL_MAX_SLOT_BYTES a slot, else flags), "
                      "slot 0 + ... + slot n-1 folded in f32 by every rank; "
                      "f32: FMA")


def _b4_alternating(draw):
    """draw() of _world_parity_calls for B4's alternating gate: each call
    the next of Qwen3-32B's o (K_loc 2,048) and down (K_loc 6,400) at
    TP=4, 16 rows -> 5,120, bf16: each rank's (a, b)."""
    turn = iter(range(1 << 30))

    def f():
        a, b = draw((2048, 6400)[next(turn) % 2])
        return [(a[r], b[r]) for r in range(TP)]
    return f


def phase_b4_tp(torch, symm, ga, calls: int = 20):
    """B4 across ranks (one pass over the weight shard, each tile's f32
    rows landed in this rank's slot on every rank, slot 0 + ... + slot 3
    folded in f32, one cast) against its plain version (gemm_ar_ref_shards:
    the same fold) in the one-card world. Qwen3-32B at TP=4, B=16
    replicated decode: o (16, 2048) x (2048, 5120) and down (16, 6400) x
    (6400, 5120), bf16 and f32; integer-valued (bit for bit: every sum
    exact); the protocol the plan does not pick at o and down; an odd
    shape (m 6, K 1000, N 136) and a 512-row prefill chunk; then `calls`
    successive o calls with fresh inputs, every one checked; and o and
    down alternately over both parities (4 eager calls, 4 calls in one
    graph a rank replayed over fresh inputs), random and integer-valued,
    with the flags protocol too. Within 1e-2 x max|ref| in bf16, 1e-4 in
    f32 (B10/B13a's tolerances), exact on integer-valued inputs, and the
    four ranks' outputs the same bytes. Timed: the four ranks' calls
    together on the one card (queued_ms), warm (one weight a rank) and
    cold (the calls rotate over weight copies larger than twice the L2),
    bound by the four ranks' bytes at HBM speed; the library yardstick
    each rank's torch.mm (f32 output) and one torch.stack(...).sum(0) of
    the four partials, warm and cold."""
    bf, f32 = torch.bfloat16, torch.float32
    world = symm.OneCardWorld(TP)
    g = torch.Generator(device=DEV).manual_seed(43)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [("o_m16", bf, 16, 2048, 5120), ("down_m16", bf, 16, 6400, 5120),
             ("o_m16_f32", f32, 16, 2048, 5120),
             ("down_m16_f32", f32, 16, 6400, 5120),
             ("o_m16_int", bf, 16, 2048, 5120),
             ("down_m16_int_f32", f32, 16, 6400, 5120),
             ("o_m16_other", bf, 16, 2048, 5120),
             ("down_m16_other", bf, 16, 6400, 5120),
             ("odd_m6", bf, 6, 1000, 136),
             ("o_m512", bf, 512, 2048, 5120)]
    rows, timed = [], {}

    def forced(k, ll):
        """B4 under the protocol ll at 16 rows of K -> 5,120 bf16."""
        plan = ga.ar_layout(TP, 16, k, 5120, True, sms, TP, ll)
        return lambda mesh, a, b: ga._launch_ar(mesh, a, b, plan)

    def run(name, k):
        if "_other" not in name:
            return ga.pallas_gemm_ar
        return forced(k, not ga.ar_plan(TP, 16, k, 5120, 2, sms, TP).ll)

    def run_check(name, fn, a, b, tol):
        outs = world.run(lambda r: fn(world.mesh(r), a[r], b[r]))
        torch.cuda.synchronize()
        refs = ga.gemm_ar_ref_shards(a, b)
        res = [_held(torch, f"{name}/rank{r}", outs[r], refs[r], tol)
               for r in range(TP)]
        if "_int" in name:
            for r, row in enumerate(res):
                row["exact"] = bool(torch.equal(outs[r], refs[r]))
                row["ok"] = row["ok"] and row["exact"]
        res[0]["ranks_same_bytes"] = _same_bytes(torch, outs)
        res[0]["ok"] = res[0]["ok"] and res[0]["ranks_same_bytes"]
        return res

    for name, dt, m, k, n in cases:
        draw = _int_shards if "_int" in name else _tp_shards
        a, b = draw(torch, g, dt, m, k, n)
        rows += run_check(name, run(name, k), a, b, _tp_tol(torch, dt))
        if name not in ("o_m16", "down_m16"):
            continue
        es = a[0].element_size()
        nbytes = TP * (m * k + k * n + m * n) * es
        timed[name] = _one_card_kernel_row(
            torch, world, name,
            lambda r: ga.pallas_gemm_ar(world.mesh(r), a[r], b[r]),
            lambda: ga.gemm_ar_ref_shards(a, b),
            nbytes, TP * 2.0 * m * k * n)

        def lib(w):
            return torch.stack([_mm_f32(torch, a[r], w[r])
                                for r in range(TP)]).sum(0).to(dt)
        timed[name]["library_ms"] = queued_ms(torch, lambda: lib(b))[0]
        ws = [weight_copies(torch, g, k, n, dt) for _ in range(TP)]
        timed[name]["cold_ms"] = _world_cold_ms(
            torch, world, lambda r, w: ga.pallas_gemm_ar(
                world.mesh(r), a[r], w), ws)
        timed[name]["library_cold_ms"] = cold_graph_ms(
            torch, lib, [list(w) for w in zip(*ws)])
        del ws
        timed[name]["max_abs_err"] = max(
            x["max_abs_err"] for x in rows if x["case"].startswith(name))
        timed[name]["plan"] = {
            key: getattr(ga.ar_plan(TP, m, k, n, es, sms, TP), key)
            for key in ("grid", "ll", "slot_bytes")}
        del a, b
        torch.cuda.empty_cache()
    seq_ok = []
    for _ in range(calls):
        a, b = _tp_shards(torch, g, bf, 16, 2048, 5120)
        seq_ok.append(all(x["ok"] for x in run_check(
            "seq", ga.pallas_gemm_ar, a, b, 1e-2)))
    alternating = {}
    for name, draw, tol, other in (("random", _tp_shards, 1e-2, False),
                                   ("int", _int_shards, 0, False),
                                   ("random_other", _tp_shards, 1e-2, True)):
        # the other protocol: o and down each under the one their plan
        # does not pick (still one plan, one workspace for both)
        def fn(mesh, a, b, other=other):
            if not other:
                return ga.pallas_gemm_ar(mesh, a, b)
            return run("_other", a.shape[1])(mesh, a, b)
        alternating[name] = _world_parity_calls(
            torch, world, fn,
            _b4_alternating(lambda k, draw=draw: draw(torch, g, bf, 16, k,
                                                      5120)),
            lambda xs: ga.gemm_ar_ref_shards([x[0] for x in xs],
                                             [x[1] for x in xs]),
            _tol_held(torch, tol), same_bytes=True)
    emit({"phase": "b4_gemm_ar_tp", "world": "one card, 4 logical ranks",
          "cases": rows, "successive_calls_ok": seq_ok,
          "alternating_o_down": alternating, "timed": timed,
          "instructions": B4_TP_INSTRUCTIONS})
    if not all(x["ok"] for x in rows) or not all(seq_ok) or \
            not all(_parity_ok(v) for v in alternating.values()):
        fail(f"B4 across ranks disagrees with its plain version: "
             f"{[x for x in rows if not x['ok']]}; successive {seq_ok}; "
             f"alternating {alternating}")
    rec = _tp_kernel_record(
        "pallas_gemm_ar", "gemm_ar.cu",
        "triton_dist_tpu/kernels/gemm_allreduce.py:101", timed,
        "one card, 4 logical ranks")
    rec["cold_ms"] = sum(t["cold_ms"] for t in timed.values()) / len(timed)
    rec["library_ms_call"] = ("4 x torch.mm(a_r, b_r, out_dtype=f32), "
                              "torch.stack(...).sum(0), cast")
    return rec


# B6's rows of x (M, a multiple of 4): the ContinuousEngine's padded
# 1- and 2-token chunks (4, 8), a TP=4 decode step (16), a short and a
# whole 512-token prefill chunk (128, 512); timed at 16 and 512 (the
# regimes' shapes); edges at K 5000 (625 vectors a row in bf16: uneven
# column slices)
_RHD_ROWS = (4, 8, 16, 128, 512)
_RHD_TIMED = (16, 512)
_RHD_EDGES = ((16, 5000), (512, 5000))
# rows of x in B6's regime / protocol sweep (K 5120 bf16)
_RHD_SWEEP_ROWS = (4, 8, 16, 32, 64, 128, 256, 512, 2048)


def phase_all_reduce(torch, symm, arm, kind, calls: int = 20):
    """B5 (kind "one_shot") or B6 ("rhd") against its plain version in
    the one-card world. B5: each rank's x of 4, 16 (Qwen3-32B's hidden
    rows at B=16: the sum after the o and down products) and 512 rows (a
    prefill chunk) of 5,120, and 16 of 5,000; B6: x of _RHD_ROWS rows (and
    the K 5000 edges), each in bf16 and f32; then `calls` successive bf16
    calls with fresh inputs (B6: at each timed shape), a graph of 64
    calls a rank replayed 3 times over fresh inputs against the eager
    calls (_graph_calls); for B5 both protocols forced at 16 and 512 rows
    and a world of 3 ranks, for B6 the regime / protocol sweep
    (_rhd_sweep). Both only add, so each rank's output must
    equal its plain fold bit for bit (B5: own term first, then the others
    ascending; B6: the halving tree, the same bytes on every rank). Timed:
    the four ranks' calls together (queued_ms; B6 also `calls` calls a
    rank in a graph per rank, graph_ms), bound by each rank's x read and
    output written at HBM speed; the library yardstick one
    torch.stack(...).sum(0) of the four inputs."""
    fn = (arm.one_shot_all_reduce if kind == "one_shot"
          else arm.rhd_all_reduce)
    ref = arm.one_shot_ref_shards if kind == "one_shot" else \
        arm.rhd_ref_shards
    world = symm.OneCardWorld(TP)
    g = torch.Generator(device=DEV).manual_seed(47)
    rows, timed = [], {}

    def draw(dt, m=16, k=5120):
        return [torch.randn((m, k), generator=g, device=DEV).to(dt)
                for _ in range(TP)]

    def run_check(name, xs):
        outs = world.run(lambda r: fn(world.mesh(r), xs[r]))
        torch.cuda.synchronize()
        refs = ref(xs)
        res = [{"case": f"{name}/rank{r}",
                "max_abs_err": (outs[r].float() - refs[r].float()).abs()
                .max().item(),
                "ok": bool(torch.equal(outs[r], refs[r]))}
               for r in range(TP)]
        if kind == "rhd":
            res[0]["ranks_same_bytes"] = _same_bytes(torch, outs)
            res[0]["ok"] = res[0]["ok"] and res[0]["ranks_same_bytes"]
        return res

    shapes = ([(4, 5120), (16, 5120), (512, 5120), (16, 5000)]
              if kind == "one_shot" else
              [(m, 5120) for m in _RHD_ROWS] + list(_RHD_EDGES))
    timed_rows = (16,) if kind == "one_shot" else _RHD_TIMED
    seq_ok = []
    for m, k in shapes:
        for dt in (torch.bfloat16, torch.float32):
            name = f"x_m{m}" + ("" if k == 5120 else f"_k{k}") + \
                ("" if dt == torch.bfloat16 else "_f32")
            xs = draw(dt, m, k)
            rows += run_check(name, xs)
            if dt != torch.bfloat16 or k != 5120 or m not in timed_rows:
                continue
            nbytes = TP * 2 * xs[0].numel() * xs[0].element_size()
            timed[name] = _one_card_kernel_row(
                torch, world, name, lambda r: fn(world.mesh(r), xs[r]),
                lambda: ref(xs), nbytes, TP * (TP - 1.0) * xs[0].numel())
            timed[name]["library_ms"] = queued_ms(
                torch, lambda: torch.stack(xs).sum(0))[0]
            timed[name]["max_abs_err"] = max(
                x["max_abs_err"] for x in rows if x["case"].startswith(name))
            if kind == "rhd":
                _, replay = _world_graphs(torch, world, lambda r: [
                    fn(world.mesh(r), xs[r]) for _ in range(calls)])
                replay()
                timed[name]["graph_ms"] = replay() / calls
                timed[name]["plan"] = _rhd_plan_of(torch, arm, xs[0], TP)
            seq_ok += [all(x["ok"] for x in run_check(
                f"seq_m{m}", draw(torch.bfloat16, m))) for _ in range(calls)]
    if kind == "one_shot":
        rows += _one_shot_protocols(torch, world, arm, draw)
        world3 = symm.OneCardWorld(3)
        xs = [torch.randn((16, 5120), generator=g, device=DEV).to(
            torch.bfloat16) for _ in range(3)]
        outs = world3.run(lambda r: fn(world3.mesh(r), xs[r]))
        torch.cuda.synchronize()
        rows += [{"case": f"x_m16_world3/rank{r}",
                  "ok": bool(torch.equal(o, want))}
                 for r, (o, want) in enumerate(zip(outs, ref(xs)))]
        del world3
        xs = draw(torch.bfloat16)
    before = fn.launches
    world.run(lambda r: fn(world.mesh(r), xs[r]))
    torch.cuda.synchronize()
    launches_per_call = (fn.launches - before) / TP
    rec = {"phase": "b5_one_shot" if kind == "one_shot" else "b6_rhd",
           "world": "one card, 4 logical ranks", "cases": rows,
           "successive_calls_ok": seq_ok, "timed": timed,
           "launches_per_call_a_rank": launches_per_call}
    graph_ok = _graph_calls(torch, world, fn, ref,
                            lambda: draw(torch.bfloat16))
    rec["graph_64_calls_x3_ok"] = graph_ok
    sweep = []
    if kind == "rhd":
        sweep = _rhd_sweep_world(torch, world, arm, g)
        rec.update(rhd_sweep=sweep,
                   one_shot_max_bytes=arm.RHD_ONE_SHOT_MAX_BYTES)
    phase = rec["phase"]
    emit(rec)
    if not all(x["ok"] for x in rows) or not all(seq_ok) or \
            not all(graph_ok) or launches_per_call != 1 or not all(
                v for r in sweep for key, v in r.items()
                if key.endswith("_ok")):
        fail(f"{phase} disagrees with its plain version: "
             f"{[x for x in rows if not x['ok']]}; successive {seq_ok}; "
             f"graph replays {graph_ok}; sweep {sweep}; "
             f"{launches_per_call} launches a call")
    rec = _tp_kernel_record(
        f"{kind}_all_reduce", "allreduce.cu",
        "triton_dist_tpu/kernels/allreduce.py:"
        + ("99" if kind == "one_shot" else "170"), timed,
        "one card, 4 logical ranks")
    if kind == "rhd":
        rec["graph_ms"] = sum(t["graph_ms"] for t in timed.values()) / len(
            timed)
    rec["library_ms_call"] = "torch.stack(xs).sum(0)"
    return rec


def _forced_one_shot(torch, arm, mesh, x, ll):
    """B5 on this rank's x under the protocol ``ll`` (LL if true, flags if
    false) on its plan's grid, through the package's private launcher (the
    package fixes it by the bytes of a slot; only the checks and the sweep
    force it). Not counted."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rows, k = x.shape
    kv = k * x.element_size() // 16
    plan = arm.rhd_layout(mesh.world, rows, kv,
                          arm.rhd_grid(rows, kv, sms, mesh.ranks_per_device),
                          ll, False)
    return arm._launch_one_shot(mesh, x, plan)


def _one_shot_protocols(torch, world, arm, draw):
    """B5 under each protocol at 16 and 512 rows of 5,120 bf16 in the
    one-card world, each rank's output bitwise one_shot_ref_shards'."""
    rows = []
    for m in (16, 512):
        xs = draw(torch.bfloat16, m)
        refs = arm.one_shot_ref_shards(xs)
        for ll in (True, False):
            outs = world.run(lambda r: _forced_one_shot(
                torch, arm, world.mesh(r), xs[r], ll))
            torch.cuda.synchronize()
            rows += [{"case": f"x_m{m}_{'ll' if ll else 'flags'}/rank{r}",
                      "ok": bool(torch.equal(outs[r], refs[r]))}
                     for r in range(TP)]
    return rows


def _rhd_plan_of(torch, arm, x, rpd):
    """B6's plan for x with rpd ranks a card: regime, protocol, grid."""
    plan = arm.rhd_plan(TP, x.shape[0], x.shape[1], x.element_size(),
                        torch.cuda.get_device_properties(
                            x.device).multi_processor_count, rpd)
    return {"two_shot": plan.two_shot, "ll": plan.ll, "grid": plan.grid}


def _forced_rhd(torch, arm, mesh, x, two_shot, ll):
    """B6 on this rank's x under the regime ``two_shot`` and the protocol
    ``ll`` (LL if true, flags if false) on that regime's grid, through the
    package's private launcher (the package fixes both by the bytes of x
    and of a slot; only this sweep forces them). Not counted."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    rows, k = x.shape
    kv = k * x.element_size() // 16
    m = rows // mesh.world if two_shot else rows
    plan = arm.rhd_layout(mesh.world, rows, kv,
                          arm.rhd_grid(m, kv, sms, mesh.ranks_per_device),
                          ll, two_shot)
    return arm._launch_rhd(mesh, x, plan)


_RHD_MODES = (("one_shot_ll", False, True), ("one_shot_flags", False, False),
              ("two_shot_ll", True, True), ("two_shot_flags", True, False))


def _rhd_sweep(call, held, plan_of, library=None):
    """B6 under each regime and protocol (_RHD_MODES) at _RHD_SWEEP_ROWS
    rows of 5120 bf16: call(m, two_shot, ll) returns ms, held(m,
    two_shot, ll) whether the outputs equal the plain version, plan_of(m)
    the package's own choice, library(m) the yardstick's ms. The rows
    that set RHD_ONE_SHOT_MAX_BYTES."""
    out = []
    for m in _RHD_SWEEP_ROWS:
        rec = {"rows": m, "x_bytes": m * 5120 * 2, "plan": plan_of(m)}
        for key, two, ll in _RHD_MODES:
            rec[f"{key}_ok"] = held(m, two, ll)
            rec[f"{key}_ms"] = call(m, two, ll)
        if library is not None:
            rec["library_ms"] = library(m)
        out.append(rec)
    return out


def _rhd_sweep_world(torch, world, arm, g):
    """_rhd_sweep in the one-card world (the four ranks' calls together,
    queued_ms), each case bitwise rhd_ref_shards."""
    inputs = {}

    def xs_of(m):
        if m not in inputs:
            inputs[m] = [torch.randn((m, 5120), generator=g, device=DEV).to(
                torch.bfloat16) for _ in range(TP)]
        return inputs[m]

    def launch(m, two, ll):
        xs = xs_of(m)
        return lambda r: _forced_rhd(torch, arm, world.mesh(r), xs[r], two,
                                     ll)

    def held(m, two, ll):
        outs = world.run(launch(m, two, ll))
        torch.cuda.synchronize()
        refs = arm.rhd_ref_shards(xs_of(m))
        return all(torch.equal(o, ref) for o, ref in zip(outs, refs))

    def call(m, two, ll):
        run = launch(m, two, ll)
        return queued_ms(torch, lambda: world.run(run))[0]
    out = _rhd_sweep(call, held,
                     lambda m: _rhd_plan_of(torch, arm, xs_of(m)[0], TP))
    inputs.clear()
    torch.cuda.empty_cache()
    return out


# the ring collectives' one-card shapes: (name, rows m of each rank's
# chunk, K); kinds "ring_rs" (B9: each rank's x (4m, K) -> (m, K)),
# "ring_ag" (B7: (m, K) -> (4m, K)) and "two_shot" (B9 then B7: (4m, K)
# -> (4m, K)). m 4: a TP=4 decode step's 16 rows; m 128: one 512-token
# prefill chunk (timed). The edges, held only: m 1 and 2 (the
# ContinuousEngine's padded short chunks) and K 5000 (625 vectors a row
# in bf16, 1,250 in f32: the grid's column slices are uneven).
_RING_SHAPES = (("m4", 4, 5120), ("m128", 128, 5120))
_RING_EDGES = (("m1", 1, 5120), ("m2", 2, 5120), ("m4_k5000", 4, 5000),
               ("m128_k5000", 128, 5000))
# rows a rank chunk of the protocol sweep (K 5120 bf16)
_RING_SWEEP_ROWS = (1, 2, 4, 8, 16, 32, 64, 128)


def _ring_io(kind, m, k):
    """(elements of one rank's input, of its output) for one call."""
    full = TP * m * k
    return {"ring_rs": (full, m * k), "ring_ag": (m * k, full),
            "two_shot": (full, full)}[kind]


def _world_graphs(torch, world, fn):
    """A CUDA graph per rank of the one-card world, fn(r) captured on the
    rank's stream after an eager warm-up of every rank (workspaces and
    kernels are made outside capture), as each rank process of four cards
    captures its own. Returns (each rank's captured outputs, replay):
    replay() launches the ranks' graphs together and returns its device
    ms."""
    world.run(fn)
    torch.cuda.synchronize()
    graphs, outs = [], []
    for r, s in enumerate(world.streams):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=s):
            outs.append(fn(r))
        graphs.append(graph)

    def replay():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        world.run(lambda r: graphs[r].replay())
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1])
    return outs, replay


def _graph_calls(torch, world, fn, plain, draw, pairs=64, replays=3):
    """`pairs` calls of fn (TWO_SHOT's pair, B6) on distinct inputs
    captured in one graph per rank (as the ContinuousEngine captures its
    steps' sums), replayed `replays` times over fresh inputs written into
    the captured ones; after each replay every output must equal the eager
    call on the same inputs and the plain version, bit for bit, on every
    rank."""
    xs = [draw() for _ in range(pairs)]
    outs, replay = _world_graphs(
        torch, world, lambda r: [fn(world.mesh(r), x[r]) for x in xs])
    ok = []
    for _ in range(replays):
        for x in xs:
            for r, t in enumerate(draw()):
                x[r].copy_(t)
        replay()
        same = True
        for i, x in enumerate(xs):
            eager = world.run(lambda r: fn(world.mesh(r), x[r]))
            torch.cuda.synchronize()
            refs = plain(x)
            same &= all(torch.equal(outs[r][i], eager[r]) and
                        torch.equal(outs[r][i], refs[r]) for r in range(TP))
        ok.append(bool(same))
    return ok


def phase_ring(torch, symm, rsm, agm, arm, kind, calls: int = 20):
    """B9 ("ring_rs"), B7 ("ring_ag") or TWO_SHOT (B9 then B7) against
    the plain version in the one-card world (four logical ranks, each its
    stream and symmetric buffer): Qwen3-32B's hidden rows at TP=4
    (_RING_SHAPES) and the edges (_RING_EDGES), bf16 and f32, then
    `calls` successive bf16 calls of each shape with fresh inputs; for
    TWO_SHOT also a graph of 64 pairs a rank replayed 3 times over fresh
    inputs (_graph_calls). They only add (B9, in the ring's order) or
    move rows (B7), so every rank's output must equal the plain version
    bit for bit (ring_rs_ref_shards; the concatenation in rank order).
    Timed: the four ranks' calls together (queued_ms) and `calls` calls a
    rank captured in a graph per rank (graph_ms); the bound is the four
    ranks' input read once and output written once at HBM speed (the
    exchange is the kernel's own traffic); the library yardstick one torch
    op of the same function on the four inputs (stack-sum-slice, cat,
    stack-sum)."""
    world = symm.OneCardWorld(TP)
    g = torch.Generator(device=DEV).manual_seed(53)
    fns = {"ring_rs": rsm.ring_reduce_scatter, "ring_ag": agm.ring_all_gather,
           "two_shot": lambda mesh, x: arm.all_reduce_per_device(
               TP, arm.AllReduceMethod.TWO_SHOT, x, mesh=mesh)}
    fn = fns[kind]

    def plain(xs):
        if kind == "ring_ag":
            full = torch.cat(xs)
            return [full] * TP
        outs = rsm.ring_rs_ref_shards(xs)
        if kind == "two_shot":
            full = torch.cat(outs)
            return [full] * TP
        return outs

    def library(xs):
        if kind == "ring_ag":
            return torch.cat(xs)
        total = torch.stack(xs).sum(0)
        if kind == "ring_rs":
            return list(total.chunk(TP))
        return total

    def draw(dt, m, k):
        rows = m if kind == "ring_ag" else TP * m
        return [torch.randn((rows, k), generator=g, device=DEV).to(dt)
                for _ in range(TP)]

    def run_check(name, xs):
        outs = world.run(lambda r: fn(world.mesh(r), xs[r]))
        torch.cuda.synchronize()
        refs = plain(xs)
        return [{"case": f"{name}/rank{r}",
                 "max_abs_err": (outs[r].float() - refs[r].float()).abs()
                 .max().item(),
                 "ok": bool(torch.equal(outs[r], refs[r]))}
                for r in range(TP)]

    rows, timed, seq_ok = [], {}, []
    for shp, m, k in _RING_SHAPES + _RING_EDGES:
        for dt in (torch.bfloat16, torch.float32):
            name = shp if dt == torch.bfloat16 else f"{shp}_f32"
            xs = draw(dt, m, k)
            rows += run_check(name, xs)
            if dt != torch.bfloat16 or (shp, m, k) not in _RING_SHAPES:
                continue
            n_in, n_out = _ring_io(kind, m, k)
            nbytes = TP * (n_in + n_out) * xs[0].element_size()
            adds = 0 if kind == "ring_ag" else TP * (TP - 1.0) * m * k
            timed[name] = _one_card_kernel_row(
                torch, world, name, lambda r: fn(world.mesh(r), xs[r]),
                lambda: plain(xs), nbytes, adds)
            _, replay = _world_graphs(torch, world, lambda r: [
                fn(world.mesh(r), xs[r]) for _ in range(calls)])
            replay()
            timed[name]["graph_ms"] = replay() / calls
            timed[name]["library_ms"] = queued_ms(
                torch, lambda: library(xs))[0]
            timed[name]["max_abs_err"] = max(
                x["max_abs_err"] for x in rows if x["case"].startswith(name))
        seq_ok += [all(x["ok"] for x in run_check(
            f"seq_{shp}", draw(torch.bfloat16, m, k))) for _ in range(calls)]
    graph_ok = (_graph_calls(torch, world, fn, plain,
                                lambda: draw(torch.bfloat16, 4, 5120))
                if kind == "two_shot" else [])
    phase = {"ring_rs": "b9_ring_rs", "ring_ag": "b7_ring_ag",
             "two_shot": "two_shot"}[kind]
    emit({"phase": phase, "world": "one card, 4 logical ranks",
          "cases": rows, "successive_calls_ok": seq_ok,
          "graph_64_pairs_x3_ok": graph_ok, "timed": timed})
    if not all(x["ok"] for x in rows) or not all(seq_ok) or \
            not all(graph_ok):
        fail(f"{phase} disagrees with its plain version: "
             f"{[x for x in rows if not x['ok']]}; successive {seq_ok}; "
             f"graph replays {graph_ok}")
    if kind == "two_shot":
        return None
    rec = _tp_kernel_record(
        "ring_reduce_scatter" if kind == "ring_rs" else "ring_all_gather",
        "ring_collectives.cu",
        "triton_dist_tpu/kernels/reduce_scatter.py:38" if kind == "ring_rs"
        else "triton_dist_tpu/kernels/allgather.py:59", timed,
        "one card, 4 logical ranks")
    rec["graph_ms"] = sum(t["graph_ms"] for t in timed.values()) / len(timed)
    rec["library_ms_call"] = ("[torch.stack(xs).sum(0).chunk(4)]"
                              if kind == "ring_rs" else "torch.cat(xs)")
    return rec


def _forced_ring(torch, rsm, kind, mesh, x, m, ll):
    """B9 (kind "ring_rs") or B7 ("ring_ag") on this rank under the
    protocol ``ll`` (LL if true, flags if false) on the plan's own grid,
    through the package's private launcher (the package fixes the protocol
    by LL_MAX_SLOT_BYTES; only this sweep forces one). Not counted."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = rsm.ring_plan(mesh.world, m, x.shape[1], x.element_size(), sms,
                         mesh.ranks_per_device)
    forced = rsm.ring_layout(mesh.world, m, plan.kv, plan.grid, ll)
    return rsm._launch(kind, mesh, x, forced)


def _ring_sweep(call, held, library=None):
    """B9 and B7 under each protocol (LL, flags) at _RING_SWEEP_ROWS rows
    a rank chunk of 5120 bf16: call(kind, m, ll) returns (ms, the plan's
    own choice), held(kind, m, ll) whether the outputs equal the plain
    version, library(kind, m) the yardstick's ms. The rows that set
    LL_MAX_SLOT_BYTES."""
    out = []
    for m in _RING_SWEEP_ROWS:
        rec = {"rows_a_chunk": m}
        for kind in ("ring_rs", "ring_ag"):
            for ll in (True, False):
                key = f"{kind}_{'ll' if ll else 'flags'}"
                rec[f"{key}_ok"] = held(kind, m, ll)
                rec[f"{key}_ms"], rec["plan"] = call(kind, m, ll)
            if library is not None:
                rec[f"{kind}_library_ms"] = library(kind, m)
        out.append(rec)
    return out


def phase_ring_floor(torch, symm, rsm):
    """The latency floor of a one-hop kernel in the one-card world: ranks
    0 and 1 bounce one flag ROUND_TRIPS times (``flag_round_trip``),
    device ms over ROUND_TRIPS = one round trip; then the protocol sweep
    of B9 and B7 (_ring_sweep, the four ranks' calls together,
    queued_ms), each case bitwise its plain version."""
    world = symm.OneCardWorld(TP)
    g = torch.Generator(device=DEV).manual_seed(59)

    def bounce():
        world.run(lambda r: rsm.flag_round_trip(world.mesh(r)))
    bounce()
    torch.cuda.synchronize()
    trip_ms = queued_ms(torch, bounce, iters=5, warm=1)[0] / rsm.ROUND_TRIPS
    inputs = {}

    def xs_of(kind, m):
        if (kind, m) not in inputs:
            rows = TP * m if kind == "ring_rs" else m
            inputs[kind, m] = [torch.randn((rows, 5120), generator=g,
                                           device=DEV).to(torch.bfloat16)
                               for _ in range(TP)]
        return inputs[kind, m]

    def launch(kind, m, ll):
        xs = xs_of(kind, m)
        return lambda r: _forced_ring(torch, rsm, kind, world.mesh(r), xs[r],
                                      m, ll)

    def held(kind, m, ll):
        xs = xs_of(kind, m)
        outs = world.run(launch(kind, m, ll))
        torch.cuda.synchronize()
        refs = (rsm.ring_rs_ref_shards(xs) if kind == "ring_rs"
                else [torch.cat(xs)] * TP)
        return all(torch.equal(o, ref) for o, ref in zip(outs, refs))

    def call(kind, m, ll):
        run = launch(kind, m, ll)
        plan = rsm.ring_plan(TP, m, 5120, 2, torch.cuda.get_device_properties(
            DEV).multi_processor_count, TP)
        return (queued_ms(torch, lambda: world.run(run))[0],
                {"grid": plan.grid, "ll": plan.ll})
    sweep = _ring_sweep(call, held)
    emit({"phase": "ring_floor", "world": "one card, 4 logical ranks",
          "flag_round_trip_ms": trip_ms, "rounds": rsm.ROUND_TRIPS,
          "ll_max_slot_bytes": rsm.LL_MAX_SLOT_BYTES, "sweep": sweep})
    if not all(v for rec in sweep for key, v in rec.items()
               if key.endswith("_ok")):
        fail(f"ring protocol sweep disagrees with the plain version: "
             f"{sweep}")
    return trip_ms


# -- slice 8 in the one-card world: B8, B11, B13b ----------------------------

_B8_SHAPES = (("m4", 4, 5120), ("m128", 128, 5120))


def phase_b8(torch, symm, kern, ring_ag, calls: int = 20):
    """B8 (the full-mesh all-gather) against its plain version, the
    concatenation in rank order, in the one-card world: the B7 shapes, a
    decode step's 4 rows per rank and a 512-token chunk's 128 (Qwen3-32B's
    hidden, TP=4), bf16 and f32, then `calls` successive bf16 calls of
    each shape with fresh inputs; every rank's rows must be the plain
    version's bytes. Timed: the four ranks' calls together, beside B7 on
    the same inputs (queued_ms). Then the mesh-level path: the counts
    zeroed, ``all_gather_op`` at AUTO on every rank at the decode shape
    (FULL_MESH: B8), the counts read."""
    world = symm.OneCardWorld(TP)
    g = torch.Generator(device=DEV).manual_seed(57)

    def draw(dt, m, k):
        return [torch.randn((m, k), generator=g, device=DEV).to(dt)
                for _ in range(TP)]

    def run_check(name, xs, fn=ring_ag.full_mesh_all_gather):
        outs = world.run(lambda r: fn(world.mesh(r), xs[r]))
        torch.cuda.synchronize()
        ref = torch.cat(xs)
        return [{"case": f"{name}/rank{r}",
                 "max_abs_err": (outs[r].float() - ref.float()).abs()
                 .max().item(), "ok": bool(torch.equal(outs[r], ref))}
                for r in range(TP)]

    rows, timed, seq_ok = [], {}, []
    for shp, m, k in _B8_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            name = shp if dt == torch.bfloat16 else f"{shp}_f32"
            xs = draw(dt, m, k)
            rows += run_check(name, xs)
            if dt != torch.bfloat16:
                continue
            nbytes = TP * (m * k + TP * m * k) * xs[0].element_size()
            timed[name] = _one_card_kernel_row(
                torch, world, name,
                lambda r: ring_ag.full_mesh_all_gather(world.mesh(r), xs[r]),
                lambda: [torch.cat(xs)] * TP, nbytes, 0.0)
            timed[name]["library_ms"] = queued_ms(
                torch, lambda: torch.cat(xs))[0]
            timed[name]["b7_ms"] = queued_ms(torch, lambda: world.run(
                lambda r: ring_ag.ring_all_gather(world.mesh(r), xs[r])))[0]
            timed[name]["max_abs_err"] = max(
                x["max_abs_err"] for x in rows if x["case"].startswith(name))
        seq_ok += [all(x["ok"] for x in run_check(
            f"seq_{shp}", draw(torch.bfloat16, m, k))) for _ in range(calls)]
    xs = draw(torch.bfloat16, 4, 5120)
    kern.reset_launch_counts()
    outs = world.run(lambda r: ring_ag.all_gather_op(world.mesh(r), xs[r]))
    torch.cuda.synchronize()
    path = kern.launch_counts()
    op_ok = all(torch.equal(o, torch.cat(xs)) for o in outs) and \
        path == _only(path, full_mesh_all_gather=TP)
    emit({"phase": "b8_full_mesh_ag", "world": "one card, 4 logical ranks",
          "cases": rows, "successive_calls_ok": seq_ok, "timed": timed,
          "all_gather_op_auto": {"launches": path, "ok": op_ok}})
    if not all(x["ok"] for x in rows) or not all(seq_ok) or not op_ok:
        fail(f"B8 disagrees with its plain version or all_gather_op did "
             f"not take it: {[x for x in rows if not x['ok']]}; successive "
             f"{seq_ok}; all_gather_op {path}")
    rec = _tp_kernel_record("full_mesh_all_gather", "ring_collectives.cu",
                            "triton_dist_tpu/kernels/allgather.py:114",
                            timed, "one card, 4 logical ranks")
    rec["library_ms_call"] = "torch.cat(xs)"
    rec["launches_by_path"] = {"all_gather_op_one_card": path[
        "full_mesh_all_gather"]}
    rec["launches"] = path["full_mesh_all_gather"]
    return rec


def _int_shards(torch, g, dt, m, k, n):
    """Integer-valued shards in [-3, 3]: every product and sum exact in
    f32 whatever the order, so kernel and plain version agree bit for
    bit."""
    a = [torch.randint(-3, 4, (m, k), generator=g, device=DEV).to(dt)
         for _ in range(TP)]
    b = [torch.randint(-3, 4, (k, n), generator=g, device=DEV).to(dt)
         for _ in range(TP)]
    return a, b


def phase_b11(torch, symm, agm, calls: int = 20):
    """B11 (the bidirectional-ring AllGather + GEMM) in the one-card world
    at B10's cases (_ag_phase): every call run by B10 too on the same
    inputs, B11's out B10's bits."""
    return _ag_phase(torch, symm, agm, True, calls)


def _same_bits(a, b) -> bool:
    """Two outputs (a tensor or a tuple of tensors) hold the same bytes."""
    if isinstance(a, (tuple, list)):
        return all(_same_bits(x, y) for x, y in zip(a, b))
    return _bitwise(a, b)


def _world_parity_calls(torch, world, fn, draw, plain, held, calls=4,
                        replays=2, same_bytes=False):
    """Both parities of a double-buffered kernel in the one-card world:
    `calls` successive eager calls on fresh inputs (draw(): each rank's
    input tuple), each rank's output held to plain(xs)[r] by held(); then
    `calls` calls on `calls` input sets captured in one graph a rank,
    replayed `replays` times over fresh inputs copied into the captured
    ones, every output the eager call's bytes on the same inputs and held
    to the plain version. same_bytes: every rank's output also the same
    bytes as rank 0's."""
    def same(outs):
        return not same_bytes or all(_same_bits(o, outs[0]) for o in outs)

    eager = []
    for _ in range(calls):
        xs = draw()
        outs = world.run(lambda r: fn(world.mesh(r), *xs[r]))
        torch.cuda.synchronize()
        eager.append(all(held(o, ref) for o, ref in zip(outs, plain(xs)))
                     and same(outs))
    sets = [draw() for _ in range(calls)]
    outs, replay = _world_graphs(torch, world, lambda r: [
        fn(world.mesh(r), *x[r]) for x in sets])
    graph = []
    for _ in range(replays):
        for x in sets:
            for r, new in enumerate(draw()):
                for dst, src in zip(x[r], new):
                    dst.copy_(src)
        replay()
        ok = True
        for i, x in enumerate(sets):
            again = world.run(lambda r: fn(world.mesh(r), *x[r]))
            torch.cuda.synchronize()
            refs = plain(x)
            ok &= all(_same_bits(outs[r][i], again[r])
                      and held(outs[r][i], refs[r]) for r in range(TP))
            ok &= same([outs[r][i] for r in range(TP)])
        graph.append(bool(ok))
    return {"eager_calls_ok": eager, "graph_replays_ok": graph}


def _rank_parity_calls(torch, fn, draw, plain, held, calls=4, replays=2):
    """_world_parity_calls on one rank of four cards (every rank runs it in
    step): draw() gives this rank's input tuple, plain(*x) its reference."""
    eager = []
    for _ in range(calls):
        x = draw()
        eager.append(bool(held(fn(*x), plain(*x))))
    sets = [draw() for _ in range(calls)]
    fn(*sets[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*x) for x in sets]
    replayed = []
    for _ in range(replays):
        for x in sets:
            for dst, src in zip(x, draw()):
                dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        ok = True
        for x, o in zip(sets, outs):
            # both sides on every rank: each may hold a collective
            again, ref = fn(*x), plain(*x)
            ok &= bool(_same_bits(o, again)) & bool(held(o, ref))
        replayed.append(bool(ok))
    return {"eager_calls_ok": eager, "graph_replays_ok": replayed}


def _parity_ok(rec) -> bool:
    return all(rec["eager_calls_ok"]) and all(rec["graph_replays_ok"])


def _tol_held(torch, tol):
    """held() within tol x max|ref|, or bit for bit at tol 0."""
    if tol == 0:
        return _same_bits
    return lambda out, ref: _held(torch, "", out, ref, tol)["ok"]


def _world_cold_ms(torch, world, fn, ws, rounds: int = 3) -> float:
    """Device ms a call of fn(r, w) in the one-card world with each rank's
    w taken in turn from ws[r] (weight_copies: out of L2 at each call),
    the calls of every rank captured in one graph a rank."""
    iters = max(20, rounds * len(ws[0]))
    _, replay = _world_graphs(torch, world, lambda r: [
        fn(r, ws[r][i % len(ws[r])]) for i in range(iters)])
    replay()
    return replay() / iters


# what B13b runs on (csrc/gemm_rs.cu)
B13B_INSTRUCTIONS = ("bf16: gemm_stream_sm90.cuh's mma.sync m16n8k16 "
                     "stream-K GEMM over every chunk's rows in one pass "
                     "(128 x 128 weight tiles by TMA, 5 stages), each "
                     "tile's f32 rows landed in their owners' slots (LL "
                     "lines up to RS_LL_MAX_SLOT_BYTES a slot, else flags), "
                     "the arcs' fold by the owner; f32: FMA")


def phase_b13b(torch, symm, grs, calls: int = 20):
    """B13b (the bidirectional-ring GEMM + ReduceScatter) against its plain
    version (gemm_rs_bidir_ref_shards: the same arcs, the same fold) in
    the one-card world at Qwen3-32B's TP=4 shapes, B=16 decode (m_loc 4,
    A (16, K_loc)): o K_loc 2048 -> N 5120 and down K_loc 6400 -> N 5120,
    bf16 and f32, random (within 1e-2 x max|ref| in bf16, 1e-4 in f32:
    the products are summed in another order) and integer-valued (bit for
    bit: every sum exact); the flags protocol forced at the decode shape;
    an odd shape (m 3, K 1000, N 136); the static serve's prefill (m_loc
    2,048, flags); `calls` successive calls with fresh inputs. Over both
    parities: 4 successive eager calls and 4 calls in one graph a rank,
    replayed over fresh inputs, at o in bf16 (random and integer-valued,
    and under flags). Timed: the four ranks' calls
    together, warm (one weight a rank, queued_ms) and cold (the calls
    rotate over weight copies larger than twice the L2), B13a beside it;
    and at the prefill shape."""
    bf, f32 = torch.bfloat16, torch.float32
    world = symm.OneCardWorld(TP)
    g = torch.Generator(device=DEV).manual_seed(67)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = [("o_m4", bf, 4, 2048, 5120), ("down_m4", bf, 4, 6400, 5120),
             ("o_m4_f32", f32, 4, 2048, 5120),
             ("o_m4_int", bf, 4, 2048, 5120),
             ("down_m4_int_f32", f32, 4, 6400, 5120),
             ("o_m4_flags", bf, 4, 2048, 5120),
             ("o_m4_int_flags", bf, 4, 2048, 5120),
             ("odd_m3", bf, 3, 1000, 136),
             ("o_m2048", bf, 2048, 2048, 5120),
             ("down_m2048", bf, 2048, 6400, 5120)]
    rows, timed = [], {}

    def run(name, m, k, n):
        if "_flags" not in name:
            return lambda mesh, a, b: grs.pallas_gemm_rs_bidir(mesh, a, b)
        plan = grs.bidir_layout(TP, m, k, n, True, sms, TP, False)
        return lambda mesh, a, b: grs._launch_bidir(mesh, a, b, plan)

    def run_check(name, fn, a, b, tol):
        outs = world.run(lambda r: fn(world.mesh(r), a[r], b[r]))
        torch.cuda.synchronize()
        refs = grs.gemm_rs_bidir_ref_shards(a, b)
        res = [_held(torch, f"{name}/rank{r}", outs[r], refs[r], tol)
               for r in range(TP)]
        if "_int" in name:
            for r, row in enumerate(res):
                row["exact"] = bool(torch.equal(outs[r], refs[r]))
                row["ok"] = row["ok"] and row["exact"]
        return res

    for name, dt, m, k, n in cases:
        draw = _int_shards if "_int" in name else _tp_shards
        a, b = draw(torch, g, dt, TP * m, k, n)
        fn = run(name, m, k, n)
        rows += run_check(name, fn, a, b, _tp_tol(torch, dt))
        if name not in ("o_m4", "down_m4", "o_m2048", "down_m2048"):
            continue
        es = a[0].element_size()
        nbytes = TP * (TP * m * k + k * n + m * n) * es
        timed[name] = _one_card_kernel_row(
            torch, world, name,
            lambda r: grs.pallas_gemm_rs_bidir(world.mesh(r), a[r], b[r]),
            lambda: grs.gemm_rs_bidir_ref_shards(a, b),
            nbytes, TP * 2.0 * TP * m * k * n)
        timed[name]["b13a_ms"] = queued_ms(torch, lambda: world.run(
            lambda r: grs.pallas_gemm_rs(world.mesh(r), a[r], b[r])))[0]
        timed[name]["max_abs_err"] = max(
            x["max_abs_err"] for x in rows if x["case"].startswith(name))
        if m == 4:
            ws = [weight_copies(torch, g, k, n, bf) for _ in range(TP)]
            timed[name]["cold_ms"] = _world_cold_ms(
                torch, world, lambda r, w: grs.pallas_gemm_rs_bidir(
                    world.mesh(r), a[r], w), ws)
            timed[name]["b13a_cold_ms"] = _world_cold_ms(
                torch, world, lambda r, w: grs.pallas_gemm_rs(
                    world.mesh(r), a[r], w), ws)
            del ws
        del a, b
        torch.cuda.empty_cache()
    seq_ok = []
    for _ in range(calls):
        a, b = _tp_shards(torch, g, bf, TP * 4, 2048, 5120)
        seq_ok.append(all(x["ok"] for x in run_check(
            "seq", run("o_m4", 4, 2048, 5120), a, b, 1e-2)))
    parity = {}
    for name, draw, tol in (("o_m4", _tp_shards, 1e-2),
                            ("o_m4_int", _int_shards, 0),
                            ("o_m4_flags", _tp_shards, 1e-2)):
        def draw_xs(draw=draw):
            a, b = draw(torch, g, bf, TP * 4, 2048, 5120)
            return [(a[r], b[r]) for r in range(TP)]
        parity[name] = _world_parity_calls(
            torch, world, run(name, 4, 2048, 5120), draw_xs,
            lambda xs: grs.gemm_rs_bidir_ref_shards(
                [x[0] for x in xs], [x[1] for x in xs]),
            _tol_held(torch, tol))
    emit({"phase": "b13b_gemm_rs_bidir",
          "world": "one card, 4 logical ranks", "cases": rows,
          "successive_calls_ok": seq_ok, "parity_calls": parity,
          "timed": timed, "instructions": B13B_INSTRUCTIONS})
    if not all(x["ok"] for x in rows) or not all(seq_ok) or \
            not all(_parity_ok(v) for v in parity.values()):
        fail(f"B13b disagrees with its plain version: "
             f"{[x for x in rows if not x['ok']]}; successive {seq_ok}; "
             f"parity {parity}")
    rec = _tp_kernel_record(
        "pallas_gemm_rs_bidir", "gemm_rs.cu",
        "triton_dist_tpu/kernels/gemm_reduce_scatter.py:432",
        {k: timed[k] for k in ("o_m4", "down_m4")},
        "one card, 4 logical ranks")
    rec["prefill_shape"] = {k: timed[k] for k in ("o_m2048", "down_m2048")}
    return rec


# -- expert parallelism in the one-card world: B17, B18, B16 -----------------

# Qwen3-30B-A3B at EP=4: hidden, experts a rank, gate/up width, experts,
# top-k
EP_DIMS = (2048, 128 // TP, 2 * 768, 128, 8)
# the dispatch slots a (src, dst) pair holds: a decode step's 4 tokens a
# rank x top-8, and a 512-token prefill chunk's
_EP_SLOTS = (("decode_m32", 4), ("prefill_m4096", 512))
_EP_ONE_CARD_LIB = ("none on one card: NCCL needs a process per card "
                    "(tp4_ep times NCCL all_to_all_single)")


def _slot_rows(name, outs, refs):
    """One case per rank: the kernel's slots bitwise the plain version's."""
    rows = []
    for r, (o, ref) in enumerate(zip(outs, refs)):
        rows.append({"case": f"{name}/rank{r}",
                     "max_abs_err": (o.float() - ref.float()).abs().max()
                     .item(), "ok": bool(_bitwise(o, ref))})
    return rows


def _bitwise(a, b) -> bool:
    import torch
    if a.element_size() == 1:
        return torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    return torch.equal(a, b)


def _a2a_protocols(torch, world, ll, plain, draw, row_bytes, scale_bytes):
    """B17 (scale_bytes 0) or B18 at _EP_SLOTS' shapes in the one-card
    world: both parities, eagerly and graph-replayed (draw(mm): each
    rank's input tuple), bitwise the plain exchange; then each shape under
    the protocol its plan does not pick (forced through ``a2a_layout``),
    bitwise too."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def fn(mesh, x, s=None):
        return ll.fast_all_to_all_per_device(mesh, x) if s is None else \
            ll.fast_all_to_all_q_per_device(mesh, x, s)

    def ref(xs):
        outs = [plain.all_to_all_slots_shards([x[i] for x in xs])
                for i in range(len(xs[0]))]
        return [tuple(o[r] for o in outs) if len(outs) > 1 else outs[0][r]
                for r in range(TP)]

    parity, forced = {}, []
    for shp, m_loc in _EP_SLOTS:
        mm = m_loc * EP_DIMS[4]
        parity[shp] = _world_parity_calls(
            torch, world, fn, lambda mm=mm: draw(mm), ref, _same_bits)
        xs = draw(mm)
        rows1 = xs[0][1].shape[1] if scale_bytes else 0
        pick = ll.a2a_plan(TP, mm, row_bytes, rows1, scale_bytes, sms, TP)
        plan = ll.a2a_layout(TP, mm, row_bytes, rows1, scale_bytes,
                             pick.grid, not pick.ll)
        outs = world.run(lambda r: ll._launch(
            world.mesh(r), xs[r][0], xs[r][1] if rows1 else None, plan))
        torch.cuda.synchronize()
        want = ref(xs)
        for r in range(TP):
            got = outs[r] if rows1 else outs[r][0]
            forced.append({"case": f"{shp}_{'ll' if plan.ll else 'flags'}"
                                   f"/rank{r}", "grid": plan.grid,
                           "ok": _same_bits(got, want[r])})
        del xs, outs, want
        torch.cuda.empty_cache()
    return parity, forced


def phase_b17(torch, symm, kern, ll, plain, calls: int = 5):
    """B17 (the low-latency all-to-all of padded slots) against its plain
    version (slot r of every rank, stacked) in the one-card world, at
    Qwen3-30B-A3B's EP=4 dispatch slots (4, max_m, 2048): decode (max_m
    32: 4 tokens a rank x top-8) in bf16 and f32, a 512-token chunk
    (max_m 4,096) in bf16; every rank's slots the plain version's bytes,
    then `calls` successive calls with fresh slots. Timed: the four ranks'
    calls together (queued_ms) against the plain version; the bound reads
    and writes every rank's slots once at HBM speed. Then the mesh-level
    ``fast_all_to_all`` on every rank at the decode shape, counted."""
    world = symm.OneCardWorld(TP)
    g = torch.Generator(device=DEV).manual_seed(81)
    d = EP_DIMS[0]

    def draw(dt, mm):
        return [torch.randn((TP, mm, d), generator=g, device=DEV).to(dt)
                for _ in range(TP)]

    def run_check(name, xs):
        outs = world.run(lambda r: ll.fast_all_to_all_per_device(
            world.mesh(r), xs[r]))
        torch.cuda.synchronize()
        return _slot_rows(name, outs, plain.all_to_all_slots_shards(xs))

    rows, timed, seq_ok = [], {}, []
    for shp, m_loc in _EP_SLOTS:
        mm = m_loc * EP_DIMS[4]
        for dt in ((torch.bfloat16, torch.float32) if m_loc == 4
                   else (torch.bfloat16,)):
            name = shp if dt == torch.bfloat16 else f"{shp}_f32"
            xs = draw(dt, mm)
            rows += run_check(name, xs)
            if dt != torch.bfloat16:
                continue
            nbytes = TP * 2 * TP * mm * d * xs[0].element_size()
            timed[name] = _one_card_kernel_row(
                torch, world, name,
                lambda r: ll.fast_all_to_all_per_device(world.mesh(r), xs[r]),
                lambda: plain.all_to_all_slots_shards(xs), nbytes, 0.0)
            timed[name]["max_abs_err"] = max(
                x["max_abs_err"] for x in rows if x["case"].startswith(name))
        seq_ok += [all(x["ok"] for x in run_check(
            f"seq_{shp}", draw(torch.bfloat16, mm))) for _ in range(calls)]
    parity, forced = _a2a_protocols(
        torch, world, ll, plain, lambda mm: [(x,) for x in draw(
            torch.bfloat16, mm)], 2 * d, 0)
    xs = draw(torch.bfloat16, 32)
    kern.reset_launch_counts()
    outs = world.run(lambda r: ll.fast_all_to_all(world.mesh(r), "tp",
                                                  xs[r]))
    torch.cuda.synchronize()
    path = kern.launch_counts()
    op_ok = all(_bitwise(o, ref) for o, ref in zip(
        outs, plain.all_to_all_slots_shards(xs))) and \
        path == _only(path, fast_all_to_all_per_device=TP)
    emit({"phase": "b17_ll_a2a", "world": "one card, 4 logical ranks",
          "cases": rows, "successive_calls_ok": seq_ok, "timed": timed,
          "parity_calls": parity, "other_protocol": forced,
          "fast_all_to_all": {"launches": path, "ok": op_ok}})
    if not all(x["ok"] for x in rows + forced) or not all(seq_ok) or \
            not op_ok or not all(_parity_ok(v) for v in parity.values()):
        fail(f"B17 disagrees with its plain version: "
             f"{[x for x in rows + forced if not x['ok']]}; successive "
             f"{seq_ok}; parity {parity}; fast_all_to_all {path}")
    rec = _tp_kernel_record(
        "fast_all_to_all_per_device", "ep_a2a.cu",
        "triton_dist_tpu/kernels/low_latency_all_to_all.py:38",
        {"decode_m32": timed["decode_m32"]}, "one card, 4 logical ranks")
    rec["prefill_shape"] = timed["prefill_m4096"]
    rec["library_ms_call"] = _EP_ONE_CARD_LIB
    rec["launches_by_path"] = {"fast_all_to_all_one_card": path[
        "fast_all_to_all_per_device"]}
    rec["launches"] = path["fast_all_to_all_per_device"]
    return rec


def phase_b18(torch, symm, kern, ll, plain, calls: int = 5):
    """B18 (B17 over the fp8 rows and their packed f32 scales in one
    launch) against its plain version (each payload's slot r of every
    rank, stacked) in the one-card world, at the B17 shapes: the rows of
    random bf16 slots quantized per row to fp8 e4m3 (quantize_rows, as the
    dispatch does), the scales packed (n, ceil(max_m / 128), 128); both
    payloads bitwise, `calls` successive calls with fresh slots. Timed as
    B17. Then the mesh-level ``fast_all_to_all_quantized`` on every rank
    at the decode shape, counted, its rows the plain exchange's
    dequantized."""
    world = symm.OneCardWorld(TP)
    g = torch.Generator(device=DEV).manual_seed(83)
    d, f8 = EP_DIMS[0], torch.float8_e4m3fn

    def draw(mm):
        qs, ss = [], []
        for _ in range(TP):
            q, s = ll.quantize_rows(torch.randn(
                (TP, mm, d), generator=g, device=DEV).to(torch.bfloat16), f8)
            qs.append(q)
            ss.append(ll.pack_scales(s))
        return qs, ss

    def run_check(name, qs, ss):
        outs = world.run(lambda r: ll.fast_all_to_all_q_per_device(
            world.mesh(r), qs[r], ss[r]))
        torch.cuda.synchronize()
        return (_slot_rows(f"{name}/rows", [o[0] for o in outs],
                           plain.all_to_all_slots_shards(qs))
                + _slot_rows(f"{name}/scales", [o[1] for o in outs],
                             plain.all_to_all_slots_shards(ss)))

    rows, timed, seq_ok = [], {}, []
    for shp, m_loc in _EP_SLOTS:
        mm = m_loc * EP_DIMS[4]
        qs, ss = draw(mm)
        rows += run_check(shp, qs, ss)
        nbytes = TP * 2 * TP * (mm * d + ss[0][0].numel() * 4)
        timed[shp] = _one_card_kernel_row(
            torch, world, shp,
            lambda r: ll.fast_all_to_all_q_per_device(world.mesh(r), qs[r],
                                                      ss[r]),
            lambda: (plain.all_to_all_slots_shards(qs),
                     plain.all_to_all_slots_shards(ss)), nbytes, 0.0)
        timed[shp]["max_abs_err"] = max(
            x["max_abs_err"] for x in rows if x["case"].startswith(shp))
        seq_ok += [all(x["ok"] for x in run_check(f"seq_{shp}", *draw(mm)))
                   for _ in range(calls)]
    parity, forced = _a2a_protocols(
        torch, world, ll, plain, lambda mm: list(zip(*draw(mm))), d,
        4 * ll._LANE)
    xs = [torch.randn((TP, 32, d), generator=g, device=DEV).to(
        torch.bfloat16) for _ in range(TP)]
    # the reference first: it also loads the dequantize kernels, which the
    # op launches behind its spinning B18 (a lazy load there would wait
    # for the ranks not yet launched)
    qd = [ll.quantize_rows(x, f8) for x in xs]
    rq = plain.all_to_all_slots_shards([q for q, _ in qd])
    rs = plain.all_to_all_slots_shards([s for _, s in qd])
    want = [ll.dequantize_rows(q, s, torch.bfloat16) for q, s in zip(rq, rs)]
    torch.cuda.synchronize()
    kern.reset_launch_counts()
    outs = world.run(lambda r: ll.fast_all_to_all_quantized(
        world.mesh(r), "tp", xs[r]))
    torch.cuda.synchronize()
    path = kern.launch_counts()
    op_ok = all(torch.equal(o, w) for o, w in zip(outs, want)) and \
        path == _only(path, fast_all_to_all_q_per_device=TP)
    emit({"phase": "b18_ll_a2a_q", "world": "one card, 4 logical ranks",
          "cases": rows, "successive_calls_ok": seq_ok, "timed": timed,
          "parity_calls": parity, "other_protocol": forced,
          "fast_all_to_all_quantized": {"launches": path, "ok": op_ok}})
    if not all(x["ok"] for x in rows + forced) or not all(seq_ok) or \
            not op_ok or not all(_parity_ok(v) for v in parity.values()):
        fail(f"B18 disagrees with its plain version: "
             f"{[x for x in rows + forced if not x['ok']]}; successive "
             f"{seq_ok}; parity {parity}; fast_all_to_all_quantized {path}")
    rec = _tp_kernel_record(
        "fast_all_to_all_q_per_device", "ep_a2a.cu",
        "triton_dist_tpu/kernels/low_latency_all_to_all.py:96",
        {"decode_m32": timed["decode_m32"]}, "one card, 4 logical ranks")
    rec["prefill_shape"] = timed["prefill_m4096"]
    rec["library_ms_call"] = _EP_ONE_CARD_LIB
    rec["launches_by_path"] = {"fast_all_to_all_quantized_one_card": path[
        "fast_all_to_all_q_per_device"]}
    rec["launches"] = path["fast_all_to_all_q_per_device"]
    return rec


def _ep_case(torch, ep, mu, plain, meshes, g, m_loc, dt, ws, integer=False):
    """One EP=4 routing: every rank's m_loc tokens through one random
    router of Qwen3-30B-A3B's widths, packed into its send slots
    (``dispatch_layout`` and the dispatch's packing), the splits (ids,
    counts) exchanged by the plain all-to-all. integer: tokens drawn in
    [-3, 3] (every product and sum of the f32 case exact)."""
    d, _, _, e, topk = EP_DIMS
    x, ids, _ = _moe_routing(torch, mu, plain, g, TP * m_loc, d, e, topk)
    if integer:
        x = torch.randint(-3, 4, x.shape, generator=g, device=DEV)
    x = x.to(dt)
    max_m = m_loc * topk
    sends, sids, sent = [], [], []
    for r in range(TP):
        ctx = ep.EpA2AContext(meshes[r], "tp", e, topk, max_m)
        lay = ep.dispatch_layout(ids[r * m_loc:(r + 1) * m_loc], TP,
                                 e // TP)
        sx, si = ep._pack(ctx, x[r * m_loc:(r + 1) * m_loc],
                          ids[r * m_loc:(r + 1) * m_loc], lay)
        sends.append(sx.contiguous())
        sids.append(si)
        sent.append(torch.clamp(lay.send_counts, max=max_m))
    rids = plain.all_to_all_slots_shards(sids)
    rcounts = plain.all_to_all_slots_shards(sent)
    recv = plain.all_to_all_slots_shards(sends)
    live = []
    for r in range(TP):
        mask = (torch.arange(max_m, device=DEV)[None, :]
                < rcounts[r][:, None]).reshape(-1)
        live.append(int(torch.unique(rids[r].reshape(-1)[mask]).numel()))
    return {"sends": sends, "rids": rids, "rcounts": rcounts, "recv": recv,
            "max_m": max_m, "m_loc": m_loc, "w": ws, "live": live,
            "rows_live": [int(c.sum()) for c in rcounts]}


def phase_b16(torch, symm, ep, mu, plain, calls: int = 3):
    """B16 (the EP dispatch fused with the gate/up grouped GEMM) against
    its plain version (the slots exchanged, then each live slot's row
    times its expert's weight, pads 0) in the one-card world, at
    Qwen3-30B-A3B's EP=4 shapes: each rank's 32 experts' random gate/up
    slabs (32, 2048, 1536), a decode routing from a random router (4
    tokens a rank, max_m 32) in bf16, f32 and integer-valued f32, and a
    512-token chunk (max_m 4,096) in bf16, comm_blocks 4. The received
    rows bitwise; inter within 1e-2 x max|ref| in bf16 (one rounding,
    another f32 summation order), 1e-4 in f32, exactly on integer-valued
    f32; `calls` repeats the same bits. Timed at both bf16 shapes: the
    four ranks' launches together (queued_ms, on plans built beforehand:
    the serve's captured step replays the schedule building) against the
    plain version and four torch._grouped_mm over the live received rows
    (the yardstick); the bound reads each rank's live experts' slabs
    once."""
    world = symm.OneCardWorld(TP)
    meshes = [world.mesh(r) for r in range(TP)]
    d, e_loc, ni, _, _ = EP_DIMS
    g = torch.Generator(device=DEV).manual_seed(87)
    w_bf = [_randn_bf16(torch, g, (e_loc, d, ni), d ** -0.5)
            for _ in range(TP)]
    rows, timed = [], {}

    def run(c):
        return world.run(lambda r: ep.pallas_dispatch_gg(
            meshes[r], c["sends"][r], c["rids"][r], c["rcounts"][r],
            c["w"][r], comm_blocks=4))

    def plain_fn(c):
        return [plain.slot_expert_product(c["recv"][r], c["rids"][r],
                                          c["rcounts"][r], c["w"][r])
                for r in range(TP)]

    cases = [("decode_m32", 4, torch.bfloat16, False),
             ("decode_m32_f32", 4, torch.float32, False),
             ("decode_m32_int", 4, torch.float32, True),
             ("prefill_m4096", 512, torch.bfloat16, False)]
    for name, m_loc, dt, integer in cases:
        if dt == torch.bfloat16:
            ws = w_bf
        elif integer:
            ws = [torch.randint(-2, 3, (e_loc, d, ni), generator=g,
                                device=DEV).float() for _ in range(TP)]
        else:
            ws = [w.float() for w in w_bf]
        c = _ep_case(torch, ep, mu, plain, meshes, g, m_loc, dt, ws,
                     integer)
        outs = run(c)
        torch.cuda.synchronize()
        ref = plain_fn(c)
        tol = 0.0 if integer else _tp_tol(torch, dt)
        for r in range(TP):
            row = _held(torch, f"{name}/rank{r}", outs[r][1], ref[r], tol)
            if integer:
                row["ok"] = bool(torch.equal(outs[r][1], ref[r]))
            row["recv_bitwise"] = bool(torch.equal(
                outs[r][0], c["recv"][r].reshape(outs[r][0].shape)))
            row["ok"] = row["ok"] and row["recv_bitwise"]
            rows.append(row)
        same = []
        for _ in range(calls):
            again = run(c)
            torch.cuda.synchronize()
            same.append(all(torch.equal(a[1], o[1]) and torch.equal(a[0], o[0])
                            for a, o in zip(again, outs)))
        rows[-1]["repeats_bitwise"] = same
        rows[-1]["ok"] = rows[-1]["ok"] and all(same)
        if dt != torch.bfloat16:
            continue
        es = 2
        hbm = sum(c["live"][r] * d * ni + c["rows_live"][r] * (d + ni)
                  for r in range(TP)) * es
        flops = sum(2.0 * c["rows_live"][r] * d * ni for r in range(TP))
        lib_fns = []
        for r in range(TP):
            flat_ids = c["rids"][r].reshape(-1)
            mask = (torch.arange(c["max_m"], device=DEV)[None, :]
                    < c["rcounts"][r][:, None]).reshape(-1)
            sel = torch.nonzero(mask)[:, 0]
            lib_fns.append(_grouped_mm_fn(
                torch, mu, c["recv"][r].reshape(-1, d)[sel],
                flat_ids[sel][:, None], c["w"][r], e_loc))
        # timed on plans built beforehand: the kernel, not the host's
        # schedule building (which the serve's captured step replays)
        plans = [ep.dispatch_gg_plan(c["rids"][r], c["rcounts"][r], e_loc,
                                     comm_blocks=4) for r in range(TP)]
        timed[name] = _one_card_kernel_row(
            torch, world, name,
            lambda r: ep.launch_dispatch_gg(meshes[r], c["sends"][r],
                                            plans[r], c["w"][r]),
            lambda: plain_fn(c), hbm, flops)
        timed[name]["plain_ms"] = time_ms(lambda: plain_fn(c), iters=3,
                                          warmup=1)
        if all(f is not None for f, _ in lib_fns):
            timed[name]["library_ms"] = graph_time_ms(
                lambda: [f() for f, _ in lib_fns])
        timed[name].update(
            library_how=lib_fns[0][1], live_experts=c["live"],
            live_rows=c["rows_live"], max_m=c["max_m"],
            max_abs_err=max(x["max_abs_err"] for x in rows
                            if x["case"].startswith(name)))
    emit({"phase": "b16_ep_dispatch_gg", "world": "one card, 4 logical ranks",
          "cases": rows, "timed": timed})
    bad = [x for x in rows if not x["ok"]]
    if bad:
        fail(f"B16 disagrees with its plain version or its repeats: {bad}")
    rec = _tp_kernel_record("pallas_dispatch_gg", "ep_a2a.cu",
                            "triton_dist_tpu/kernels/ep_a2a.py:272",
                            {"decode_m32": timed["decode_m32"]},
                            "one card, 4 logical ranks")
    rec["prefill_shape"] = timed["prefill_m4096"]
    rec["library_ms_call"] = ("4 x torch._grouped_mm over the live "
                              "received rows (no exchange: one card)")
    return rec


MOE_TP_DIMS = (2048, 128, 768 // 4, 8)   # d, experts, I/n, top-k at TP=4


def _moe_tp_case(torch, mu, plain, g, m_loc, dt, w_gu, w_dn):
    """One decode routing of Qwen3-30B-A3B at TP=4 (m_loc tokens per rank,
    a random router): every rank's token shard, the whole routing and its
    n-chunk schedule, every rank's B15 input rows (random, the silu * up
    rows of B14's output), each rank's weight shards in ``dt``."""
    d, e, il, topk = MOE_TP_DIMS
    x, ids, w = _moe_routing(torch, mu, plain, g, TP * m_loc, d, e, topk)
    bm = min(128, max(8, m_loc * topk))
    sched = mu.aligned_chunk_schedule(ids, TP, e, bm)
    inter = [torch.randn((TP * m_loc * topk, il), generator=g,
                         device=DEV).to(dt) for _ in range(TP)]
    return {"tok": [t.to(dt) for t in x.chunk(TP)], "ids": ids, "w": w,
            "sched": sched, "inter": inter, "bm": bm, "m_loc": m_loc,
            "w_gu": [t.to(dt) for t in w_gu], "w_dn": [t.to(dt) for t in w_dn],
            "live": int(torch.unique(ids).numel())}


def _moe_tp_bytes(c, kind):
    """(HBM bytes of one rank's call, NVLink bytes it sends, FLOPs) of B14
    ("b14") or B15 ("b15") on case c: the live experts' weight slabs read
    once, the rows in and out once."""
    d, _, il, topk = MOE_TP_DIMS
    es = c["tok"][0].element_size()
    m, rows = c["m_loc"], TP * c["m_loc"] * topk
    if kind == "b14":
        return ((c["live"] * d * 2 * il + m * d + TP * m * d
                 + rows * 2 * il) * es, (TP - 1) * m * d * es,
                2.0 * rows * d * 2 * il)
    return ((c["live"] * il * d + rows * il + m * d) * es + rows * 8,
            (TP - 1) * m * d * 4, 2.0 * rows * il * d + 2.0 * rows * d)


def phase_b14_b15_tp(torch, symm, agg, mrs, mu, plain, calls: int = 5):
    """B14 and B15 across ranks in the one-card world (four logical ranks
    of one card, each its stream and symmetric buffers) at Qwen3-30B-A3B's
    TP=4 shapes: d 2048, 128 experts, I/4 = 192, top-8, each rank's one
    layer of random expert shards (gate/up (128, 2048, 384), down (128,
    192, 2048)), decode routing from a random router at 4 and 16 tokens
    per rank (B=16 and 64), bf16 and f32. B14's output against its plain
    version (the shards concatenated, the world-1 plain version per chunk:
    cuBLAS) and B15's against its plain version (each rank's chunk
    partials, the fold in ascending sender) within 1e-2 x max|ref| in bf16
    and 1e-4 in f32 (the world-1 tolerances: one rounding of the output,
    another f32 summation order); B14's gathered tokens exact and its rows
    BITWISE the world-1 kernel's on each chunk; then `calls` layer-shaped
    calls (B14 then B15 on every rank) whose outputs must repeat the
    first's bits. Timed at 4 tokens per rank in bf16: the four ranks'
    calls together (queued_ms) against the plain versions (eager: they
    read used_tiles on the host) and the library yardstick, one
    torch._grouped_mm per rank over the gathered, expert-sorted rows (B15:
    then torch.stack(...).sum(0)); the bound counts the four ranks' HBM
    bytes (each rank's live experts' slabs once) at HBM speed."""
    world = symm.OneCardWorld(TP)
    d, e, il, topk = MOE_TP_DIMS
    g = torch.Generator(device=DEV).manual_seed(61)
    w_gu = [_randn_bf16(torch, g, (e, d, 2 * il), d ** -0.5)
            for _ in range(TP)]
    w_dn = [_randn_bf16(torch, g, (e, il, d), il ** -0.5)
            for _ in range(TP)]
    rows14, rows15, timed = [], [], {"b14": {}, "b15": {}}

    def b14(c):
        return world.run(lambda r: agg.pallas_ag_group_gemm(
            world.mesh(r), c["tok"][r], c["w_gu"][r], c["sched"], topk, 4))

    def b15(c):
        return world.run(lambda r: mrs.pallas_moe_reduce_rs(
            world.mesh(r), c["inter"][r], c["w_dn"][r], c["ids"], c["w"],
            c["sched"]))

    def plain14(c):
        ag = torch.cat(c["tok"])
        return [agg.ag_group_gemm_ref_chunks(ag, c["w_gu"][r], c["sched"],
                                             topk) for r in range(TP)]

    def plain15(c):
        return mrs.moe_reduce_rs_ref_shards(c["inter"], c["w_dn"], c["ids"],
                                            c["w"], c["sched"])

    for m_loc in (4, 16):
        for dt in (torch.bfloat16, torch.float32):
            tag = f"m{m_loc}_{str(dt).split('.')[-1]}"
            tol = _tp_tol(torch, dt)
            c = _moe_tp_case(torch, mu, plain, g, m_loc, dt, w_gu, w_dn)
            out14, out15 = b14(c), b15(c)
            torch.cuda.synchronize()
            ref14, ref15 = plain14(c), plain15(c)
            ag = torch.cat(c["tok"])
            nf = m_loc * topk
            for r in range(TP):
                row = _held(torch, f"{tag}/rank{r}", out14[r][0], ref14[r],
                            tol)
                row["gathered_exact"] = bool(torch.equal(out14[r][1], ag))
                w1 = torch.cat([agg.group_gemm(
                    c["tok"][ch], c["w_gu"][r], agg.chunk_of(c["sched"], ch),
                    topk) for ch in range(TP)])
                row["world1_kernel_bitwise"] = bool(torch.equal(
                    out14[r][0], w1))
                row["ok"] = (row["ok"] and row["gathered_exact"]
                             and row["world1_kernel_bitwise"])
                rows14.append(row)
                rows15.append(_held(torch, f"{tag}/rank{r}", out15[r],
                                    ref15[r], tol))
            # layer-shaped repeats: B14 then B15 on every rank, the same bits
            same = []
            for _ in range(calls):
                again = world.run(lambda r: (
                    agg.pallas_ag_group_gemm(world.mesh(r), c["tok"][r],
                                             c["w_gu"][r], c["sched"], topk,
                                             4)[0],
                    mrs.pallas_moe_reduce_rs(world.mesh(r), c["inter"][r],
                                             c["w_dn"][r], c["ids"], c["w"],
                                             c["sched"])))
                torch.cuda.synchronize()
                same.append(all(torch.equal(again[r][0], out14[r][0])
                                and torch.equal(again[r][1], out15[r])
                                for r in range(TP)))
            rows14[-1]["repeats_bitwise"] = rows15[-1]["repeats_bitwise"] = \
                same
            rows14[-1]["ok"] = rows14[-1]["ok"] and all(same)
            rows15[-1]["ok"] = rows15[-1]["ok"] and all(same)
            if m_loc != 4 or dt != torch.bfloat16:
                continue
            for key, run, ref, lib_parts in (
                    ("b14", lambda: b14(c), lambda: plain14(c),
                     [_grouped_mm_fn(torch, mu, ag[torch.arange(
                         TP * nf, device=DEV) // topk], c["ids"],
                         c["w_gu"][r], e) for r in range(TP)]),
                    ("b15", lambda: b15(c), lambda: plain15(c),
                     [_grouped_mm_fn(torch, mu, c["inter"][r], c["ids"],
                                     c["w_dn"][r], e) for r in range(TP)])):
                hbm, _, flops = _moe_tp_bytes(c, key)
                bms, by = bound_ms(TP * hbm, TP * flops)
                ms, host_s, ahead = queued_ms(torch, run)
                lib_fns = [f for f, _ in lib_parts]
                lib_ms = None
                if all(f is not None for f in lib_fns):
                    if key == "b14":
                        lib_ms = graph_time_ms(lambda: [f() for f in lib_fns])
                    else:
                        lib_ms = graph_time_ms(lambda: torch.stack(
                            [f() for f in lib_fns]).sum(0))
                # the world-1 kernel on one chunk, four times (a rank's
                # share of the work), for scale
                s1 = mu.aligned_chunk_schedule(c["ids"][:m_loc], 1, e,
                                               c["bm"])
                w1_ms = graph_time_ms(lambda: [
                    agg.group_gemm(c["tok"][0], c["w_gu"][0],
                                   agg.chunk_of(c["sched"], 0), topk)
                    if key == "b14" else mrs.moe_rs(
                        c["inter"][0][:nf], c["w_dn"][0], c["ids"][:m_loc],
                        c["w"][:m_loc], s1)
                    for _ in range(TP)])
                timed[key]["decode_m4"] = {
                    "world1_kernel_4_chunks_ms": w1_ms,
                    "ms": ms, "plain_ms": time_ms(ref, iters=3, warmup=1),
                    "library_ms": lib_ms, "library_how": lib_parts[0][1],
                    "bound_ms": bms, "bound_by": by, "bytes": TP * hbm,
                    "live_experts": c["live"], "bm": c["bm"],
                    "tiles": int(c["sched"].tile_expert.shape[1]),
                    "live_tiles": c["sched"].used_tiles.tolist(),
                    "host_enqueue_s": host_s, "queued_ahead": ahead,
                    "max_abs_err": max(x["max_abs_err"] for x in (
                        rows14 if key == "b14" else rows15)
                        if x["case"].startswith(tag))}
    emit({"phase": "b14_b15_tp", "world": "one card, 4 logical ranks",
          "b14_cases": rows14, "b15_cases": rows15, "timed": timed})
    bad = [x for x in rows14 + rows15 if not x["ok"]]
    if bad:
        fail(f"B14/B15 across ranks disagree with their plain versions, "
             f"the world-1 kernel or their own repeats: {bad}")
    recs = []
    for key, name, rep, call in (
            ("b14", "pallas_ag_group_gemm",
             "triton_dist_tpu/kernels/allgather_group_gemm.py:146",
             "4 x torch._grouped_mm over the gathered expert-sorted rows"),
            ("b15", "pallas_moe_reduce_rs",
             "triton_dist_tpu/kernels/moe_reduce_rs.py:130",
             "4 x torch._grouped_mm over the expert-sorted rows, "
             "torch.stack(...).sum(0)")):
        rec = _tp_kernel_record(name, "moe_group_gemm.cu", rep, timed[key],
                                "one card, 4 logical ranks")
        rec["library_ms_call"] = call
        recs.append(rec)
    return recs


def _tp_kernel_record(name, source, replaces, timed, world):
    """A kernels-line row: the mean over the decode shapes (one of each per
    layer on the main path). ``launches`` stays None unless the TP=4 serve
    ran and counted them."""
    mean = {key: sum(t[key] for t in timed.values()) / len(timed)
            for key in ("ms", "plain_ms", "bound_ms")}
    libs = [t["library_ms"] for t in timed.values()]
    by = max(timed.values(), key=lambda t: t["bound_ms"])["bound_by"]
    return {"name": name, "route": "cuda",
            "source": f"triton_dist_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "max_abs_err": max(t["max_abs_err"] for t in timed.values()),
            **mean, "bound_by": by,
            "library_ms": (sum(libs) / len(libs)
                           if all(x is not None for x in libs) else None),
            "launches": None, "measured_on": world, "shapes": timed}


# -- across ranks: four cards (rank processes) -------------------------------

_TP_SHAPES = (("qkv_m4", "ag", 4, 5120, 2560),
              ("gate_up_m4", "ag", 4, 5120, 12800),
              ("o_m4", "rs", 4, 2048, 5120),
              ("down_m4", "rs", 4, 6400, 5120),
              ("o_m16", "ar", 16, 2048, 5120),
              ("down_m16", "ar", 16, 6400, 5120),
              ("x_m16_one_shot", "one_shot", 16, 5120, 0),
              ("x_m16_rhd", "rhd", 16, 5120, 0),
              ("x_m512_rhd", "rhd", 512, 5120, 0),
              ("rs_m16", "ring_rs", 16, 5120, 0),
              ("rs_m512", "ring_rs", 512, 5120, 0),
              ("ag_m16", "ring_ag", 16, 5120, 0),
              ("ag_m512", "ring_ag", 512, 5120, 0),
              ("fm_m16", "full_mesh", 16, 5120, 0),
              ("fm_m512", "full_mesh", 512, 5120, 0),
              ("qkv_m4_bidir", "ag_bidir", 4, 5120, 2560),
              ("gate_up_m4_bidir", "ag_bidir", 4, 5120, 12800),
              ("qkv_m2048", "ag", 2048, 5120, 2560),
              ("qkv_m2048_bidir", "ag_bidir", 2048, 5120, 2560),
              ("gate_up_m2048", "ag", 2048, 5120, 12800),
              ("gate_up_m2048_bidir", "ag_bidir", 2048, 5120, 12800),
              ("o_m4_bidir", "rs_bidir", 4, 2048, 5120),
              ("down_m4_bidir", "rs_bidir", 4, 6400, 5120),
              ("o_m2048_bidir", "rs_bidir", 2048, 2048, 5120),
              ("down_m2048_bidir", "rs_bidir", 2048, 6400, 5120))
# kernels-line rows of the four-card timings: (wrapper, its shapes,
# source, the TPU kernel it replaces, the library call timed beside it)
_TP_ROWS = (
    ("pallas_ag_gemm", ("qkv_m4", "gate_up_m4"), "ag_gemm.cu",
     "triton_dist_tpu/kernels/allgather_gemm.py:293",
     "torch.distributed._symmetric_memory._fused_all_gather_matmul"),
    ("pallas_gemm_rs", ("o_m4", "down_m4"), "gemm_rs.cu",
     "triton_dist_tpu/kernels/gemm_reduce_scatter.py:321",
     "torch.distributed._symmetric_memory._fused_matmul_reduce_scatter"),
    ("pallas_gemm_ar", ("o_m16", "down_m16"), "gemm_ar.cu",
     "triton_dist_tpu/kernels/gemm_allreduce.py:101",
     "torch.mm + torch.distributed.all_reduce (NCCL)"),
    ("one_shot_all_reduce", ("x_m16_one_shot",), "allreduce.cu",
     "triton_dist_tpu/kernels/allreduce.py:99",
     "torch.distributed.all_reduce (NCCL)"),
    ("rhd_all_reduce", ("x_m16_rhd", "x_m512_rhd"), "allreduce.cu",
     "triton_dist_tpu/kernels/allreduce.py:170",
     "torch.distributed.all_reduce (NCCL)"),
    ("ring_reduce_scatter", ("rs_m16", "rs_m512"), "ring_collectives.cu",
     "triton_dist_tpu/kernels/reduce_scatter.py:38",
     "torch.distributed.reduce_scatter_tensor (NCCL)"),
    ("ring_all_gather", ("ag_m16", "ag_m512"), "ring_collectives.cu",
     "triton_dist_tpu/kernels/allgather.py:59",
     "torch.distributed.all_gather_into_tensor (NCCL)"),
    ("full_mesh_all_gather", ("fm_m16", "fm_m512"), "ring_collectives.cu",
     "triton_dist_tpu/kernels/allgather.py:114",
     "torch.distributed.all_gather_into_tensor (NCCL)"),
    ("pallas_ag_gemm_bidir", ("qkv_m4_bidir", "gate_up_m4_bidir"),
     "ag_gemm.cu", "triton_dist_tpu/kernels/allgather_gemm.py:498",
     "torch.distributed._symmetric_memory._fused_all_gather_matmul"),
    ("pallas_gemm_rs_bidir", ("o_m4_bidir", "down_m4_bidir"), "gemm_rs.cu",
     "triton_dist_tpu/kernels/gemm_reduce_scatter.py:432",
     "torch.distributed._symmetric_memory._fused_matmul_reduce_scatter"))


def _tp_case(torch, mesh, kind, m, k, n, seed):
    """This rank's bf16 inputs of one decode shape and the calls of the
    same function: the kernel, its plain version, the library yardstick
    (torch's fused symmetric-memory ops for B10 / B13a / B11 / B13b, NCCL
    for B4 / B5 / B6 / B9 / B7 / B8) and a second yardstick or None (NCCL
    + torch.mm for B11 / B13b; B7 for B8; B10 for B11, whose out must be
    its bits). Every rank draws its own inputs."""
    import torch.distributed as dist
    from torch.distributed import _symmetric_memory as symm_mem
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import allreduce as arm
    from triton_dist_tpu_torch.kernels import gemm_allreduce as ga
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    from triton_dist_tpu_torch.kernels import allgather as ring_ag
    from triton_dist_tpu_torch.kernels import reduce_scatter as ring_rs
    g = torch.Generator(device=mesh.device).manual_seed(seed + mesh.rank)
    if kind in ("ring_rs", "ring_ag", "full_mesh"):
        # m: rows of the whole (reduce-scattered or gathered) array
        a = torch.randn((m if kind == "ring_rs" else m // TP, k),
                        generator=g, device=mesh.device).to(torch.bfloat16)
        if kind == "ring_rs":
            def nccl_rs():
                y = a.new_empty((m // TP, k))
                dist.reduce_scatter_tensor(y, a, group=mesh.group)
                return y
            return (lambda: ring_rs.ring_reduce_scatter(mesh, a),
                    lambda: ring_rs.ring_rs_ref(mesh, a), nccl_rs, None)

        def nccl_ag():
            y = a.new_empty((m, k))
            dist.all_gather_into_tensor(y, a, group=mesh.group)
            return y
        if kind == "full_mesh":
            return (lambda: ring_ag.full_mesh_all_gather(mesh, a),
                    lambda: ring_ag.ring_ag_ref(mesh, a), nccl_ag,
                    lambda: ring_ag.ring_all_gather(mesh, a))
        return (lambda: ring_ag.ring_all_gather(mesh, a),
                lambda: ring_ag.ring_ag_ref(mesh, a), nccl_ag, None)
    rows = TP * m if kind in ("rs", "rs_bidir") else m
    a = torch.randn((rows, k), generator=g, device=mesh.device).to(
        torch.bfloat16)
    if kind in ("one_shot", "rhd"):
        fn = (arm.one_shot_all_reduce if kind == "one_shot"
              else arm.rhd_all_reduce)
        plain = arm.one_shot_ref if kind == "one_shot" else arm.rhd_ref

        def nccl():
            y = a.clone()
            dist.all_reduce(y, group=mesh.group)
            return y
        return (lambda: fn(mesh, a), lambda: plain(mesh, a), nccl, None)
    b = (torch.randn((k, n), generator=g, device=mesh.device)
         * k ** -0.5).to(torch.bfloat16)
    group_name = mesh.group.group_name
    if kind in ("ag", "ag_bidir"):
        def lib():
            return symm_mem._fused_all_gather_matmul(
                a, [b], gather_dim=0, group_name=group_name)[1][0]

        def b10():
            return agm.pallas_ag_gemm(mesh, a, b)[0]
        if kind == "ag":
            return b10, lambda: agm.ag_gemm_ref(mesh, a, b)[0], lib, None
        return (lambda: agm.pallas_ag_gemm_bidir(mesh, a, b)[0],
                lambda: agm.ag_gemm_ref(mesh, a, b)[0], lib, b10)
    if kind == "ar":
        def mm_nccl():
            y = torch.mm(a, b)
            dist.all_reduce(y, group=mesh.group)
            return y
        return (lambda: ga.pallas_gemm_ar(mesh, a, b),
                lambda: ga.gemm_ar_ref_tp(mesh, a, b), mm_nccl, None)

    def lib():
        return symm_mem._fused_matmul_reduce_scatter(
            a, b, "sum", scatter_dim=0, group_name=group_name)
    if kind == "rs_bidir":
        def mm_nccl_rs():
            part = torch.mm(a, b)
            y = part.new_empty((m, n))
            dist.reduce_scatter_tensor(y, part, group=mesh.group)
            return y
        return (lambda: grs.pallas_gemm_rs_bidir(mesh, a, b),
                lambda: grs.gemm_rs_bidir_ref(mesh, a, b), lib, mm_nccl_rs)
    return (lambda: grs.pallas_gemm_rs(mesh, a, b),
            lambda: grs.gemm_rs_ref(mesh, a, b), lib, None)


def _tp_bound(kind, m, k, n):
    """(HBM bytes, NVLink bytes this rank sends, FLOPs) of one call."""
    kind = {"ag_bidir": "ag", "rs_bidir": "rs",
            "full_mesh": "ring_ag"}.get(kind, kind)
    if kind == "ag":
        return ((m * k + k * n + TP * m * n + TP * m * k) * 2,
                (TP - 1) * m * k * 2, 2.0 * TP * m * k * n)
    if kind == "rs":
        return ((TP * m * k + k * n + m * n) * 2, (TP - 1) * m * n * 4,
                2.0 * TP * m * k * n)
    if kind == "ar":
        return ((m * k + k * n + m * n) * 2, (TP - 1) * m * n * 4,
                2.0 * m * k * n)
    if kind == "one_shot":
        return 2 * m * k * 2, (TP - 1) * m * k * 2, (TP - 1.0) * m * k
    if kind == "ring_rs":     # x (m, K) in, its (m/n, K) chunk out
        return ((m + m // TP) * k * 2, (TP - 1) * (m // TP) * k * 2,
                (TP - 1.0) * (m // TP) * k)
    if kind == "ring_ag":     # (m/n, K) in, (m, K) out
        return (m + m // TP) * k * 2, (TP - 1) * (m // TP) * k * 2, 0.0
    # rhd: (1 - 1/n) of x out in each phase, as many adds in the halving
    return (2 * m * k * 2, 2 * (TP - 1) * m * k * 2 // TP,
            (TP - 1.0) * m * k / TP)


def _tp_ranks_time(torch, dist, mesh):
    """On each of the four cards: each kernel against its plain version
    at the TP=4 decode shapes of Qwen3-32B, B=16, bf16 (B10 / B13a: 4
    rows per rank, the batch-sharded triton_dist projections; B4, B5, B6:
    the 16 replicated rows), and the device time per call of both
    (queued_ms; each rank times its own calls, all ranks in step). B10,
    B13a and B4 within 1e-2 x max|ref|; B5 and B6, which only add, bit
    for bit. The bound counts this rank's HBM bytes, the bytes it sends
    over NVLink and the FLOPs. Returns {shape: row} of this rank."""
    out = {}
    for name, kind, m, k, n in _TP_SHAPES:
        run, plain, _, alt = _tp_case(torch, mesh, kind, m, k, n, 50)
        got, ref = run(), plain()
        torch.cuda.synchronize()
        held = _held(torch, name, got, ref, 1e-2)
        if kind in ("one_shot", "rhd", "ring_rs", "ring_ag", "full_mesh"):
            held["ok"] = bool(torch.equal(got, ref))
        if kind == "ag_bidir":      # B11's out: B10's bits
            held["b10_bits"] = bool(torch.equal(got, alt()))
            held["ok"] = held["ok"] and held["b10_bits"]
        dist.barrier()
        ms, host_s, ahead = queued_ms(torch, run)
        dist.barrier()
        plain_ms, _, _ = queued_ms(torch, plain)
        dist.barrier()
        hbm, link, flops = _tp_bound(kind, m, k, n)
        bms, by = tp_bound_ms(hbm, link, flops)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "hbm_bytes": hbm, "nvlink_bytes": link,
                     "max_abs_err": held["max_abs_err"], "ok": held["ok"],
                     "host_enqueue_s": host_s, "queued_ahead": ahead}
        if alt is not None:
            out[name]["alt_ms"] = queued_ms(torch, alt)[0]
            dist.barrier()
        if kind in ("ring_rs", "ring_ag", "rhd"):
            out[name]["graph_ms"] = graph_time_ms(run)
            dist.barrier()
        if kind == "rs_bidir" and m == 4:
            out[name].update(_tp4_bidir_extras(torch, dist, mesh, m, k, n))
            out[name]["ok"] = out[name]["ok"] and all(
                _parity_ok(out[name][key])
                for key in ("parity_random", "parity_int"))
        if kind == "ar":
            out[name].update(_tp4_ar_extras(torch, dist, mesh, m, k, n,
                                            gate=k == 2048))
            out[name]["ok"] = out[name]["ok"] and all(
                _parity_ok(v) for key, v in out[name].items()
                if key.startswith("alternating_"))
    return out


def queued_cold_ms(torch, fn, ws) -> float:
    """queued_ms of fn(w) with w taken in turn from ws (weight_copies: out
    of L2 at each call), for work a graph may not hold (NCCL) and for the
    kernels timed beside it."""
    it = iter(range(1 << 30))
    return queued_ms(torch, lambda: fn(ws[next(it) % len(ws)]),
                     iters=max(20, 3 * len(ws)))[0]


def _tp4_ag_cases(torch, dist, mesh):
    """B10 and B11 on one of four cards before any other call of theirs:
    every bf16 workspace they use here (4, 3, 32, 130 and 2,048 rows a
    rank of QKV, K 5,120: 32 rows the stream over eight M groups, which
    only a card that hosts one rank takes) made and its landing rows
    NaN-filled first; at 3, 32, 130 and 2,048 rows a rank both held to
    ag_gemm_ref (1e-2 x max|ref|, the gathered A exact) with B11's out
    B10's bits; both parities eagerly and graph-replayed at 4, 32, 130
    and 2,048 rows (_rank_parity_calls). Returns {case: True | parity
    record}."""
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    bf, dev, k, n = torch.bfloat16, mesh.device, 5120, 2560
    for bidir in (False, True):
        for m in (4, 3, 32, 130, 2048):
            plan = _ag_plan(torch, agm, mesh, m, k, n)
            agm.ag_workspace(mesh, plan, bidir).buf.tensor[
                :plan.flag_off].fill_(255)
    torch.cuda.synchronize()
    dist.barrier()
    g = torch.Generator(device=dev).manual_seed(80 + mesh.rank)

    def draw(m):
        return (torch.randn((m, k), generator=g, device=dev).to(bf),
                (torch.randn((k, n), generator=g, device=dev)
                 * k ** -0.5).to(bf))

    def held(o, ref):
        return (_held(torch, "", o[0], ref[0], 1e-2)["ok"]
                and bool(torch.equal(o[1], ref[1])))
    rec = {}
    for m in (3, 32, 130, 2048):
        a, b = draw(m)
        o10 = agm.pallas_ag_gemm(mesh, a, b)
        o11 = agm.pallas_ag_gemm_bidir(mesh, a, b)
        ref = agm.ag_gemm_ref(mesh, a, b)
        torch.cuda.synchronize()
        rec[f"qkv_m{m}"] = (held(o10, ref) and held(o11, ref)
                            and bool(torch.equal(o11[0], o10[0])))
        dist.barrier()
    for m in (4, 32, 130, 2048):
        for tag, fn in (("b10", agm.pallas_ag_gemm),
                        ("b11", agm.pallas_ag_gemm_bidir)):
            rec[f"parity_{tag}_m{m}"] = _rank_parity_calls(
                torch, lambda x, w, fn=fn: fn(mesh, x, w),
                lambda m=m: draw(m),
                lambda x, w: agm.ag_gemm_ref(mesh, x, w), held,
                calls=4 if m < 2048 else 2)
            dist.barrier()
    torch.cuda.empty_cache()
    return rec


def _tp4_bidir_extras(torch, dist, mesh, m, k, n):
    """B13b on one of four cards beyond _tp_ranks_time's warm timing: cold
    (queued calls rotating over weight copies larger than twice the L2),
    B13a and torch.mm + NCCL reduce-scatter cold beside it; both parities
    eagerly and graph-replayed, random bf16 within 1e-2 x max|ref| and
    integer-valued bit for bit."""
    import torch.distributed as dist_
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    bf, dev = torch.bfloat16, mesh.device
    g = torch.Generator(device=dev).manual_seed(70 + mesh.rank)
    a = torch.randn((TP * m, k), generator=g, device=dev).to(bf)
    ws = weight_copies(torch, g, k, n, bf)

    def mm_rs(w):
        part = torch.mm(a, w)
        y = part.new_empty((m, n))
        dist_.reduce_scatter_tensor(y, part, group=mesh.group)
        return y
    rec = {}
    for key, fn in (("cold_ms", lambda w: grs.pallas_gemm_rs_bidir(
            mesh, a, w)), ("b13a_cold_ms", lambda w: grs.pallas_gemm_rs(
                mesh, a, w)), ("mm_nccl_rs_cold_ms", mm_rs)):
        fn(ws[0])
        torch.cuda.synchronize()
        dist.barrier()
        rec[key] = queued_cold_ms(torch, fn, ws)
        dist.barrier()
    del ws

    def draw_rand():
        return (torch.randn((TP * m, k), generator=g, device=dev).to(bf),
                (torch.randn((k, n), generator=g, device=dev)
                 * k ** -0.5).to(bf))

    def draw_int():
        return (torch.randint(-3, 4, (TP * m, k), generator=g,
                              device=dev).to(bf),
                torch.randint(-3, 4, (k, n), generator=g, device=dev).to(bf))
    for tag, draw, tol in (("random", draw_rand, 1e-2),
                           ("int", draw_int, 0)):
        rec[f"parity_{tag}"] = _rank_parity_calls(
            torch, lambda x, w: grs.pallas_gemm_rs_bidir(mesh, x, w), draw,
            lambda x, w: grs.gemm_rs_bidir_ref(mesh, x, w),
            _tol_held(torch, tol))
        dist.barrier()
    torch.cuda.empty_cache()
    return rec


def _tp4_ar_extras(torch, dist, mesh, m, k, n, gate):
    """B4 across ranks on one of four cards beyond _tp_ranks_time's warm
    timing: cold (queued calls rotating over weight copies larger than
    twice the L2) beside torch.mm + NCCL all-reduce cold; with ``gate``,
    o and down alternately over both parities, eagerly and
    graph-replayed (_rank_parity_calls), random bf16 within 1e-2 x
    max|ref| and integer-valued bit for bit, every rank's output the same
    bytes as every other rank's."""
    from triton_dist_tpu_torch.kernels import gemm_allreduce as ga
    from triton_dist_tpu_torch.kernels.plain import all_gather_list
    bf, dev = torch.bfloat16, mesh.device
    g = torch.Generator(device=dev).manual_seed(80 + mesh.rank)
    a = torch.randn((m, k), generator=g, device=dev).to(bf)
    ws = weight_copies(torch, g, k, n, bf)

    def mm_ar(w):
        y = torch.mm(a, w)
        dist.all_reduce(y, group=mesh.group)
        return y
    rec = {}
    for key, fn in (("cold_ms", lambda w: ga.pallas_gemm_ar(mesh, a, w)),
                    ("mm_nccl_ar_cold_ms", mm_ar)):
        fn(ws[0])
        torch.cuda.synchronize()
        dist.barrier()
        rec[key] = queued_cold_ms(torch, fn, ws)
        dist.barrier()
    del ws
    if not gate:
        torch.cuda.empty_cache()
        return rec
    turn = iter(range(1 << 30))

    def draw(integer):
        kk = (2048, 6400)[next(turn) % 2]
        if integer:
            return (torch.randint(-3, 4, (m, kk), generator=g,
                                  device=dev).to(bf),
                    torch.randint(-3, 4, (kk, n), generator=g,
                                  device=dev).to(bf))
        return (torch.randn((m, kk), generator=g, device=dev).to(bf),
                (torch.randn((kk, n), generator=g, device=dev)
                 * kk ** -0.5).to(bf))

    def held_same(tol):
        held = _tol_held(torch, tol)

        def f(out, ref):
            outs = all_gather_list(mesh, out)   # on every rank, first
            return held(out, ref) and all(_same_bits(o, out) for o in outs)
        return f
    for tag, integer, tol in (("random", False, 1e-2), ("int", True, 0)):
        rec[f"alternating_{tag}"] = _rank_parity_calls(
            torch, lambda x, w: ga.pallas_gemm_ar(mesh, x, w),
            lambda integer=integer: draw(integer),
            lambda x, w: ga.gemm_ar_ref_tp(mesh, x, w), held_same(tol))
        dist.barrier()
    torch.cuda.empty_cache()
    return rec


def _tp4_ring(torch, dist, mesh, calls: int = 20):
    """B9, B7, TWO_SHOT and B6 at their edges on four cards, each rank on
    its own inputs: every shape of _RING_SHAPES and _RING_EDGES (rows a
    rank chunk; B6: _RHD_ROWS and _RHD_EDGES, rows of x) of each kind in
    bf16 and f32 against its plain version over the process group,
    `calls` successive bf16 calls at the decode shape (B6: at 16 and 512
    rows), and 64 TWO_SHOT pairs (B6: 64 calls at 16 rows) captured in one
    graph replayed 3 times over fresh inputs against the eager calls and
    the plain version, all bit for bit (B6's plain version is the same
    bytes on every rank); then the flag round trip between ranks 0 and 1
    (two cards), the protocol sweep (_ring_sweep) and B6's regime sweep
    beside NCCL's all-reduce (_rhd_sweep; queued_ms, each rank its
    own)."""
    from triton_dist_tpu_torch.kernels import allgather as agk
    from triton_dist_tpu_torch.kernels import allreduce as arm
    from triton_dist_tpu_torch.kernels import reduce_scatter as rsk
    bf16, dev = torch.bfloat16, mesh.device
    g = torch.Generator(device=dev).manual_seed(90 + mesh.rank)
    fns = {"ring_rs": (rsk.ring_reduce_scatter, rsk.ring_rs_ref),
           "ring_ag": (agk.ring_all_gather, agk.ring_ag_ref),
           "two_shot": (lambda mh, x: arm.all_reduce_per_device(
               TP, arm.AllReduceMethod.TWO_SHOT, x, mesh=mh),
               lambda mh, x: agk.ring_ag_ref(mh, rsk.ring_rs_ref(mh, x))),
           "rhd": (arm.rhd_all_reduce, arm.rhd_ref)}

    def draw(kind, dt, m, k=5120):
        # m: rows a rank chunk (B6: rows of x)
        rows = m if kind in ("ring_ag", "rhd") else TP * m
        return torch.randn((rows, k), generator=g, device=dev).to(dt)

    def held(kind, x):
        fn, ref = fns[kind]
        got, want = fn(mesh, x), ref(mesh, x)
        torch.cuda.synchronize()
        return bool(torch.equal(got, want))

    cases = {}
    for kind in fns:
        shapes = (_RING_SHAPES + _RING_EDGES if kind != "rhd" else
                  tuple((f"m{m}", m, 5120) for m in _RHD_ROWS) +
                  tuple((f"m{m}_k{k}", m, k) for m, k in _RHD_EDGES))
        for shp, m, k in shapes:
            for dt in (bf16, torch.float32):
                name = f"{kind}_{shp}" + ("" if dt == bf16 else "_f32")
                cases[name] = held(kind, draw(kind, dt, m, k))
        for m in (_RHD_TIMED if kind == "rhd" else (4,)):
            cases[f"{kind}_successive_m{m}"] = all(
                held(kind, draw(kind, bf16, m)) for _ in range(calls))

    def graph_calls(kind, m):
        """64 calls captured in one graph, replayed 3 times over fresh
        inputs: each output the eager call's and the plain version's."""
        fn, ref = fns[kind]
        xs = [draw(kind, bf16, m) for _ in range(64)]
        for x in xs:
            fn(mesh, x)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [fn(mesh, x) for x in xs]
        ok = []
        for _ in range(3):
            for x in xs:
                x.copy_(draw(kind, bf16, m))
            graph.replay()
            same = True
            for o, x in zip(outs, xs):
                eager, want = fn(mesh, x), ref(mesh, x)
                torch.cuda.synchronize()
                same &= torch.equal(o, eager) and torch.equal(o, want)
            ok.append(bool(same))
        del graph, outs
        dist.barrier()
        return ok
    graph_ok = graph_calls("two_shot", 4)
    rhd_graph_ok = graph_calls("rhd", 16)

    def bounce():
        rsk.flag_round_trip(mesh)
    bounce()
    torch.cuda.synchronize()
    dist.barrier()
    trip_ms = queued_ms(torch, bounce, iters=5, warm=1)[0] / rsk.ROUND_TRIPS
    dist.barrier()
    inputs = {}

    def x_of(kind, m):
        if (kind, m) not in inputs:
            inputs[kind, m] = draw(kind, bf16, m)
        return inputs[kind, m]

    def sweep_held(kind, m, ll):
        x = x_of(kind, m)
        got = _forced_ring(torch, rsk, kind, mesh, x, m, ll)
        want = fns[kind][1](mesh, x)
        torch.cuda.synchronize()
        return bool(torch.equal(got, want))

    def sweep_call(kind, m, ll):
        x = x_of(kind, m)
        dist.barrier()
        ms = queued_ms(torch, lambda: _forced_ring(torch, rsk, kind, mesh, x,
                                                   m, ll))[0]
        plan = rsk.ring_plan(TP, m, 5120, 2, torch.cuda.get_device_properties(
            dev).multi_processor_count, mesh.ranks_per_device)
        return ms, {"grid": plan.grid, "ll": plan.ll}
    def nccl(kind, m):
        x = x_of(kind, m)
        y = x.new_empty((m if kind == "ring_rs" else TP * m, 5120))
        op = (dist.reduce_scatter_tensor if kind == "ring_rs"
              else dist.all_gather_into_tensor)
        dist.barrier()
        return queued_ms(torch, lambda: op(y, x, group=mesh.group))[0]
    sweep = _ring_sweep(sweep_call, sweep_held, nccl)
    dist.barrier()
    inputs.clear()

    def rhd_held(m, two, ll):
        x = x_of("rhd", m)
        got = _forced_rhd(torch, arm, mesh, x, two, ll)
        want = arm.rhd_ref(mesh, x)
        torch.cuda.synchronize()
        return bool(torch.equal(got, want))

    def rhd_call(m, two, ll):
        x = x_of("rhd", m)
        dist.barrier()
        return queued_ms(torch, lambda: _forced_rhd(torch, arm, mesh, x, two,
                                                    ll))[0]

    def rhd_nccl(m):
        y = x_of("rhd", m).clone()
        dist.barrier()
        return queued_ms(torch, lambda: dist.all_reduce(y, group=mesh.group)
                         )[0]
    rhd_sweep = _rhd_sweep(
        rhd_call, rhd_held,
        lambda m: _rhd_plan_of(torch, arm, x_of("rhd", m), 1), rhd_nccl)
    inputs.clear()
    torch.cuda.empty_cache()
    dist.barrier()
    return {"cases": cases, "graph_64_pairs_x3_ok": graph_ok,
            "rhd_graph_64_calls_x3_ok": rhd_graph_ok,
            "flag_round_trip_ms": trip_ms, "rounds": rsk.ROUND_TRIPS,
            "sweep": sweep, "rhd_sweep": rhd_sweep}


# all-gather shards of the AUTO sweep: rows per rank of Qwen3-32B's hidden
_AG_SWEEP_ROWS = (1, 4, 16, 64, 128, 512, 2048)


def _tp4_ag_sweep(torch, dist, mesh):
    """The sweep that sets all_gather_op's AUTO crossover on the card: at
    each shard size (rows per rank of 5120 bf16), B8 (full mesh), B7
    (ring) and NCCL's all_gather_into_tensor, device ms per call
    (queued_ms), each rank its own; B8's rows must be NCCL's bytes."""
    from triton_dist_tpu_torch.kernels import allgather as agk
    out = []
    for rows in _AG_SWEEP_ROWS:
        g = torch.Generator(device=mesh.device).manual_seed(70 + mesh.rank)
        x = torch.randn((rows, 5120), generator=g, device=mesh.device).to(
            torch.bfloat16)

        def nccl():
            y = x.new_empty((TP * rows, 5120))
            dist.all_gather_into_tensor(y, x, group=mesh.group)
            return y
        same = bool(torch.equal(agk.full_mesh_all_gather(mesh, x), nccl()))
        rec = {"rows_per_rank": rows,
               "shard_bytes": rows * 5120 * 2, "b8_equals_nccl": same}
        for label, fn in (("b8_ms", lambda: agk.full_mesh_all_gather(mesh,
                                                                     x)),
                          ("b7_ms", lambda: agk.ring_all_gather(mesh, x)),
                          ("nccl_ms", nccl)):
            dist.barrier()
            rec[label] = queued_ms(torch, fn)[0]
        dist.barrier()
        out.append(rec)
    return out


def _tp4_mesh_ops(torch, dist, mesh, kern):
    """The mesh-level ops' path on four cards, each rank on its shards:
    the counts zeroed, ``all_gather_op`` at AUTO on a decode step's 4 rows
    (FULL_MESH: B8), ``ag_gemm`` and ``gemm_rs`` through PALLAS_BIDIR
    contexts at the QKV and o shapes (B11, B13b), the counts read; each
    output held to its plain version."""
    from triton_dist_tpu_torch.kernels import allgather as agk
    from triton_dist_tpu_torch.kernels import allgather_gemm as agm
    from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
    g = torch.Generator(device=mesh.device).manual_seed(80 + mesh.rank)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=mesh.device)
                * scale).to(torch.bfloat16)
    x, a = randn(4, 5120), randn(4, 5120)
    b = randn(5120, 2560, scale=5120 ** -0.5)
    ra, rb = randn(16, 2048), randn(2048, 5120, scale=2048 ** -0.5)
    # warm-up calls first: they make the ops' symmetric buffers
    agk.all_gather_op(mesh, x)
    agm.ag_gemm(agm.create_ag_gemm_context(
        mesh, method=agm.AgGemmMethod.PALLAS_BIDIR), a, b)
    grs.gemm_rs(grs.create_gemm_rs_context(
        mesh, method=grs.GemmRsMethod.PALLAS_BIDIR), ra, rb)
    torch.cuda.synchronize()
    dist.barrier()
    kern.reset_launch_counts()
    gathered = agk.all_gather_op(mesh, x)
    c, ag = agm.ag_gemm(agm.create_ag_gemm_context(
        mesh, method=agm.AgGemmMethod.PALLAS_BIDIR), a, b)
    y = grs.gemm_rs(grs.create_gemm_rs_context(
        mesh, method=grs.GemmRsMethod.PALLAS_BIDIR), ra, rb)
    torch.cuda.synchronize()
    counts = kern.launch_counts()
    ref_c, ref_ag = agm.ag_gemm_ref(mesh, a, b)
    ok = {"all_gather_op": bool(torch.equal(gathered,
                                            agk.ring_ag_ref(mesh, x))),
          "ag_gemm": _held(torch, "ag_gemm", c, ref_c, 1e-2)["ok"]
          and bool(torch.equal(ag, ref_ag)),
          "gemm_rs": _held(torch, "gemm_rs", y,
                           grs.gemm_rs_bidir_ref(mesh, ra, rb), 1e-2)["ok"]}
    return {"launches": counts, "ok": ok}


def _tp_library_time(torch, dist, mesh):
    """The library yardsticks at the same shapes (the port never calls
    them): torch's fused symmetric-memory ops for B10 / B13a, NCCL for
    B4 / B5 / B6; device ms per call, or why one could not run. Run last:
    a failure here costs nothing else."""
    out = {}
    for name, kind, m, k, n in _TP_SHAPES:
        _, plain, lib, _ = _tp_case(torch, mesh, kind, m, k, n, 50)
        try:
            from torch.distributed import _symmetric_memory as symm_mem
            if hasattr(symm_mem, "enable_symm_mem_for_group"):
                symm_mem.enable_symm_mem_for_group(mesh.group.group_name)
            err = (lib().float() - plain().float()).abs().max().item()
            dist.barrier()
            out[name] = {"library_ms": queued_ms(torch, lib)[0],
                         "library_max_abs_err": err}
        except Exception as exc:     # the yardstick only; not the port
            out[name] = {"library_ms": None,
                         "library_note": f"{type(exc).__name__}: "
                                         f"{str(exc)[:300]}"}
        dist.barrier()
    return out


def _rank_logits(torch, dist, engine, ids, fixed):
    """Prefill ``ids`` (no decode step), then ONE decode step of the
    given tokens: the (B, V) f32 logits of the whole batch (a
    batch-sharded engine's rows all-gathered)."""
    engine.serve(ids, gen_len=1)
    logits = engine.decode_logits(fixed).clone()
    mesh = engine.model.ctx.mesh
    if engine.backend == "triton_dist" and mesh.world > 1:
        full = torch.empty((mesh.world * logits.shape[0], logits.shape[1]),
                           dtype=logits.dtype, device=logits.device)
        dist.all_gather_into_tensor(full, logits, group=mesh.group)
        logits = full
    return logits


def _tp_prompt(torch, vocab, batch, length, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (batch, length + 1), generator=g)


# the replicated TP=4 serves: (label, TPContext fields,
# backend); "mega_default" is Engine(model, params) at its defaults
_TP4_REPLICATED = (("mega_default", {}, "xla"),
                   ("ar_one_shot", {"ar_method": "one_shot"},
                    "triton_dist_AR"),
                   ("ar_rhd", {"ar_method": "rhd"}, "triton_dist_AR"),
                   ("ar_two_shot", {"ar_method": "two_shot"},
                    "triton_dist_AR"),
                   ("ar_qint8_os", {"ar_method": "qint8_os"},
                    "triton_dist_AR"),
                   ("ar_qint8", {"ar_method": "qint8"}, "triton_dist_AR"),
                   ("mega_td_quant", {}, "xla"))
# the serves on the int8 wire (PR 12); "mega_td_quant" is the defaults
# built under TD_QUANT=always (the mega o/down through gemm_ar XLA_QINT8)
_TP4_QUANT_LABELS = ("ar_qint8_os", "ar_qint8", "mega_td_quant")


def _tp_ctx(mesh, **kw):
    """TPContext on ``mesh`` with methods named by value (ag_method,
    rs_method, ar_method, gemm_ar_method)."""
    from triton_dist_tpu_torch.kernels.allgather_gemm import AgGemmMethod
    from triton_dist_tpu_torch.kernels.allreduce import AllReduceMethod
    from triton_dist_tpu_torch.kernels.gemm_allreduce import GemmArMethod
    from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (
        GemmRsMethod,
    )
    from triton_dist_tpu_torch.layers.common import TPContext
    enums = {"ag_method": AgGemmMethod, "rs_method": GemmRsMethod,
             "ar_method": AllReduceMethod, "gemm_ar_method": GemmArMethod}
    return TPContext(mesh, **{k: enums[k](v) for k, v in kw.items()})


_TD_PALLAS = {"ag_method": "pallas", "rs_method": "pallas"}
_TD_BIDIR = {"ag_method": "pallas_bidir", "rs_method": "pallas_bidir"}


def _tp4_measure(torch, dist, kern, engine, ids, gen, profile):
    """One graph-replayed TP=4 serve of ``engine``: the launches counted
    in the measured serve (_serve_counted), its timings and peak memory,
    whether every rank returned the same tokens, which tokens this rank's
    own sample differed from rank 0's (replicated backends), the idle
    share by events and, with ``profile``, a profile of one prefill and 4
    steps."""
    prompt = ids[:, :-1]
    out, launches, per_step, eager, replays = _serve_counted(
        torch, kern, engine, prompt, gen)
    differs = engine.own_token_differs
    rec = {"peak_bytes": torch.cuda.max_memory_allocated(),
           "prefill_ms": engine.last_prefill_s * 1e3,
           "decode_ms_per_step": engine.last_decode_s * 1e3
           / engine.last_decode_steps,
           "decode_tok_s": ids.shape[0] * engine.last_decode_steps
           / engine.last_decode_s,
           "graph_replays": replays, "launches_per_replay": per_step,
           "eager_launches": eager, "launches": launches,
           "own_token_differs": (None if differs is None
                                 else differs.tolist())}
    wall_ms, replay_ms = _replay_idle(torch, engine, ids, 8)
    rec.update(step_wall_ms=wall_ms, replay_device_ms=replay_ms,
               idle_share_by_events=1 - replay_ms / wall_ms)
    if profile:
        pre, dec = _profile_engine(torch, engine, ids, 4)
        rec["profile"] = {"prefill": pre, "decode_step": dec}
    toks = [torch.empty_like(out) for _ in range(TP)]
    dist.all_gather(toks, out.contiguous())
    rec["tokens_same_on_every_rank"] = all(torch.equal(t, out) for t in toks)
    rec["tokens_shape"] = list(out.shape)
    return rec, out


def _tp4_params(torch, mesh, models):
    """This rank's shard of Qwen3-32B's world-1 bf16 weights from seed 0
    (drawn once per run): (params, draw s, peak bytes while drawn)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models.init_random_params(
        torch.Generator(device=mesh.device).manual_seed(0),
        models.QWEN3_ARCHS[TP_MODEL], mesh.device, torch.bfloat16,
        rank=mesh.rank, world=mesh.world)
    torch.cuda.synchronize()
    return (params, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


def _tp4_serve(torch, dist, mesh, models, kern, tmp, drawn, gen: int = 32):
    """Qwen3-32B at its published widths, all 64 layers, bf16, random
    weights from seed 0 (this rank's shard of the world-1 weights, drawn
    once: ``drawn``), max_length 1024; B=16 prompts of 512 tokens, 32 tokens each,
    prefill in xla, every decode step one CUDA-graph replay: in
    triton_dist (B10 for QKV and gate/up, B13a for o and down, each rank
    its 4 rows), then the replicated serves of _TP4_REPLICATED: the
    Engine's defaults (the mega step on the pallas_chain tier: B4 for o
    and down, B3, B1) and triton_dist_AR under ONE_SHOT (B5), RHD (B6) and
    TWO_SHOT (B9 then B7).
    Each measured by _tp4_measure (triton_dist and the mega default also
    profiled). Then the same weights served by the plain TP=4 xla decode
    (mega off) for the logits comparison."""
    arch = models.QWEN3_ARCHS[TP_MODEL]

    def model_of(**kw):
        return models.Qwen3(arch, _tp_ctx(mesh, **kw), max_length=1024,
                            dtype=torch.bfloat16)

    params, init_s, init_peak = drawn
    param_bytes = sum(t.numel() * t.element_size() for t in
                      [*(v for k, v in params.items() if k != "layers"),
                       *params["layers"].values()])
    ids = _tp_prompt(torch, arch.vocab_size, 16, 512, 1).to(mesh.device)
    prompt, fixed = ids[:, :512], ids[:, 512].to(torch.int32)
    engine = models.Engine(model_of(**_TD_PALLAS), params,
                           backend="triton_dist")
    rec, out = _tp4_measure(torch, dist, kern, engine, ids, gen, True)
    rec.update({"model": TP_MODEL, "layers": arch.num_layers,
                "tp": mesh.world, "batch": 16, "prompt": 512,
                "gen_len": gen, "dtype": "bf16",
                "param_bytes_per_card": param_bytes, "init_s": init_s,
                "init_peak_bytes": init_peak})
    logits = {"td": _rank_logits(torch, dist, engine, prompt, fixed).cpu()}
    del engine
    torch.cuda.empty_cache()
    engine = models.Engine(model_of(**_TD_BIDIR), params,
                           backend="triton_dist")
    rec["bidir"], bidir_out = _tp4_measure(torch, dist, kern, engine, ids,
                                           gen, False)
    rec["bidir"]["tokens_equal_triton_dist"] = bool(torch.equal(bidir_out,
                                                                out))
    logits["td_bidir"] = _rank_logits(torch, dist, engine, prompt,
                                      fixed).cpu()
    del engine
    torch.cuda.empty_cache()
    rec["replicated"] = {}
    for label, kw, backend in _TP4_REPLICATED:
        if label == "mega_td_quant":
            os.environ["TD_QUANT"] = "always"
        try:
            engine = models.Engine(model_of(**kw), params, backend=backend)
        finally:
            os.environ.pop("TD_QUANT", None)
        r, _ = _tp4_measure(torch, dist, kern, engine, ids, gen,
                            label == "mega_default")
        r["mega_tier"] = engine.mega_tier
        if engine._mega_rt is not None:
            r["mega_gemm_ar_method"] = getattr(
                engine._mega_rt.gemm_ar_method, "value", None)
        rec["replicated"][label] = r
        logits[label] = _rank_logits(torch, dist, engine, prompt,
                                     fixed).cpu()
        del engine
        torch.cuda.empty_cache()
    xla = models.Engine(model_of(), params, backend="xla", mega="off")
    logits["xla"] = _rank_logits(torch, dist, xla, prompt, fixed).cpu()
    if mesh.rank == 0:
        torch.save({**logits, "tokens": out.cpu()},
                   os.path.join(tmp, "tp4_bf16.pt"))
    del xla, params
    torch.cuda.empty_cache()
    return rec


# the continuous TP=4 paths: (label, TPContext fields, engine mode)
_TP4_CONTINUOUS = (("xla", {}, "xla"),
                   ("ar_two_shot", {"ar_method": "two_shot"},
                    "triton_dist_AR"),
                   ("ar_rhd", {"ar_method": "rhd"}, "triton_dist_AR"),
                   ("ar_qint8_os", {"ar_method": "qint8_os"},
                    "triton_dist_AR"))
# the lossy continuous paths: held to the same tokens on every rank, not
# to world 1's (QINT8_OS folds int8-quantized terms: its error budget is
# tp4_quant's contract checks)
_TP4_CONTINUOUS_LOSSY = ("ar_qint8_os",)


def _tp4_continuous(torch, dist, mesh, models, kern, drawn):
    """Qwen3-32B (64 layers, bf16, the same weights as tp4_serve) served
    by ContinuousEngine at TP=4, max_batch 16, page 128, max_length
    2048, prefill_chunk 512, decode_steps 4, prefix cache on: 32 requests
    (_traffic, seed 13, prompts 16-1536, 8 of them behind one 384-token
    prefix, budgets 16-64) in four waves of 8, one every 4 harvests; (a)
    mode xla at the defaults (prefill chunks with NCCL all-reduces, each
    harvest the paged mega graph: B4 across ranks, B3, B2), (b)
    triton_dist_AR with TWO_SHOT (prefill chunks through B9 + B7, each
    harvest the layer path's step: B9 + B7 after o and down, B2), (c)
    with RHD (B6 in both), (d) with QINT8_OS (B28), all on the same
    traffic. TWO_SHOT and RHD need the world to divide the rows: the
    engine pads a chunk's bucket to a multiple of the world (the f32 gate
    serves 1- and 2-token chunks), and a direct 2-row TWO_SHOT sum is
    shown to raise before any launch. Each rank returns its records and
    its tokens."""
    from triton_dist_tpu_torch.kernels.allreduce import (
        AllReduceMethod, all_reduce_per_device,
    )
    arch = models.QWEN3_ARCHS[TP_MODEL]
    params = drawn[0]
    out = {}
    for label, kw, mode in _TP4_CONTINUOUS:
        traffic = _traffic(torch, arch.vocab_size, 32, 13)
        model = models.Qwen3(arch, _tp_ctx(mesh, **kw), max_length=2048,
                             dtype=torch.bfloat16)
        rec, done, eng = _serve_continuous(
            torch, kern, models, model, params, traffic, decode_steps=4,
            max_batch=16, label=f"tp4_continuous_{label}", mode=mode)
        rec["tokens"] = [r.out for r in done]
        rec["traffic"] = [[len(p), g] for p, g in traffic]
        out[label] = rec
        del eng, model
        torch.cuda.empty_cache()
    before = kern.launch_counts()
    x = torch.randn((2, arch.hidden_size), device=mesh.device).to(
        torch.bfloat16)
    try:
        all_reduce_per_device(TP, AllReduceMethod.TWO_SHOT, x, mesh=mesh)
        raised = None
    except ValueError as exc:
        raised = str(exc)
    out["two_token_chunk"] = {"raised": raised,
                              "launches_unchanged":
                              kern.launch_counts() == before}
    return out


def _cont_gate_traffic(torch, vocab):
    """The f32 continuous gates' requests: 8 prompts (40-700 tokens, two
    behind one 256-token prefix) and three whose last prefill chunk of
    256 holds 1 or 2 tokens (1, 2 and 257 tokens: TWO_SHOT pads them to
    the world), 8 greedy tokens each."""
    small = _traffic(torch, vocab, 8, 12, n_shared=2, prefix_len=256,
                     lo=40, hi=700)
    g = torch.Generator().manual_seed(14)
    small += [(torch.randint(0, vocab, (n,), generator=g).tolist(), 8)
              for n in (1, 2, 257)]
    return [(p, 8) for p, _ in small]


def _tp4_continuous_consistency(torch, dist, mesh, models, tmp):
    """The f32 gate of the continuous paths: Qwen3-32B's widths cut to 4
    layers, f32 weights from seed 7 (drawn once); every request of
    _cont_gate_traffic through ContinuousEngine (max_batch 4, page 128,
    prefill_chunk 256, decode_steps 4, prefix cache) on each path of
    _TP4_CONTINUOUS, and through the static Engine at its defaults, one
    prompt at a time; rank 0 keeps the token sets for the parent, which
    serves world 1 on card 0 from the same seed; every rank returns its
    tokens and each engine's own_token_differs (the lossy paths are held
    to the same tokens on every rank)."""
    import dataclasses
    arch = dataclasses.replace(models.QWEN3_ARCHS[TP_MODEL], num_layers=4)
    params = models.init_random_params(
        torch.Generator(device=mesh.device).manual_seed(7), arch,
        mesh.device, torch.float32, rank=mesh.rank, world=mesh.world)
    reqs = _cont_gate_traffic(torch, arch.vocab_size)
    toks, differs = {}, {}
    for label, kw, mode in _TP4_CONTINUOUS:
        model = models.Qwen3(arch, _tp_ctx(mesh, **kw), max_length=1024,
                             dtype=torch.float32)
        eng = models.ContinuousEngine(model, params, max_batch=4,
                                      page_size=128, prefill_chunk=256,
                                      decode_steps=4, prefix_cache=True,
                                      mode=mode)
        for p, g in reqs:
            eng.submit(p, max_new_tokens=g)
        toks[f"continuous_{label}"] = [r.out for r in eng.run()]
        differs[f"continuous_{label}"] = eng.own_token_differs
        del eng
        torch.cuda.empty_cache()
    model = models.Qwen3(arch, _tp_ctx(mesh), max_length=1024,
                         dtype=torch.float32)
    static = models.Engine(model, params)
    toks["static_mega_default"] = [
        static.serve(torch.tensor([p], device=mesh.device), g)[0].tolist()
        for p, g in reqs]
    if mesh.rank == 0:
        torch.save(toks, os.path.join(tmp, "tp4_f32_continuous.pt"))
    del static, params
    torch.cuda.empty_cache()
    return {"tokens_equal_static": {
        k: v == toks["static_mega_default"] for k, v in toks.items()},
        "tokens": toks, "own_token_differs": differs}


# the f32 gate's TP=4 serves: (label, TPContext fields, Engine arguments)
_TP4_GATE = (
    ("td", _TD_PALLAS, {"backend": "triton_dist"}),
    ("td_bidir", _TD_BIDIR, {"backend": "triton_dist"}),
    ("xla", {}, {"mega": "off"}),
    ("mega_pallas_chain", {}, {"mega": "pallas_chain"}),
    ("mega_xla", {}, {"mega": "xla"}),
    ("ar_one_shot", {"ar_method": "one_shot"},
     {"backend": "triton_dist_AR"}),
    ("ar_rhd", {"ar_method": "rhd"}, {"backend": "triton_dist_AR"}),
    ("ar_two_shot", {"ar_method": "two_shot"},
     {"backend": "triton_dist_AR"}),
    ("ar_gemm_ar", {"gemm_ar_method": "pallas"},
     {"backend": "triton_dist_AR"}))


def _tp4_consistency(torch, dist, mesh, models, tmp, gen: int = 16):
    """The f32 gate: Qwen3-32B's widths cut to 4 layers, f32 weights from
    seed 7 (drawn once); B=16 prompts of 64 tokens, 16 greedy tokens,
    served at TP=4 down every path of _TP4_GATE: triton_dist (B10/B13a),
    xla with mega off (NCCL all-reduce), the mega step on both tiers
    (pallas_chain: B4 and B3), triton_dist_AR under ONE_SHOT (B5), RHD
    (B6) and the fused gemm_ar (B4); rank 0 keeps the token sets for the
    parent, which serves world 1 on card 0 from the same seed."""
    import dataclasses
    arch = dataclasses.replace(models.QWEN3_ARCHS[TP_MODEL], num_layers=4)
    params = models.init_random_params(
        torch.Generator(device=mesh.device).manual_seed(7), arch,
        mesh.device, torch.float32, rank=mesh.rank, world=mesh.world)
    ids = _tp_prompt(torch, arch.vocab_size, 16, 64, 2)[:, :64].to(
        mesh.device)
    toks = {}
    for label, kw, engine_kw in _TP4_GATE:
        model = models.Qwen3(arch, _tp_ctx(mesh, **kw), max_length=128,
                             dtype=torch.float32)
        toks[label] = models.Engine(model, params, **engine_kw).serve(
            ids, gen).cpu()
        torch.cuda.empty_cache()
    if mesh.rank == 0:
        torch.save(toks, os.path.join(tmp, "tp4_f32.pt"))
    del params
    torch.cuda.empty_cache()
    return {"tokens_equal_td": {k: bool(torch.equal(v, toks["td"]))
                                for k, v in toks.items()}}


def _tp4_moe_kernels(torch, dist, mesh, calls: int = 5):
    """On each of the four cards: B14 and B15 across ranks at
    Qwen3-30B-A3B's TP=4 decode shapes (4 tokens per rank, B=16, bf16;
    the same random routing on every rank, each rank its own tokens, B15
    rows and one layer's random expert shards) against their plain
    versions (NCCL all-gather + the world-1 plain version per chunk; each
    chunk's f32 partial + NCCL all_to_all_single + the fold in ascending
    sender) within 1e-2 x max|ref|, B14's rows BITWISE the world-1
    kernel's on the gathered chunks, `calls` repeats the same bits; device
    ms per call (queued_ms; the plain versions eagerly, they read the
    schedule on the host) and the library yardstick: NCCL
    all_gather_into_tensor + one torch._grouped_mm over the gathered,
    expert-sorted rows (B14), torch._grouped_mm + NCCL reduce_scatter_tensor
    of the (M, d) f32 rows (B15, its top-k combine left out)."""
    from triton_dist_tpu_torch.kernels import allgather_group_gemm as agg
    from triton_dist_tpu_torch.kernels import moe_reduce_rs as mrs
    from triton_dist_tpu_torch.kernels import moe_utils as mu
    from triton_dist_tpu_torch.kernels import plain
    d, e, il, topk = MOE_TP_DIMS
    dev, m = mesh.device, 4
    g = torch.Generator(device=dev).manual_seed(71)   # the same routing
    xr = torch.randn((TP * m, d), generator=g, device=dev)
    wr = torch.randn((d, e), generator=g, device=dev) * d ** -0.5
    w, ids = mu.route_topk(plain.dot_f32(xr, wr), topk)
    bm = min(128, max(8, m * topk))
    sched = mu.aligned_chunk_schedule(ids, TP, e, bm)
    g = torch.Generator(device=dev).manual_seed(72 + mesh.rank)
    tok = torch.randn((m, d), generator=g, device=dev).to(torch.bfloat16)
    inter = torch.randn((TP * m * topk, il), generator=g, device=dev).to(
        torch.bfloat16)
    w_gu = (torch.randn((e, d, 2 * il), generator=g, device=dev)
            * d ** -0.5).to(torch.bfloat16)
    w_dn = (torch.randn((e, il, d), generator=g, device=dev)
            * il ** -0.5).to(torch.bfloat16)
    c = {"tok": [tok], "m_loc": m, "live": int(torch.unique(ids).numel())}

    def b14():
        return agg.pallas_ag_group_gemm(mesh, tok, w_gu, sched, topk, 4)

    def b15():
        return mrs.pallas_moe_reduce_rs(mesh, inter, w_dn, ids, w, sched)

    out14, ag = b14()
    out15 = b15()
    ref14, ref_ag = agg.ag_group_gemm_ref(mesh, tok, w_gu, sched, topk)
    ref15 = mrs.moe_reduce_rs_tp_ref(mesh, inter, w_dn, ids, w, sched)
    torch.cuda.synchronize()
    w1 = torch.cat([agg.group_gemm(ag[ch * m:(ch + 1) * m], w_gu,
                                   agg.chunk_of(sched, ch), topk)
                    for ch in range(TP)])
    same = []
    for _ in range(calls):
        a14, _ = b14()
        a15 = b15()
        torch.cuda.synchronize()
        same.append(bool(torch.equal(a14, out14) and torch.equal(a15, out15)))
    held = {"b14": _held(torch, "b14_m4", out14, ref14, 1e-2),
            "b15": _held(torch, "b15_m4", out15, ref15, 1e-2)}
    held["b14"]["gathered_exact"] = bool(torch.equal(ag, ref_ag))
    held["b14"]["world1_kernel_bitwise"] = bool(torch.equal(out14, w1))
    for h in held.values():
        h["repeats_bitwise"] = same
        h["ok"] = (h["ok"] and all(same) and h.get("gathered_exact", True)
                   and h.get("world1_kernel_bitwise", True))

    st = mu.sort_by_expert(ids, e)
    offs = torch.cumsum(st.group_sizes, 0).to(torch.int32)
    flat_tok = torch.arange(TP * m * topk, device=dev) // topk
    gmm = getattr(torch, "_grouped_mm", None)

    def lib14():
        full = tok.new_empty((TP * m, d))
        dist.all_gather_into_tensor(full, tok, group=mesh.group)
        return gmm(full[flat_tok[st.sort_idx.long()]], w_gu, offs=offs)

    def lib15():
        y = gmm(inter[st.sort_idx.long()], w_dn, offs=offs)
        rows = torch.zeros((TP * m, d), dtype=torch.float32, device=dev)
        rows.index_add_(0, st.token_idx.long(), y.float())
        part = rows.new_empty((m, d))
        dist.reduce_scatter_tensor(part, rows, group=mesh.group)
        return part

    out = {}
    for key, run, ref, lib in (("b14", b14, lambda: agg.ag_group_gemm_ref(
            mesh, tok, w_gu, sched, topk), lib14),
            ("b15", b15, lambda: mrs.moe_reduce_rs_tp_ref(
                mesh, inter, w_dn, ids, w, sched), lib15)):
        dist.barrier()
        ms, host_s, ahead = queued_ms(torch, run)
        dist.barrier()
        plain_ms = time_ms(ref, iters=3, warmup=1)
        dist.barrier()
        lib_ms, note = None, None
        try:
            if gmm is None:
                raise RuntimeError("torch._grouped_mm missing")
            lib()
            torch.cuda.synchronize()
            dist.barrier()
            lib_ms = queued_ms(torch, lib)[0]
        except Exception as exc:     # the yardstick only; not the port
            note = f"{type(exc).__name__}: {str(exc)[:200]}"
        dist.barrier()
        hbm, link, flops = _moe_tp_bytes(c, key)
        bms, by = tp_bound_ms(hbm, link, flops)
        out[key] = {**held[key], "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "library_note": note,
                    "bound_ms": bms, "bound_by": by, "hbm_bytes": hbm,
                    "nvlink_bytes": link, "live_experts": c["live"],
                    "host_enqueue_s": host_s, "queued_ahead": ahead}
    return out


def _tp4_moe(torch, dist, mesh, models, kern, gen: int = 32):
    """Qwen3-30B-A3B at its published widths (hidden 2048, 48 layers, 32 q
    / 4 kv heads, 128 experts, top-8, expert width 768: 192 per rank),
    bf16, random weights from seed 0 (this rank's shard of the world-1
    draw, about 15.3 GB), max_length 1024, served at TP=4 on B=16 prompts
    of 512 tokens, 32 tokens each, prefill in xla (the experts per expert,
    then NCCL's all-reduce), each decode step one CUDA-graph replay:
    (a) backend triton_dist with B10 / B13a on the attention projections
    and the MoE AUTO rule (B14 and B15 across ranks), each rank its 4 rows;
    (b) Engine(model, params) at its defaults (the mega step: B1 at T=1,
    B4 across ranks on the o projection, B3; the moe task's xla tier with
    NCCL's f32 all-reduce). Each measured by _tp4_measure, both profiled;
    then B14 / B15 timed on the card (_tp4_moe_kernels)."""
    arch = models.QWEN3_ARCHS[MOE_MODEL]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models.init_random_params(
        torch.Generator(device=mesh.device).manual_seed(0), arch,
        mesh.device, torch.bfloat16, rank=mesh.rank, world=mesh.world)
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()
    param_bytes = sum(t.numel() * t.element_size() for t in
                      [*(v for k, v in params.items() if k != "layers"),
                       *params["layers"].values()])
    ids = _tp_prompt(torch, arch.vocab_size, 16, 512, 4).to(mesh.device)

    def model_of(**kw):
        return models.Qwen3MoE(arch, _tp_ctx(mesh, **kw), max_length=1024,
                               dtype=torch.bfloat16)

    rec = {"model": MOE_MODEL, "layers": arch.num_layers, "tp": mesh.world,
           "batch": 16, "prompt": 512, "gen_len": gen, "dtype": "bf16",
           "param_bytes_per_card": param_bytes, "init_s": init_s,
           "init_peak_bytes": init_peak, "paths": {}}
    toks = {}
    for label, kw, engine_kw in (
            ("triton_dist", _TD_PALLAS, {"backend": "triton_dist"}),
            ("mega_default", {}, {})):
        torch.cuda.empty_cache()
        engine = models.Engine(model_of(**kw), params, **engine_kw)
        r, toks[label] = _tp4_measure(torch, dist, kern, engine, ids, gen,
                                      True)
        r["mega_tier"] = engine.mega_tier
        rec["paths"][label] = r
        del engine
    rec["tokens_agree_triton_dist_vs_mega"] = (
        toks["triton_dist"] == toks["mega_default"]).float().mean().item()
    del params
    torch.cuda.empty_cache()
    rec["kernels"] = _tp4_moe_kernels(torch, dist, mesh)
    return rec


def _tp4_moe_gate_arch(models):
    import dataclasses
    return dataclasses.replace(models.QWEN3_ARCHS[MOE_MODEL], num_layers=4)


def _eager_greedy(torch, model, params, ids, gen):
    """Greedy tokens of the eager xla step (Qwen3MoE.inference, no graph,
    no mega) after an xla prefill."""
    cache = model.create_kv_cache(ids.shape[0])
    logits, cache = model.inference(params, cache, ids)
    tok = logits.argmax(-1).to(torch.int32)
    out = [tok]
    for _ in range(gen - 1):
        logits, cache = model.inference(params, cache, tok[:, None].long())
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)


def _tp4_moe_consistency(torch, dist, mesh, models, tmp, gen: int = 8):
    """The f32 gate of tp4_moe: Qwen3-30B-A3B's widths cut to 4 layers,
    f32 weights from seed 7 (this rank's shard of the world-1 draw); B=16
    prompts of 64 tokens, 8 greedy tokens through (a) triton_dist (B14,
    B15 across ranks; B10, B13a), (b) the Engine's defaults (the mega
    step) and (c) the eager xla step; rank 0 keeps them for the parent,
    which serves world 1 on card 0 from the same seed."""
    arch = _tp4_moe_gate_arch(models)
    params = models.init_random_params(
        torch.Generator(device=mesh.device).manual_seed(7), arch,
        mesh.device, torch.float32, rank=mesh.rank, world=mesh.world)
    ids = _tp_prompt(torch, arch.vocab_size, 16, 64, 5)[:, :64].to(
        mesh.device)

    def model_of(**kw):
        return models.Qwen3MoE(arch, _tp_ctx(mesh, **kw), max_length=128,
                               dtype=torch.float32)

    toks, ran = {}, {}
    for label, kw, engine_kw in (
            ("td", _TD_PALLAS, {"backend": "triton_dist"}),
            ("mega_default", {}, {})):
        engine = models.Engine(model_of(**kw), params, **engine_kw)
        toks[label] = engine.serve(ids, gen).cpu()
        ran[label] = {k: v for k, v in engine.graph_launches.items() if v}
        del engine
        torch.cuda.empty_cache()
    toks["eager_xla"] = _eager_greedy(torch, model_of(), params, ids,
                                      gen).cpu()
    if mesh.rank == 0:
        torch.save(toks, os.path.join(tmp, "tp4_moe_f32.pt"))
    del params
    torch.cuda.empty_cache()
    return {"launches_per_replay": ran,
            "tokens_equal_td": {k: bool(torch.equal(v, toks["td"]))
                                for k, v in toks.items()}}


# -- expert parallelism on four cards: Qwen3-30B-A3B at EP=4 -----------------

# the EP serves: (label, TPContext fields, Engine kwargs, TD_QUANT,
# the mega runtime's transport); "mega_*" are Engine(model, params) at its
# defaults (the mega step)
_TP4_EP_PATHS = (
    ("td_pallas", {"ep_a2a_method": "pallas"}, {"backend": "triton_dist"},
     None, None),
    ("td_pallas_fused", {"ep_a2a_method": "pallas_fused"},
     {"backend": "triton_dist"}, None, None),
    ("td_pallas_fp8", {"ep_a2a_method": "pallas"},
     {"backend": "triton_dist"}, "always", None),
    ("mega_default", {}, {}, None, None),
    ("mega_pallas_fused", {}, {}, None, "pallas_fused"))


def _ep_ctx(mesh, ep_a2a_method=None):
    """TPContext on ``mesh``: B10 / B13a on the triton_dist attention
    projections, the EP transport named by value (None: XLA)."""
    import dataclasses
    from triton_dist_tpu_torch.kernels.ep_a2a import EpA2AMethod
    ctx = _tp_ctx(mesh, **_TD_PALLAS)
    if ep_a2a_method is None:
        return ctx
    return dataclasses.replace(ctx, ep_a2a_method=EpA2AMethod(ep_a2a_method))


def _ep_engine(models, mesh, arch, params, ctx_kw, engine_kw, mega_ep,
               max_length):
    """The Engine of one EP path: triton_dist with B10 / B13a on the
    attention projections and the path's transport, or Engine(model,
    params) at its defaults, its mega runtime on ``mega_ep``'s transport
    when given."""
    from triton_dist_tpu_torch.kernels.ep_a2a import EpA2AMethod
    from triton_dist_tpu_torch.mega.runtime import MegaDecodeRuntime
    model = models.Qwen3MoE(arch, _ep_ctx(mesh, **ctx_kw),
                            max_length=max_length, dtype=params[
                                "embed"].dtype)
    engine = models.Engine(model, params, **engine_kw)
    if mega_ep is not None:
        engine._mega_rt = MegaDecodeRuntime(
            model, ep_a2a_method=EpA2AMethod(mega_ep))
    return engine


def _ep_arch(models, layers=None):
    import dataclasses
    arch = dataclasses.replace(models.QWEN3_ARCHS[MOE_MODEL],
                               moe_parallel="ep")
    return arch if layers is None else dataclasses.replace(
        arch, num_layers=layers)


def _tp4_ep_kernels(torch, dist, mesh, calls: int = 3):
    """On each of the four cards: B17, B18 and B16 at Qwen3-30B-A3B's EP=4
    shapes, each rank its own slots and the same random routing: B17 on
    (4, max_m, 2048) bf16 slots at decode (max_m 32) and a 512-token chunk
    (max_m 4,096), B18 on their fp8 rows and packed scales, B16 at the
    decode routing (4 tokens a rank, 32 experts' random gate/up slabs a
    rank). Against their plain versions (NCCL all_to_all_single of each
    payload; B16: then each live slot's row times its expert), bitwise
    (B17, B18, B16's received rows) and within 1e-2 x max|ref| (B16's
    inter); `calls` repeats the same bits. Timed (queued_ms, the plain
    versions eagerly) beside the library yardstick: NCCL
    all_to_all_single (B17, B18: of the rows, then of the scales; B16:
    then torch._grouped_mm over the live received rows)."""
    from triton_dist_tpu_torch.kernels import ep_a2a as ep
    from triton_dist_tpu_torch.kernels import low_latency_all_to_all as ll
    from triton_dist_tpu_torch.kernels import moe_utils as mu
    from triton_dist_tpu_torch.kernels import plain
    d, e_loc, ni, e, topk = EP_DIMS
    dev, me = mesh.device, mesh.rank
    g = torch.Generator(device=dev).manual_seed(91 + me)
    out = {}

    def nccl(x):
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=mesh.group)
        return y

    def timed(key, run, ref, lib, hbm, link, flops, held):
        dist.barrier()
        ms, host_s, ahead = queued_ms(torch, run)
        dist.barrier()
        plain_ms = time_ms(ref, iters=5, warmup=1)
        dist.barrier()
        lib_ms, note = None, None
        try:
            lib()
            torch.cuda.synchronize()
            dist.barrier()
            lib_ms = queued_ms(torch, lib)[0]
        except Exception as exc:     # the yardstick only; not the port
            note = f"{type(exc).__name__}: {str(exc)[:200]}"
        dist.barrier()
        bms, by = tp_bound_ms(hbm, link, flops)
        out[key] = {**held, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "library_note": note,
                    "bound_ms": bms, "bound_by": by, "hbm_bytes": hbm,
                    "nvlink_bytes": link, "host_enqueue_s": host_s,
                    "queued_ahead": ahead}

    for shp, m_loc in _EP_SLOTS:
        mm = m_loc * topk
        x = torch.randn((TP, mm, d), generator=g, device=dev).to(
            torch.bfloat16)
        y = ll.fast_all_to_all_per_device(mesh, x)
        same = []
        for _ in range(calls):
            same.append(bool(torch.equal(ll.fast_all_to_all_per_device(
                mesh, x), y)))
        held = {"case": f"b17_{shp}", "max_abs_err": 0.0,
                "ok": bool(torch.equal(y, plain.all_to_all_slots(mesh, x)))
                and all(same), "repeats_bitwise": same}
        slot = mm * d * 2
        timed(f"b17_{shp}", lambda: ll.fast_all_to_all_per_device(mesh, x),
              lambda: plain.all_to_all_slots(mesh, x), lambda: nccl(x),
              2 * TP * slot, (TP - 1) * slot, 0.0, held)
        q, s = ll.quantize_rows(x, torch.float8_e4m3fn)
        s = ll.pack_scales(s)
        rq, rs = ll.fast_all_to_all_q_per_device(mesh, q, s)
        same = []
        for _ in range(calls):
            a, b = ll.fast_all_to_all_q_per_device(mesh, q, s)
            same.append(_bitwise(a, rq) and _bitwise(b, rs))
        held = {"case": f"b18_{shp}", "max_abs_err": 0.0,
                "ok": _bitwise(rq, plain.all_to_all_slots(mesh, q))
                and _bitwise(rs, plain.all_to_all_slots(mesh, s))
                and all(same), "repeats_bitwise": same}

        def draw17(mm=mm):
            return (torch.randn((TP, mm, d), generator=g, device=dev).to(
                torch.bfloat16),)

        def draw18(mm=mm):
            q_, s_ = ll.quantize_rows(draw17(mm)[0], torch.float8_e4m3fn)
            return q_, ll.pack_scales(s_)
        dist.barrier()
        parity = {
            "b17": _rank_parity_calls(
                torch, lambda x_: ll.fast_all_to_all_per_device(mesh, x_),
                draw17, lambda x_: plain.all_to_all_slots(mesh, x_),
                _same_bits),
            "b18": _rank_parity_calls(
                torch, lambda q_, s_: ll.fast_all_to_all_q_per_device(
                    mesh, q_, s_), draw18,
                lambda q_, s_: (plain.all_to_all_slots(mesh, q_),
                                plain.all_to_all_slots(mesh, s_)),
                _same_bits)}
        dist.barrier()
        out[f"b17_{shp}"]["parity_calls"] = parity["b17"]
        out[f"b17_{shp}"]["ok"] &= _parity_ok(parity["b17"])
        held["parity_calls"] = parity["b18"]
        held["ok"] = held["ok"] and _parity_ok(parity["b18"])
        qb = q.view(torch.uint8)
        slot = mm * d + s[0].numel() * 4
        timed(f"b18_{shp}",
              lambda: ll.fast_all_to_all_q_per_device(mesh, q, s),
              lambda: (plain.all_to_all_slots(mesh, q),
                       plain.all_to_all_slots(mesh, s)),
              lambda: (nccl(qb), nccl(s)), 2 * TP * slot, (TP - 1) * slot,
              0.0, held)
    # B16: one routing of the whole batch (the same on every rank)
    gr = torch.Generator(device=dev).manual_seed(97)
    m_loc = 4
    max_m = m_loc * topk
    xr = torch.randn((TP * m_loc, d), generator=gr, device=dev)
    wr = torch.randn((d, e), generator=gr, device=dev) * d ** -0.5
    _, ids = mu.route_topk(plain.dot_f32(xr, wr), topk)
    tok = torch.randn((m_loc, d), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((e_loc, d, ni), generator=g, device=dev)
         * d ** -0.5).to(torch.bfloat16)
    ctx = ep.EpA2AContext(mesh, "tp", e, topk, max_m)
    lay = ep.dispatch_layout(ids[me * m_loc:(me + 1) * m_loc], TP, e_loc)
    send, sid = ep._pack(ctx, tok, ids[me * m_loc:(me + 1) * m_loc], lay)
    send = send.contiguous()
    rids = plain.all_to_all_slots(mesh, sid)
    rcounts = plain.all_to_all_slots(
        mesh, torch.clamp(lay.send_counts, max=max_m))
    recv, inter = ep.pallas_dispatch_gg(mesh, send, rids, rcounts, w)
    ref_recv, ref_inter = plain.dispatch_gg_ref(mesh, send, rids, rcounts, w)
    same = []
    for _ in range(calls):
        a, b = ep.pallas_dispatch_gg(mesh, send, rids, rcounts, w)
        same.append(bool(torch.equal(a, recv) and torch.equal(b, inter)))
    held = _held(torch, "b16_decode_m32", inter, ref_inter, 1e-2)
    held["recv_bitwise"] = bool(torch.equal(recv, ref_recv))
    held["repeats_bitwise"] = same
    held["ok"] = held["ok"] and held["recv_bitwise"] and all(same)
    mask = (torch.arange(max_m, device=dev)[None, :]
            < rcounts[:, None]).reshape(-1)
    sel = torch.nonzero(mask)[:, 0]
    flat_ids = rids.reshape(-1)[sel]
    live = int(torch.unique(flat_ids).numel())
    lib_fn, how = _grouped_mm_fn(torch, mu, ref_recv[sel], flat_ids[:, None],
                                 w, e_loc)

    def lib16():
        if lib_fn is None:
            raise RuntimeError(how)
        return nccl(send), lib_fn()

    n_live = int(sel.numel())
    plan = ep.dispatch_gg_plan(rids, rcounts, e_loc)
    timed("b16_decode_m32",
          lambda: ep.launch_dispatch_gg(mesh, send, plan, w),
          lambda: plain.dispatch_gg_ref(mesh, send, rids, rcounts, w), lib16,
          (live * d * ni + TP * max_m * d * 2 + n_live * ni) * 2,
          (TP - 1) * max_m * d * 2, 2.0 * n_live * d * ni,
          {**held, "live_experts": live, "live_rows": n_live,
           "library_how": how})
    return out


def _tp4_ep(torch, dist, mesh, models, kern, gen: int = 32):
    """Qwen3-30B-A3B at its published widths (hidden 2048, 48 layers, 32 q
    / 4 kv heads, 128 experts, top-8, expert width 768) expert-parallel at
    EP=4: each rank 32 experts at full width, bf16, random weights from
    seed 0 (this rank's shard of the world-1 draw, ~15.3 GB), max_length
    1024, served on B=16 prompts of 512 tokens, 32 tokens each, prefill in
    xla (the expert slabs all-gathered a layer), each decode step one
    CUDA-graph replay, through every EP path of _TP4_EP_PATHS: triton_dist
    (B10 / B13a on the attention projections, B1; each rank its 4 rows)
    over PALLAS (B17 out and back), PALLAS_FUSED (B16, then B17) and
    PALLAS under TD_QUANT=always (B18, then B17), and Engine(model,
    params) at its defaults (the mega step: B1, B4, B3, the moe task's
    fused tier over NCCL's all-to-all) and with the mega runtime on
    PALLAS_FUSED. Each measured by _tp4_measure (the first two
    profiled); then the kernels timed on the card (_tp4_ep_kernels)."""
    arch = _ep_arch(models)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = models.init_random_params(
        torch.Generator(device=mesh.device).manual_seed(0), arch,
        mesh.device, torch.bfloat16, rank=mesh.rank, world=mesh.world)
    torch.cuda.synchronize()
    init_s, init_peak = time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated()
    param_bytes = sum(t.numel() * t.element_size() for t in
                      [*(v for k, v in params.items() if k != "layers"),
                       *params["layers"].values()])
    ids = _tp_prompt(torch, arch.vocab_size, 16, 512, 4).to(mesh.device)
    rec = {"model": MOE_MODEL, "moe_parallel": "ep", "layers":
           arch.num_layers, "ep": mesh.world, "batch": 16, "prompt": 512,
           "gen_len": gen, "dtype": "bf16",
           "param_bytes_per_card": param_bytes, "init_s": init_s,
           "init_peak_bytes": init_peak, "paths": {}}
    toks = {}
    for i, (label, ctx_kw, engine_kw, quant, mega_ep) in enumerate(
            _TP4_EP_PATHS):
        torch.cuda.empty_cache()
        if quant:
            os.environ["TD_QUANT"] = quant
        try:
            engine = _ep_engine(models, mesh, arch, params, ctx_kw,
                                engine_kw, mega_ep, 1024)
            r, toks[label] = _tp4_measure(torch, dist, kern, engine, ids,
                                          gen, i < 2)
        finally:
            os.environ.pop("TD_QUANT", None)
        r["mega_tier"] = engine.mega_tier
        rec["paths"][label] = r
        del engine
    rec["tokens_agree_vs_td_pallas"] = {
        k: (v == toks["td_pallas"]).float().mean().item()
        for k, v in toks.items()}
    del params
    torch.cuda.empty_cache()
    rec["kernels"] = _tp4_ep_kernels(torch, dist, mesh)
    return rec


def _tp4_ep_consistency(torch, dist, mesh, models, tmp, gen: int = 8):
    """The f32 gate of tp4_ep: Qwen3-30B-A3B's widths cut to 4 layers,
    expert-parallel, f32 weights from seed 7 (this rank's shard of the
    world-1 draw, the tp4_moe_consistency weights); B=16 prompts of 64
    tokens, 8 greedy tokens through every EP path of _TP4_EP_PATHS and the
    eager xla step (the experts all-gathered): rank 0 keeps them for the
    parent. The fp8 path is lossy by design: its agreement is reported,
    not gated."""
    arch = _ep_arch(models, layers=4)
    params = models.init_random_params(
        torch.Generator(device=mesh.device).manual_seed(7), arch,
        mesh.device, torch.float32, rank=mesh.rank, world=mesh.world)
    ids = _tp_prompt(torch, arch.vocab_size, 16, 64, 5)[:, :64].to(
        mesh.device)
    toks, ran = {}, {}
    for label, ctx_kw, engine_kw, quant, mega_ep in _TP4_EP_PATHS:
        if quant:
            os.environ["TD_QUANT"] = quant
        try:
            engine = _ep_engine(models, mesh, arch, params, ctx_kw,
                                engine_kw, mega_ep, 128)
            toks[label] = engine.serve(ids, gen).cpu()
        finally:
            os.environ.pop("TD_QUANT", None)
        ran[label] = {k: v for k, v in engine.graph_launches.items() if v}
        del engine
        torch.cuda.empty_cache()
    toks["eager_xla"] = _eager_greedy(torch, models.Qwen3MoE(
        arch, _ep_ctx(mesh), max_length=128, dtype=torch.float32), params,
        ids, gen).cpu()
    if mesh.rank == 0:
        torch.save(toks, os.path.join(tmp, "tp4_ep_f32.pt"))
    del params
    torch.cuda.empty_cache()
    return {"launches_per_replay": ran}


def _tp4_ep_rows(torch, models, results, extra):
    """The parent's side of tp4_ep: each path's record (launches per
    replay, replays and tokens checked on every rank), and the kernel rows
    of B16, B17 and B18 from the four cards' timings (slowest rank), their
    launches those of the EP serves."""
    ep = [results[r]["ep"] for r in range(TP)]
    L = models.QWEN3_ARCHS[MOE_MODEL].num_layers
    attn = {"pallas_ag_gemm": L, "pallas_gemm_rs": L}
    mega = {"pallas_gemm_ar": L, "fused_add_rms": L}
    wants = {
        "td_pallas": {**attn, "fast_all_to_all_per_device": 2 * L,
                      "group_gemm": 2 * L},
        "td_pallas_fused": {**attn, "pallas_dispatch_gg": L,
                            "fast_all_to_all_per_device": L,
                            "group_gemm": L},
        "td_pallas_fp8": {**attn, "fast_all_to_all_q_per_device": L,
                          "fast_all_to_all_per_device": L,
                          "group_gemm": 2 * L},
        "mega_default": {**mega, "group_gemm": 2 * L},
        "mega_pallas_fused": {**mega, "pallas_dispatch_gg": L,
                              "fast_all_to_all_per_device": L,
                              "group_gemm": L}}
    head = {k: v for k, v in ep[0].items() if k not in ("paths", "kernels")}
    for label, want_kw in wants.items():
        per = [x["paths"][label] for x in ep]
        r = {**head, **per[0], "phase": f"tp4_ep_{label}"}
        r["peak_gb_per_card"] = [x["peak_bytes"] / 1e9 for x in per]
        r["init_peak_gb_per_card"] = [x["init_peak_bytes"] / 1e9 for x in ep]
        r["decode_ms_per_step_per_rank"] = [x["decode_ms_per_step"]
                                            for x in per]
        differs = [x["own_token_differs"] for x in per]
        r.pop("own_token_differs")
        r["own_token_differs_per_rank"] = (
            None if differs[0] is None else [sum(d) for d in differs])
        want = _only(r["launches_per_replay"], flash_prefill=L, **want_kw)
        emit(r)
        bad = []
        if any(x["launches_per_replay"] != want for x in per):
            bad.append(f"{r['launches_per_replay']} per replay, want {want}")
        if any(x["graph_replays"] != r["gen_len"] - 1 for x in per):
            bad.append(f"{r['graph_replays']} replays")
        if any(x["eager_launches"] != _only(x["eager_launches"],
                                            flash_prefill=L) for x in per):
            bad.append(f"eager launches {r['eager_launches']}")
        if not all(x["tokens_same_on_every_rank"] for x in per) or \
                r["tokens_shape"] != [16, r["gen_len"]]:
            bad.append("ranks returned different tokens")
        if label.startswith("mega") and r["mega_tier"] != "pallas_chain":
            bad.append(f"mega tier {r['mega_tier']}")
        if bad:
            fail(f"EP=4 {label}: " + "; ".join(bad))
        extra[f"tp4_ep_{label}"] = r["launches"]
    rows = {}
    for name, keys, rep, call in (
            ("fast_all_to_all_per_device",
             ("b17_decode_m32", "b17_prefill_m4096"),
             "triton_dist_tpu/kernels/low_latency_all_to_all.py:38",
             "torch.distributed.all_to_all_single (NCCL)"),
            ("fast_all_to_all_q_per_device",
             ("b18_decode_m32", "b18_prefill_m4096"),
             "triton_dist_tpu/kernels/low_latency_all_to_all.py:96",
             "NCCL all_to_all_single of the fp8 rows (as bytes), then of "
             "the scales"),
            ("pallas_dispatch_gg", ("b16_decode_m32",),
             "triton_dist_tpu/kernels/ep_a2a.py:272",
             "NCCL all_to_all_single of the payload + torch._grouped_mm "
             "over the live received rows")):
        timed = {}
        for key in keys:
            rws = [x["kernels"][key] for x in ep]
            if not all(x["ok"] for x in rws):
                fail(f"{name} on four cards disagrees with its plain "
                     f"version or its repeats at {key}: {rws}")
            t = {k: max(x[k] for x in rws)
                 for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")}
            t["library_ms"] = (max(x["library_ms"] for x in rws)
                               if x_all_num(rws, "library_ms") else None)
            t["library_note"] = next((x["library_note"] for x in rws
                                      if x["library_note"]), None)
            t["bound_by"] = rws[0]["bound_by"]
            t["per_rank_ms"] = [x["ms"] for x in rws]
            timed[key] = t
        emit({"phase": f"tp4_ep_{name}", "per_rank": [
            {k: x["kernels"][k] for k in keys} for x in ep]})
        dec = {k: v for k, v in timed.items() if "decode" in k}
        row = _tp_kernel_record(name, "ep_a2a.cu", rep, dec,
                                "4 cards, EP=4")
        pre = [k for k in timed if "prefill" in k]
        if pre:
            row["prefill_shape"] = timed[pre[0]]
        row["launches_by_path"] = {
            f"tp4_ep_{label}": ep[0]["paths"][label]["launches"][name]
            for label in wants if ep[0]["paths"][label]["launches"][name]}
        row["launches"] = sum(row["launches_by_path"].values())
        row["library_ms_call"] = call
        rows[name] = row
    return rows


# -- the sequence-parallel slice: B1's fold and varlen forms, B19, B20, B21 --

SP_HEADS = (64, 8, 128)       # Qwen3-32B's attention: Hq, Hkv, D
SP_TOL_BF16 = 2e-2            # x max|ref|: bf16 outputs, bf16-rounded P
SP_TOL_F32 = 1e-4             # x max|ref|: f32, summation order only
# four cards: prefill B=1 at Qwen3-32B's native 32,768 tokens (8,192 a
# rank); decode B=4 over the YaRN-extended 131,072-token cache (32,768 a
# rank), 32 steps, page 128; the f32 gate at 4,096 tokens and 16,384 keys
SP_TP4 = {"b": 1, "t": 32768, "dec_b": 4, "cache": 131072, "steps": 32,
          "page": 128, "gate_t": 4096, "gate_cache": 16384, "timed": 2}
SP_GATE_TOL = 1e-4            # x max(1, max|ref|): the f32 four-card gate
_SRC = "triton_dist_tpu_torch/csrc/"
SP_PREFILL_TIERS = (("xla", "contiguous"), ("xla_ring", "contiguous"),
                    ("flash_ring", "contiguous"), ("flash_ring", "zigzag"),
                    ("xla_ring", "zigzag"), ("xla_block", "contiguous"),
                    ("pallas", "contiguous"))


def _sp_rand(torch, g, shape, dt, device=DEV):
    return torch.randn(shape, generator=g, device=device).to(dt)


def _held_triple(torch, name, got, ref, tol):
    """An unnormalized (acc, m, l) against the plain version's: the rows
    acc / l within tol x max|ref| (as _held), log l + m within 1e-3 on
    the rows with a live key, and the rows without one (0, -1e30, 0) on
    both sides."""
    acc, m, l = (x.float() for x in got)
    racc, rm, rl = (x.float() for x in ref)
    row = _held(torch, name, acc / torch.clamp_min(l, 1e-30)[..., None],
                racc / torch.clamp_min(rl, 1e-30)[..., None], tol)
    live = rl > 0
    lse = (m + torch.log(torch.clamp_min(l, 1e-30))
           - rm - torch.log(torch.clamp_min(rl, 1e-30)))
    lse_err = lse[live].abs().max().item() if bool(live.any()) else 0.0
    dead = ~live
    dead_ok = bool((l[dead] == 0).all() and (acc[dead] == 0).all()
                   and (m[dead] <= -1e29).all())
    row.update(lse_err=lse_err, dead_rows=int(dead.sum()),
               ok=row["ok"] and lse_err <= 1e-3 and dead_ok)
    return row


def _sp_row(name, source, replaces, rows, timed, measured_on, **extra):
    """A kernels-line row of the slice (one card): timed = {case: {ms,
    plain_ms, library_ms, bound_ms, bound_by, ...}}, the first case the
    row's numbers."""
    main = next(iter(timed.values()))
    return {"name": name, "route": "cuda", "source": _SRC + source,
            "replaces": replaces,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "launches": None,
            "measured_on": measured_on, "shapes": timed, **extra}


def _sdpa(torch, q, k, v, mask=None):
    """One scaled_dot_product_attention of (B, T, H, D) tensors: GQA
    through enable_gqa without a mask; with a bool mask the kv heads are
    repeated and the memory-efficient backend is asked for, which takes a
    mask without materializing the scores."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    if mask is None:
        return sdpa(qh, kh, vh, enable_gqa=True)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    g = qh.shape[1] // kh.shape[1]
    kh, vh = kh.repeat_interleave(g, 1), vh.repeat_interleave(g, 1)
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]):
        return sdpa(qh, kh, vh, attn_mask=mask)


def _sdpa_causal_offset(torch, q, k, v, live: int):
    """One scaled_dot_product_attention of (B, T, H, D) tensors, causal
    with an offset: q's T queries sit at the last T positions of the
    live keys k[:, :live], where causal_lower_right puts its diagonal
    (the flash backend takes it; GQA through enable_gqa). As (B, H, T, D)."""
    from torch.nn.attention.bias import causal_lower_right
    qh = q.transpose(1, 2)
    kh, vh = k[:, :live].transpose(1, 2), v[:, :live].transpose(1, 2)
    return torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=causal_lower_right(qh.shape[2], kh.shape[2]),
        enable_gqa=True)


def _library(torch, fn, **kw):
    """(ms of fn, None), or (None, the error) where the card's backends
    refuse the call."""
    try:
        return time_ms(fn, **kw), None
    except RuntimeError as exc:
        torch.cuda.synchronize()
        return None, str(exc).splitlines()[0][:200]


def phase_b1_fold(torch, fa):
    """B1's fold form (flash_fold_partial: the unnormalized (acc, m, l)
    of q against one key chunk whose origin is k_start) and its varlen
    form (flash_prefill with cu_seqlens), against their plain versions,
    at Qwen3-32B's heads (Hq 64, Hkv 8, D 128) and bf16: 2,048 queries
    against a 2,048-key chunk at k_start 0 (the diagonal chunk of a ring)
    and at k_start 2,048 with q_start 4,096 (a whole chunk), the starts
    also as device tensors, a chunk partly and one wholly in the future;
    the varlen form over 2,048 rows in 3 segments; D=64 at g = 8 (a fold
    with segments, a varlen with an offset); f32 cases with segments and
    a chunk wholly in the future. Tolerances:
    SP_TOL_BF16 / SP_TOL_F32 x max|ref| on acc / l, 1e-3 on log l + m.
    Timed: the whole chunk (fold) and the 3 segments (varlen) against the
    plain versions and SDPA (the fold: SDPA over the chunk, which returns
    the normalized rows; the varlen form: SDPA with the block-causal
    mask)."""
    hq, hkv, d = SP_HEADS
    g = torch.Generator(device=DEV).manual_seed(101)
    t = 2048
    q = _sp_rand(torch, g, (1, t, hq, d), torch.bfloat16)
    k = _sp_rand(torch, g, (1, t, hkv, d), torch.bfloat16)
    v = _sp_rand(torch, g, (1, t, hkv, d), torch.bfloat16)
    i32 = dict(dtype=torch.int32, device=DEV)
    rows = []
    for name, qs, ks in (("fold_k0", 0, 0), ("fold_k2048", 4096, 2048),
                         ("fold_k2048_device_starts",
                          torch.tensor(4096, **i32),
                          torch.tensor(2048, **i32))):
        got = fa.flash_fold_partial(q, k, v, qs, ks)
        ref = fa.flash_fold_partial_ref(q, k, v, qs, ks)
        rows.append(_held_triple(torch, name, got, ref, SP_TOL_BF16))
    cu = torch.tensor([0, 700, 1500, t], **i32)
    rows.append(_held(torch, "varlen_3seg",
                      fa.flash_prefill(q, k, v, 0, cu_seqlens=cu),
                      fa.flash_prefill_ref(q, k, v, 0, cu), SP_TOL_BF16))
    # bf16 chunks partly in the future (queries before k_start have no
    # live key: (0, NEG_INF, 0) rows beside live ones) and wholly in it
    for name, qs, ks in (("fold_partly_future", 0, 1000),
                         ("fold_wholly_future", 0, 2048)):
        rows.append(_held_triple(
            torch, name, fa.flash_fold_partial(q, k, v, qs, ks),
            fa.flash_fold_partial_ref(q, k, v, qs, ks), SP_TOL_BF16))
    # D = 64, g = 8, ragged lengths: a fold with segments and a varlen
    q64 = _sp_rand(torch, g, (2, 300, 16, 64), torch.bfloat16)
    k64 = _sp_rand(torch, g, (2, 333, 2, 64), torch.bfloat16)
    v64 = _sp_rand(torch, g, (2, 333, 2, 64), torch.bfloat16)
    cu64 = torch.tensor([0, 90, 260, 633], **i32)
    rows.append(_held_triple(
        torch, "fold_d64_segments",
        fa.flash_fold_partial(q64, k64, v64, 333, 0, cu_seqlens=cu64),
        fa.flash_fold_partial_ref(q64, k64, v64, 333, 0, cu64), SP_TOL_BF16))
    rows.append(_held(torch, "varlen_d64_offset33",
                      fa.flash_prefill(q64, k64, v64, 33, cu_seqlens=cu64),
                      fa.flash_prefill_ref(q64, k64, v64, 33, cu64),
                      SP_TOL_BF16))
    qf = _sp_rand(torch, g, (2, 200, 8, d), torch.float32)
    kf = _sp_rand(torch, g, (2, 300, 2, d), torch.float32)
    vf = _sp_rand(torch, g, (2, 300, 2, d), torch.float32)
    cuf = torch.tensor([0, 90, 260, 500], **i32)
    for name, qs, ks, c in (("f32_fold_segments", 300, 0, cuf),
                            ("f32_fold_future", 100, 400, None),
                            ("f32_fold_ragged", 250, 100, None)):
        rows.append(_held_triple(
            torch, name, fa.flash_fold_partial(qf, kf, vf, qs, ks,
                                               cu_seqlens=c),
            fa.flash_fold_partial_ref(qf, kf, vf, qs, ks, c), SP_TOL_F32))
    rows.append(_held(torch, "f32_varlen_offset",
                      fa.flash_prefill(qf, kf, vf, 100, cu_seqlens=cuf),
                      fa.flash_prefill_ref(qf, kf, vf, 100, cuf),
                      SP_TOL_F32))
    torch.cuda.synchronize()
    emit({"phase": "b1_fold", "cases": rows})
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        fail(f"B1's fold / varlen forms disagree with their plain "
             f"versions: {bad}")

    io = (q.numel() + k.numel() + v.numel()) * 2
    stats = t * hq * (d + 2) * 4
    fold = {"ms": time_ms(lambda: fa.flash_fold_partial(q, k, v, 4096, 2048),
                          iters=10),
            "plain_ms": time_ms(lambda: fa.flash_fold_partial_ref(
                q, k, v, 4096, 2048), iters=2, warmup=1)}
    fold["library_ms"], fold["library_note"] = _library(
        torch, lambda: _sdpa(torch, q, k, v), iters=5, warmup=1)
    fold["graph_ms"] = graph_time_ms(
        lambda: fa.flash_fold_partial(q, k, v, 4096, 2048), 10)
    fold["library_graph_ms"] = graph_or_none(
        torch, lambda: _sdpa(torch, q, k, v))
    fold["bound_ms"], fold["bound_by"] = bound_ms(io + stats,
                                                  4.0 * t * t * hq * d)
    seg = [700, 800, t - 1500]
    mask = torch.zeros((t, t), dtype=torch.bool, device=DEV)
    lo = 0
    for n_ in seg:
        mask[lo:lo + n_, lo:lo + n_] = torch.ones(
            (n_, n_), dtype=torch.bool, device=DEV).tril()
        lo += n_
    var = {"ms": time_ms(lambda: fa.flash_prefill(q, k, v, 0,
                                                  cu_seqlens=cu), iters=10),
           "plain_ms": time_ms(lambda: fa.flash_prefill_ref(q, k, v, 0, cu),
                               iters=2, warmup=1)}
    var["library_ms"], var["library_note"] = _library(
        torch, lambda: _sdpa(torch, q, k, v, mask), iters=5, warmup=1)
    var["graph_ms"] = graph_time_ms(
        lambda: fa.flash_prefill(q, k, v, 0, cu_seqlens=cu), 10)
    pairs = sum(n_ * (n_ + 1) // 2 for n_ in seg)
    var["bound_ms"], var["bound_by"] = bound_ms(io + q.numel() * 2,
                                                4.0 * pairs * hq * d)
    shape = {"q": [1, t, hq, d], "chunk": [1, t, hkv, d], "dtype": "bf16"}
    fold_row = _sp_row(
        "flash_fold_partial", "flash_prefill.cu",
        "triton_dist_tpu/kernels/flash_attention.py:63",
        [r for r in rows if "fold" in r["case"]],
        {"chunk_k2048_q4096": {**fold, **shape}}, "one card",
        library_ms_call="scaled_dot_product_attention over the chunk "
                        "(normalized rows, enable_gqa)",
        instructions=B1_INSTRUCTIONS)
    var_row = _sp_row(
        "flash_prefill_varlen", "flash_prefill.cu",
        "triton_dist_tpu/kernels/flash_attention.py:63",
        [r for r in rows if "varlen" in r["case"]],
        {"segments_700_800_548": {**var, **shape}}, "one card",
        library_ms_call="scaled_dot_product_attention with the "
                        "block-causal bool mask (enable_gqa)",
        instructions=B1_INSTRUCTIONS)
    return fold_row, var_row


def phase_b19(torch, fa):
    """B19 (flash_decode_partial: the split-KV partial of one decode step
    over a dense shard) against its plain version at the sequence-parallel
    decode shape: B=4, S_loc = 32,768 (rank 3 of the 131,072-token cache),
    Qwen3-32B's heads, bf16, the positions device tensors: the whole shard
    live, a partly live shard, an empty shard (start past q_pos: (0,
    -1e30, 0)); the head-major layout; f32 at S_loc 1,000 (1,000 % 128 !=
    0). Then the bf16 form's cases (_b19_cases): g = 1, 2, 4 and 8 at D
    128 and 64, an S_loc that is no multiple of a tile with the horizon
    inside a tile, a split wholly in the future, strided key-range views
    of a larger shard in both layouts, and one call captured in a CUDA
    graph replayed at two q_pos values. The split-KV merge differs from
    the sequential fold by rounding: SP_TOL_BF16 / SP_TOL_F32 x max|ref| on
    acc / l, 1e-3 on log l + m. Timed at the whole live shard (S_loc
    32,768, and a short shard of 4,096) against the plain version and
    SDPA at T=1 over the same keys (head-major, enable_gqa)."""
    hq, hkv, d = SP_HEADS
    b, s_loc = 4, 32768
    g = torch.Generator(device=DEV).manual_seed(102)
    q = _sp_rand(torch, g, (b, hq, d), torch.bfloat16)
    k = _sp_rand(torch, g, (b, s_loc, hkv, d), torch.bfloat16)
    v = _sp_rand(torch, g, (b, s_loc, hkv, d), torch.bfloat16)
    i32 = dict(dtype=torch.int32, device=DEV)
    start = torch.tensor(3 * s_loc, **i32)
    rows = []
    for name, qp in (("whole_shard", 4 * s_loc - 1),
                     ("partial_shard", 3 * s_loc + 10000),
                     ("empty_shard", 3 * s_loc - 1)):
        qp = torch.tensor(qp, **i32)
        rows.append(_held_triple(
            torch, name, fa.flash_decode_partial(q, k, v, start, qp),
            fa.flash_decode_partial_ref(q, k, v, start, qp), SP_TOL_BF16))
    kh, vh = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    qp = torch.tensor(3 * s_loc + 20000, **i32)
    rows.append(_held_triple(
        torch, "head_major",
        fa.flash_decode_partial(q, kh, vh, start, qp, head_major=True),
        fa.flash_decode_partial_ref(q, k, v, start, qp), SP_TOL_BF16))
    qf = _sp_rand(torch, g, (2, 16, d), torch.float32)
    kf = _sp_rand(torch, g, (2, 1000, 4, d), torch.float32)
    vf = _sp_rand(torch, g, (2, 1000, 4, d), torch.float32)
    rows.append(_held_triple(
        torch, "f32_ragged", fa.flash_decode_partial(qf, kf, vf, 500, 1300),
        fa.flash_decode_partial_ref(qf, kf, vf, 500, 1300), SP_TOL_F32))
    rows += _b19_cases(torch, fa, g)
    torch.cuda.synchronize()
    emit({"phase": "b19_flash_decode_partial", "cases": rows})
    bad = [r["case"] for r in rows if not r["ok"]]
    if bad:
        fail(f"B19 disagrees with its plain version: {bad}")
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = {}
    for s_len in (s_loc, 4096):
        ks, vs = k[:, :s_len].contiguous(), v[:, :s_len].contiguous()
        khs, vhs = kh[:, :, :s_len].contiguous(), vh[:, :, :s_len].contiguous()
        st = torch.tensor(3 * s_len, **i32)
        qp = torch.tensor(4 * s_len - 1, **i32)
        rec = {"ms": time_ms(lambda: fa.flash_decode_partial(q, ks, vs, st,
                                                             qp)),
               "graph_ms": graph_time_ms(lambda: fa.flash_decode_partial(
                   q, ks, vs, st, qp)),
               "plain_ms": time_ms(lambda: fa.flash_decode_partial_ref(
                   q, ks, vs, st, qp), iters=2, warmup=1)}
        q4 = q[:, :, None]
        rec["library_ms"] = time_ms(lambda: sdpa(q4, khs, vhs,
                                                 enable_gqa=True))
        nbytes = (ks.numel() + vs.numel() + q.numel()) * 2 + \
            b * hq * (d + 2) * 4
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            nbytes, 4.0 * b * hq * s_len * d)
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        plan = fa.decode_plan(s_len, b * hkv, sms, torch.bfloat16)
        rec.update(shape=[b, s_len, hq, hkv, d], dtype="bf16",
                   kv_bytes=(ks.numel() + vs.numel()) * 2,
                   plan={"chunk": plan.chunk, "splits": plan.splits,
                         "tile": plan.tile, "stages": plan.stages})
        timed[f"s_loc{s_len}_b4"] = rec
        del ks, vs, khs, vhs
    return _sp_row("flash_decode_partial", "flash_decode.cu",
                   "triton_dist_tpu/kernels/flash_attention.py:269", rows,
                   timed, "one card",
                   library_ms_call="scaled_dot_product_attention at T=1 "
                                   "over the head-major keys (enable_gqa)")


def _b19_cases(torch, fa, g):
    """B19's bf16 form beyond the SP shape, each held to the plain version
    (SP_TOL_BF16): B=2, S_loc 3,000 (no multiple of the 64-key tile or the
    128-key split unit) at g = 1, 2, 4, 8 (Hq 8, 16, 32, 64 over Hkv 8) and
    D 128 and 64, the horizon inside a tile (q_pos - start = 2,899), and
    at g = 8 the whole shard live (its last tile past S_loc); a
    horizon at the first key of a tile and a split wholly in the future
    (the horizon 200 keys in, on a card of many splits); strided key-range
    views (keys [1,000, 4,000) of a 6,000-key shard, both layouts, no
    copy); one call captured in a CUDA graph and replayed at two q_pos
    values written into its device tensor."""
    i32 = dict(dtype=torch.int32, device=DEV)
    bf = torch.bfloat16
    rows = []

    def case(name, q, k, v, start, qpos, head_major=False):
        st, qp = torch.tensor(start, **i32), torch.tensor(qpos, **i32)
        kr = k if not head_major else k.transpose(1, 2)
        vr = v if not head_major else v.transpose(1, 2)
        rows.append(_held_triple(
            torch, name,
            fa.flash_decode_partial(q, k, v, st, qp, head_major=head_major),
            fa.flash_decode_partial_ref(q, kr, vr, st, qp), SP_TOL_BF16))

    for d in (128, 64):
        for gq in (1, 2, 4, 8):
            q = _sp_rand(torch, g, (2, 8 * gq, d), bf)
            k = _sp_rand(torch, g, (2, 3000, 8, d), bf)
            v = _sp_rand(torch, g, (2, 3000, 8, d), bf)
            case(f"g{gq}_d{d}_s3000", q, k, v, 100, 2999)
        case(f"g8_d{d}_s3000_whole", q, k, v, 0, 5000)
    q = _sp_rand(torch, g, (1, 64, 128), bf)
    k = _sp_rand(torch, g, (1, 32768, 8, 128), bf)
    v = _sp_rand(torch, g, (1, 32768, 8, 128), bf)
    case("horizon_at_tile_start", q, k, v, 0, 4096)
    case("splits_in_future", q, k, v, 0, 199)
    big_k = _sp_rand(torch, g, (2, 6000, 8, 128), bf)
    big_v = _sp_rand(torch, g, (2, 6000, 8, 128), bf)
    q = _sp_rand(torch, g, (2, 32, 128), bf)
    case("key_range_view", q, big_k[:, 1000:4000], big_v[:, 1000:4000], 500,
         3000)
    hm_k, hm_v = big_k.transpose(1, 2).contiguous(), \
        big_v.transpose(1, 2).contiguous()
    case("key_range_view_head_major", q, hm_k[:, :, 1000:4000],
         hm_v[:, :, 1000:4000], 500, 3000, head_major=True)
    # one call in a graph, replayed at two q_pos values
    st = torch.tensor(0, **i32)
    qp = torch.tensor(0, **i32)
    kv_k, kv_v = big_k[:, :4096].contiguous(), big_v[:, :4096].contiguous()
    fa.flash_decode_partial(q, kv_k, kv_v, st, qp)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_decode_partial(q, kv_k, kv_v, st, qp)
    for pos in (1234, 4095):
        qp.fill_(pos)
        graph.replay()
        torch.cuda.synchronize()
        rows.append(_held_triple(
            torch, f"graph_replay_q_pos{pos}", [x.clone() for x in out],
            fa.flash_decode_partial_ref(q, kv_k, kv_v, st, qp),
            SP_TOL_BF16))
    del graph
    return rows


def phase_b20(torch, symm, fd, calls: int = 5):
    """B20 (pallas_combine_per_device: the cross-rank LSE merge of every
    rank's (acc, m, l)) against its plain version (lse_merge /
    lse_partial_merge over the ranks' triples stacked in rank order) in
    the one-card world: B.Hq = 256 rows (B=4, Hq 64), D 128, f32, at
    comm_blocks 1 and 4, normalized and partial, one rank empty (m =
    -1e30, l = 0) in half the cases; then `calls` successive calls with
    fresh triples. Every rank's output within 1e-5 x max|ref| (the merge
    is the same f32 arithmetic in slot order). Timed: the four ranks'
    calls together against the plain version and 4 x (stack + merge)."""
    world = symm.OneCardWorld(TP)
    b, hq, d = 4, SP_HEADS[0], SP_HEADS[2]
    g = torch.Generator(device=DEV).manual_seed(103)

    def draw(empty=None):
        accs, ms, ls = [], [], []
        for r in range(TP):
            acc = torch.randn((b, hq, d), generator=g, device=DEV)
            m = torch.randn((b, hq), generator=g, device=DEV) * 3
            l = torch.rand((b, hq), generator=g, device=DEV) + 0.5
            if r == empty:
                acc, m, l = acc * 0, torch.full_like(m, -1e30), l * 0
            accs.append(acc)
            ms.append(m)
            ls.append(l)
        return accs, ms, ls

    def run(tri, cb, partial):
        return world.run(lambda r: fd.pallas_combine_per_device(
            world.mesh(r), tri[0][r], tri[1][r], tri[2][r],
            partial=partial, comm_blocks=cb))

    def check(name, tri, cb, partial):
        stacked = [torch.stack(x) for x in tri]
        ref = fd.lse_partial_merge(*stacked) if partial else \
            fd.lse_merge(*stacked)
        outs = run(tri, cb, partial)
        torch.cuda.synchronize()
        res = []
        for r, o in enumerate(outs):
            if partial:
                row = _held(torch, f"{name}/rank{r}", o[0], ref[0], 1e-5)
                row["ok"] = row["ok"] and bool(
                    torch.allclose(o[1], ref[1], rtol=0, atol=1e-6)
                    and torch.allclose(o[2], ref[2], rtol=1e-5, atol=1e-6))
            else:
                row = _held(torch, f"{name}/rank{r}", o, ref, 1e-5)
            res.append(row)
        return res

    fd.lse_merge(*(torch.stack(x) for x in draw()))   # load the torch ops
    rows = []
    for cb in (1, 4):
        for partial in (False, True):
            for empty in (None, 2):
                rows += check(f"cb{cb}/{'partial' if partial else 'out'}"
                              f"/{'empty2' if empty is not None else 'all'}",
                              draw(empty), cb, partial)
    seq_ok = [all(x["ok"] for x in check("seq", draw(), 4, False))
              for _ in range(calls)]
    emit({"phase": "b20_decode_combine", "world": "one card, 4 logical ranks",
          "cases": rows, "successive_calls_ok": seq_ok})
    if not all(x["ok"] for x in rows) or not all(seq_ok):
        fail(f"B20 disagrees with its plain version: "
             f"{[x['case'] for x in rows if not x['ok']]}; successive "
             f"{seq_ok}")
    tri = draw()
    stacked = [torch.stack(x) for x in tri]
    timed = {}
    for cb in (4, 1):
        ms, host_s, covered = queued_ms(torch, lambda: run(tri, cb, False))
        plain_ms, _, _ = queued_ms(torch, lambda: fd.lse_merge(
            *(torch.stack(x) for x in tri)))
        lib_ms, _, _ = queued_ms(torch, lambda: [fd.lse_merge(*stacked)
                                                 for _ in range(TP)])
        nbytes = TP * (TP * b * hq * (d + 2) + b * hq * d) * 4
        bms, by = bound_ms(nbytes, 0.0)
        timed[f"cb{cb}"] = {"ms": ms, "plain_ms": plain_ms,
                            "library_ms": lib_ms, "bound_ms": bms,
                            "bound_by": by, "bytes": nbytes,
                            "host_enqueue_s": host_s,
                            "queued_ahead": covered,
                            "rows": b * hq, "d": d}
    return _sp_row("pallas_combine_per_device", "flash_decode.cu",
                   "triton_dist_tpu/kernels/flash_decode.py:207", rows,
                   timed, "one card, 4 logical ranks",
                   library_ms_call="4 x (torch.stack + lse_merge) of the "
                                   "ranks' triples (the all-gather is "
                                   "NCCL's on four cards: tp4_sp)")


# what B21 runs on (csrc/sp_attention.cu)
B21_INSTRUCTIONS = ("bf16: wgmma m64n128k16 QK^T and m64n64k16 P.V (P in "
                    "registers) over tiles of 128 GQA-packed rows, 128-key "
                    "K/V tiles by TMA through 5-D maps of the local shard or "
                    "a landing slot in a 2-stage mbarrier ring, a persistent "
                    "grid (ring_plan), setmaxnreg 40 / 232; each shard "
                    "pushed to every peer in one hop, a flag per (sender, "
                    "comm block); f32: FMA")


def _nan_slots(torch, sp, mesh, b, t_loc, hkv, d, dt, comm_blocks):
    """Makes B21's workspace of this shape on this rank (it must not exist
    yet) and fills its K and V landing slots of both parities with NaN
    (0xFF bytes: NaN in bf16 and f32), as memory no call wrote may hold.
    The flags stay 0."""
    nblk = sp.legal_attn_blocks(t_loc, comm_blocks, mesh.world)
    ws, _, flag_off = sp._ring_workspace(mesh, b, t_loc, hkv, d, dt, nblk)
    ws.buf.tensor[:flag_off].fill_(255)


def phase_b21(torch, symm, sp, plain, calls: int = 2):
    """B21 (pallas_ring_attn_per_device: the fused causal GQA ring
    attention) against its plain version (XLA_BLOCK's fold over every
    rank's shards, sp_ag_attention.ring_attn_shards_ref) in the one-card
    world: 8,192 tokens (2,048 a rank), Qwen3-32B's heads, bf16, B=1, at
    comm_blocks 1 and 4 (SP_TOL_BF16 x max|ref|); bf16 at 600 rows a rank
    (comm blocks of 150 and 200 rows: no multiple of the 128-key step)
    and at 300 rows a rank, comm_blocks 4 (blocks of 75 rows, shorter
    than one key step), at D 128 and then D 64, each shape's landing
    slots NaN-filled before its first call, then `calls` + 1 successive
    calls on new draws (the slots' parity alternating); f32 at 256 rows
    a rank, B=2, comm_blocks 4 (SP_TOL_F32), then `calls` successive f32
    calls, then f32 at D 64 (each head dim's kernel after the other's in
    one process). Timed at comm_blocks 4: the four ranks' calls
    together against the plain version, the XLA tier's torch.cat of the
    shards + SDPA with the causal mask at each rank's offset, and B1's
    prefill form on the same work (each rank's queries against the
    gathered keys at its offset), held against its plain version."""
    from triton_dist_tpu_torch.kernels import flash_attention as fa
    world = symm.OneCardWorld(TP)
    hq, hkv, d = SP_HEADS
    g = torch.Generator(device=DEV).manual_seed(104)

    def draw(b, t_loc, dt, dd=d):
        return ([_sp_rand(torch, g, (b, t_loc, hq, dd), dt)
                 for _ in range(TP)],
                [_sp_rand(torch, g, (b, t_loc, hkv, dd), dt)
                 for _ in range(TP)],
                [_sp_rand(torch, g, (b, t_loc, hkv, dd), dt)
                 for _ in range(TP)])

    def run(qs, ks, vs, cb):
        return world.run(lambda r: sp.pallas_ring_attn_per_device(
            world.mesh(r), qs[r], ks[r], vs[r], cb))

    def ref(qkv, r, cb):
        return plain.ring_attn_shards_ref(
            qkv[0][r], qkv[1], qkv[2], r,
            sp.legal_attn_blocks(qkv[0][r].shape[1], cb, TP))

    def check(name, qkv, cb, tol):
        outs = run(*qkv, cb)
        torch.cuda.synchronize()
        return [_held(torch, f"{name}/rank{r}", o, ref(qkv, r, cb), tol)
                for r, o in enumerate(outs)]

    big = draw(1, 2048, torch.bfloat16)
    rows = []
    for cb in (1, 4):
        rows += check(f"bf16_t8192_cb{cb}", big, cb, SP_TOL_BF16)
    # ragged comm blocks over NaN-filled slots, then both parities
    ragged_ok = []
    for t_loc, cb, dd in ((600, 4, d), (600, 3, d), (300, 4, d),
                          (300, 4, 64)):
        for r in range(TP):
            _nan_slots(torch, sp, world.mesh(r), 1, t_loc, hkv, dd,
                       torch.bfloat16, cb)
        for call in range(calls + 1):
            got = check(f"bf16_d{dd}_t{t_loc * TP}_cb{cb}_call{call}",
                        draw(1, t_loc, torch.bfloat16, dd), cb, SP_TOL_BF16)
            rows += got
            ragged_ok.append(all(x["ok"] for x in got))
    rows += check("f32_t1024_b2_cb4", draw(2, 256, torch.float32), 4,
                  SP_TOL_F32)
    seq_ok = [all(x["ok"] for x in check(
        "seq", draw(2, 256, torch.float32), 4, SP_TOL_F32))
        for _ in range(calls)]
    rows += check("f32_d64_t1024_b2_cb4", draw(2, 256, torch.float32, 64),
                  4, SP_TOL_F32)
    emit({"phase": "b21_ring_attn", "world": "one card, 4 logical ranks",
          "cases": rows, "successive_calls_ok": seq_ok,
          "ragged_nan_slots_parities_ok": ragged_ok})
    if not all(x["ok"] for x in rows) or not all(seq_ok):
        fail(f"B21 disagrees with its plain version: "
             f"{[x['case'] for x in rows if not x['ok']]}; successive "
             f"{seq_ok}")
    qs, ks, vs = big
    t_loc, t = 2048, 2048 * TP
    ms, host_s, covered = queued_ms(torch, lambda: run(qs, ks, vs, 4),
                                    iters=3, warm=1)
    plain_ms = time_ms(lambda: [ref(big, r, 4) for r in range(TP)],
                       iters=1, warmup=1)
    pos = torch.arange(t, device=DEV)
    masks = [pos[None, :] <= (r * t_loc + torch.arange(t_loc, device=DEV))
             [:, None] for r in range(TP)]
    k_all, v_all = torch.cat(ks, dim=1), torch.cat(vs, dim=1)
    lib_ms, note = _library(torch, lambda: [
        _sdpa(torch, qs[r], torch.cat(ks, dim=1), torch.cat(vs, dim=1),
              masks[r]) for r in range(TP)], iters=3, warmup=1)
    pairs = t * (t + 1) // 2
    nbytes = 2 * (2 * t * hq * d + 2 * t * hkv * d)
    bms, by = bound_ms(nbytes, 4.0 * pairs * hq * d)
    # B1's prefill form on the same work, beside it
    b1_rows = [_held(torch, f"b1_prefill_rank{r}", fa.flash_prefill(
        qs[r], k_all, v_all, r * t_loc), fa.flash_prefill_ref(
        qs[r], k_all, v_all, r * t_loc), SP_TOL_BF16) for r in range(TP)]
    b1_ms = time_ms(lambda: [fa.flash_prefill(qs[r], k_all, v_all,
                                              r * t_loc)
                             for r in range(TP)], iters=3, warmup=1)
    emit({"phase": "b21_ring_attn", "b1_prefill_same_work": b1_rows,
          "b1_ms": b1_ms, "b21_ms": ms})
    if not all(x["ok"] for x in b1_rows):
        fail("B1's prefill form disagrees with its plain version on B21's "
             "work")
    timed = {"t8192_cb4": {"ms": ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms, "library_note": note,
                           "bound_ms": bms, "bound_by": by,
                           "host_enqueue_s": host_s,
                           "queued_ahead": covered,
                           "b1_prefill_same_work_ms": b1_ms,
                           "shape": [1, t_loc, hq, hkv, d], "dtype": "bf16"}}
    return _sp_row("pallas_ring_attn_per_device", "sp_attention.cu",
                   "triton_dist_tpu/kernels/sp_ag_attention.py:614", rows,
                   timed, "one card, 4 logical ranks",
                   instructions=B21_INSTRUCTIONS,
                   library_ms_call="torch.cat of the K/V shards + "
                                   "scaled_dot_product_attention with the "
                                   "causal mask at each rank's offset")


def _dense_ref(torch, q, k, v, q_start=0):
    """One card's dense causal GQA attention in f32: q (B, Tq, Hq, D) at
    positions q_start + i over all keys (B, S, Hkv, D). Row chunks keep
    the scores under 2 GiB."""
    b, tq, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    outs = []
    rows = max(1, (1 << 31) // (b * hq * s * 4))
    for r0 in range(0, tq, rows):
        qc = q[:, r0:r0 + rows].float().transpose(1, 2)
        sc = torch.matmul(qc, kf.transpose(-1, -2)) * d ** -0.5
        qpos = q_start + r0 + torch.arange(qc.shape[2], device=q.device)
        mask = torch.arange(s, device=q.device)[None, :] <= qpos[:, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        outs.append(torch.matmul(torch.softmax(sc, -1), vf).transpose(1, 2))
        del sc
    return torch.cat(outs, dim=1)


def _paged_of(torch, k, page):
    """A dense shard (B, S_loc, Hkv, D) as a page pool (Hkv, B S_loc /
    page, page, D), sequence b's pages b * S_loc / page onwards, with its
    block table (B, S_loc / page) int32."""
    b, s_loc, hkv, d = k.shape
    pool = k.permute(2, 0, 1, 3).reshape(hkv, b * s_loc // page, page,
                                         d).contiguous()
    table = torch.arange(b * s_loc // page, dtype=torch.int32,
                         device=k.device).reshape(b, -1)
    return pool, table


def phase_sp_layer(torch, kern, symm):
    """The slice's main path on one card, through SpGQAFlashDecodeAttention
    at Qwen3-32B's heads, bf16, the counts zeroed just before each path and
    read just after. World 1 (make_comm_mesh without a process group):
    prefill of 4,096 tokens under FLASH_RING (B1's fold form) and under XLA
    with 3 packed segments (B1's varlen form); then decode (B=4 over a
    16,384-key cache, combine PALLAS) captured in ONE CUDA graph (B19 +
    B20 at world 1, the offset advanced on the card) and replayed 8 times,
    each replay equal to the eager step at its offset. The one-card world
    (four logical ranks, 1,024 tokens and a 4,096-key shard each): prefill
    under PALLAS (B21), decode under combine PALLAS (B19 + B20) and
    decode_paged (page 128: B2 + B20). Every output against one card's
    dense attention within SP_TOL_BF16 x max|ref|; every kernel of the
    slice launched."""
    from triton_dist_tpu_torch.kernels.flash_decode import FlashDecodeCombine
    from triton_dist_tpu_torch.kernels.sp_ag_attention import SpAttnMethod
    from triton_dist_tpu_torch.layers import SpGQAFlashDecodeAttention
    from triton_dist_tpu_torch.runtime.mesh import make_comm_mesh
    hq, hkv, d = SP_HEADS
    t, b_dec, cache = 4096, 4, 16384
    g = torch.Generator(device=DEV).manual_seed(105)
    bf = torch.bfloat16
    q = _sp_rand(torch, g, (1, t, hq, d), bf)
    k = _sp_rand(torch, g, (1, t, hkv, d), bf)
    v = _sp_rand(torch, g, (1, t, hkv, d), bf)
    qd = _sp_rand(torch, g, (b_dec, hq, d), bf)
    kc = _sp_rand(torch, g, (b_dec, cache, hkv, d), bf)
    vc = _sp_rand(torch, g, (b_dec, cache, hkv, d), bf)
    i32 = dict(dtype=torch.int32, device=DEV)
    dense = _dense_ref(torch, q, k, v)
    cu = torch.tensor([0, 1000, 2500, t], **i32)
    rows, by_path = [], {}
    mesh1 = make_comm_mesh()
    create = SpGQAFlashDecodeAttention.create

    kern.reset_launch_counts()
    out = create(mesh1, axis="tp", prefill=SpAttnMethod.FLASH_RING).prefill(
        q, k, v)
    torch.cuda.synchronize()
    by_path["sp_world1_flash_ring"] = kern.launch_counts()
    rows.append(_held(torch, "world1_flash_ring", out, dense, SP_TOL_BF16))
    ref_v = torch.cat([_dense_ref(torch, q[:, a:b_], k[:, a:b_], v[:, a:b_])
                       for a, b_ in ((0, 1000), (1000, 2500), (2500, t))],
                      dim=1)
    kern.reset_launch_counts()
    out = create(mesh1, axis="tp", prefill=SpAttnMethod.XLA).prefill(
        q, k, v, cu_seqlens=cu)
    torch.cuda.synchronize()
    by_path["sp_world1_xla_varlen"] = kern.launch_counts()
    rows.append(_held(torch, "world1_xla_varlen", out, ref_v, SP_TOL_BF16))
    del dense, ref_v

    # world-1 decode, one CUDA graph a step, the offset on the card
    layer = create(mesh1, axis="tp", combine=FlashDecodeCombine.PALLAS)
    off0, steps = cache - 16, 8
    off = torch.full((), off0, **i32)
    layer.decode(qd, kc, vc, off)                 # warm-up: workspaces
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    kern.reset_launch_counts()
    with torch.cuda.graph(graph):
        out_g = layer.decode(qd, kc, vc, off)
        off.add_(1)
    per_replay = kern.launch_counts()
    off.fill_(off0)
    graph_ok = []
    for i in range(steps):
        graph.replay()
        eager = layer.decode(qd, kc, vc, off0 + i)
        torch.cuda.synchronize()
        graph_ok.append(bool(torch.equal(out_g, eager)))
    by_path["sp_world1_decode_graph"] = {
        key: n * steps for key, n in per_replay.items()}
    dec_ref = _dense_ref(torch, qd[:, None], kc[:, :off0 + steps],
                         vc[:, :off0 + steps], off0 + steps - 1)[:, 0]
    rows.append(_held(torch, "world1_decode_graph_last", out_g, dec_ref,
                      SP_TOL_BF16))

    # the one-card world: four logical ranks
    world = symm.OneCardWorld(TP)
    t_loc, s_loc = t // TP, cache // TP
    dense = _dense_ref(torch, q, k, v)
    layers = [create(world.mesh(r), axis="tp",
                     combine=FlashDecodeCombine.PALLAS,
                     prefill=SpAttnMethod.PALLAS) for r in range(TP)]
    sh = [tuple(x[:, r * t_loc:(r + 1) * t_loc].contiguous()
                for x in (q, k, v)) for r in range(TP)]
    kcs = [kc[:, r * s_loc:(r + 1) * s_loc].contiguous() for r in range(TP)]
    vcs = [vc[:, r * s_loc:(r + 1) * s_loc].contiguous() for r in range(TP)]
    pools = [(_paged_of(torch, kcs[r], 128)[0], *_paged_of(torch, vcs[r],
                                                          128))
             for r in range(TP)]
    q_pos = cache - 3000                 # rank 3's shard partly live
    lengths = [torch.full((b_dec,), max(0, min(s_loc, q_pos + 1 - r * s_loc)),
                          **i32) for r in range(TP)]
    off = torch.full((), q_pos, **i32)
    kern.reset_launch_counts()
    pre = world.run(lambda r: layers[r].prefill(*sh[r]))
    dec = world.run(lambda r: layers[r].decode(qd, kcs[r], vcs[r], off))
    pag = world.run(lambda r: layers[r].decode_paged(
        qd, pools[r][0], pools[r][1], pools[r][2], lengths[r]))
    torch.cuda.synchronize()
    by_path["sp_one_card_world"] = kern.launch_counts()
    dec_ref = _dense_ref(torch, qd[:, None], kc[:, :q_pos + 1],
                         vc[:, :q_pos + 1], q_pos)[:, 0]
    for r in range(TP):
        rows.append(_held(torch, f"world4_pallas_prefill/rank{r}", pre[r],
                          dense[:, r * t_loc:(r + 1) * t_loc], SP_TOL_BF16))
        rows.append(_held(torch, f"world4_decode/rank{r}", dec[r], dec_ref,
                          SP_TOL_BF16))
        rows.append(_held(torch, f"world4_decode_paged/rank{r}", pag[r],
                          dec_ref, SP_TOL_BF16))
    want = {"sp_world1_flash_ring": {"flash_fold_partial": 1},
            "sp_world1_xla_varlen": {"flash_prefill_varlen": 1},
            "sp_world1_decode_graph": {"flash_decode_partial": steps,
                                       "pallas_combine_per_device": steps},
            "sp_one_card_world": {"pallas_ring_attn_per_device": TP,
                                  "flash_decode_partial": TP,
                                  "paged_flash_decode_partial": TP,
                                  "pallas_combine_per_device": 2 * TP}}
    counts_ok = {p: by_path[p] == _only(by_path[p], **w)
                 for p, w in want.items()}
    emit({"phase": "sp_layer", "model_heads": TP_MODEL, "cases": rows,
          "graph_replays": steps, "launches_per_replay": per_replay,
          "graph_equals_eager": graph_ok, "launches_by_path": by_path,
          "counts_ok": counts_ok})
    if not all(x["ok"] for x in rows) or not all(graph_ok) or \
            not all(counts_ok.values()):
        fail(f"SP layer on one card: bad cases "
             f"{[x['case'] for x in rows if not x['ok']]}, graph "
             f"{graph_ok}, counts {by_path}")
    return by_path


# -- four cards ----------------------------------------------------------------

def _sp_time(torch, dist, mesh, fn, iters, warm: int = 1):
    """(ms per call on this card, the last output): `warm` calls, then
    `iters` calls after a barrier, timed with CUDA events."""
    for _ in range(warm):
        fn()
    dist.barrier()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(iters):
        out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / iters, out


def _sp_shards(torch, mesh, g, b, t, dt, hq, hkv, d):
    """This rank's q/k/v of a global (B, T, H, D) sequence drawn from g
    (every rank draws all of it: the same global arrays)."""
    t_loc = t // mesh.world
    rows = slice(mesh.rank * t_loc, (mesh.rank + 1) * t_loc)
    out = []
    for h in (hq, hkv, hkv):
        x = torch.randn((b, t, h, d), generator=g, device=mesh.device)
        out.append(x[:, rows].to(dt).contiguous())
    return out


def _tp4_sp(torch, dist, mesh, kern, dims=SP_TP4, heads=SP_HEADS):
    """Qwen3-32B's attention widths on four cards through
    SpGQAFlashDecodeAttention, bf16. Prefill: B=1 over dims["t"] tokens
    under every tier (ms per call on this card, the launches of one call).
    Decode: B=4 over a dims["cache"]-token cache, each step ONE CUDA-graph
    replay of decode (the offset advanced on the card inside the graph)
    under combine XLA (B19 + NCCL) and PALLAS (B19 + B20), and of
    decode_paged (page dims["page"], the lengths computed on the card from
    the offset; B2 + B20): ms per step, launches per replay, the last
    replay equal to the eager step. Then each kernel on this card against
    its plain version and NCCL + lse_partial_merge or NCCL all-gather +
    SDPA."""
    from triton_dist_tpu_torch.kernels.flash_decode import FlashDecodeCombine
    from triton_dist_tpu_torch.kernels.sp_ag_attention import SpAttnMethod
    from triton_dist_tpu_torch.layers import SpGQAFlashDecodeAttention
    hq, hkv, d = heads
    n, me, dev = mesh.world, mesh.rank, mesh.device
    bf = torch.bfloat16
    res = {"heads": list(heads), "dims": dict(dims), "prefill": {},
           "decode": {}}
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(201)
    q, k, v = _sp_shards(torch, mesh, g, dims["b"], dims["t"], bf, hq, hkv,
                         d)
    t_loc = q.shape[1]
    for method, layout in SP_PREFILL_TIERS:
        layer = SpGQAFlashDecodeAttention.create(
            mesh, axis=mesh.axis, prefill=SpAttnMethod(method),
            layout=layout, comm_blocks=4)
        layer.prefill(q, k, v)                              # warm-up
        kern.reset_launch_counts()
        ms, out = _sp_time(torch, dist, mesh, lambda: layer.prefill(q, k, v),
                           dims["timed"], warm=0)
        counts = {key: c for key, c in kern.launch_counts().items() if c}
        res["prefill"][f"{method}/{layout}"] = {
            "ms": ms, "calls": dims["timed"], "launches": counts,
            "finite": bool(torch.isfinite(out).all())}
        del out
    # decode: rank r's shard of the cache
    b, cache = dims["dec_b"], dims["cache"]
    s_loc = cache // n
    gq = torch.Generator(device=dev).manual_seed(202)
    qd = torch.randn((b, hq, d), generator=gq, device=dev).to(bf)
    gk = torch.Generator(device=dev).manual_seed(203 + me)
    kc = torch.randn((b, s_loc, hkv, d), generator=gk, device=dev).to(bf)
    vc = torch.randn((b, s_loc, hkv, d), generator=gk, device=dev).to(bf)
    pool_k, table = _paged_of(torch, kc, dims["page"])
    pool_v, _ = _paged_of(torch, vc, dims["page"])
    off0 = cache - dims["steps"] - 1
    i32 = dict(dtype=torch.int32, device=dev)
    for label, combine, paged in (("xla", "xla", False),
                                  ("pallas", "pallas", False),
                                  ("paged_pallas", "pallas", True),
                                  ("paged_xla", "xla", True)):
        layer = SpGQAFlashDecodeAttention.create(
            mesh, axis=mesh.axis, combine=FlashDecodeCombine(combine))
        off = torch.full((), off0, **i32)

        def step(off=off, layer=layer, paged=paged):
            if paged:
                lengths = (off + 1 - me * s_loc).clamp(0, s_loc).to(
                    torch.int32).expand(b).contiguous()
                out = layer.decode_paged(qd, pool_k, pool_v, table, lengths)
            else:
                out = layer.decode(qd, kc, vc, off)
            off.add_(1)
            return out

        step()                                             # warm-up
        off.fill_(off0)
        kern.reset_launch_counts()
        graph = torch.cuda.CUDAGraph()
        dist.barrier()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            out_g = step()
        per_replay = {key: c for key, c in kern.launch_counts().items() if c}
        off.fill_(off0)
        dist.barrier()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        replays = 0
        for _ in range(dims["steps"]):
            graph.replay()
            replays += 1
        ev[1].record()
        torch.cuda.synchronize()
        ms = ev[0].elapsed_time(ev[1]) / dims["steps"]
        off.fill_(off0 + dims["steps"] - 1)
        eager = step()
        torch.cuda.synchronize()
        same = bool(torch.equal(out_g, eager))
        del graph
        res["decode"][label] = {
            "ms_per_step": ms, "replays": replays,
            "replays_per_step": replays / dims["steps"],
            "launches_per_replay": per_replay, "graph_equals_eager": same,
            "finite": bool(torch.isfinite(out_g).all())}
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    res["kernels"] = _tp4_sp_kernels(torch, dist, mesh, q, k, v, qd, kc,
                                     vc, s_loc, pool_k, pool_v, table,
                                     off0 + dims["steps"] - 1)
    return res


def _tp4_sp_kernels(torch, dist, mesh, q, k, v, qd, kc, vc, s_loc, pool_k,
                    pool_v, table, last_off):
    """Each kernel on this card at the shapes the paths gave it: B19 at
    this rank's decode shard, B2 over its page pool at the last decode
    step's lengths, B20 at B.Hq = 256 rows, B21, B1's fold form and B1's
    prefill form (the XLA tier: this rank's queries against the gathered
    keys at offset rank x T_loc) at this rank's prefill shard, each held
    against its plain version, and against the library calls: SDPA for
    B19 / B1, NCCL all-gather + lse_merge for B20, NCCL all-gather + SDPA
    with the causal mask for B21."""
    from triton_dist_tpu_torch.kernels import flash_attention as fa
    pfd = importlib.import_module(
        "triton_dist_tpu_torch.kernels.paged_flash_decode")
    from triton_dist_tpu_torch.kernels.flash_decode import (
        lse_merge, pallas_combine_per_device as combine,
    )
    from triton_dist_tpu_torch.kernels.plain import all_gather_list
    from triton_dist_tpu_torch.kernels.plain import ring_attn_ref as ring_ref
    from triton_dist_tpu_torch.kernels.sp_ag_attention import (
        legal_attn_blocks, pallas_ring_attn_per_device as ring,
    )
    spm = importlib.import_module(
        "triton_dist_tpu_torch.kernels.sp_ag_attention")
    n, me = mesh.world, mesh.rank
    b, t_loc, hq, d = q.shape
    hkv = k.shape[2]
    i32 = dict(dtype=torch.int32, device=mesh.device)
    start = torch.tensor(me * s_loc, **i32)
    qpos = torch.tensor(n * s_loc - 1, **i32)
    out = {}
    ms, part = _sp_time(torch, dist, mesh, lambda: fa.flash_decode_partial(
        qd, kc, vc, start, qpos), 10)
    plain_ms, ref = _sp_time(torch, dist, mesh,
                             lambda: fa.flash_decode_partial_ref(
                                 qd, kc, vc, start, qpos), 1)
    row = _held_triple(torch, "b19", part, ref, SP_TOL_BF16)
    nbytes = (kc.numel() + vc.numel() + qd.numel()) * 2 + \
        b * hq * (d + 2) * 4
    bms, by = bound_ms(nbytes, 4.0 * qd.shape[0] * hq * s_loc * d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kh, vh = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
    lib_ms, _ = _sp_time(torch, dist, mesh, lambda: sdpa(
        qd[:, :, None], kh, vh, enable_gqa=True), 10)
    del kh, vh
    out["b19"] = {**row, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                  "bound_ms": bms, "bound_by": by}
    lengths = (last_off + 1 - me * s_loc + torch.zeros(
        qd.shape[0], **i32)).clamp(0, s_loc).to(torch.int32)
    ms, part_p = _sp_time(torch, dist, mesh,
                          lambda: pfd.paged_flash_decode_partial(
                              qd, pool_k, pool_v, table, lengths), 10)
    plain_ms, ref = _sp_time(torch, dist, mesh,
                             lambda: pfd.paged_flash_decode_partial_ref(
                                 qd, pool_k, pool_v, table, lengths), 1)
    row = _held_triple(torch, "b2", part_p, ref, SP_TOL_BF16)
    out["b2"] = {**row, "ms": ms, "plain_ms": plain_ms,
                 "lengths": lengths.tolist()}
    del part_p, ref
    acc, m, l = part

    def xla_combine():
        return lse_merge(*(torch.stack(all_gather_list(mesh, x))
                           for x in (acc, m, l)))

    ref = xla_combine()
    ms, got = _sp_time(torch, dist, mesh, lambda: combine(mesh, acc, m, l),
                       20)
    lib_ms, _ = _sp_time(torch, dist, mesh, xla_combine, 20)
    row = _held(torch, "b20", got, ref, 1e-5)
    nbytes = (n * acc.numel() + n * 2 * m.numel() + acc.numel()) * 4
    bms, by = tp_bound_ms(nbytes, (n - 1) * (acc.numel() + 2 * m.numel()) * 4,
                          0.0)
    out["b20"] = {**row, "ms": ms, "plain_ms": lib_ms, "library_ms": lib_ms,
                  "bound_ms": bms, "bound_by": by}
    ms, got = _sp_time(torch, dist, mesh, lambda: ring(mesh, q, k, v, 4), 2)
    t = n * t_loc
    pairs = sum(me * t_loc + i + 1 for i in range(t_loc))
    flops = 4.0 * pairs * hq * d
    nbytes = 2 * (2 * q.numel() + k.numel() * n + v.numel() * n)
    bms, by = tp_bound_ms(nbytes, 2 * (n - 1) * k.numel() * 2, flops)

    pos = torch.arange(t, device=q.device)
    mask = pos[None, :] <= (me * t_loc + torch.arange(
        t_loc, device=q.device))[:, None]

    k_all = torch.cat(all_gather_list(mesh, k), dim=1)
    v_all = torch.cat(all_gather_list(mesh, v), dim=1)

    def ag_sdpa():
        return _sdpa(torch, q, torch.cat(all_gather_list(mesh, k), dim=1),
                     torch.cat(all_gather_list(mesh, v), dim=1), mask)

    try:
        lib_ms, _ = _sp_time(torch, dist, mesh, ag_sdpa, 2)
        note = None
    except RuntimeError as exc:
        torch.cuda.synchronize()
        lib_ms, note = None, str(exc).splitlines()[0][:200]
    plain_ms, ref = _sp_time(torch, dist, mesh, lambda: ring_ref(
        mesh, q, k, v, legal_attn_blocks(t_loc, 4, n)), 1)
    row = _held(torch, "b21", got, ref, SP_TOL_BF16)
    del got, ref
    # comm blocks of 150 rows (no multiple of the 128-key step) over
    # landing slots NaN-filled before the first call, three calls on new
    # draws (the slots' parity alternating)
    ragged = []
    _nan_slots(torch, spm, mesh, 1, 600, hkv, d, torch.bfloat16, 4)
    torch.cuda.synchronize()
    dist.barrier()         # no peer pushes into a slot before it is filled
    gr = torch.Generator(device=mesh.device).manual_seed(211)
    for call in range(3):
        qr, kr, vr = _sp_shards(torch, mesh, gr, 1, 600 * n, torch.bfloat16,
                                hq, hkv, d)
        ragged.append(_held(torch, f"b21_t{600 * n}_cb4_call{call}",
                            ring(mesh, qr, kr, vr, 4),
                            ring_ref(mesh, qr, kr, vr,
                                     legal_attn_blocks(600, 4, n)),
                            SP_TOL_BF16))
    out["b21"] = {**row, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                  "library_note": note, "bound_ms": bms, "bound_by": by,
                  "flops": flops, "ragged_nan_slots_parities": ragged,
                  "ok": row["ok"] and all(x["ok"] for x in ragged),
                  "max_abs_err": max([row["max_abs_err"]] +
                                     [x["max_abs_err"] for x in ragged])}
    ms, got = _sp_time(torch, dist, mesh, lambda: fa.flash_prefill(
        q, k_all, v_all, me * t_loc), 2)
    plain_ms, ref = _sp_time(torch, dist, mesh, lambda: fa.flash_prefill_ref(
        q, k_all, v_all, me * t_loc), 1)
    row = _held(torch, "prefill", got, ref, SP_TOL_BF16)
    del got, ref
    # bound by operations over the causal (query, key) pairs at the
    # rank's offset; SDPA over the rank's live keys, causal aligned to its
    # last query (and, as a note, with the causal-with-offset mask over
    # every gathered key)
    pre_pairs = sum(min(me * t_loc + i + 1, k_all.shape[1])
                    for i in range(t_loc))
    pre_bytes = 2 * (2 * q.numel() + k_all.numel() + v_all.numel())
    pbms, pby = bound_ms(pre_bytes, 4.0 * b * hq * d * pre_pairs)
    live_keys = (me + 1) * t_loc
    try:
        lib_ms, _ = _sp_time(torch, dist, mesh, lambda: _sdpa_causal_offset(
            torch, q, k_all, v_all, live_keys), 2)
        note = None
    except RuntimeError as exc:
        torch.cuda.synchronize()
        lib_ms, note = None, str(exc).splitlines()[0][:200]
    try:
        mask_ms, _ = _sp_time(torch, dist, mesh,
                              lambda: _sdpa(torch, q, k_all, v_all, mask), 2)
    except RuntimeError:
        torch.cuda.synchronize()
        mask_ms = None
    out["prefill"] = {**row, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "library_note": note,
                      "library_call": "scaled_dot_product_attention over "
                                      "the rank's live keys, "
                                      "causal_lower_right, enable_gqa",
                      "library_mask_ms": mask_ms,
                      "bound_ms": pbms, "bound_by": pby,
                      "flops": 4.0 * b * hq * d * pre_pairs,
                      "offset": me * t_loc, "keys": k_all.shape[1]}
    k0 = ((me - 1) % n) * t_loc
    k_src = k_all[:, k0:k0 + t_loc].contiguous()
    v_src = v_all[:, k0:k0 + t_loc].contiguous()
    del k_all, v_all
    ms, got = _sp_time(torch, dist, mesh, lambda: fa.flash_fold_partial(
        q, k_src, v_src, me * t_loc, k0), 2)
    plain_ms, ref = _sp_time(torch, dist, mesh,
                             lambda: fa.flash_fold_partial_ref(
                                 q, k_src, v_src, me * t_loc, k0), 1)
    row = _held_triple(torch, "fold", got, ref, SP_TOL_BF16)
    lib_ms, note = _library(torch, lambda: _sdpa(torch, q, k_src, v_src),
                            iters=2, warmup=1)
    live = me > 0
    fold_pairs = t_loc * t_loc if live else 0
    fbytes = 2 * (q.numel() + 2 * k.numel()) + q.numel() * 4
    bms, by = bound_ms(fbytes, 4.0 * fold_pairs * hq * d)
    out["fold"] = {**row, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms,
                   "library_note": note, "bound_ms": bms, "bound_by": by,
                   "chunk": "the left neighbour's shard (a whole chunk on "
                            "ranks 1-3, wholly in the future on rank 0)"}
    return out


def _tp4_sp_consistency(torch, dist, mesh, kern, dims=SP_TP4,
                        heads=SP_HEADS):
    """The f32 gate on four cards: every prefill tier over dims["gate_t"]
    tokens (PALLAS and XLA_BLOCK at comm_blocks 1 and 4) and every decode
    combine over a dims["gate_cache"]-key cache (dense, local B19 and the
    masked einsum; paged), each against one card's dense attention over
    the whole sequence (each rank gathers it), and PALLAS against
    XLA_BLOCK. Returns each case's max abs error and max|ref|."""
    from triton_dist_tpu_torch.kernels.flash_decode import FlashDecodeCombine
    from triton_dist_tpu_torch.kernels.plain import all_gather_list
    from triton_dist_tpu_torch.kernels.sp_ag_attention import (
        SpAttnMethod, zigzag_shard, zigzag_unshard,
    )
    from triton_dist_tpu_torch.layers import SpGQAFlashDecodeAttention
    hq, hkv, d = heads
    n, me, dev = mesh.world, mesh.rank, mesh.device
    create = SpGQAFlashDecodeAttention.create
    g = torch.Generator(device=dev).manual_seed(301)
    t = dims["gate_t"]
    full = [torch.randn((1, t, h, d), generator=g, device=dev)
            for h in (hq, hkv, hkv)]
    t_loc = t // n
    rows = slice(me * t_loc, (me + 1) * t_loc)
    q, k, v = (x[:, rows].contiguous() for x in full)
    dense = _dense_ref(torch, *full)
    want = dense[:, rows]
    errs = {}

    def err(name, got, ref):
        errs[name] = {"max_abs_err": (got.float() - ref.float()).abs().max()
                      .item(), "ref_absmax": ref.abs().max().item(),
                      "finite": bool(torch.isfinite(got).all())}

    outs = {}
    for method, layout, cb in [(m_, l_, 4) for m_, l_ in SP_PREFILL_TIERS] \
            + [("xla_block", "contiguous", 1), ("pallas", "contiguous", 1)]:
        key = f"{method}/{layout}/cb{cb}"
        layer = create(mesh, axis=mesh.axis, prefill=SpAttnMethod(method),
                       layout=layout, comm_blocks=cb)
        if layout == "zigzag":
            zq, zk, zv = (zigzag_shard(x, n)[:, rows].contiguous()
                          for x in full)
            got = layer.prefill(zq, zk, zv)
            got = zigzag_unshard(torch.cat(all_gather_list(mesh, got),
                                           dim=1), n)[:, rows]
        else:
            got = layer.prefill(q, k, v)
        outs[key] = got
        err(f"prefill/{key}", got, want)
    err("prefill/pallas_vs_xla_block/cb4", outs["pallas/contiguous/cb4"],
        outs["xla_block/contiguous/cb4"])
    err("prefill/pallas_vs_xla_block/cb1", outs["pallas/contiguous/cb1"],
        outs["xla_block/contiguous/cb1"])
    del dense, outs
    # decode over dims["gate_cache"] keys
    b, cache = 4, dims["gate_cache"]
    s_loc = cache // n
    gd = torch.Generator(device=dev).manual_seed(302)
    qd = torch.randn((b, hq, d), generator=gd, device=dev)
    kf = torch.randn((b, cache, hkv, d), generator=gd, device=dev)
    vf = torch.randn((b, cache, hkv, d), generator=gd, device=dev)
    kc, vc = (x[:, me * s_loc:(me + 1) * s_loc].contiguous()
              for x in (kf, vf))
    pos = cache - cache // 3 - 1         # one rank partly live, one empty
    ref = _dense_ref(torch, qd[:, None], kf[:, :pos + 1], vf[:, :pos + 1],
                     pos)[:, 0]
    pool_k, table = _paged_of(torch, kc, 128)
    pool_v, _ = _paged_of(torch, vc, 128)
    lengths = torch.full((b,), max(0, min(s_loc, pos + 1 - me * s_loc)),
                         dtype=torch.int32, device=dev)
    off = torch.full((), pos, dtype=torch.int32, device=dev)
    for combine in ("xla", "pallas"):
        for local in ("pallas", "xla"):
            layer = create(mesh, axis=mesh.axis,
                           combine=FlashDecodeCombine(combine),
                           local_method=local)
            err(f"decode/{combine}/{local}",
                layer.decode(qd, kc, vc, off), ref)
        layer = create(mesh, axis=mesh.axis,
                       combine=FlashDecodeCombine(combine), kv_splits=2)
        err(f"decode/{combine}/kv_splits2", layer.decode(qd, kc, vc, off),
            ref)
        err(f"decode_paged/{combine}", layer.decode_paged(
            qd, pool_k, pool_v, table, lengths), ref)
    return errs


_SP_PREFILL_WANT = {"xla/contiguous": {"flash_prefill": 1},
                    "flash_ring/contiguous": {"flash_fold_partial": TP},
                    "flash_ring/zigzag": {"flash_fold_partial": 3 * TP},
                    "pallas/contiguous": {"pallas_ring_attn_per_device": 1}}
_SP_DECODE_WANT = {
    "xla": {"flash_decode_partial": 1},
    "pallas": {"flash_decode_partial": 1, "pallas_combine_per_device": 1},
    "paged_pallas": {"paged_flash_decode_partial": 1,
                     "pallas_combine_per_device": 1},
    "paged_xla": {"paged_flash_decode_partial": 1}}


def _sp_path(tier: str) -> str:
    """The launches_by_path name of a prefill tier "method/layout"."""
    method, layout = tier.split("/")
    return f"tp4_sp_prefill_{method}" + ("_zigzag" if layout == "zigzag"
                                         else "")


def _tp4_sp_rows(results, extra):
    """The parent's side of tp4_sp: the prefill tiers' ms per card and the
    slowest, their launches over the timed calls (gated: each kernel of a
    tier launched exactly its count a call times the calls), the decode
    paths' ms per step, replays per step and launches per replay (gated),
    the kernel holds of every card (gated), and the kernel rows of B19,
    B20, B21 and B1's fold form from the four cards (slowest rank). Every
    path's launches (rank 0's: the gate holds them equal on every rank)
    go to ``extra``, and each row's launches_by_path is taken from
    them."""
    sp = [results[r]["sp"] for r in range(TP)]
    pre = {}
    bad = []
    for tier in sp[0]["prefill"]:
        per = [x["prefill"][tier] for x in sp]
        want = _SP_PREFILL_WANT.get(tier, {})
        if any(p["launches"] != {key: w * p["calls"]
                                 for key, w in want.items()}
               or not p["finite"] for p in per):
            bad.append(f"prefill {tier}: {[p['launches'] for p in per]} "
                       f"over {per[0]['calls']} calls, want {want} a call")
        pre[tier] = {"ms_per_rank": [p["ms"] for p in per],
                     "slowest_ms": max(p["ms"] for p in per),
                     "calls": per[0]["calls"],
                     "launches": per[0]["launches"]}
        if per[0]["launches"]:
            extra[_sp_path(tier)] = dict(per[0]["launches"])
    dec = {}
    for label, want in _SP_DECODE_WANT.items():
        per = [x["decode"][label] for x in sp]
        if any(p["launches_per_replay"] != want or p["replays_per_step"] != 1
               or not p["graph_equals_eager"] or not p["finite"]
               for p in per):
            bad.append(f"decode {label}: {per}")
        dec[label] = {"ms_per_step_per_rank": [p["ms_per_step"] for p in per],
                      "slowest_ms_per_step": max(p["ms_per_step"]
                                                 for p in per),
                      "replays": per[0]["replays"],
                      "replays_per_step": per[0]["replays_per_step"],
                      "launches_per_replay": per[0]["launches_per_replay"],
                      "graph_equals_eager": [p["graph_equals_eager"]
                                             for p in per]}
        extra[f"tp4_sp_decode_{label}"] = {
            key: c * per[0]["replays"]
            for key, c in per[0]["launches_per_replay"].items()}
    d = SP_TP4
    emit({"phase": "tp4_sp", "model_heads": TP_MODEL,
          "heads": sp[0]["heads"], "dtype": "bf16",
          "prefill": {"batch": d["b"], "tokens": d["t"],
                      "tokens_per_rank": d["t"] // TP, "tiers": pre},
          "decode": {"batch": d["dec_b"], "cache": d["cache"],
                     "keys_per_rank": d["cache"] // TP, "steps": d["steps"],
                     "page": d["page"], "paths": dec},
          "peak_gb_per_card": [x["peak_bytes"] / 1e9 for x in sp],
          "kernels_per_rank": [x["kernels"] for x in sp],
          "ok": not bad})
    if bad:
        fail("tp4_sp: " + "; ".join(bad))
    kn = [x["kernels"] for x in sp]
    for key in ("b19", "b2", "b20", "b21", "fold", "prefill"):
        if not all(k[key]["ok"] for k in kn):
            fail(f"tp4_sp: {key} disagrees with its plain version on a "
                 f"card: {[k[key] for k in kn]}")
    sp_paths = {path: counts for path, counts in extra.items()
                if path.startswith("tp4_sp_")}
    rows = {}
    for name, key, source, rep, call in (
            ("flash_decode_partial", "b19", "flash_decode.cu",
             "triton_dist_tpu/kernels/flash_attention.py:269",
             "scaled_dot_product_attention at T=1 over the rank's keys "
             "(head-major, enable_gqa)"),
            ("pallas_combine_per_device", "b20", "flash_decode.cu",
             "triton_dist_tpu/kernels/flash_decode.py:207",
             "NCCL all_gather of the (acc, m, l) triple + lse_merge"),
            ("pallas_ring_attn_per_device", "b21", "sp_attention.cu",
             "triton_dist_tpu/kernels/sp_ag_attention.py:614",
             "NCCL all_gather of K and V + scaled_dot_product_attention "
             "with the causal mask at the rank's offset"),
            ("flash_fold_partial", "fold", "flash_prefill.cu",
             "triton_dist_tpu/kernels/flash_attention.py:63",
             "scaled_dot_product_attention over the chunk (normalized "
             "rows, enable_gqa)")):
        per = [k[key] for k in kn]
        slow = max(per, key=lambda x: x["ms"])
        libs = [x.get("library_ms") for x in per]
        by_path = {path: counts[name] for path, counts in sp_paths.items()
                   if counts.get(name)}
        rows[name] = {
            "name": name, "route": "cuda", "source": _SRC + source,
            "replaces": rep,
            "max_abs_err": max(x["max_abs_err"] for x in per),
            "ms": slow["ms"], "plain_ms": slow.get("plain_ms"),
            "bound_ms": slow["bound_ms"], "bound_by": slow["bound_by"],
            "library_ms": (max(libs) if all(x is not None for x in libs)
                           else None),
            "library_ms_call": call, "per_rank_ms": [x["ms"] for x in per],
            "launches_by_path": by_path,
            "launches": sum(by_path.values()),
            "measured_on": "4 cards, SP=4, the slowest rank",
            "shapes": {"tp4_sp": {k_: slow[k_] for k_ in slow
                                  if k_ not in ("case",)}}}
        if key == "b21":
            rows[name]["instructions"] = B21_INSTRUCTIONS
    return rows


def _tp4_sp_gate(results):
    """The parent's side of tp4_sp_consistency: every case on every rank
    within SP_GATE_TOL x max(1, max|ref|), finite."""
    errs = [results[r]["sp_consistency"] for r in range(TP)]
    worst = {case: max(e[case]["max_abs_err"] for e in errs)
             for case in errs[0]}
    bad = [f"rank {r} {case}: {e[case]}" for r, e in enumerate(errs)
           for case in e
           if not e[case]["finite"] or e[case]["max_abs_err"] >
           SP_GATE_TOL * max(1.0, e[case]["ref_absmax"])]
    emit({"phase": "tp4_sp_consistency", "model_heads": TP_MODEL,
          "dtype": "f32", "tokens": SP_TP4["gate_t"],
          "cache": SP_TP4["gate_cache"], "tol": SP_GATE_TOL,
          "max_abs_err": worst, "ok": not bad})
    if bad:
        fail("tp4_sp_consistency: " + "; ".join(bad))


# -- slice 11: the small collectives and pipeline point-to-point (B22-B26) --

LL_HIDDEN = 5120             # Qwen3-32B's hidden: the rows these ops move
LL_AG_ROWS = (1, 4, 16, 64, 256, 2048)   # rows a rank: decode to a chunk
LL_P2P_ROWS = (16, 2048)
LL_ODD = (3, 5)              # a bf16 shard of 30 bytes: no 16-byte rows
LL_HEADLINE = 16             # the kernels line's shape: a decode step's rows
_LL_REPLACES = {
    "bidir_ring_ag_per_device":
        "triton_dist_tpu/kernels/low_latency_allgather.py:97",
    "ring2d_ag_per_device":
        "triton_dist_tpu/kernels/low_latency_allgather.py:178",
    "p2p_put_per_device": "triton_dist_tpu/kernels/p2p.py:25",
    "barrier_all_per_device": "triton_dist_tpu/kernels/common_ops.py:22",
    "ring_shift_per_device": "triton_dist_tpu/kernels/common_ops.py:62"}
_LL_FLAG_NOTE = ("a flag round trip has no data-sheet figure; B17's "
                 "measured round trip (0.015 ms) is the port's yardstick")


def _ll_draw(torch, g, rows, k=LL_HIDDEN, dt=None, device=DEV):
    dt = dt or torch.bfloat16
    return torch.randn((rows, k), generator=g, device=device).to(dt)


def _ll_row(name, rows, timed, measured_on, **extra):
    """A kernels-line row of B22-B26: the numbers of the headline shape."""
    return _sp_row(name, "ll_collectives.cu", _LL_REPLACES[name], rows,
                   timed, measured_on, **extra)


def phase_b22_b23(torch, symm, kern, agk, llm, calls: int = 5):
    """B22 (the bidirectional-ring all-gather) and B23 (the 2-D ring,
    nx = 2) in the one-card world: four logical ranks, shards of 1-2,048
    rows of 5,120 bf16 and an odd (3, 5) bf16 shard; every rank's rows
    must be the plain version's (the concatenation in rank order) and
    B8's bytes, then `calls` successive calls with fresh shards. Timed at
    each size (queued_ms, the four ranks together): B22, B23, B8, B7 and
    torch.cat. Then the mesh-level path: the counts zeroed,
    ``fast_allgather`` under BIDIR_RING and RING_2D and the layer (AUTO:
    FULL_MESH on the card) on every rank at 16 rows, and the layer on the
    odd shard (AUTO: B22, as B8 takes 16-byte rows only), the counts
    read."""
    world = symm.OneCardWorld(TP)
    g = torch.Generator(device=DEV).manual_seed(111)
    fns = {"bidir_ring_ag_per_device":
           lambda r, x: llm.bidir_ring_ag_per_device(world.mesh(r), x),
           "ring2d_ag_per_device":
           lambda r, x: llm.ring2d_ag_per_device(world.mesh(r), x, 2)}

    def check(name, xs, with_b8=True):
        ref, rows = torch.cat(xs), []
        b8 = world.run(lambda r: agk.full_mesh_all_gather(
            world.mesh(r), xs[r])) if with_b8 else None
        for kname, fn in fns.items():
            outs = world.run(lambda r: fn(r, xs[r]))
            torch.cuda.synchronize()
            rows += _slot_rows(f"{kname}/{name}", outs, [ref] * TP)
            if b8 is not None:
                rows += _slot_rows(f"{kname}/{name}_vs_b8", outs, b8)
        return rows

    rows, seq_ok, timed = [], [], {k: {} for k in fns}
    rows += check("odd_3x5", [_ll_draw(torch, g, *LL_ODD)
                              for _ in range(TP)], with_b8=False)
    sweep = []
    for m in LL_AG_ROWS:
        xs = [_ll_draw(torch, g, m) for _ in range(TP)]
        rows += check(f"m{m}", xs)
        shard = m * LL_HIDDEN * 2
        nbytes = TP * (shard + TP * shard)
        bms, by = bound_ms(nbytes, 0.0)
        cat_ms = queued_ms(torch, lambda: torch.cat(xs))[0]
        plain_ms = queued_ms(torch, lambda: [torch.cat(xs)] * TP)[0]
        rec = {"rows_per_rank": m, "shard_bytes": shard,
               "b8_ms": queued_ms(torch, lambda: world.run(
                   lambda r: agk.full_mesh_all_gather(world.mesh(r),
                                                      xs[r])))[0],
               "b7_ms": queued_ms(torch, lambda: world.run(
                   lambda r: agk.ring_all_gather(world.mesh(r), xs[r])))[0],
               "cat_ms": cat_ms}
        for kname, fn in fns.items():
            ms, host_s, ahead = queued_ms(torch, lambda: world.run(
                lambda r: fn(r, xs[r])))
            rec[kname] = ms
            timed[kname][f"m{m}"] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": cat_ms,
                "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                "host_enqueue_s": host_s, "queued_ahead": ahead}
        sweep.append(rec)
    for _ in range(calls):
        seq_ok.append(all(x["ok"] for x in check(
            "seq_m16", [_ll_draw(torch, g, 16) for _ in range(TP)],
            with_b8=False)))
    xs = [_ll_draw(torch, g, LL_HEADLINE) for _ in range(TP)]
    odd = [_ll_draw(torch, g, *LL_ODD) for _ in range(TP)]
    ctxs = [llm.create_fast_allgather_context(
        world.mesh(r), "tp", method=method, nx=2) for r in range(TP)
        for method in (llm.LLAllGatherMethod.BIDIR_RING,
                       llm.LLAllGatherMethod.RING_2D)]
    from triton_dist_tpu_torch.layers import LowLatencyAllGatherLayer
    kern.reset_launch_counts()
    outs = world.run(lambda r: [llm.fast_allgather(c, xs[r])
                                for c in ctxs[2 * r:2 * r + 2]] +
                     [LowLatencyAllGatherLayer.create(world.mesh(r))(y)
                      for y in (xs[r], odd[r])])
    torch.cuda.synchronize()
    path = kern.launch_counts()
    refs = [torch.cat(xs)] * 3 + [torch.cat(odd)]
    op_ok = all(torch.equal(o, ref) for per in outs
                for o, ref in zip(per, refs)) and \
        path == _only(path, bidir_ring_ag_per_device=2 * TP,
                      ring2d_ag_per_device=TP, full_mesh_all_gather=TP)
    emit({"phase": "b22_b23_ll_ag", "world": "one card, 4 logical ranks",
          "cases": rows, "successive_calls_ok": seq_ok, "sweep": sweep,
          "fast_allgather": {"launches": path, "ok": op_ok}})
    if not all(x["ok"] for x in rows) or not all(seq_ok) or not op_ok:
        fail(f"B22/B23 disagree with their plain version or B8, or "
             f"fast_allgather did not take them: "
             f"{[x for x in rows if not x['ok']]}; successive {seq_ok}; "
             f"fast_allgather {path}")
    recs = []
    for kname in fns:
        t = timed[kname]
        head = f"m{LL_HEADLINE}"
        recs.append(_ll_row(
            kname, [x for x in rows if x["case"].startswith(kname)],
            {head: t[head], **{k: v for k, v in t.items() if k != head}},
            "one card, 4 logical ranks",
            library_ms_call="torch.cat(xs) (one card: the gather is a "
                            "concatenation)",
            launches_by_path={"fast_allgather_one_card": path[kname]},
            launches=path[kname]))
    return recs


def phase_b24_b26(torch, symm, kern, cops, p2pm, calls: int = 5):
    """B24 (the point-to-point put) for every (src, dst) pair, src == dst
    included, B25 (the device barrier) and B26 (the ring shift) for shifts
    0-3, in the one-card world at (16, 5120) and (2,048, 5120) bf16 and
    the odd (3, 5) bf16 shard: every rank's output bitwise the plain
    version's (dst: src's shard; the shard of rank (r - shift) mod 4; x),
    then `calls` successive calls. Timed (queued_ms, the four ranks
    together) at both sizes: B24 on the pair (0, 1), B25, B26 at shift 1,
    each beside its plain version (copies of the right shards) and one
    torch.stack of them. Then the mesh-level path, counted:
    ``p2p_put_op``, ``CommOp.send_recv``, ``barrier_all_op`` and
    ``ring_shift_op`` on every rank."""
    world = symm.OneCardWorld(TP)
    g = torch.Generator(device=DEV).manual_seed(112)
    n = TP

    def b24(src, dst):
        return (lambda r, x: p2pm.p2p_put_per_device(world.mesh(r), x, src,
                                                     dst),
                lambda xs: [xs[src] if r == dst else xs[r]
                            for r in range(n)])

    def b26(s):
        return (lambda r, x: cops.ring_shift_per_device(world.mesh(r), x, s),
                lambda xs: [xs[(r - s) % n] for r in range(n)])

    b25 = (lambda r, x: cops.barrier_all_per_device(world.mesh(r), x),
           lambda xs: list(xs))
    cases = {**{f"b24_{s}_{d}": ("p2p_put_per_device", *b24(s, d))
                for s in range(n) for d in range(n)},
             "b25": ("barrier_all_per_device", *b25),
             **{f"b26_shift{s}": ("ring_shift_per_device", *b26(s))
                for s in range(n)}}

    def check(tag, xs):
        rows = []
        for cname, (kname, fn, want) in cases.items():
            outs = world.run(lambda r: fn(r, xs[r]))
            torch.cuda.synchronize()
            rows += [dict(x, kernel=kname) for x in _slot_rows(
                f"{cname}/{tag}", outs, want(xs))]
        return rows

    rows = check("odd_3x5", [_ll_draw(torch, g, *LL_ODD) for _ in range(n)])
    timed = {"p2p_put_per_device": {}, "barrier_all_per_device": {},
             "ring_shift_per_device": {}}
    for m in LL_P2P_ROWS:
        xs = [_ll_draw(torch, g, m) for _ in range(n)]
        rows += check(f"m{m}", xs)
        nbytes = n * 2 * m * LL_HIDDEN * 2
        bms, by = bound_ms(nbytes, 0.0)
        for cname in ("b24_0_1", "b25", "b26_shift1"):
            kname, fn, want = cases[cname]
            ms, host_s, ahead = queued_ms(torch, lambda: world.run(
                lambda r: fn(r, xs[r])))
            timed[kname][f"m{m}"] = {
                "ms": ms, "case": cname,
                "plain_ms": queued_ms(torch, lambda: [
                    y.clone() for y in want(xs)])[0],
                "library_ms": queued_ms(torch, lambda: torch.stack(
                    want(xs)))[0],
                "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                "host_enqueue_s": host_s, "queued_ahead": ahead}
    seq_ok = [all(x["ok"] for x in check(
        "seq_m16", [_ll_draw(torch, g, 16) for _ in range(n)]))
        for _ in range(calls)]
    xs = [_ll_draw(torch, g, LL_HEADLINE) for _ in range(n)]
    from triton_dist_tpu_torch.layers import CommOp
    kern.reset_launch_counts()
    outs = world.run(lambda r: (
        p2pm.p2p_put_op(world.mesh(r), "tp", xs[r], 0, 2),
        CommOp(world.mesh(r), axis="tp").send_recv(xs[r], 3, 1),
        cops.barrier_all_op(world.mesh(r), "tp", xs[r]),
        cops.ring_shift_op(world.mesh(r), "tp", xs[r], shift=1)))
    torch.cuda.synchronize()
    path = kern.launch_counts()
    wants = list(zip(b24(0, 2)[1](xs), b24(3, 1)[1](xs), xs,
                     b26(1)[1](xs)))
    op_ok = all(torch.equal(o, w) for per, wp in zip(outs, wants)
                for o, w in zip(per, wp)) and \
        path == _only(path, p2p_put_per_device=2 * n,
                      barrier_all_per_device=n, ring_shift_per_device=n)
    emit({"phase": "b24_b25_b26_p2p", "world": "one card, 4 logical ranks",
          "cases": rows, "successive_calls_ok": seq_ok, "timed": timed,
          "mesh_ops": {"launches": path, "ok": op_ok},
          "bound_note": _LL_FLAG_NOTE})
    if not all(x["ok"] for x in rows) or not all(seq_ok) or not op_ok:
        fail(f"B24/B25/B26 disagree with their plain versions or the "
             f"mesh-level ops did not take them: "
             f"{[x for x in rows if not x['ok']]}; successive {seq_ok}; "
             f"mesh ops {path}")
    return [_ll_row(kname, [x for x in rows if x["kernel"] == kname],
                    timed[kname], "one card, 4 logical ranks",
                    library_ms_call="torch.stack of the output shards "
                                    "(one card)",
                    bound_note=_LL_FLAG_NOTE,
                    launches_by_path={"mesh_ops_one_card": path[kname]},
                    launches=path[kname])
            for kname in timed]


def _tp4_comm(torch, dist, mesh, kern):
    """The slice's entry points on four cards, each rank on its shards: the
    AUTO sweep (B8, B22, B23 and NCCL's all_gather_into_tensor at 1-2,048
    rows of 5120 bf16 a rank, device ms per call by queued_ms, B22's and
    B23's rows NCCL's bytes); B24 (pair (0, 1)), B25 and B26 (shift 1)
    at (16, 5120) and (2,048, 5120) against their plain versions and
    NCCL; then, the counts zeroed, every entry point under every method
    (``fast_allgather``, the layer, ``p2p_put_op``, ``CommOp`` on a "pp"
    mesh, ``barrier_all_op``, ``ring_shift_op``) at 16 rows, a 3-D f32
    shard and the odd (3, 5) bf16 shard, each output bitwise its plain
    version's, the counts read."""
    from triton_dist_tpu_torch.kernels import common_ops as cops
    from triton_dist_tpu_torch.kernels import allgather as agk
    from triton_dist_tpu_torch.kernels import low_latency_allgather as llm
    from triton_dist_tpu_torch.kernels import p2p as p2pm
    from triton_dist_tpu_torch.kernels import plain
    from triton_dist_tpu_torch.layers import (
        CommOp,
        LowLatencyAllGatherLayer,
    )
    from triton_dist_tpu_torch.runtime.mesh import make_comm_mesh
    me, n = mesh.rank, mesh.world
    g = torch.Generator(device=mesh.device).manual_seed(113 + me)

    def timed_ms(fn):
        dist.barrier()
        return queued_ms(torch, fn)[0]

    sweep = []
    for m in LL_AG_ROWS:
        x = _ll_draw(torch, g, m, device=mesh.device)

        def nccl():
            y = x.new_empty((n * m, LL_HIDDEN))
            dist.all_gather_into_tensor(y, x, group=mesh.group)
            return y
        ref = nccl()
        fns = {"b8": lambda: agk.full_mesh_all_gather(mesh, x),
               "b22": lambda: llm.bidir_ring_ag_per_device(mesh, x),
               "b23": lambda: llm.ring2d_ag_per_device(mesh, x, 2),
               "nccl": nccl, "plain": lambda: plain.all_gather_cat(mesh, x)}
        rec = {"rows_per_rank": m, "shard_bytes": m * LL_HIDDEN * 2,
               "equal_nccl": {k: bool(torch.equal(f(), ref))
                              for k, f in fns.items()}}
        torch.cuda.synchronize()
        rec.update({f"{k}_ms": timed_ms(f) for k, f in fns.items()})
        sweep.append(rec)
    small = {}
    for m in LL_P2P_ROWS:
        x = _ll_draw(torch, g, m, device=mesh.device)
        peer = {0: 1, 1: 0}.get(me)

        def nccl_p2p():
            if peer is None:
                return x
            y = torch.empty_like(x)
            for req in dist.batch_isend_irecv(
                    [dist.P2POp(dist.isend, x, peer, mesh.group)] if me == 0
                    else [dist.P2POp(dist.irecv, y, peer, mesh.group)]):
                req.wait()
            return y

        def nccl_shift():
            y = torch.empty_like(x)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, x, (me + 1) % n, mesh.group),
                    dist.P2POp(dist.irecv, y, (me - 1) % n, mesh.group)]):
                req.wait()
            return y

        def nccl_barrier():
            dist.barrier(group=mesh.group)
            return x.clone()
        kinds = {
            "p2p_put_per_device": (
                lambda: p2pm.p2p_put_per_device(mesh, x, 0, 1),
                lambda: plain.p2p_ref(mesh, x, 0, 1), nccl_p2p,
                "torch.distributed.batch_isend_irecv (NCCL)"),
            "barrier_all_per_device": (
                lambda: cops.barrier_all_per_device(mesh, x),
                lambda: plain.barrier_ref(mesh, x), nccl_barrier,
                "torch.distributed.barrier (NCCL) + copy"),
            "ring_shift_per_device": (
                lambda: cops.ring_shift_per_device(mesh, x, 1),
                lambda: plain.ring_shift_ref(mesh, x, 1), nccl_shift,
                "torch.distributed.batch_isend_irecv (NCCL)")}
        for kname, (run, ref_fn, lib, lib_call) in kinds.items():
            got, want = run(), ref_fn()
            torch.cuda.synchronize()
            small.setdefault(kname, {})[f"m{m}"] = {
                "ok": bool(torch.equal(got, want)),
                "ms": timed_ms(run), "plain_ms": timed_ms(ref_fn),
                "library_ms": timed_ms(lib), "library_call": lib_call}
    dist.barrier()
    # the entry points, every method, counted
    pp = make_comm_mesh(axes=[("pp", n)])
    shards = {"m16": _ll_draw(torch, g, 16, device=mesh.device),
              "f32_3d": torch.randn((4, 8, 16), generator=g,
                                    device=mesh.device),
              "odd_3x5": _ll_draw(torch, g, *LL_ODD, device=mesh.device)}
    # the kernel each fast_allgather method takes on the card (AUTO:
    # FULL_MESH at these sizes, B22 for rows B8 does not take)
    ag_kernel = {"xla": None, "full_mesh": "full_mesh_all_gather",
                 "bidir_ring": "bidir_ring_ag_per_device",
                 "ring_2d": "ring2d_ag_per_device",
                 "auto": "full_mesh_all_gather"}
    pairs = ((0, 1), (2, 3), (3, 0), (1, 1))
    # two passes, the first a warm-up (it makes the ops' symmetric
    # buffers); the second counted
    for _ in range(2):
        kern.reset_launch_counts()
        ok, want = {}, dict.fromkeys(kern.launch_counts(), 0)
        for name, x in shards.items():
            odd = name == "odd_3x5"
            cat = plain.all_gather_cat(mesh, x)
            for meth, kname in ag_kernel.items():
                if odd and meth == "full_mesh":
                    continue            # B8's contract: 16-byte rows
                if odd and meth == "auto":
                    kname = "bidir_ring_ag_per_device"
                ctx = llm.create_fast_allgather_context(
                    mesh, "tp", method=llm.LLAllGatherMethod(meth), nx=2)
                ok[f"fast_allgather/{meth}/{name}"] = bool(
                    torch.equal(llm.fast_allgather(ctx, x), cat))
                if kname:
                    want[kname] += 1
            ok[f"layer/{name}"] = bool(torch.equal(
                LowLatencyAllGatherLayer.create(mesh)(x), cat))
            want["bidir_ring_ag_per_device" if odd
                 else "full_mesh_all_gather"] += 1
            for src, dst in pairs:
                ok[f"p2p_put_op/{src}_{dst}/{name}"] = bool(torch.equal(
                    p2pm.p2p_put_op(mesh, "tp", x, src, dst),
                    plain.p2p_ref(mesh, x, src, dst)))
            comm = CommOp(pp)
            ok[f"comm_send_recv/{name}"] = bool(torch.equal(
                comm.send_recv(x, 0, 2), plain.p2p_ref(mesh, x, 0, 2)))
            want["p2p_put_per_device"] += len(pairs) + 1
            for by in (1, 3):           # NCCL point-to-point, no kernel
                ok[f"comm_shift{by}/{name}"] = bool(torch.equal(
                    comm.shift(x, by=by), plain.ring_shift_ref(mesh, x, by)))
            ok[f"barrier_all_op/{name}"] = bool(torch.equal(
                cops.barrier_all_op(mesh, "tp", x), x))
            want["barrier_all_per_device"] += 1
            for s in range(n):
                ok[f"ring_shift_op/{s}/{name}"] = bool(torch.equal(
                    cops.ring_shift_op(mesh, "tp", x, shift=s),
                    plain.ring_shift_ref(mesh, x, s)))
            want["ring_shift_per_device"] += n
        torch.cuda.synchronize()
        counts = kern.launch_counts()
        dist.barrier()
    return {"sweep": sweep, "small": small, "entry_points": ok,
            "launches": counts, "launches_want": want,
            "auto": {name: llm.create_fast_allgather_context(mesh).resolve(
                x.numel() * x.element_size()).value
                for name, x in shards.items()}}


def _tp4_comm_rows(results, extra):
    """The parent's side of tp4_comm: the sweep's slowest rank, the AUTO
    rule it sets, every entry point's check on every rank, the launch
    gate, and the kernel rows of B22-B26 (slowest rank)."""
    from triton_dist_tpu_torch.kernels import low_latency_allgather as llm
    per = [results[r]["comm"] for r in range(TP)]
    sweep = []
    for i, first in enumerate(per[0]["sweep"]):
        rws = [p["sweep"][i] for p in per]
        sweep.append({
            "rows_per_rank": first["rows_per_rank"],
            "shard_bytes": first["shard_bytes"],
            **{k: max(x[k] for x in rws) for k in first if k.endswith("_ms")},
            "equal_nccl": all(all(x["equal_nccl"].values()) for x in rws)})
    fastest = [min(("b8", "b22", "b23", "nccl"), key=lambda k: s[f"{k}_ms"])
               for s in sweep]
    emit({"phase": "ll_ag_auto_sweep", "tp": TP, "dtype": "bf16",
          "hidden": LL_HIDDEN, "slowest_rank": sweep,
          "fastest_by_size": fastest,
          "auto_ll_full_mesh_max_shard_bytes":
          llm.LL_FULL_MESH_MAX_SHARD_BYTES})
    bad = [f"entry points on rank {r}: "
           f"{[k for k, v in p['entry_points'].items() if not v]}"
           for r, p in enumerate(per) if not all(p["entry_points"].values())]
    if not all(s["equal_nccl"] for s in sweep):
        bad.append(f"an all-gather's rows are not NCCL's bytes: {sweep}")
    if any(p["launches"] != p["launches_want"] for p in per):
        bad.append(f"launches {[p['launches'] for p in per]}, want "
                   f"{per[0]['launches_want']}")
    small = {}
    for kname in per[0]["small"]:
        small[kname] = {}
        for shp in per[0]["small"][kname]:
            rws = [p["small"][kname][shp] for p in per]
            if not all(x["ok"] for x in rws):
                bad.append(f"{kname} at {shp} disagrees with its plain "
                           "version")
            small[kname][shp] = {k: max(x[k] for x in rws) for k in
                                 ("ms", "plain_ms", "library_ms")}
            small[kname][shp]["per_rank_ms"] = [x["ms"] for x in rws]
            small[kname][shp]["library_call"] = rws[0]["library_call"]
    emit({"phase": "tp4_comm", "tp": TP, "small": small,
          "auto_by_shard": per[0]["auto"], "launches": per[0]["launches"],
          "entry_points_checked": len(per[0]["entry_points"]),
          "ok": not bad})
    if bad:
        fail("tp4_comm: " + "; ".join(bad))
    extra["tp4_comm"] = per[0]["launches"]
    rows = {}
    shard = LL_HEADLINE * LL_HIDDEN * 2
    for kname, key in (("bidir_ring_ag_per_device", "b22"),
                       ("ring2d_ag_per_device", "b23")):
        timed = {}
        for s in sweep:
            sb = s["shard_bytes"]
            bms, by = tp_bound_ms(sb + TP * sb, (TP - 1) * sb, 0.0)
            timed[f"m{s['rows_per_rank']}"] = {
                "ms": s[f"{key}_ms"], "plain_ms": s["plain_ms"],
                "library_ms": s["nccl_ms"], "bound_ms": bms,
                "bound_by": by, "b8_ms": s["b8_ms"]}
        head = f"m{LL_HEADLINE}"
        rows[kname] = _ll_row(
            kname, [{"max_abs_err": 0.0}],
            {head: timed[head], **{k: v for k, v in timed.items()
                                   if k != head}}, "4 cards, TP=4",
            library_ms_call="torch.distributed.all_gather_into_tensor "
                            "(NCCL)")
    for kname, shapes in small.items():
        timed = {}
        for shp, t in shapes.items():
            sb = int(shp[1:]) * LL_HIDDEN * 2
            link = 0 if kname == "barrier_all_per_device" else sb
            bms, by = tp_bound_ms(2 * sb, link, 0.0)
            timed[shp] = dict(t, bound_ms=bms, bound_by=by)
        rows[kname] = _ll_row(
            kname, [{"max_abs_err": 0.0}], timed, "4 cards, TP=4",
            library_ms_call=next(iter(shapes.values()))["library_call"],
            bound_note=_LL_FLAG_NOTE)
    for kname, row in rows.items():
        row["launches_by_path"] = {"tp4_comm": per[0]["launches"][kname]}
        row["launches"] = per[0]["launches"][kname]
    return rows


# -- the quantized wire (PR 12): B27, B28, B29, B30 ---------------------------

QW_HIDDEN = 5120            # Qwen3-32B's hidden: the rows the sums carry
QW_ROWS = (16, 512)         # B28: a TP=4 decode step's rows, a 512-token
#                             prefill chunk's
# B27 at the int8 ring's hop shapes (a quarter of the rows, f32 partials:
# 16 decode rows and a 512-row chunk) and a bf16 decode x
QW_B27_SHAPES = (("hop_m4_f32", 4, "f32"), ("m16_bf16", 16, "bf16"),
                 ("hop_m128_f32", 128, "f32"))
# the KV payloads: one layer's four page planes (K / V x 2 kv heads of
# Qwen3-32B at TP=4, 128-token pages of head_dim 128: the decode-size
# move) and one 2,048-token request's pages held by one rank (64 layers x
# K / V x 2 kv heads x 16 pages), bf16
KV_PAGES = {"step_128KiB": (4, 128, 128), "request_128MiB": (4096, 128, 128)}
KV_FANOUTS = ((0, (1, 2, 3)), (2, (0, 3)), (3, (1,)))
_QW_SRC = {"quantize_stage_per_device": "quant_wire.cu",
           "qint8_one_shot_per_device": "quant_wire.cu",
           "kv_handoff_per_device": "kv_handoff.cu",
           "kv_handoff_fanout_per_device": "kv_handoff.cu"}
_QW_REPLACES = {
    "quantize_stage_per_device": "triton_dist_tpu/kernels/quant_wire.py:59",
    "qint8_one_shot_per_device": "triton_dist_tpu/kernels/quant_wire.py:101",
    "kv_handoff_per_device": "triton_dist_tpu/kernels/kv_handoff.py:68",
    "kv_handoff_fanout_per_device":
        "triton_dist_tpu/kernels/kv_handoff.py:186"}


def _qw_dtype(torch, name):
    return torch.bfloat16 if name == "bf16" else torch.float32


def _qw_row(name, rows, timed, measured_on, **extra):
    """A kernels-line row of B27-B30: the first shape's numbers."""
    return _sp_row(name, _QW_SRC[name], _QW_REPLACES[name], rows, timed,
                   measured_on, **extra)


def _qw_budget(torch, xs, method):
    """(exact f32 sum of the ranks' xs, the allreduce/<method> contract's
    budget, plus half a bf16 ulp of the sum for a bf16 output's own
    rounding, plus 1e-7)."""
    from triton_dist_tpu_torch.quant.contract import contract_for
    exact = sum(x.float() for x in xs)
    budget = contract_for("allreduce", method).budget(xs) + 1e-7
    if xs[0].dtype == torch.bfloat16:
        budget = budget + exact.abs() * 2.0 ** -8
    return exact, budget


def _kv_within(torch, src, got) -> bool:
    """The int8 wire's pages within the kv_handoff/kv_int8_page contract
    of src's pages, plus half a bf16 ulp of |src| (a bf16 decode's own
    rounding), plus 1e-7."""
    from triton_dist_tpu_torch.quant.contract import contract_for
    budget = contract_for("kv_handoff", "kv_int8_page").budget([src])
    if got.dtype == torch.bfloat16:
        budget = budget + src.float().abs() * 2.0 ** -8
    return bool(((got.float() - src.float()).abs() <= budget + 1e-7).all())


def _ring_emulate(torch, xs, me):
    """The int8 ring's definition on rank ``me`` from every rank's x, in
    one process (plain encodes): the reduce-scatter's hops, then the
    all-gather's; the product and the sum separate ops."""
    from triton_dist_tpu_torch.kernels.plain import quantize_stage_ref
    n = len(xs)
    rows, d = xs[0].shape
    chunks = [x.float().reshape(n, rows // n, d) for x in xs]
    cur = [chunks[r][r] for r in range(n)]
    for s in range(n - 1):
        sent = [quantize_stage_ref(c) for c in cur]
        cur = [sent[(r - 1) % n][0].float() * sent[(r - 1) % n][1]
               + chunks[r][(r - s - 1) % n] for r in range(n)]
    q = [quantize_stage_ref(c) for c in cur]
    out = [None] * n
    out[(me + 1) % n] = q[me][0].float() * q[me][1]
    for s in range(n - 1):
        q = [q[(r - 1) % n] for r in range(n)]
        out[(me - s) % n] = q[me][0].float() * q[me][1]
    return torch.cat(out).to(xs[0].dtype)


def phase_b27_b28(torch, symm, kern, qw, arm, calls: int = 5):
    """B27 (the int8 staging encode) at the int8 ring's hop shapes and a
    bf16 decode x, each with an all-zero row, bitwise its plain version
    (q and the scales) and timed in a CUDA graph of 20 calls; then B28
    (the int8 one-shot all-reduce) in the one-card world at (16, 5120)
    and (512, 5120), bf16 and f32: every rank's output bitwise the plain
    twin's (every rank's encode, folded in rank order in f32, one cast),
    the four ranks' outputs the same bytes, within the qint8_os contract's
    budget of the exact f32 sum; `calls` successive calls; timed (the
    four ranks together, queued_ms) beside its plain version and B5 on
    the same inputs. Then the mesh-level path, counted:
    ``all_reduce_per_device(QINT8_OS)`` on every rank."""
    from triton_dist_tpu_torch.kernels.plain import quantize_stage_ref
    g = torch.Generator(device=DEV).manual_seed(127)
    rows27, t27 = [], {}
    for name, m, dt in QW_B27_SHAPES:
        x = torch.randn((m, QW_HIDDEN), generator=g, device=DEV).to(
            _qw_dtype(torch, dt))
        x[0] = 0
        (q, s), (rq, rs) = qw.quantize_stage_per_device(x), \
            quantize_stage_ref(x)
        torch.cuda.synchronize()
        err = (q.float() * s - rq.float() * rs).abs().max().item()
        rows27.append({"case": name, "max_abs_err": err,
                       "ok": bool(torch.equal(q, rq) and torch.equal(s, rs))})
        nbytes = m * QW_HIDDEN * (x.element_size() + 1) + 4 * m
        bms, by = bound_ms(nbytes, 0.0)
        t27[name] = {
            "ms": graph_time_ms(lambda: qw.quantize_stage_per_device(x)),
            "plain_ms": graph_time_ms(lambda: quantize_stage_ref(x)),
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "bytes": nbytes, "max_abs_err": err}
    world = symm.OneCardWorld(TP)
    rows28, t28 = [], {}

    def b28(xs):
        return world.run(lambda r: qw.qint8_one_shot_per_device(
            world.mesh(r), xs[r]))

    def check(tag, xs):
        outs = b28(xs)
        torch.cuda.synchronize()
        ref = qw.qint8_one_shot_ref_shards(xs)[0]
        exact, budget = _qw_budget(torch, xs, "qint8_os")
        res = [{"case": f"{tag}/rank{r}",
                "max_abs_err": (o.float() - ref.float()).abs().max().item(),
                "max_err_vs_exact": (o.float() - exact).abs().max().item(),
                "within_contract": bool(((o.float() - exact).abs()
                                         <= budget).all()),
                "ok": bool(torch.equal(o, ref))} for r, o in enumerate(outs)]
        res[0]["ranks_same_bytes"] = _same_bytes(torch, outs)
        for x in res:
            x["ok"] = x["ok"] and x["within_contract"] and \
                res[0]["ranks_same_bytes"]
        return res

    def draw(m, dt):
        return [torch.randn((m, QW_HIDDEN), generator=g, device=DEV).to(
            _qw_dtype(torch, dt)) for _ in range(TP)]

    for m in QW_ROWS:
        for dt in ("bf16", "f32"):
            xs = draw(m, dt)
            rows28 += check(f"m{m}_{dt}", xs)
            if dt != "bf16":
                continue
            nbytes = TP * 2 * m * QW_HIDDEN * 2
            bms, by = bound_ms(nbytes, 0.0)
            ms, host_s, ahead = queued_ms(torch, lambda: b28(xs))
            t28[f"m{m}"] = {
                "ms": ms, "plain_ms": queued_ms(
                    torch, lambda: qw.qint8_one_shot_ref_shards(xs))[0],
                "library_ms": queued_ms(torch, lambda: world.run(
                    lambda r: arm.one_shot_all_reduce(world.mesh(r),
                                                      xs[r])))[0],
                "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                "host_enqueue_s": host_s, "queued_ahead": ahead,
                "max_abs_err": max(x["max_abs_err"] for x in rows28[-TP:])}
    seq_ok = [all(x["ok"] for x in check("seq_m16", draw(16, "bf16")))
              for _ in range(calls)]
    xs = draw(16, "bf16")
    kern.reset_launch_counts()
    outs = world.run(lambda r: arm.all_reduce_per_device(
        TP, arm.AllReduceMethod.QINT8_OS, xs[r], mesh=world.mesh(r)))
    torch.cuda.synchronize()
    path = kern.launch_counts()
    ref = qw.qint8_one_shot_ref_shards(xs)[0]
    op_ok = all(torch.equal(o, ref) for o in outs) and \
        path == _only(path, qint8_one_shot_per_device=TP)
    emit({"phase": "b27_b28_qint8", "world": "one card, 4 logical ranks",
          "b27_cases": rows27, "b28_cases": rows28,
          "successive_calls_ok": seq_ok, "b27_timed": t27,
          "b28_timed": t28, "mesh_op": {"launches": path, "ok": op_ok}})
    if not all(x["ok"] for x in rows27 + rows28) or not all(seq_ok) or \
            not op_ok:
        fail(f"B27/B28 disagree with their plain versions, leave the "
             f"contract or the mesh-level op did not take B28: "
             f"{[x for x in rows27 + rows28 if not x['ok']]}; successive "
             f"{seq_ok}; mesh op {path}")
    lib = "B5 one_shot_all_reduce on the same inputs (one card: NCCL " \
          "needs a process per card)"
    return [_qw_row("quantize_stage_per_device", rows27, t27, "one card"),
            _qw_row("qint8_one_shot_per_device", rows28, t28,
                    "one card, 4 logical ranks", library_ms_call=lib,
                    launches_by_path={"mesh_op_one_card":
                                      path["qint8_one_shot_per_device"]},
                    launches=path["qint8_one_shot_per_device"])]


def phase_b29_b30(torch, symm, kern, kvm, codec, calls: int = 3):
    """B29 (the KV page handoff) for every (src, dst) pair and B30 (its
    fan-out) for three destination sets, at comm_blocks 1 and 4, in the
    one-card world on one layer's four page planes (128 KiB) and one
    request's pages (128 MiB) of Qwen3-32B at TP=4, bf16: every rank's
    output bitwise the plain version's (dst: src's pages; everyone else
    its own); `calls` successive calls; ``kv_handoff_quantized``
    (kv_int8_page: B30 twice) bitwise its definition (the codec's decode
    of src's encoded pages on the destinations) and within the
    kv_handoff contract. Timed (queued_ms, the four ranks together) at
    the pair (0, 3) and the fan-out 0 -> {1, 2, 3}, beside the plain
    version (copies of the right shards) and one torch.stack of them.
    Then the mesh-level ops, counted."""
    world = symm.OneCardWorld(TP)
    g = torch.Generator(device=DEV).manual_seed(129)
    n = TP
    c = codec.codec("kv_int8_page")
    pairs = [(s, d) for s in range(n) for d in range(n) if s != d]
    rows = []
    timed = {"kv_handoff_per_device": {}, "kv_handoff_fanout_per_device": {}}

    def b29(xs, s, d, cb):
        return world.run(lambda r: kvm.kv_handoff_per_device(
            world.mesh(r), xs[r], s, d, cb))

    def b30(xs, s, ds, cb):
        return world.run(lambda r: kvm.kv_handoff_fanout_per_device(
            world.mesh(r), xs[r], s, ds, cb))

    def check(tag, xs, cb):
        res = []
        for s, d in pairs:
            outs = b29(xs, s, d, cb)
            torch.cuda.synchronize()
            res += [dict(x, kernel="kv_handoff_per_device") for x in
                    _slot_rows(f"{tag}/b29_{s}_{d}", outs,
                               [xs[s] if r == d else xs[r]
                                for r in range(n)])]
        for s, ds in KV_FANOUTS:
            outs = b30(xs, s, ds, cb)
            torch.cuda.synchronize()
            res += [dict(x, kernel="kv_handoff_fanout_per_device") for x in
                    _slot_rows(f"{tag}/b30_{s}_{''.join(map(str, ds))}",
                               outs, [xs[s] if r in ds else xs[r]
                                      for r in range(n)])]
        return res

    quant = []
    for pname, shape in KV_PAGES.items():
        xs = [torch.randn(shape, generator=g, device=DEV).to(torch.bfloat16)
              for _ in range(n)]
        enc = [c.encode(x) for x in xs]
        dec0 = c.decode(*enc[0], torch.bfloat16)
        for cb in (1, 4):
            rows += check(f"{pname}/cb{cb}", xs, cb)
            # the int8 wire: its two fan-outs' buffers made and its torch
            # kernels loaded before any spinning launch
            b30([q for q, _ in enc], 0, (1, 2, 3), cb)
            b30([s for _, s in enc], 0, (1, 2, 3), cb)
            outs = world.run(lambda r: kvm.kv_handoff_quantized(
                world.mesh(r), "tp", xs[r], 0, (1, 2, 3), comm_blocks=cb))
            torch.cuda.synchronize()
            for r, o in enumerate(outs):
                want = dec0 if r else xs[0]
                quant.append({"case": f"{pname}/cb{cb}/rank{r}",
                              "ok": bool(torch.equal(o, want))
                              and _kv_within(torch, xs[0], o),
                              "max_abs_err_vs_src": (o.float() - xs[0].float())
                              .abs().max().item()})
        shard = xs[0].numel() * xs[0].element_size()
        for kname, run, want in (
                ("kv_handoff_per_device", lambda: b29(xs, 0, 3, 4),
                 [xs[0] if r == 3 else xs[r] for r in range(n)]),
                ("kv_handoff_fanout_per_device",
                 lambda: b30(xs, 0, (1, 2, 3), 4),
                 [xs[0] if r else xs[r] for r in range(n)])):
            nbytes = n * 2 * shard
            bms, by = bound_ms(nbytes, 0.0)
            ms, host_s, ahead = queued_ms(torch, run)
            timed[kname][pname] = {
                "ms": ms, "comm_blocks": 4,
                "plain_ms": queued_ms(torch, lambda: [
                    y.clone() for y in want])[0],
                "library_ms": queued_ms(torch, lambda: torch.stack(
                    want))[0],
                "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                "host_enqueue_s": host_s, "queued_ahead": ahead}
    xs = [torch.randn(KV_PAGES["step_128KiB"], generator=g,
                      device=DEV).to(torch.bfloat16) for _ in range(n)]
    seq_ok = [all(x["ok"] for x in check("seq_step", xs, 4))
              for _ in range(calls)]
    kern.reset_launch_counts()
    outs = world.run(lambda r: (
        kvm.kv_handoff(world.mesh(r), "tp", xs[r], 0, 3),
        kvm.kv_handoff_fanout(world.mesh(r), "tp", xs[r], 0, (1, 2, 3)),
        kvm.kv_handoff_quantized(world.mesh(r), "tp", xs[r], 0,
                                 (1, 2, 3))))
    torch.cuda.synchronize()
    path = kern.launch_counts()
    dec0 = c.decode(*c.encode(xs[0]), torch.bfloat16)
    op_ok = all(torch.equal(o[0], xs[0] if r == 3 else xs[r])
                and torch.equal(o[1], xs[0] if r else xs[r])
                and torch.equal(o[2], dec0 if r else xs[r])
                for r, o in enumerate(outs)) and \
        path == _only(path, kv_handoff_per_device=n,
                      kv_handoff_fanout_per_device=3 * n)
    emit({"phase": "b29_b30_kv_handoff", "world": "one card, 4 logical ranks",
          "payloads": {k: list(v) for k, v in KV_PAGES.items()},
          "cases": len(rows), "failed": [x for x in rows if not x["ok"]],
          "quantized": quant, "successive_calls_ok": seq_ok,
          "timed": timed, "mesh_ops": {"launches": path, "ok": op_ok}})
    if not all(x["ok"] for x in rows + quant) or not all(seq_ok) or \
            not op_ok:
        fail(f"B29/B30 disagree with their plain versions, the int8 wire "
             f"left its contract or the mesh-level ops did not take them: "
             f"{[x for x in rows + quant if not x['ok']][:8]}; successive "
             f"{seq_ok}; mesh ops {path}")
    return [_qw_row(kname, [x for x in rows if x["kernel"] == kname],
                    timed[kname], "one card, 4 logical ranks",
                    library_ms_call="torch.stack of the output shards "
                                    "(one card)",
                    launches_by_path={"mesh_ops_one_card": path[kname]},
                    launches=path[kname])
            for kname in timed]


def _tp4_quant(torch, dist, mesh, kern):
    """The quantized wire on four cards, each rank on its own draws: B28
    at (16, 5120) and (512, 5120) bf16 / f32 bitwise its plain twin (NCCL
    all-gather of q and s, the fold), the four ranks' bytes the same,
    within the qint8_os contract of the exact sum; the int8 ring (QINT8)
    at (16, 5120) bf16 / f32 bitwise its definition run in one process on
    the gathered x, within the qint8 contract, B27's launches per call;
    B27 alone at its hop shapes; the KV moves (kv_handoff 0 -> 3,
    kv_handoff_fanout 0 -> {1, 2, 3}, kv_handoff_quantized on the same
    fan-out) at both payloads and comm_blocks 1 and 4, bitwise the XLA
    twins (send / recv, all-gather + select); timed (queued_ms, after a
    barrier) beside NCCL: all_reduce (and B5) for B28 and the ring, a
    send / recv pair for B29, a broadcast for B30. Then, the counts
    zeroed, the mesh-level entry points once each, counted."""
    from triton_dist_tpu_torch.kernels import allreduce as arm
    from triton_dist_tpu_torch.kernels import plain
    from triton_dist_tpu_torch.kernels import quant_wire as qw
    from triton_dist_tpu_torch.kernels.gemm_allreduce import (
        GemmArMethod, gemm_ar_per_device,
    )
    kvm = importlib.import_module("triton_dist_tpu_torch.kernels.kv_handoff")
    me, n = mesh.rank, mesh.world
    g = torch.Generator(device=mesh.device).manual_seed(131 + me)

    def timed_ms(fn):
        dist.barrier()
        return queued_ms(torch, fn)[0]

    def draw(shape, dt):
        return torch.randn(shape, generator=g, device=mesh.device).to(
            _qw_dtype(torch, dt))

    def nccl_ar(x):
        def run():
            y = x.clone()
            dist.all_reduce(y, group=mesh.group)
            return y
        return run

    b27 = {}
    for name, m, dt in QW_B27_SHAPES:
        x = draw((m, QW_HIDDEN), dt)
        b27[name] = {"ms": graph_time_ms(
            lambda: qw.quantize_stage_per_device(x)), "plain_ms":
            graph_time_ms(lambda: plain.quantize_stage_ref(x))}
    b28 = {}
    for m in QW_ROWS:
        for dt in ("bf16", "f32"):
            x = draw((m, QW_HIDDEN), dt)
            got = qw.qint8_one_shot_per_device(mesh, x)
            want = qw.qint8_one_shot_reference_per_device(mesh, x)
            xs = plain.all_gather_list(mesh, x)
            exact, budget = _qw_budget(torch, xs, "qint8_os")
            err = (got.float() - exact).abs()
            rec = {"ok": bool(torch.equal(got, want)),
                   "ranks_same_bytes": _same_bytes(
                       torch, plain.all_gather_list(mesh, got)),
                   "within_contract": bool((err <= budget).all()),
                   "max_err_vs_exact": err.max().item(),
                   "budget_max": budget.max().item()}
            if dt == "bf16":
                rec.update(
                    ms=timed_ms(lambda: qw.qint8_one_shot_per_device(mesh,
                                                                     x)),
                    plain_ms=timed_ms(
                        lambda: qw.qint8_one_shot_reference_per_device(
                            mesh, x)),
                    b5_ms=timed_ms(lambda: arm.one_shot_all_reduce(mesh, x)),
                    nccl_ms=timed_ms(nccl_ar(x)))
            b28[f"m{m}_{dt}"] = rec
    ring = {}
    for dt in ("bf16", "f32"):
        x = draw((16, QW_HIDDEN), dt)
        before = kern.launch_counts()["quantize_stage_per_device"]
        got = arm.all_reduce_per_device(n, arm.AllReduceMethod.QINT8, x,
                                        mesh=mesh)
        torch.cuda.synchronize()
        per_call = kern.launch_counts()["quantize_stage_per_device"] - before
        xs = plain.all_gather_list(mesh, x)
        exact, budget = _qw_budget(torch, xs, "qint8")
        err = (got.float() - exact).abs()
        rec = {"ok": bool(torch.equal(got, _ring_emulate(torch, xs, me))),
               "ranks_same_bytes": _same_bytes(
                   torch, plain.all_gather_list(mesh, got)),
               "within_contract": bool((err <= budget).all()),
               "max_err_vs_exact": err.max().item(),
               "b27_launches_per_call": per_call}
        if dt == "bf16":
            rec.update(ms=timed_ms(lambda: arm.all_reduce_per_device(
                n, arm.AllReduceMethod.QINT8, x, mesh=mesh)),
                nccl_ms=timed_ms(nccl_ar(x)))
        ring[dt] = rec
    kv = {}
    for pname, shape in KV_PAGES.items():
        x = draw(shape, "bf16")
        y = torch.empty_like(x)

        def p2p():
            if me not in (0, 3):
                return x
            for req in dist.batch_isend_irecv(
                    [dist.P2POp(dist.isend, x, 3, mesh.group)] if me == 0
                    else [dist.P2POp(dist.irecv, y, 0, mesh.group)]):
                req.wait()
            return y

        def bcast():
            dist.broadcast(x if me == 0 else y, src=0, group=mesh.group)
            return y

        for cb in (1, 4):
            ops = {
                "kv_handoff_per_device": (
                    lambda: kvm.kv_handoff(mesh, "tp", x, 0, 3,
                                           comm_blocks=cb),
                    lambda: kvm.kv_handoff(mesh, "tp", x, 0, 3,
                                           method="xla"), p2p,
                    x.numel() * 2, x.numel() * 2),
                "kv_handoff_fanout_per_device": (
                    lambda: kvm.kv_handoff_fanout(mesh, "tp", x, 0,
                                                  (1, 2, 3), comm_blocks=cb),
                    lambda: kvm.kv_handoff_fanout(mesh, "tp", x, 0,
                                                  (1, 2, 3), method="xla"),
                    bcast, x.numel() * 2, 3 * x.numel() * 2),
                "quantized": (
                    lambda: kvm.kv_handoff_quantized(mesh, "tp", x, 0,
                                                     (1, 2, 3),
                                                     comm_blocks=cb),
                    lambda: kvm.kv_handoff_quantized(mesh, "tp", x, 0,
                                                     (1, 2, 3),
                                                     method="xla"),
                    None, None, None)}
            src_pages = ops["kv_handoff_fanout_per_device"][1]()
            for name, (run, ref, lib, hbm, link) in ops.items():
                got, want = run(), ref()
                torch.cuda.synchronize()
                rec = {"ok": bool(torch.equal(got, want))}
                if name == "quantized":
                    rec["within_contract"] = _kv_within(torch, src_pages,
                                                        got)
                    rec["max_abs_err_vs_src"] = (
                        got.float() - src_pages.float()).abs().max().item()
                rec.update(ms=timed_ms(run), plain_ms=timed_ms(ref))
                if lib is not None:
                    rec.update(library_ms=timed_ms(lib),
                               bytes_hbm=2 * hbm, bytes_link=link)
                kv[f"{name}/{pname}/cb{cb}"] = rec
    # the entry points once each, the counts zeroed after the warm-ups
    x16 = draw((16, QW_HIDDEN), "bf16")
    a = draw((16, 256), "bf16")
    b = draw((256, QW_HIDDEN), "bf16")
    pages = draw(KV_PAGES["step_128KiB"], "bf16")
    dist.barrier()
    kern.reset_launch_counts()
    arm.all_reduce_per_device(n, arm.AllReduceMethod.QINT8_OS, x16,
                              mesh=mesh)
    arm.all_reduce_per_device(n, arm.AllReduceMethod.QINT8, x16, mesh=mesh)
    gemm_ar_per_device(n, GemmArMethod.XLA_QINT8, a, b, mesh=mesh)
    kvm.kv_handoff(mesh, "tp", pages, 0, 3)
    kvm.kv_handoff_fanout(mesh, "tp", pages, 0, (1, 2, 3))
    kvm.kv_handoff_quantized(mesh, "tp", pages, 0, (1, 2, 3))
    torch.cuda.synchronize()
    counts = kern.launch_counts()
    want = _only(counts, qint8_one_shot_per_device=1,
                 quantize_stage_per_device=2 * n, kv_handoff_per_device=1,
                 kv_handoff_fanout_per_device=3)
    dist.barrier()
    return {"b27": b27, "b28": b28, "ring": ring, "kv": kv,
            "launches": counts, "launches_want": want}


def _tp4_quant_rows(results, extra):
    """The parent's side of tp4_quant: every check on every rank, the
    launch gate, and the kernel rows of B27-B30 (slowest rank)."""
    per = [results[r]["quant"] for r in range(TP)]
    bad = []
    for r, p in enumerate(per):
        for sect in ("b28", "ring", "kv"):
            for case, rec in p[sect].items():
                if not rec["ok"] or not rec.get("ranks_same_bytes", True) \
                        or not rec.get("within_contract", True):
                    bad.append(f"rank {r} {sect}/{case}: {rec}")
        if any(x["b27_launches_per_call"] != TP for x in p["ring"].values()):
            bad.append(f"rank {r}: B27 launches per ring call "
                       f"{[x['b27_launches_per_call'] for x in p['ring'].values()]}")
        if p["launches"] != p["launches_want"]:
            bad.append(f"rank {r}: launches {p['launches']}, want "
                       f"{p['launches_want']}")

    def slowest(sect, case, key):
        vals = [p[sect][case].get(key) for p in per]
        return None if any(v is None for v in vals) else max(vals)

    summary = {sect: {case: {k: slowest(sect, case, k) for k in rec
                             if isinstance(rec[k], float)}
                      for case, rec in per[0][sect].items()}
               for sect in ("b27", "b28", "ring", "kv")}
    emit({"phase": "tp4_quant", "tp": TP, "slowest_rank": summary,
          "ring_b27_launches_per_call": per[0]["ring"]["bf16"][
              "b27_launches_per_call"],
          "launches": per[0]["launches"], "ok": not bad})
    if bad:
        fail("tp4_quant: " + "; ".join(bad[:8]))
    extra["tp4_quant"] = per[0]["launches"]
    h = QW_HIDDEN
    t27 = {}
    for name, m, dt in QW_B27_SHAPES:
        es = 2 if dt == "bf16" else 4
        nbytes = m * h * (es + 1) + 4 * m
        bms, by = bound_ms(nbytes, 0.0)
        t27[name] = {"ms": summary["b27"][name]["ms"],
                     "plain_ms": summary["b27"][name]["plain_ms"],
                     "library_ms": None, "bound_ms": bms, "bound_by": by,
                     "bytes": nbytes}
    t28 = {}
    for m in QW_ROWS:
        s = summary["b28"][f"m{m}_bf16"]
        bms, by = tp_bound_ms(2 * m * h * 2, (TP - 1) * (m * h + 4 * m), 0.0)
        t28[f"m{m}"] = {"ms": s["ms"], "plain_ms": s["plain_ms"],
                        "library_ms": s["nccl_ms"], "b5_ms": s["b5_ms"],
                        "bound_ms": bms, "bound_by": by,
                        "max_err_vs_exact": s["max_err_vs_exact"],
                        "per_rank_ms": [p["b28"][f"m{m}_bf16"]["ms"]
                                        for p in per]}
    rows = {
        "quantize_stage_per_device": _qw_row(
            "quantize_stage_per_device", [{"max_abs_err": 0.0}], t27,
            "4 cards, TP=4 (each card alone)",
            ring_16x5120_bf16=summary["ring"]["bf16"]),
        "qint8_one_shot_per_device": _qw_row(
            "qint8_one_shot_per_device", [{"max_abs_err": 0.0}], t28,
            "4 cards, TP=4",
            library_ms_call="torch.distributed.all_reduce (NCCL)",
            bound_note="NVLink bytes (n-1)(mK + 4m) a rank; a flag round "
                       "trip has no data-sheet figure")}
    for kname in ("kv_handoff_per_device", "kv_handoff_fanout_per_device"):
        timed = {}
        for pname in ("request_128MiB", "step_128KiB"):
            for cb in (4, 1):
                key = f"{kname}/{pname}/cb{cb}"
                s = summary["kv"][key]
                hbm, link = per[0]["kv"][key]["bytes_hbm"], \
                    per[0]["kv"][key]["bytes_link"]
                bms, by = tp_bound_ms(hbm, link, 0.0)
                timed[f"{pname}/cb{cb}"] = {
                    "ms": s["ms"], "plain_ms": s["plain_ms"],
                    "library_ms": s["library_ms"], "bound_ms": bms,
                    "bound_by": by, "bytes_link": link}
        q = {k: v for k, v in summary["kv"].items()
             if k.startswith("quantized/")}
        rows[kname] = _qw_row(
            kname, [{"max_abs_err": 0.0}], timed, "4 cards, TP=4",
            library_ms_call=("torch.distributed.batch_isend_irecv (NCCL)"
                             if kname == "kv_handoff_per_device" else
                             "torch.distributed.broadcast (NCCL)"),
            **({"quantized_kv_int8_page": q}
               if kname == "kv_handoff_fanout_per_device" else {}))
    return rows


def _tp4_rank(rank, port, phases, tmp, queue):
    """One rank process of the four-card phases (rank r on cuda:r)."""
    import traceback
    t_start = time.time()
    try:
        import torch
        import torch.distributed as dist
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from triton_dist_tpu_torch import kernels as kern
        from triton_dist_tpu_torch import models
        from triton_dist_tpu_torch.runtime import mesh as tp_mesh
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        tp_mesh.initialize_distributed(f"tcp://localhost:{port}", TP, rank,
                                       device="cuda")
        mesh = tp_mesh.make_comm_mesh()
        res = {"seconds": {"started_at": t_start}}
        t0 = time.time()
        res["seconds"]["imports_and_init"] = t0 - t_start

        def lap(name):
            nonlocal t0
            now = time.time()
            res["seconds"][name] = now - t0
            t0 = now

        if "tp4_serve" in phases:
            res["ag_cases"] = _tp4_ag_cases(torch, dist, mesh)
            res["kernels"] = _tp_ranks_time(torch, dist, mesh)
            res["ag_sweep"] = _tp4_ag_sweep(torch, dist, mesh)
            res["mesh_ops"] = _tp4_mesh_ops(torch, dist, mesh, kern)
            lap("tp4_serve_kernels")
        if "tp4_ring" in phases:
            res["ring"] = _tp4_ring(torch, dist, mesh)
            lap("tp4_ring")
        drawn = None
        if "tp4_serve" in phases or "tp4_continuous" in phases:
            drawn = _tp4_params(torch, mesh, models)
            lap("weights_draw")
        if "tp4_serve" in phases:
            res["serve"] = _tp4_serve(torch, dist, mesh, models, kern, tmp,
                                      drawn)
            lap("tp4_serve")
        if "tp4_continuous" in phases:
            res["continuous"] = _tp4_continuous(torch, dist, mesh, models,
                                                kern, drawn)
            lap("tp4_continuous")
        drawn = None
        torch.cuda.empty_cache()
        if "tp4_consistency" in phases:
            res["consistency"] = _tp4_consistency(torch, dist, mesh, models,
                                                  tmp)
            lap("tp4_consistency")
        if "tp4_continuous_consistency" in phases:
            res["continuous_consistency"] = _tp4_continuous_consistency(
                torch, dist, mesh, models, tmp)
            lap("tp4_continuous_consistency")
        if "tp4_moe" in phases:
            res["moe"] = _tp4_moe(torch, dist, mesh, models, kern)
            lap("tp4_moe")
        if "tp4_moe_consistency" in phases:
            res["moe_consistency"] = _tp4_moe_consistency(
                torch, dist, mesh, models, tmp)
            lap("tp4_moe_consistency")
        if "tp4_ep" in phases:
            res["ep"] = _tp4_ep(torch, dist, mesh, models, kern)
            lap("tp4_ep")
        if "tp4_ep_consistency" in phases:
            res["ep_consistency"] = _tp4_ep_consistency(
                torch, dist, mesh, models, tmp)
            lap("tp4_ep_consistency")
        if "tp4_sp" in phases:
            torch.cuda.empty_cache()
            res["sp"] = _tp4_sp(torch, dist, mesh, kern)
            lap("tp4_sp")
        if "tp4_sp_consistency" in phases:
            torch.cuda.empty_cache()
            res["sp_consistency"] = _tp4_sp_consistency(torch, dist, mesh,
                                                        kern)
            lap("tp4_sp_consistency")
        if "tp4_comm" in phases:
            torch.cuda.empty_cache()
            res["comm"] = _tp4_comm(torch, dist, mesh, kern)
            lap("tp4_comm")
        if "tp4_quant" in phases:
            torch.cuda.empty_cache()
            res["quant"] = _tp4_quant(torch, dist, mesh, kern)
            lap("tp4_quant")
        dist.barrier()
        queue.put((rank, "ok", res))
        if "tp4_serve" in phases:
            t_lib = time.time()
            lib = _tp_library_time(torch, dist, mesh)
            lib["seconds"] = time.time() - t_lib
            queue.put((rank, "library", lib))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))


def _tp4_moe_rows(torch, models, results, extra):
    """The parent's side of tp4_moe: each path's record (launches per
    replay, replays and tokens checked on every rank), and the kernel rows
    of B14 and B15 across ranks from the four cards' timings (slowest
    rank), their launches those of the triton_dist serve."""
    moe = [results[r]["moe"] for r in range(TP)]
    L = models.QWEN3_ARCHS[MOE_MODEL].num_layers
    wants = {"triton_dist": {"pallas_ag_gemm": L, "pallas_gemm_rs": L,
                             "pallas_ag_group_gemm": L,
                             "pallas_moe_reduce_rs": L},
             "mega_default": {"pallas_gemm_ar": L, "fused_add_rms": L}}
    head = {k: v for k, v in moe[0].items() if k not in ("paths",
                                                         "kernels")}
    for label, want_kw in wants.items():
        per = [x["paths"][label] for x in moe]
        r = {**head, **per[0], "phase": f"tp4_moe_{label}"}
        r["peak_gb_per_card"] = [x["peak_bytes"] / 1e9 for x in per]
        r["init_peak_gb_per_card"] = [x["init_peak_bytes"] / 1e9
                                      for x in moe]
        r["decode_ms_per_step_per_rank"] = [x["decode_ms_per_step"]
                                            for x in per]
        differs = [x["own_token_differs"] for x in per]
        r.pop("own_token_differs")
        r["own_token_differs_per_rank"] = (
            None if differs[0] is None else [sum(d) for d in differs])
        r["tokens_own_argmax_disagreed"] = (
            None if differs[0] is None
            else sum(any(col) for col in zip(*differs)))
        want = _only(r["launches_per_replay"], flash_prefill=L, **want_kw)
        emit(r)
        bad = []
        if any(x["launches_per_replay"] != want for x in per):
            bad.append(f"{r['launches_per_replay']} per replay, want {want}")
        if any(x["graph_replays"] != r["gen_len"] - 1 for x in per):
            bad.append(f"{r['graph_replays']} replays")
        if any(x["eager_launches"] != _only(x["eager_launches"],
                                            flash_prefill=L) for x in per):
            bad.append(f"eager launches {r['eager_launches']}")
        if not all(x["tokens_same_on_every_rank"] for x in per) or \
                r["tokens_shape"] != [16, r["gen_len"]]:
            bad.append("ranks returned different tokens")
        if label == "mega_default" and r["mega_tier"] != "pallas_chain":
            bad.append(f"mega tier {r['mega_tier']}")
        if bad:
            fail(f"TP=4 MoE {label}: " + "; ".join(bad))
        extra[f"tp4_moe_{label}"] = r["launches"]
    rows = {}
    for key, name, rep, call in (
            ("b14", "pallas_ag_group_gemm",
             "triton_dist_tpu/kernels/allgather_group_gemm.py:146",
             "NCCL all_gather_into_tensor + torch._grouped_mm over the "
             "gathered expert-sorted rows"),
            ("b15", "pallas_moe_reduce_rs",
             "triton_dist_tpu/kernels/moe_reduce_rs.py:130",
             "torch._grouped_mm + index_add_ of the rows + NCCL "
             "reduce_scatter_tensor (f32)")):
        rws = [x["kernels"][key] for x in moe]
        if not all(x["ok"] for x in rws):
            fail(f"{name} on four cards disagrees with its plain version, "
                 f"the world-1 kernel or its repeats: {rws}")
        t = {k: max(x[k] for x in rws)
             for k in ("ms", "plain_ms", "bound_ms", "max_abs_err")}
        t["library_ms"] = (max(x["library_ms"] for x in rws)
                           if x_all_num(rws, "library_ms") else None)
        t["library_note"] = next((x["library_note"] for x in rws
                                  if x["library_note"]), None)
        t["bound_by"] = rws[0]["bound_by"]
        t["per_rank_ms"] = [x["ms"] for x in rws]
        t["live_experts"] = rws[0]["live_experts"]
        row = _tp_kernel_record(name, "moe_group_gemm.cu", rep,
                                {"decode_m4": t}, "4 cards, TP=4")
        row["launches_by_path"] = {"tp4_moe_triton_dist": moe[0]["paths"][
            "triton_dist"]["launches"][name]}
        row["launches"] = sum(row["launches_by_path"].values())
        row["library_ms_call"] = call
        emit({"phase": f"tp4_moe_{name}", "per_rank": rws})
        rows[name] = row
    return rows


def _slowest(per_rank):
    """Sweep rows of every rank merged: checks all, times the slowest."""
    return [{key: (all(x[i][key] for x in per_rank)
                   if key.endswith("_ok") else
                   max(x[i][key] for x in per_rank)
                   if key.endswith("_ms") else first[key])
             for key in first}
            for i, first in enumerate(per_rank[0])]


def _tp4_ring_rows(results, rows):
    """The parent's side of tp4_ring: every rank's edge cases and graph
    replays (B9 / B7 / TWO_SHOT and B6) must hold; the round trip of ranks
    0 and 1, the protocol sweep and B6's regime sweep (slowest rank)
    printed; the round trip and the graph-replayed times join B9's, B7's
    and B6's four-card rows where tp4_serve made them."""
    ring = [results[r]["ring"] for r in range(TP)]
    trip_ms = max(x["flag_round_trip_ms"] for x in ring)
    sweep_rows = _slowest([x["sweep"] for x in ring])
    rhd_rows = _slowest([x["rhd_sweep"] for x in ring])
    emit({"phase": "tp4_ring", "tp": TP,
          "cases_per_rank": [x["cases"] for x in ring],
          "graph_64_pairs_x3_ok": [x["graph_64_pairs_x3_ok"] for x in ring],
          "rhd_graph_64_calls_x3_ok": [x["rhd_graph_64_calls_x3_ok"]
                                       for x in ring],
          "flag_round_trip_ms_ranks_0_1": trip_ms,
          "sweep_slowest_rank": sweep_rows,
          "rhd_sweep_slowest_rank": rhd_rows})
    if not all(all(x["cases"].values()) and all(x["graph_64_pairs_x3_ok"])
               and all(x["rhd_graph_64_calls_x3_ok"]) for x in ring) or \
            not all(v for rec in sweep_rows + rhd_rows
                    for key, v in rec.items() if key.endswith("_ok")):
        fail(f"B9 / B7 / TWO_SHOT / B6 on four cards disagree with their "
             f"plain versions: {ring}")
    for name in ("ring_reduce_scatter", "ring_all_gather", "rhd_all_reduce"):
        if name in rows:
            rows[name]["latency_floor_ms"] = trip_ms


def _world1_logits_and_tokens(torch, models, tmp):
    """World 1 on card 0, from the seeds the ranks used: the bf16 64-layer
    logits of the comparison, the f32 4-layer greedy tokens."""
    import dataclasses
    res = {}
    full = models.QWEN3_ARCHS[TP_MODEL]
    if os.path.exists(os.path.join(tmp, "tp4_bf16.pt")):
        model = models.Qwen3(full, max_length=1024, dtype=torch.bfloat16,
                             device=DEV)
        params = models.init_random_params(
            torch.Generator(device=DEV).manual_seed(0), full, DEV,
            torch.bfloat16)
        ids = _tp_prompt(torch, full.vocab_size, 16, 512, 1).to(DEV)
        engine = models.Engine(model, params, mega="off")
        res["bf16"] = _rank_logits(torch, None, engine, ids[:, :512],
                                   ids[:, 512].to(torch.int32)).cpu()
        del engine, params, model
        torch.cuda.empty_cache()
    if os.path.exists(os.path.join(tmp, "tp4_f32.pt")):
        arch = dataclasses.replace(full, num_layers=4)
        model = models.Qwen3(arch, max_length=128, dtype=torch.float32,
                             device=DEV)
        params = models.init_random_params(
            torch.Generator(device=DEV).manual_seed(7), arch, DEV,
            torch.float32)
        ids = _tp_prompt(torch, arch.vocab_size, 16, 64, 2)[:, :64].to(DEV)
        res["f32"] = models.Engine(model, params, mega="off").serve(
            ids, 16).cpu()
        del params, model
        torch.cuda.empty_cache()
    if any(os.path.exists(os.path.join(tmp, f)) for f in (
            "tp4_moe_f32.pt", "tp4_ep_f32.pt")):
        arch = _tp4_moe_gate_arch(models)
        model = models.Qwen3MoE(arch, max_length=128, dtype=torch.float32,
                                device=DEV)
        params = models.init_random_params(
            torch.Generator(device=DEV).manual_seed(7), arch, DEV,
            torch.float32)
        ids = _tp_prompt(torch, arch.vocab_size, 16, 64, 5)[:, :64].to(DEV)
        res["moe_f32"] = models.Engine(model, params, mega="off").serve(
            ids, 8).cpu()
        del params, model
        torch.cuda.empty_cache()
    if os.path.exists(os.path.join(tmp, "tp4_f32_continuous.pt")):
        arch = dataclasses.replace(full, num_layers=4)
        model = models.Qwen3(arch, max_length=1024, dtype=torch.float32,
                             device=DEV)
        params = models.init_random_params(
            torch.Generator(device=DEV).manual_seed(7), arch, DEV,
            torch.float32)
        reqs = _cont_gate_traffic(torch, arch.vocab_size)
        eng = models.ContinuousEngine(model, params, max_batch=4,
                                      page_size=128, prefill_chunk=256,
                                      decode_steps=4, prefix_cache=True)
        for p, g in reqs:
            eng.submit(p, max_new_tokens=g)
        res["f32_continuous"] = [r.out for r in eng.run()]
        del eng, params, model
        torch.cuda.empty_cache()
    return res


def _rel_rms(torch, x, ref):
    return ((x - ref).float().pow(2).mean().sqrt()
            / ref.float().pow(2).mean().sqrt()).item()


def phase_four_cards(torch, models, kern, phases, timeout_s: int = 900):
    """The four-card phases: the kernels are built (main, before this),
    then four rank processes (one per card, NCCL over tcp://localhost)
    run ``phases``; world 1 runs on card 0 after they exit. Returns the
    kernel rows of the cross-rank kernels (4 cards)."""
    import multiprocessing as mp
    import socket
    import tempfile
    from triton_dist_tpu_torch.kernels import allgather as agk
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp4_")
    torch.cuda.empty_cache()
    procs = [ctx.Process(target=_tp4_rank, args=(r, port, phases, tmp, queue))
             for r in range(TP)]
    t_spawn = time.time()
    for p in procs:
        p.start()
    results, libs, errors = {}, {}, []
    t_results = t_libs = None
    want_libs = TP if "tp4_serve" in phases else 0
    deadline = time.time() + timeout_s
    lib_deadline = None
    try:
        while len(results) < TP or len(libs) < want_libs:
            if len(results) == TP and lib_deadline is None:
                lib_deadline = time.time() + 240
            left = min(deadline, lib_deadline or deadline) - time.time()
            if left <= 0:
                if len(results) < TP:
                    errors.append(f"timed out after {timeout_s} s")
                break
            try:
                rank, status, payload = queue.get(timeout=min(left, 10))
            except Exception:
                if any(p.exitcode not in (None, 0) for p in procs):
                    if len(results) < TP:
                        errors.append("a rank process died: exit codes "
                                      f"{[p.exitcode for p in procs]}")
                    break
                continue
            if status == "ok":
                results[rank] = payload
                t_results = time.time()
            elif status == "library":
                libs[rank] = payload
                t_libs = time.time()
            else:
                errors.append(f"rank {rank}: {payload}")
                break
    finally:
        # the ranks have handed over everything: 30 s in all for them to
        # tear down, then the stragglers are killed
        join_by = time.time() + (30 if not errors else 1)
        killed = 0
        for p in procs:
            p.join(timeout=max(join_by - time.time(), 0.1))
            if p.is_alive():
                killed += 1
                p.kill()
                p.join()
        t_joined = time.time()
    if errors:
        fail("four-card phases: " + " | ".join(errors))
    rows, extra = {}, {}
    if "tp4_serve" in phases:
        serve = [results[r]["serve"] for r in range(TP)]
        rec = dict(serve[0])
        replicated = rec.pop("replicated")
        rb = dict(rec.pop("bidir"))
        rec["peak_bytes_per_card"] = [s["peak_bytes"] for s in serve]
        rec["init_peak_bytes_per_card"] = [s["init_peak_bytes"]
                                           for s in serve]
        rec["decode_ms_per_step_per_rank"] = [s["decode_ms_per_step"]
                                              for s in serve]
        L = rec["layers"]
        per_step = rec["launches_per_replay"]
        want = _only(per_step, flash_prefill=L, pallas_ag_gemm=2 * L,
                     pallas_gemm_rs=2 * L)
        rec["phase"] = "tp4_serve"
        emit(rec)
        if any(s["launches_per_replay"] != want for s in serve) or \
                rec["graph_replays"] != rec["gen_len"] - 1 or \
                rec["eager_launches"] != _only(rec["eager_launches"],
                                               flash_prefill=L):
            fail(f"TP=4 serve: {per_step} per replay x "
                 f"{rec['graph_replays']} + {rec['eager_launches']} eager; "
                 f"want {want} per replay and no B12")
        if not all(s["tokens_same_on_every_rank"] for s in serve) or \
                rec["tokens_shape"] != [16, rec["gen_len"]]:
            fail("TP=4 serve: ranks returned different tokens")
        launches_by_path = {"triton_dist": rec["launches"]}
        bidir = [s["bidir"] for s in serve]
        rb.update(phase="tp4_serve_triton_dist_bidir", backend="triton_dist",
                  ag_method="pallas_bidir", rs_method="pallas_bidir",
                  model=TP_MODEL, layers=L, tp=TP, batch=16, prompt=512,
                  gen_len=rec["gen_len"], dtype="bf16")
        rb["peak_bytes_per_card"] = [x["peak_bytes"] for x in bidir]
        rb["decode_ms_per_step_per_rank"] = [x["decode_ms_per_step"]
                                             for x in bidir]
        emit(rb)
        want_b = _only(rb["launches_per_replay"], flash_prefill=L,
                       pallas_ag_gemm_bidir=2 * L,
                       pallas_gemm_rs_bidir=2 * L)
        if any(x["launches_per_replay"] != want_b for x in bidir) or \
                rb["graph_replays"] != rb["gen_len"] - 1 or \
                rb["eager_launches"] != _only(rb["eager_launches"],
                                              flash_prefill=L):
            fail(f"TP=4 triton_dist_bidir: {rb['launches_per_replay']} per "
                 f"replay x {rb['graph_replays']} + {rb['eager_launches']} "
                 f"eager; want {want_b} per replay")
        if not all(x["tokens_same_on_every_rank"] for x in bidir):
            fail("TP=4 triton_dist_bidir: ranks returned different tokens")
        launches_by_path["triton_dist_bidir"] = rb["launches"]
        sweep = [results[r]["ag_sweep"] for r in range(TP)]
        rows_sweep = []
        for i, first in enumerate(sweep[0]):
            per = [sw[i] for sw in sweep]
            rows_sweep.append({
                "rows_per_rank": first["rows_per_rank"],
                "shard_bytes": first["shard_bytes"],
                **{key: max(x[key] for x in per)
                   for key in ("b8_ms", "b7_ms", "nccl_ms")},
                "b8_equals_nccl": all(x["b8_equals_nccl"] for x in per)})
        emit({"phase": "b8_auto_sweep", "tp": TP, "dtype": "bf16",
              "hidden": 5120, "slowest_rank": rows_sweep,
              "auto_full_mesh_max_shard_bytes":
              agk.FULL_MESH_MAX_SHARD_BYTES})
        if not all(x["b8_equals_nccl"] for x in rows_sweep):
            fail(f"B8's rows are not NCCL's bytes: {rows_sweep}")
        mops = [results[r]["mesh_ops"] for r in range(TP)]
        emit({"phase": "tp4_mesh_ops", "ranks": mops})
        want_m = _only(mops[0]["launches"], full_mesh_all_gather=1,
                       pallas_ag_gemm_bidir=1, pallas_gemm_rs_bidir=1)
        if any(x["launches"] != want_m or not all(x["ok"].values())
               for x in mops):
            fail(f"TP=4 mesh-level ops: {mops}; want {want_m}")
        launches_by_path["tp4_mesh_ops"] = mops[0]["launches"]
        wants = {"mega_default": {"pallas_gemm_ar": 2 * L,
                                  "fused_add_rms": L},
                 "ar_one_shot": {"one_shot_all_reduce": 2 * L},
                 "ar_rhd": {"rhd_all_reduce": 2 * L},
                 "ar_two_shot": {"ring_reduce_scatter": 2 * L,
                                 "ring_all_gather": 2 * L},
                 "ar_qint8_os": {"qint8_one_shot_per_device": 2 * L},
                 "ar_qint8": {"quantize_stage_per_device": 2 * L * TP},
                 "mega_td_quant": {"quantize_stage_per_device": 2 * L * TP,
                                   "fused_add_rms": L}}
        for label, _, backend in _TP4_REPLICATED:
            per = [s["replicated"][label] for s in serve]
            r = dict(replicated[label])
            r.update(phase=f"tp4_serve_{label}", backend=backend,
                     model=TP_MODEL, layers=L, tp=TP, batch=16, prompt=512,
                     gen_len=rec["gen_len"], dtype="bf16")
            r["peak_bytes_per_card"] = [x["peak_bytes"] for x in per]
            r["decode_ms_per_step_per_rank"] = [x["decode_ms_per_step"]
                                                for x in per]
            differs = [x["own_token_differs"] for x in per]
            r.pop("own_token_differs")
            r["own_token_differs_per_rank"] = [sum(d) for d in differs]
            # tokens (prefill's, then each step's) on which some rank's
            # own sample was not rank 0's
            r["tokens_own_argmax_disagreed"] = sum(
                any(col) for col in zip(*differs))
            want = _only(r["launches_per_replay"], flash_prefill=L,
                         **wants[label])
            emit(r)
            if any(x["launches_per_replay"] != want for x in per) or \
                    r["graph_replays"] != r["gen_len"] - 1 or \
                    r["eager_launches"] != _only(r["eager_launches"],
                                                 flash_prefill=L):
                fail(f"TP=4 {label}: {r['launches_per_replay']} per replay "
                     f"x {r['graph_replays']} + {r['eager_launches']} "
                     f"eager; want {want} per replay")
            if label in ("mega_default", "mega_td_quant") and \
                    r["mega_tier"] != "pallas_chain":
                fail(f"TP=4 {label}: mega tier {r['mega_tier']}")
            if label == "mega_td_quant" and \
                    r.get("mega_gemm_ar_method") != "xla_qint8":
                fail(f"TP=4 {label}: the mega step's GEMM+AR method is "
                     f"{r.get('mega_gemm_ar_method')}, not xla_qint8")
            # B28 folds the same terms on every rank: the same logits, so
            # no rank's own token may ever differ from rank 0's
            if label == "ar_qint8_os" and any(r["own_token_differs_per_rank"]):
                fail(f"TP=4 {label}: own_token_differs "
                     f"{r['own_token_differs_per_rank']}")
            if label in _TP4_QUANT_LABELS:
                extra[f"tp4_serve_{label}"] = r["launches"]
            if not all(x["tokens_same_on_every_rank"] for x in per):
                fail(f"TP=4 {label}: ranks returned different tokens")
            launches_by_path[label] = r["launches"]
        per_rank = [results[r]["kernels"] for r in range(TP)]
        for name, shapes, src, rep, lib_call in _TP_ROWS:
            timed = {}
            for shp in shapes:
                rws = [k[shp] for k in per_rank]
                if not all(x["ok"] for x in rws):
                    fail(f"{name} on four cards disagrees with its plain "
                         f"version at {shp}: {rws}")
                timed[shp] = {key: max(x[key] for x in rws)
                              for key in ("ms", "plain_ms", "bound_ms",
                                          "max_abs_err", "alt_ms",
                                          "graph_ms", "cold_ms",
                                          "b13a_cold_ms",
                                          "mm_nccl_rs_cold_ms",
                                          "mm_nccl_ar_cold_ms")
                              if key in rws[0]}
                lib = [libs.get(r, {}).get(shp, {}) for r in range(TP)]
                timed[shp]["library_ms"] = (
                    max(x["library_ms"] for x in lib)
                    if x_all_num(lib, "library_ms") else None)
                timed[shp]["library_note"] = next(
                    (x["library_note"] for x in lib if "library_note" in x),
                    None if len(libs) == TP else
                    f"library timing returned from {len(libs)} of {TP} "
                    "ranks")
                timed[shp]["bound_by"] = rws[0]["bound_by"]
                timed[shp]["per_rank_ms"] = [x["ms"] for x in rws]
            row = _tp_kernel_record(name, src, rep, timed, "4 cards, TP=4")
            row["launches_by_path"] = {
                path: n[name] for path, n in launches_by_path.items()
                if n[name]}
            row["launches"] = sum(row["launches_by_path"].values())
            row["library_ms_call"] = lib_call
            if all("graph_ms" in t for t in timed.values()):
                row["graph_ms"] = sum(t["graph_ms"] for t in timed.values()
                                      ) / len(timed)
            rows[name] = row
        # B10 and B11 at the static serve's prefill (2,048 rows a rank),
        # where the rings have bytes to carry
        for name, tag in (("pallas_ag_gemm", ""),
                          ("pallas_ag_gemm_bidir", "_bidir")):
            pre = {}
            for shp in (f"qkv_m2048{tag}", f"gate_up_m2048{tag}"):
                rws = [k[shp] for k in per_rank]
                if not all(x["ok"] for x in rws):
                    fail(f"{shp} on four cards disagrees with its plain "
                         f"version (or B11 with B10): {rws}")
                pre[shp] = {key: max(x[key] for x in rws) for key in
                            ("ms", "plain_ms", "bound_ms", "max_abs_err")}
            rows[name]["prefill_shape"] = pre
        agc = [results[r]["ag_cases"] for r in range(TP)]
        emit({"phase": "tp4_ag_cases", "ranks": agc})
        if not all(v is True or (isinstance(v, dict) and _parity_ok(v))
                   for x in agc for v in x.values()):
            fail(f"B10 / B11 on four cards: {agc}")
        # B13b at the static serve's prefill (2,048 rows a rank)
        pre = {}
        for shp in ("o_m2048_bidir", "down_m2048_bidir"):
            rws = [k[shp] for k in per_rank]
            if not all(x["ok"] for x in rws):
                fail(f"{shp} on four cards disagrees with its plain "
                     f"version: {rws}")
            pre[shp] = {key: max(x[key] for x in rws) for key in
                        ("ms", "plain_ms", "bound_ms", "max_abs_err",
                         "alt_ms")}
        rows["pallas_gemm_rs_bidir"]["prefill_shape"] = pre
    if "tp4_continuous" in phases:
        per = [results[r]["continuous"] for r in range(TP)]
        L = models.QWEN3_ARCHS[TP_MODEL].num_layers
        k_steps = 4
        wants = {"xla": {"paged_flash_decode_partial": L * k_steps,
                         "fused_add_rms": L * k_steps,
                         "pallas_gemm_ar": 2 * L * k_steps},
                 "ar_two_shot": {"paged_flash_decode_partial": L * k_steps,
                                 "ring_reduce_scatter": 2 * L * k_steps,
                                 "ring_all_gather": 2 * L * k_steps},
                 "ar_rhd": {"paged_flash_decode_partial": L * k_steps,
                            "rhd_all_reduce": 2 * L * k_steps},
                 "ar_qint8_os": {"paged_flash_decode_partial": L * k_steps,
                                 "qint8_one_shot_per_device":
                                 2 * L * k_steps}}
        for label, _, mode in _TP4_CONTINUOUS:
            recs = [p[label] for p in per]
            r = {k: v for k, v in recs[0].items()
                 if k not in ("tokens", "own_token_differs")}
            r.update(phase=f"tp4_continuous_{label}", model=TP_MODEL,
                     layers=L, tp=TP, dtype="bf16", max_length=2048,
                     page_size=128, prefill_chunk=512)
            for key in ("harvest_wall_ms_mean", "replay_device_ms_mean",
                        "run_wall_s", "peak_mem_gb"):
                r[f"{key}_per_rank"] = [x[key] for x in recs]
            r["own_token_differs_per_rank"] = [x["own_token_differs"]
                                               for x in recs]
            r["tokens_same_on_every_rank"] = all(
                x["tokens"] == recs[0]["tokens"] for x in recs)
            emit(r)
            vocab = models.QWEN3_ARCHS[TP_MODEL].vocab_size
            gens = [g for _, g in r["traffic"]]
            bad = []
            if any(x["graph_replays"] != x["harvests"] for x in recs):
                bad.append("not one graph replay per harvest")
            if not r["tokens_same_on_every_rank"]:
                bad.append("ranks served different tokens")
            if [len(t) for t in recs[0]["tokens"]] != gens or not all(
                    0 <= t < vocab for ts in recs[0]["tokens"] for t in ts):
                bad.append("tokens missing or out of range")
            if any(x["overflow"] for x in recs) or \
                    r["prefix_pages_adopted"] <= 0:
                bad.append("pool overflow or no prefix adopted")
            want = _only(r["launches_per_replay"], **wants[label])
            if any(x["launches_per_replay"] != want for x in recs):
                bad.append(f"launches per replay "
                           f"{r['launches_per_replay']}, want {want}")
            if label == "ar_qint8_os" and any(
                    r["own_token_differs_per_rank"]):
                bad.append("a rank's own token differed from rank 0's "
                           "under B28")
            if bad:
                fail(f"TP=4 continuous {label}: " + "; ".join(bad))
            extra[f"tp4_continuous_{label}"] = r["launches"]
        two = [p["two_token_chunk"] for p in per]
        emit({"phase": "tp4_continuous_two_token_chunk", "ranks": two})
        if not all(x["raised"] and "divisible" in x["raised"]
                   and x["launches_unchanged"] for x in two):
            fail(f"TWO_SHOT on a 2-row chunk did not raise before any "
                 f"launch: {two}")
    if "tp4_moe" in phases:
        rows.update(_tp4_moe_rows(torch, models, results, extra))
    if "tp4_ep" in phases:
        rows.update(_tp4_ep_rows(torch, models, results, extra))
    if "tp4_sp" in phases:
        rows.update(_tp4_sp_rows(results, extra))
    if "tp4_sp_consistency" in phases:
        _tp4_sp_gate(results)
    if "tp4_comm" in phases:
        rows.update(_tp4_comm_rows(results, extra))
    if "tp4_ring" in phases:
        _tp4_ring_rows(results, rows)
    if "tp4_quant" in phases:
        rows.update(_tp4_quant_rows(results, extra))
    t_w1 = time.time()
    w1 = _world1_logits_and_tokens(torch, models, tmp)
    rank0 = dict(results[0]["seconds"])
    emit({"phase": "four_card_seconds",
          "rank0_start_after_spawn": rank0.pop("started_at") - t_spawn,
          "rank0": rank0,
          "library_per_rank": [libs[r].get("seconds") for r in sorted(libs)],
          "results_after_spawn": t_results - t_spawn,
          "libraries_after_results": (None if t_libs is None
                                      else t_libs - t_results),
          "teardown": t_joined - (t_libs or t_results),
          "ranks_killed_at_teardown": killed,
          "world1_on_card0": time.time() - t_w1,
          "ranks_wall": t_w1 - t_spawn})
    if "tp4_serve" in phases:
        saved = torch.load(os.path.join(tmp, "tp4_bf16.pt"))
        ref = w1["bf16"]
        paths = ["td", "td_bidir", "xla",
                 *(label for label, _, _ in _TP4_REPLICATED)]
        emit({"phase": "tp4_logits_bf16", "layers": 64,
              "rel_rms_vs_world1": {p: _rel_rms(torch, saved[p], ref)
                                    for p in paths},
              "rel_rms_vs_xla": {p: _rel_rms(torch, saved[p], saved["xla"])
                                 for p in paths if p != "xla"},
              "argmax_agree_vs_world1": {
                  p: (saved[p].argmax(-1) == ref.argmax(-1)).float().mean()
                  .item() for p in paths}})
    if "tp4_continuous_consistency" in phases:
        saved = torch.load(os.path.join(tmp, "tp4_f32_continuous.pt"))
        ref = w1["f32_continuous"]
        static_w1 = saved["static_mega_default"]
        lossy = {f"continuous_{x}" for x in _TP4_CONTINUOUS_LOSSY}
        # the lossless paths: world 1's tokens, identically
        same = {f"{k}_vs_world1_continuous": v == ref
                for k, v in saved.items() if k not in lossy}
        same["world1_continuous_vs_tp4_static"] = ref == static_w1
        # the lossy paths: the same tokens on every rank, no rank's own
        # token ever other than rank 0's
        per = [results[r]["continuous_consistency"] for r in range(TP)]
        ranks_agree = {k: all(x["tokens"][k] == per[0]["tokens"][k]
                              and x["own_token_differs"][k] == 0
                              for x in per) for k in sorted(lossy)}

        def parting(toks):
            """share of tokens equal to world 1's, and the first position
            where each request parts from world 1 (None: never)."""
            flat = [(a == b) for t, w in zip(toks, ref)
                    for a, b in zip(t, w)]
            first = [next((i for i, (a, b) in enumerate(zip(t, w))
                           if a != b), None) for t, w in zip(toks, ref)]
            return {"share_equal_world1": sum(flat) / max(len(flat), 1),
                    "first_parting": first}
        emit({"phase": "tp4_continuous_consistency", "layers": 4,
              "dtype": "f32", "requests": len(ref), "gen_len": 8,
              "identical": same, "lossy_same_tokens_every_rank": ranks_agree,
              "own_token_differs_per_rank": [x["own_token_differs"]
                                             for x in per],
              "vs_world1": {k: parting(v) for k, v in saved.items()},
              "ok": all(same.values()) and all(ranks_agree.values())})
        if not all(same.values()) or not all(ranks_agree.values()):
            fail(f"TP=4 continuous f32 gate: greedy tokens differ: {same}; "
                 f"lossy paths the same on every rank: {ranks_agree}")
    if "tp4_moe_consistency" in phases:
        saved = torch.load(os.path.join(tmp, "tp4_moe_f32.pt"))
        ran = [results[r]["moe_consistency"]["launches_per_replay"]["td"]
               for r in range(TP)]
        same = {f"{k}_vs_world1": bool(torch.equal(v, w1["moe_f32"]))
                for k, v in saved.items()}
        kernels_ran = all(x.get("pallas_ag_group_gemm") == 4
                          and x.get("pallas_moe_reduce_rs") == 4
                          for x in ran)
        emit({"phase": "tp4_moe_consistency", "model": MOE_MODEL,
              "layers": 4, "dtype": "f32", "batch": 16, "prompt": 64,
              "gen_len": 8, "identical": same,
              "td_launches_per_replay": ran,
              "tokens": {k: v.tolist() for k, v in saved.items()},
              "ok": all(same.values()) and kernels_ran})
        if not all(same.values()) or not kernels_ran:
            fail(f"TP=4 MoE f32 gate: greedy tokens differ ({same}) or "
                 f"B14/B15 did not run in the triton_dist step ({ran})")
    if "tp4_ep_consistency" in phases:
        saved = torch.load(os.path.join(tmp, "tp4_ep_f32.pt"))
        ran = [results[r]["ep_consistency"]["launches_per_replay"]
               for r in range(TP)]
        ref = saved["eager_xla"]
        same = {f"{k}_vs_eager_xla": bool(torch.equal(v, ref))
                for k, v in saved.items() if k != "td_pallas_fp8"}
        same["eager_xla_vs_world1"] = bool(torch.equal(ref, w1["moe_f32"]))
        kernels_ran = all(
            x["td_pallas"].get("fast_all_to_all_per_device") == 8
            and x["td_pallas_fused"].get("pallas_dispatch_gg") == 4
            and x["td_pallas_fp8"].get("fast_all_to_all_q_per_device") == 4
            and x["mega_pallas_fused"].get("pallas_dispatch_gg") == 4
            for x in ran)
        emit({"phase": "tp4_ep_consistency", "model": MOE_MODEL,
              "moe_parallel": "ep", "layers": 4, "dtype": "f32",
              "batch": 16, "prompt": 64, "gen_len": 8, "identical": same,
              "fp8_tokens_agree_vs_eager_xla": (
                  saved["td_pallas_fp8"] == ref).float().mean().item(),
              "launches_per_replay": ran[0],
              "tokens": {k: v.tolist() for k, v in saved.items()},
              "ok": all(same.values()) and kernels_ran})
        if not all(same.values()) or not kernels_ran:
            fail(f"EP=4 f32 gate: greedy tokens differ ({same}) or the EP "
                 f"kernels did not run in the captured steps ({ran[0]})")
    if "tp4_consistency" in phases:
        saved = torch.load(os.path.join(tmp, "tp4_f32.pt"))
        same = {f"{label}_vs_world1": bool(torch.equal(saved[label],
                                                       w1["f32"]))
                for label, _, _ in _TP4_GATE}
        emit({"phase": "tp4_consistency", "layers": 4, "dtype": "f32",
              "batch": 16, "prompt": 64, "gen_len": 16, "identical": same,
              "ok": all(same.values())})
        if not all(same.values()):
            fail(f"TP=4 f32 gate: greedy tokens differ: {same}")
    return rows, extra


def x_all_num(rows, key):
    return all(isinstance(x.get(key), (int, float)) for x in rows)


def run_earlier(torch, kern, models, mods, shared) -> list:
    """The phases of the earlier slices (one card): their kernels against
    the plain versions, the Qwen3-8B and Qwen3-30B-A3B serves, their
    consistency checks; returns their kernels-line rows."""
    agm, agg, fa, fc, ga, mrs, mu, pfd, plain, codec = mods
    b1, b2 = phase_b1(torch, fa), phase_b2(torch, pfd, codec, models,
                                              kern)
    b1_dec = phase_b1_decode(torch, fa)
    b3, b4 = phase_b3(torch, fc), phase_b4(torch, ga)
    b12 = phase_b12(torch, agm)
    b14, b15 = phase_b14_b15(torch, agg, mrs, mu, plain)
    torch.cuda.empty_cache()
    model, params, ids, paged, engine = phase_main(torch, models, kern,
                                                   shared)
    dense_engine, dense = phase_main_dense(torch, models, kern, model,
                                           params, ids)
    m32, p32 = phase_consistency(torch, models, model, params, ids)
    phase_consistency_dense(torch, models, model, params, ids, dense_engine,
                            m32, p32)
    del m32, p32
    phase_profile(torch, engine, dense_engine, ids)
    dense_td, dense_td_eager = phase_dense_triton_dist(
        torch, models, kern, model, params, ids)
    del model, params, engine, dense_engine
    shared.clear()
    torch.cuda.empty_cache()
    # the 61.1 GB MoE model fits only once the 8B model is freed
    moe_model, moe_params, moe_ids, moe_engines, moe = phase_main_moe(
        torch, models, kern)
    rows = phase_consistency_moe(torch, models, moe_model, moe_params,
                                 moe_ids, moe_engines)
    del moe_model, moe_params, moe_engines
    torch.cuda.empty_cache()
    phase_consistency_moe_f32(torch, models, moe_ids, rows)
    torch.cuda.empty_cache()
    phase_small_reference(torch, models)

    # launches per serve, by path (each path's counts zeroed just before
    # its measured serve and read just after)
    (td, td_eager), (mg, mg_eager) = moe["triton_dist"], moe["mega_default"]
    prefill = {"paged": paged["flash_prefill"], "dense": dense["prefill"],
               "moe_triton_dist": td_eager["flash_prefill"],
               "moe_mega": mg_eager["flash_prefill"]}
    decode = {"dense": dense["decode"],
              "dense_triton_dist": dense_td["flash_prefill"]
              - dense_td_eager["flash_prefill"],
              "moe_triton_dist": td["flash_prefill"]
              - td_eager["flash_prefill"],
              "moe_mega": mg["flash_prefill"] - mg_eager["flash_prefill"]}
    b1["launches"], b1["launches_by_path"] = sum(prefill.values()), prefill
    b1_dec["launches"] = sum(decode.values())
    b1_dec["launches_by_path"] = decode
    b2["launches"] = paged["paged_flash_decode_partial"]
    for form in ("int8", "f32"):        # not on a default path
        b2[form]["launches"] = 0
        b2[form]["library_ms"] = None
    for rec, key, dense_key in ((b3, "fused_add_rms", "fused_add_rms"),
                                (b4, "gemm_ar", "gemm_ar")):
        rec["launches_by_path"] = {"dense": dense[dense_key],
                                   "moe_mega": mg[key]}
        rec["launches"] = sum(rec["launches_by_path"].values())
    b12["launches_by_path"] = {"moe_triton_dist": td["pallas_matmul"],
                               "dense_triton_dist": dense_td["pallas_matmul"]}
    b12["launches"] = sum(b12["launches_by_path"].values())
    b14["launches"] = td["group_gemm"]
    b15["launches"] = td["moe_rs"]
    return [b1, b1_dec, b2, b3, b4, b12, b14, b15]


ALL_PHASES = ("paged_graph", "continuous", "earlier", *ONE_CARD_TP_PHASES,
              *FOUR_CARD_PHASES)
_RING_PHASES = (("b9_ring_rs", "ring_rs"), ("b7_ring_ag", "ring_ag"),
                ("two_shot", "two_shot"))


def merge_launches(rows, by_path: dict) -> None:
    """Add each path's launch counts ({path: {kernel: n}}) to the kernel
    rows of the same name: the row's launches_by_path gains the path, and
    its launches become their sum (a row's own count without paths stays
    as the path "earlier")."""
    for row in rows:
        for path, counts in by_path.items():
            n = counts.get(row["name"], 0)
            if not n:
                continue
            paths = row.get("launches_by_path")
            if paths is None:
                paths = row["launches_by_path"] = (
                    {"earlier": row["launches"]} if row.get("launches")
                    else {})
            paths[path] = n
            row["launches"] = sum(paths.values())


def main() -> None:
    """python3 chip_smoke.py [phase ...]: with no argument every phase
    this machine allows (the four-card phases need four cards); named
    phases run alone (after the build): "paged_graph", "continuous" (one
    card, Qwen3-8B), "earlier" (the earlier slices' phases),
    "dist_notify_wait", "b10_ag_gemm", "b13_gemm_rs", "b4_gemm_ar_tp",
    "b5_one_shot", "b6_rhd", "b9_ring_rs", "b7_ring_ag", "two_shot",
    "ring_floor", "b14_b15_tp", "b8_full_mesh_ag", "b11_ag_gemm_bidir",
    "b13b_gemm_rs_bidir", "b17_ll_a2a", "b18_ll_a2a_q",
    "b16_ep_dispatch_gg" (the one-card world), "b1_fold",
    "b19_flash_decode_partial", "b20_decode_combine", "b21_ring_attn",
    "sp_layer" (sequence parallelism on one card), "b22_b23_ll_ag",
    "b24_b25_b26_p2p" (the small collectives, the one-card world),
    "b27_b28_qint8", "b29_b30_kv_handoff" (the quantized wire and the KV
    handoff, the one-card world), "tp4_serve", "tp4_consistency",
    "tp4_continuous", "tp4_continuous_consistency", "tp4_moe",
    "tp4_moe_consistency", "tp4_ep", "tp4_ep_consistency", "tp4_sp",
    "tp4_sp_consistency", "tp4_comm", "tp4_quant", "tp4_ring" (four
    cards)."""
    import torch
    phases = sys.argv[1:] or list(ALL_PHASES)
    if any(p not in ALL_PHASES for p in phases):
        print(f"chip_smoke: phases are {list(ALL_PHASES)}; got {phases}",
              file=sys.stderr)
        sys.exit(2)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from triton_dist_tpu_torch import kernels as kern
        from triton_dist_tpu_torch import language as lang
        from triton_dist_tpu_torch import models
        from triton_dist_tpu_torch.kernels import allgather_gemm as agm
        from triton_dist_tpu_torch.kernels import allgather_group_gemm as agg
        from triton_dist_tpu_torch.kernels import allreduce as arm
        from triton_dist_tpu_torch.kernels import flash_attention as fa
        from triton_dist_tpu_torch.kernels import fused_chain as fc
        from triton_dist_tpu_torch.kernels import gemm_allreduce as ga
        from triton_dist_tpu_torch.kernels import gemm_reduce_scatter as grs
        from triton_dist_tpu_torch.kernels import moe_reduce_rs as mrs
        from triton_dist_tpu_torch.kernels import moe_utils as mu
        from triton_dist_tpu_torch.kernels import paged_flash_decode as pfd
        from triton_dist_tpu_torch.kernels import plain
        from triton_dist_tpu_torch.quant import codec
        from triton_dist_tpu_torch.runtime import build, symm
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        sys.exit(3)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    cards = smi.stdout.strip().splitlines()
    print(cards[0] if cards else f"nvidia-smi failed: {smi.stderr.strip()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "cards": cards,
          "phases": phases})

    # every source, built here once: the four-card phases' rank processes
    # only load the libraries
    t0 = time.perf_counter()
    reports = build.build(build.all_sources())
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, text in reports.items()}
    emit({"phase": "build", "seconds": build_s, "built": sorted(reports),
          "ptxas": ptxas})

    kernels, shared, by_path, b1_cont = [], {}, {}, None
    if "paged_graph" in phases:
        by_path["paged_graph"] = phase_paged_graph(torch, models, kern,
                                                   shared)
    if "continuous" in phases:
        launches, b1_cont = phase_continuous(torch, models, kern, fa, shared)
        by_path.update(launches)
    if "earlier" in phases:
        kernels += run_earlier(torch, kern, models, (
            agm, agg, fa, fc, ga, mrs, mu, pfd, plain, codec), shared)
    shared.clear()
    torch.cuda.empty_cache()
    if "dist_notify_wait" in phases:
        phase_dist_notify_wait(torch, symm, lang)
    tp_rows = {}
    if "b10_ag_gemm" in phases:
        tp_rows["pallas_ag_gemm"] = phase_b10(torch, symm, agm)
    if "b13_gemm_rs" in phases:
        tp_rows["pallas_gemm_rs"] = phase_b13(torch, symm, grs)
    if "b4_gemm_ar_tp" in phases:
        tp_rows["pallas_gemm_ar"] = phase_b4_tp(torch, symm, ga)
    for kind in ("one_shot", "rhd"):
        if ("b5_one_shot" if kind == "one_shot" else "b6_rhd") in phases:
            tp_rows[f"{kind}_all_reduce"] = phase_all_reduce(
                torch, symm, arm, kind)
    from triton_dist_tpu_torch.kernels import allgather as ring_ag
    from triton_dist_tpu_torch.kernels import reduce_scatter as ring_rs
    for phase, kind in _RING_PHASES:
        if phase in phases:
            rec = phase_ring(torch, symm, ring_rs, ring_ag, arm, kind)
            if rec is not None:
                tp_rows[rec["name"]] = rec
    if "ring_floor" in phases:
        trip_ms = phase_ring_floor(torch, symm, ring_rs)
        for name in ("ring_reduce_scatter", "ring_all_gather"):
            if name in tp_rows:
                tp_rows[name]["latency_floor_ms"] = trip_ms
    if "b14_b15_tp" in phases:
        for rec in phase_b14_b15_tp(torch, symm, agg, mrs, mu, plain):
            tp_rows[rec["name"]] = rec
        torch.cuda.empty_cache()
    if "b8_full_mesh_ag" in phases:
        tp_rows["full_mesh_all_gather"] = phase_b8(torch, symm, kern,
                                                   ring_ag)
    if "b11_ag_gemm_bidir" in phases:
        tp_rows["pallas_ag_gemm_bidir"] = phase_b11(torch, symm, agm)
        torch.cuda.empty_cache()
    if "b13b_gemm_rs_bidir" in phases:
        tp_rows["pallas_gemm_rs_bidir"] = phase_b13b(torch, symm, grs)
    from triton_dist_tpu_torch.kernels import ep_a2a as ep
    from triton_dist_tpu_torch.kernels import low_latency_all_to_all as ll
    if "b17_ll_a2a" in phases:
        tp_rows["fast_all_to_all_per_device"] = phase_b17(
            torch, symm, kern, ll, plain)
        torch.cuda.empty_cache()
    if "b18_ll_a2a_q" in phases:
        tp_rows["fast_all_to_all_q_per_device"] = phase_b18(
            torch, symm, kern, ll, plain)
        torch.cuda.empty_cache()
    if "b16_ep_dispatch_gg" in phases:
        tp_rows["pallas_dispatch_gg"] = phase_b16(torch, symm, ep, mu, plain)
        torch.cuda.empty_cache()
    # the package exports a function of the module's name
    fdm = importlib.import_module("triton_dist_tpu_torch.kernels.flash_decode")
    spm = importlib.import_module(
        "triton_dist_tpu_torch.kernels.sp_ag_attention")
    if "b1_fold" in phases:
        for rec in phase_b1_fold(torch, fa):
            tp_rows[rec["name"]] = rec
    if "b19_flash_decode_partial" in phases:
        tp_rows["flash_decode_partial"] = phase_b19(torch, fa)
        torch.cuda.empty_cache()
    if "b20_decode_combine" in phases:
        tp_rows["pallas_combine_per_device"] = phase_b20(torch, symm, fdm)
    if "b21_ring_attn" in phases:
        tp_rows["pallas_ring_attn_per_device"] = phase_b21(torch, symm, spm,
                                                           plain)
        torch.cuda.empty_cache()
    if "sp_layer" in phases:
        by_path.update(phase_sp_layer(torch, kern, symm))
        torch.cuda.empty_cache()
    from triton_dist_tpu_torch.kernels import common_ops as cops
    from triton_dist_tpu_torch.kernels import low_latency_allgather as llm
    from triton_dist_tpu_torch.kernels import p2p as p2pm
    if "b22_b23_ll_ag" in phases:
        for rec in phase_b22_b23(torch, symm, kern, ring_ag, llm):
            tp_rows[rec["name"]] = rec
        torch.cuda.empty_cache()
    if "b24_b25_b26_p2p" in phases:
        for rec in phase_b24_b26(torch, symm, kern, cops, p2pm):
            tp_rows[rec["name"]] = rec
        torch.cuda.empty_cache()
    from triton_dist_tpu_torch.kernels import quant_wire as qw
    kvm = importlib.import_module("triton_dist_tpu_torch.kernels.kv_handoff")
    if "b27_b28_qint8" in phases:
        for rec in phase_b27_b28(torch, symm, kern, qw, arm):
            tp_rows[rec["name"]] = rec
        torch.cuda.empty_cache()
    if "b29_b30_kv_handoff" in phases:
        for rec in phase_b29_b30(torch, symm, kern, kvm, codec):
            tp_rows[rec["name"]] = rec
        torch.cuda.empty_cache()
    four = [p for p in phases if p in FOUR_CARD_PHASES]
    n_cards = torch.cuda.device_count()
    if four and n_cards < TP:
        for p in four:
            emit({"phase": p, "ran": False,
                  "reason": f"torch.cuda.device_count() = {n_cards} < {TP}"})
    elif four:
        torch.cuda.empty_cache()
        rows, extra = phase_four_cards(torch, models, kern, four)
        by_path.update(extra)
        for name, row in rows.items():
            if name in tp_rows:
                one = tp_rows[name]
                row["one_card_world"] = {
                    k: one[k] for k in
                    ("ms", "plain_ms", "bound_ms", "max_abs_err", "shapes",
                     "graph_ms", "latency_floor_ms") if k in one}
                # a path the one-card world drove (all_gather_op for B8)
                for path, n in (one.get("launches_by_path") or {}).items():
                    row.setdefault("launches_by_path", {})[path] = n
                    row["launches"] = sum(row["launches_by_path"].values())
            tp_rows[name] = row
    kernels += list(tp_rows.values())
    merge_launches(kernels, by_path)
    for row in tp_rows.values():
        if row["measured_on"].startswith("one card") and \
                not row.get("launches"):
            row["launches_note"] = (
                "the TP=4 serve needs four cards "
                f"(torch.cuda.device_count() = {n_cards}); it did not run")
    for row in kernels:
        if row["name"] == "flash_prefill" and b1_cont is not None:
            row["continuation_form"] = b1_cont

    print(cards[0] if cards else "nvidia-smi unavailable", flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
