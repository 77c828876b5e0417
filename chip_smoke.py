#!/usr/bin/env python3
"""Chip smoke run of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (one nvcc per source, all
started together), holds each against its plain PyTorch version on the
card, and serves Qwen3-8B (published widths, all 36 layers, random bf16
weights from a seed) down both main paths: ``Engine.serve`` on the paged
cache (eager decode, B1 + B2) and ``Engine(model, params)`` at its
defaults (the dense cache, each decode step one CUDA-graph replay of the
mega task graph: B1 at T=1, B3, B4). It counts each path's kernel launches
in one serve, checks prefill against prefill + one decode step and the
graph-replayed step against the eager xla tier and the paged step, and
checks small f32 models served on the card against the CPU. One JSON line
per phase; the line before the last lists every kernel with its times and
bound; the last line is the device record. Any failed check exits
non-zero. Imports nothing of JAX. Needs one card; without one it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

MEM_BW = 3.35e12          # H100 SXM HBM3 bytes/s (data sheet)
BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core FLOP/s
F32_FLOPS = 67e12         # H100 SXM f32 FLOP/s outside the tensor cores
DEV = "cuda"
KERNEL_SOURCES = ["flash_prefill", "paged_flash_decode", "fused_add_rms",
                  "gemm_ar"]


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


def graph_time_ms(fn, iters: int = 20) -> float:
    """Device time per call of fn(): `iters` calls captured in one CUDA
    graph (after a warm-up call), the graph replayed under CUDA events.
    For kernels shorter than the host's launch cost, which back-to-back
    eager calls would time instead; it is also how the dense decode step
    runs them."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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

def phase_b1(torch, fa):
    """Kernel vs plain version on the main-path shape, a ragged T=200, an
    offset > 0, and f32 at both head dims. Tolerances: bf16 2e-2 absolute
    (outputs round to bf16, 2^-9 relative, and the kernel's 64-key steps
    round P to bf16 against another running max than the plain version's
    128-key blocks); f32 1e-4 (summation order only)."""
    g = torch.Generator(device=DEV).manual_seed(1)
    cases = [  # (name, dtype, B, T, S, Hq, Hkv, D, offset, tol)
        ("main", torch.bfloat16, 4, 512, 512, 32, 8, 128, 0, 2e-2),
        ("ragged_t200", torch.bfloat16, 4, 200, 200, 32, 8, 128, 0, 2e-2),
        ("offset384", torch.bfloat16, 2, 128, 512, 32, 8, 128, 384, 2e-2),
        ("f32_offset70", torch.float32, 2, 130, 200, 4, 2, 128, 70, 1e-4),
        ("f32_d64", torch.float32, 1, 100, 100, 8, 8, 64, 0, 1e-4),
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
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    pairs = sum(min(off + i + 1, s) for i in range(t))   # causal (q, k)
    flops = 4.0 * b * hq * d * pairs
    bms, by = bound_ms(nbytes, flops)
    return {"name": "flash_prefill", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/flash_prefill.cu",
            "replaces": "triton_dist_tpu/kernels/flash_attention.py:63",
            "max_abs_err": rows[0]["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "shape": [b, t, hq, int(k.shape[2]), d],
            "bytes": nbytes, "flops": flops}


# -- B2: paged flash decode --------------------------------------------------

def phase_b2(torch, pfd, codec):
    """Kernel vs plain version at B=4, Hq=32, Hkv=8, D=128, page 128, a
    shuffled table with garbage in dead slots, ragged lengths with 0, 1 and
    a page boundary; bf16 and int8 pools. Compared on the normalized
    output acc/l and on m and l. Tolerance 2e-3 absolute on acc/l (P is
    rounded to bf16 at the same points in both; f32 summation order
    otherwise), 1e-4 relative on m and l."""
    g = torch.Generator(device=DEV).manual_seed(2)
    b, hq, hkv, d, ps, npg = 4, 32, 8, 128, 128, 8
    num_pages = b * npg
    perm = torch.randperm(num_pages, generator=g, device=DEV)
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

    modes = {"bf16": (k16, v16, {}),
             "int8": (k8, v8, {"k_scales": ks, "v_scales": vs})}
    rows, timed = [], {}
    for mode, (kp, vp, kw) in modes.items():
        for case, tab, lens in (("ragged", dead, check_lens),
                                ("main", table, main_lens)):
            acc, m, l = pfd.paged_flash_decode_partial(q, kp, vp, tab, lens,
                                                       **kw)
            racc, rm, rl = pfd.paged_flash_decode_partial_ref(
                q, kp, vp, tab, lens, **kw)
            torch.cuda.synchronize()
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
            rows.append({"mode": mode, "case": case, "max_abs_err": err,
                         "m_rel_err": m_err, "l_rel_err": l_err, "ok": ok})
        ms = time_ms(lambda: pfd.paged_flash_decode_partial(
            q, kp, vp, table, main_lens, **kw), iters=50)
        plain_ms = time_ms(lambda: pfd.paged_flash_decode_partial_ref(
            q, kp, vp, table, main_lens, **kw), iters=5)
        tokens = int(main_lens.sum())
        row_bytes = d * kp.element_size() + (4 if kw else 0)
        nbytes = (2 * tokens * hkv * row_bytes + q.numel() * 2
                  + table.numel() * 4 + b * 4 + (b * hq * d + 2 * b * hq) * 4)
        flops = 4.0 * hq * d * tokens
        bms, by = bound_ms(nbytes, flops)
        timed[mode] = {
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["mode"] == mode),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "bytes": nbytes, "flops": flops}
    emit({"phase": "b2_paged_flash_decode", "cases": rows})
    bad = [(r["mode"], r["case"]) for r in rows if not r["ok"]]
    if bad:
        fail(f"B2 disagrees with its plain version: {bad}")
    # the main path's pools are full width (bf16); the int8-resident mode
    # of the same kernel rides along as a sub-record
    return {"name": "paged_flash_decode_partial", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/paged_flash_decode.cu",
            "replaces": "triton_dist_tpu/kernels/paged_flash_decode.py:38",
            **timed["bf16"], "library_ms": None,
            "shape": [b, hq, hkv, d, ps, 528], "int8": timed["int8"]}


# -- B1 in its decode form ---------------------------------------------------

def phase_b1_decode(torch, fa):
    """B1 at T=1 over the dense cache, the dense decode step's attention:
    B=4, Hq 32, Hkv 8, D 128, S=1024, offset 540 as a 0-d int32 tensor on
    the card. Checked against the plain version eagerly and inside a
    captured CUDA graph replayed after the offset moved to 777 (the graph
    must read the offset on the device). Tolerance 2e-2 absolute (bf16, as
    B1's prefill form)."""
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
            "max_abs_err": max(r["max_abs_err"] for r in rows), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "shape": [b, 1, hq, hkv, d, s, off],
            "bytes": nbytes, "flops": flops}


# -- B3: fused add + RMSNorm -------------------------------------------------

def phase_b3(torch, fc):
    """Kernel vs plain version, bf16 and f32, d 4096 and 128, 4 and 2048
    rows. s must be bitwise equal (one rounding of h + a in both). The
    f32 square sums are taken in another order, so the normalized value
    x * rsqrt(var + eps), rounded to bf16 before the multiply by w, may
    take the neighbouring bf16 value: bf16 normed must lie within
    |w| x ulp(normed / w) (that one step carried through w) + ulp(normed)
    (the product's own rounding) of the plain version, elementwise; f32
    within 1e-5 relative. Timed at the decode shape (4 x 4096 bf16)."""
    g = torch.Generator(device=DEV).manual_seed(12)
    rows, main = [], None
    for dt in (torch.bfloat16, torch.float32):
        for d in (4096, 128):
            for n in (4, 2048):
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
                               if r["rows"] == 4 and r["d"] == 4096),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": library_ms, "shape": [n, d], "bytes": nbytes,
            "flops": flops}


# -- B4: GEMM + AR at world 1 ------------------------------------------------

def phase_b4(torch, ga):
    """Kernel vs plain version at the decode path's o (K = N = 4096) and
    down (K = 12288, N = 4096) shapes at M = 4, and M = 2048, bf16; o at
    M = 4 in f32. Max abs error <= 1e-2 x max|ref| for bf16 (one bf16
    rounding of the output, 2^-9, and another f32 summation order), 1e-4
    relative for f32. Timed at the two decode shapes; the row's times are
    the mean over the main path's launches (one o and one down per
    layer)."""
    g = torch.Generator(device=DEV).manual_seed(13)
    cases = [("o_m4", torch.bfloat16, 4, 4096, 4096, 1e-2),
             ("down_m4", torch.bfloat16, 4, 12288, 4096, 1e-2),
             ("o_m2048", torch.bfloat16, 2048, 4096, 4096, 1e-2),
             ("o_m4_f32", torch.float32, 4, 4096, 4096, 1e-4)]
    rows, timed = [], {}
    for name, dt, m, k, n, tol in cases:
        a = torch.randn((m, k), generator=g, device=DEV).to(dt)
        b = (torch.randn((k, n), generator=g, device=DEV) * k ** -0.5).to(dt)
        out = ga.gemm_ar(a, b)
        ref = ga.gemm_ar_ref(a, b)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        rows.append({"case": name, "max_abs_err": err, "ref_absmax": scale,
                     "tol": tol * scale, "ok": err <= tol * scale
                     and bool(torch.isfinite(out).all())})
        if name in ("o_m4", "down_m4"):
            ms = graph_time_ms(lambda: ga.gemm_ar(a, b))
            plain_ms = graph_time_ms(lambda: ga.gemm_ar_ref(a, b))
            library_ms = graph_time_ms(
                lambda: torch.mm(a, b, out_dtype=torch.float32))
            nbytes = (m * k + k * n + m * n) * a.element_size()
            bms, by = bound_ms(nbytes, 2.0 * m * k * n)
            timed[name] = {"ms": ms, "plain_ms": plain_ms,
                           "library_ms": library_ms, "bound_ms": bms,
                           "bound_by": by, "bytes": nbytes,
                           "shape": [m, k, n], "max_abs_err": err}
    emit({"phase": "b4_gemm_ar", "cases": rows})
    if not all(r["ok"] for r in rows):
        fail(f"B4 disagrees with its plain version: "
             f"{[r for r in rows if not r['ok']]}")
    mean = {key: sum(t[key] for t in timed.values()) / len(timed)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {"name": "gemm_ar", "route": "cuda",
            "source": "triton_dist_tpu_torch/csrc/gemm_ar.cu",
            "replaces": "triton_dist_tpu/kernels/gemm_allreduce.py:101",
            "max_abs_err": max(t["max_abs_err"] for t in timed.values()),
            **mean, "bound_by": "bytes", "library_ms_call":
                "torch.mm(a, b, out_dtype=torch.float32)",
            "shapes": timed}


# -- the main paths ----------------------------------------------------------

def phase_main(torch, models, kern):
    """Qwen3-8B at its published widths, all 36 layers, random bf16
    weights; Engine(cache_mode="paged", page_size=128) serves B=4 prompts
    of T=512 for gen_len=32 (the decode crosses the page boundary at 512).
    One warm-up serve first; the counts are zeroed just before the
    measured serve and read just after it."""
    cfg = models.ModelConfig(model_name="Qwen/Qwen3-8B", max_length=1024,
                             dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model, params = models.AutoLLM.from_pretrained(
        cfg, device=DEV,
        generator=torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    arch = model.arch
    b, t, gen = 4, 512, 32
    ids = torch.randint(0, arch.vocab_size, (b, t + 1), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(3))
    engine = models.Engine(model, params, cache_mode="paged", page_size=128)
    engine.serve(ids[:, :t], gen_len=2)                       # warm-up
    torch.cuda.reset_peak_memory_stats()

    kern.reset_launch_counts()
    out = engine.serve(ids[:, :t], gen_len=gen)
    launches = kern.launch_counts()

    steps = engine.last_decode_steps
    rec = {"phase": "main_path", "model": cfg.model_name,
           "layers": arch.num_layers, "hidden": arch.hidden_size,
           "batch": b, "prompt": t, "gen_len": gen, "page_size": 128,
           "init_s": init_s, "prefill_ms": engine.last_prefill_s * 1e3,
           "decode_ms_per_step": engine.last_decode_s * 1e3 / steps,
           "decode_tok_per_s": b * steps / engine.last_decode_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches,
           "overflow": int(engine.kv_cache.overflow),
           "tokens_shape": list(out.shape)}
    emit(rec)
    want = {"flash_prefill": arch.num_layers,
            "paged_flash_decode_partial": arch.num_layers * (gen - 1),
            "fused_add_rms": 0, "gemm_ar": 0}
    if launches != want:
        fail(f"launch counts {launches}, want {want}")
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
    want_step = {"flash_prefill": L, "paged_flash_decode_partial": 0,
                 "fused_add_rms": L, "gemm_ar": 2 * L}
    want_eager = {"flash_prefill": L, "paged_flash_decode_partial": 0,
                  "fused_add_rms": 0, "gemm_ar": 0}
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
                "top": [[e.key[:90], self_dev_us(e) / 1e3 / per, e.count]
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


def phase_profile(torch, engine, dense_engine, ids, steps: int = 4):
    """Where each main path's time goes (_profile_engine), the paged
    engine's eager step and the dense engine's graph-replayed step. For
    the dense step also, without the profiler: the host's wall ms per step
    over `steps` back-to-back steps and the device ms of one bare replay
    (CUDA events around graph.replay()), whose ratio is a second reading
    of the idle share."""
    pre, dec = _profile_engine(torch, engine, ids, steps)
    dpre, ddec = _profile_engine(torch, dense_engine, ids, steps)
    t = ids.shape[1] - 1
    out = dense_engine.serve(ids[:, :t], gen_len=1)
    tok = out[:, -1].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        tok = dense_engine.step(tok)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    graph = dense_engine._graph
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / steps
    emit({"phase": "profile", "prefill": pre, "decode_step": dec,
          "dense_prefill": dpre, "dense_decode_step": ddec,
          "dense_step_wall_ms": wall_ms, "dense_replay_device_ms": replay_ms,
          "dense_idle_share_by_events": 1 - replay_ms / wall_ms})


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
    emit({"phase": "small_reference", "cases": rows})
    if not all(r["ok"] for r in rows):
        fail("the small model on the card disagrees with the CPU")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from triton_dist_tpu_torch import kernels as kern
        from triton_dist_tpu_torch import models
        from triton_dist_tpu_torch.kernels import flash_attention as fa
        from triton_dist_tpu_torch.kernels import fused_chain as fc
        from triton_dist_tpu_torch.kernels import gemm_allreduce as ga
        from triton_dist_tpu_torch.kernels import paged_flash_decode as pfd
        from triton_dist_tpu_torch.quant import codec
        from triton_dist_tpu_torch.runtime import build
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        sys.exit(3)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    reports = build.build(KERNEL_SOURCES)
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, text in reports.items()}
    emit({"phase": "build", "seconds": build_s, "built": sorted(reports),
          "ptxas": ptxas})

    b1, b2 = phase_b1(torch, fa), phase_b2(torch, pfd, codec)
    b1_dec = phase_b1_decode(torch, fa)
    b3, b4 = phase_b3(torch, fc), phase_b4(torch, ga)
    model, params, ids, paged, engine = phase_main(torch, models, kern)
    dense_engine, dense = phase_main_dense(torch, models, kern, model,
                                           params, ids)
    b1["launches"] = paged["flash_prefill"] + dense["prefill"]
    b1["launches_by_path"] = {"paged": paged["flash_prefill"],
                              "dense": dense["prefill"]}
    b1_dec["launches"] = dense["decode"]
    b2["launches"] = paged["paged_flash_decode_partial"]
    b2["int8"]["launches"] = 0          # not on a default path
    b2["int8"]["library_ms"] = None
    b3["launches"] = dense["fused_add_rms"]
    b4["launches"] = dense["gemm_ar"]
    m32, p32 = phase_consistency(torch, models, model, params, ids)
    phase_consistency_dense(torch, models, model, params, ids, dense_engine,
                            m32, p32)
    del m32, p32
    phase_profile(torch, engine, dense_engine, ids)
    del model, params, engine, dense_engine
    torch.cuda.empty_cache()
    phase_small_reference(torch, models)

    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi unavailable", flush=True)
    emit({"kernels": [b1, b1_dec, b2, b3, b4]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
