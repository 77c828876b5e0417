#!/usr/bin/env python3
"""Chip smoke run of the PyTorch + CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version on the card, serves Qwen3-8B (published widths, all 36
layers, random bf16 weights from a seed) through ``Engine.serve`` on the
paged cache, counts the kernel launches of that one serve, checks prefill
against prefill + one decode step, and checks a small f32 model served on
the card against the same model on the CPU. One JSON line per phase; the
line before the last lists every kernel with its times and bound; the
last line is the device record. Any failed check exits non-zero. Imports
nothing of JAX. Needs one card; without one it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

MEM_BW = 3.35e12          # H100 SXM HBM3 bytes/s (data sheet)
BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core FLOP/s
DEV = "cuda"


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / MEM_BW, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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


# -- the main path -----------------------------------------------------------

def phase_main(torch, models, fa, pfd):
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

    fa.flash_prefill.launches = 0
    pfd.paged_flash_decode_partial.launches = 0
    out = engine.serve(ids[:, :t], gen_len=gen)
    launches = {"flash_prefill": fa.flash_prefill.launches,
                "paged_flash_decode_partial":
                    pfd.paged_flash_decode_partial.launches}

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
            "paged_flash_decode_partial": arch.num_layers * (gen - 1)}
    if launches != want:
        fail(f"launch counts {launches}, want {want}")
    if tuple(out.shape) != (b, gen) or not bool(
            ((out >= 0) & (out < arch.vocab_size)).all()) or rec["overflow"]:
        fail("served tokens out of range or the page pool overflowed")
    return model, params, ids, launches, engine


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
      only), which pins the bf16 gap on rounding."""
    rows = []
    full, step = _prefill_vs_decode(torch, model, params, ids)
    rows.append(_compare_logits(torch, f"bf16_{model.arch.num_layers}_layers", full, step,
                                rel_tol=0.1, abs_frac=0.1))
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
    del m32, p32
    emit({"phase": "consistency", "cases": rows})
    if not all(r["ok"] for r in rows):
        fail("prefill(T+1) and prefill(T) + decode disagree")


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


def phase_profile(torch, engine, ids, steps: int = 4):
    """Where the main path's time goes: torch.profiler over one prefill
    (serve with gen_len=1) and over `steps` decode steps. Reports wall ms
    (profiled), the summed device time of all kernels, the device-idle
    share (one stream, so 1 - device/wall) and the kernels with the most
    device time."""
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
    dec = summarize(prof, wall, steps)
    emit({"phase": "profile", "prefill": pre, "decode_step": dec})


def phase_small_reference(torch, models):
    """A small f32 model (head_dim 128, 2 layers, T=128 so B1 runs) on the
    card against the same weights on the CPU (plain versions): the CPU
    Engine serves 8 greedy tokens, then both sides are teacher-forced on
    them (prefill + 7 decode steps through the cache) and every step's
    logits are compared. Tolerance 1e-3 for full-width pools (f32 on both
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
    for resident, tol in ((None, 1e-3), ("int8", 1e-2)):
        toks, logits = {}, {}
        for dev in ("cpu", DEV):
            model = models.Qwen3(arch, max_length=160, dtype=torch.float32,
                                 device=dev)
            params = models.params_from_numpy(raw, arch, dev, torch.float32)
            eng = models.Engine(model, params, page_size=32,
                                kv_resident=resident)
            toks[dev] = eng.serve(ids, gen_len=8).cpu()
            forced = toks["cpu"].to(dev)
            cache = model.create_paged_kv_cache(2, page_size=32,
                                                kv_resident=resident)
            out, cache = model.inference(params, cache, ids.to(dev))
            steps = [out.cpu()]
            for j in range(forced.shape[1] - 1):
                out, cache = model.inference(params, cache,
                                             forced[:, j:j + 1])
                steps.append(out.cpu())
            logits[dev] = torch.stack(steps)
        err = (logits["cpu"] - logits[DEV]).abs().max().item()
        rows.append({"kv_resident": resident,
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
        from triton_dist_tpu_torch import models
        from triton_dist_tpu_torch.kernels import flash_attention as fa
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
    reports = build.build(["flash_prefill", "paged_flash_decode"])
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, text in reports.items()}
    emit({"phase": "build", "seconds": build_s, "built": sorted(reports),
          "ptxas": ptxas})

    kernels = [phase_b1(torch, fa), phase_b2(torch, pfd, codec)]
    model, params, ids, launches, engine = phase_main(torch, models, fa,
                                                      pfd)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    phase_consistency(torch, models, model, params, ids)
    phase_profile(torch, engine, ids)
    del model, params, engine
    torch.cuda.empty_cache()
    phase_small_reference(torch, models)

    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi unavailable", flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
