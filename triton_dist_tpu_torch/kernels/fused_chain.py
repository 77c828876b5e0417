"""B3: fused residual add + RMSNorm (the reference's kernels/fused_chain.py,
the mega program's attention→MLP boundary).

``fused_add_rms`` launches the hand-written CUDA kernel
``csrc/fused_add_rms.cu`` for CUDA tensors and runs ``add_rms_norm_xla``,
its plain PyTorch version, for CPU tensors. There is no fallback between
the two: a CUDA tensor the kernel does not take raises.

The plain version keeps the reference's fold order: the residual add in
the input dtype, then the RMSNorm of the rounded sum (f32 square-mean,
rsqrt, cast to the input dtype, THEN the multiply by w). The kernel keeps
the same cast points, so ``s`` is bitwise equal and ``normed`` differs only
by the order of the f32 square sum.
"""

from __future__ import annotations

import ctypes
import enum

import torch

from triton_dist_tpu_torch.runtime import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_VEC_PER_THREAD = 8       # the kernel's largest instantiation
_THREADS = 256


class FusedChainMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"          # the plain fold: the reference's twin
    PALLAS = "pallas"    # the fused kernel (the reference's name for it)


def add_rms_norm_xla(h: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                     eps: float):
    """(s, normed): s = h + a in the input dtype; normed = RMSNorm(s) * w
    in the reference's fold order."""
    s = h + a
    xf = s.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    normed = (xf * torch.rsqrt(var + eps)).to(s.dtype) * w
    return s, normed


def fused_add_rms(h: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
                  eps: float):
    """(h + a, RMSNorm(h + a) * w) for h/a (..., d) and w (d,). CUDA
    tensors launch the kernel (counted in ``fused_add_rms.launches``); CPU
    tensors run ``add_rms_norm_xla``."""
    if h.device.type == "cpu":
        return add_rms_norm_xla(h, a, w, eps)
    if h.device.type != "cuda":
        raise ValueError(f"fused_add_rms: unsupported device {h.device}")
    return _launch(h, a, w, eps)


fused_add_rms.launches = 0


def fused_add_rms_per_device(method: FusedChainMethod, h: torch.Tensor,
                             a: torch.Tensor, w: torch.Tensor, eps: float):
    """The reference's per-device entry: AUTO and XLA take the plain fold,
    PALLAS the fused kernel (one block per row on the card, so the TPU's
    row block and interpret flag have nothing to choose here)."""
    if method in (FusedChainMethod.AUTO, FusedChainMethod.XLA):
        return add_rms_norm_xla(h, a, w, eps)
    if method != FusedChainMethod.PALLAS:
        raise ValueError(f"unknown fused-chain method {method}")
    return fused_add_rms(h, a, w, eps)


def _launch(h, a, w, eps):
    d = h.shape[-1]
    if a.shape != h.shape or w.shape != (d,):
        raise ValueError(f"fused_add_rms: h {tuple(h.shape)}, a "
                         f"{tuple(a.shape)}, w {tuple(w.shape)}")
    if h.dtype not in _DTYPE_CODE or a.dtype != h.dtype \
            or w.dtype != h.dtype:
        raise ValueError("fused_add_rms: h/a/w must share one dtype of "
                         f"{list(_DTYPE_CODE)}; got {h.dtype}/{a.dtype}/"
                         f"{w.dtype}")
    vec = 16 // h.element_size()
    nvec = d // vec
    if d % vec or nvec > _MAX_VEC_PER_THREAD * _THREADS:
        raise ValueError(f"fused_add_rms: d={d} must be a multiple of {vec} "
                         f"and at most {_MAX_VEC_PER_THREAD * _THREADS * vec}")
    if not (h.is_contiguous() and a.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_add_rms: h/a/w must be contiguous")
    if not (h.device == a.device == w.device):
        raise ValueError("fused_add_rms: h/a/w on different devices")
    if any(t.data_ptr() % 16 for t in (h, a, w)):
        raise ValueError("fused_add_rms: h/a/w must be 16-byte aligned")
    s = torch.empty_like(h)
    normed = torch.empty_like(h)
    rows = h.numel() // d
    if rows == 0:
        return s, normed
    fn = build.function("fused_add_rms", "td_fused_add_rms", (
        *(ctypes.c_void_p,) * 5, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p))
    with torch.cuda.device(h.device):
        err = fn(h.data_ptr(), a.data_ptr(), w.data_ptr(), s.data_ptr(),
                 normed.data_ptr(), rows, d, eps, _DTYPE_CODE[h.dtype],
                 build.stream_of(h))
    build.check(err, "fused_add_rms")
    fused_add_rms.launches += 1
    return s, normed
