"""B1: causal GQA flash prefill (the reference's kernels/flash_attention.py
flash_prefill over its Pallas _prefill_kernel).

``flash_prefill`` launches the hand-written CUDA kernel
``csrc/flash_prefill.cu`` for CUDA tensors and runs ``flash_prefill_ref``,
its plain PyTorch version, for CPU tensors. There is no fallback between
the two: a CUDA tensor the kernel does not take raises.

``offset`` is an int or a 0-d int32 tensor. A CUDA launch with a tensor
offset hands the kernel its device address and never reads it on the host,
so a decode step over the dense cache (whose offset lives on the device)
can be captured in a CUDA graph and replayed as the offset advances.

The plain version repeats the TPU kernel's fold: key blocks of
``min(128, S)`` keys, an online softmax with finite NEG_INF masking,
probabilities rounded to bf16 before P.V only when V is bf16, and a final
division by max(l, 1e-30). The emit_stats (SP chunk fold) and cu_seqlens
(packed varlen) variants are still to port (ROADMAP A11).
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.runtime import build

NEG_INF = -1e30   # finite: keeps exp/max NaN-free in fully masked rows

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_REF_BK = 128     # the TPU kernel's key block, min(128, S)


def p_cast(p: torch.Tensor, v_dtype: torch.dtype) -> torch.Tensor:
    """Probabilities enter P.V in V's dtype: rounded to bf16 when V is
    bf16, exact otherwise (returned as f32 for the f32 product)."""
    if v_dtype == torch.bfloat16:
        return p.to(torch.bfloat16).float()
    return p


def flash_prefill_ref(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, offset) -> torch.Tensor:
    """Plain PyTorch causal GQA attention in the TPU kernel's fold order.

    q: (B, T, Hq, D); k_cache/v_cache: (B, S, Hkv, D); query i sits at
    position offset + i and attends keys [0, offset + i]. Returns
    (B, T, Hq, D) in q.dtype. ``offset``: an int or a 0-d tensor."""
    b, t, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    bk = min(_REF_BK, s)
    dev = q.device
    qf = q.float().reshape(b, t, hkv, g, d).permute(0, 2, 3, 1, 4)
    kf = k_cache.float().permute(0, 2, 1, 3)[:, :, None]   # (B,Hkv,1,S,D)
    vf = v_cache.float().permute(0, 2, 1, 3)[:, :, None]
    q_pos = offset + torch.arange(t, device=dev)
    m = torch.full((b, hkv, g, t, 1), NEG_INF, device=dev)
    l = torch.zeros((b, hkv, g, t, 1), device=dev)
    acc = torch.zeros((b, hkv, g, t, d), device=dev)
    scale = d ** -0.5
    for k0 in range(0, s, bk):
        kb = kf[..., k0:k0 + bk, :]
        vb = vf[..., k0:k0 + bk, :]
        sc = torch.matmul(qf, kb.transpose(-1, -2)) * scale   # (.., T, bk)
        k_pos = k0 + torch.arange(kb.shape[-2], device=dev)
        valid = k_pos[None, :] <= q_pos[:, None]               # (T, bk)
        sc = torch.where(valid, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(sc - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
        acc = acc * alpha + torch.matmul(p_cast(p, v_cache.dtype), vb)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, d).to(q.dtype)


def flash_prefill(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, offset) -> torch.Tensor:
    """Causal GQA attention over the cache, no score materialization.

    q: (B, T, Hq, D); k_cache/v_cache: (B, S, Hkv, D) with valid keys in
    [0, offset + T); query i attends keys [0, offset + i]; ``offset`` is
    an int or a 0-d int32 tensor on q's device, read by the kernel on the
    device. Returns (B, T, Hq, D) in q.dtype. CUDA tensors launch the
    kernel (counted in ``flash_prefill.launches``); CPU tensors run
    ``flash_prefill_ref``."""
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k_cache, v_cache, offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    return _launch(q, k_cache, v_cache, offset)


flash_prefill.launches = 0


def _offset_args(offset, q: torch.Tensor):
    """(device pointer or None, int) for the C entry point: a tensor offset
    is passed by address and never read here."""
    if not isinstance(offset, torch.Tensor):
        return None, int(offset)
    if offset.ndim != 0 or offset.dtype != torch.int32 \
            or offset.device != q.device:
        raise ValueError("flash_prefill: a tensor offset must be a 0-d "
                         f"int32 tensor on {q.device}; got "
                         f"{tuple(offset.shape)} {offset.dtype} on "
                         f"{offset.device}")
    return offset.data_ptr(), 0


def _launch(q, k, v, offset) -> torch.Tensor:
    b, t, hq, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    s, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"flash_prefill: Hq={hq} not a multiple of "
                         f"Hkv={hkv}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError("flash_prefill: q/k/v must share one dtype of "
                         f"{list(_DTYPE_CODE)}; got {q.dtype}/{k.dtype}/"
                         f"{v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_prefill: head_dim {d} not in {_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_prefill: q/k/v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_prefill: q/k/v on different devices")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_prefill: q/k/v must be 16-byte aligned")
    off_ptr, off_val = _offset_args(offset, q)
    out = torch.empty_like(q)
    fn = build.function("flash_prefill", "td_flash_prefill", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p))
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, t, s, hq, hkv, d, off_ptr, off_val, d ** -0.5,
                 _DTYPE_CODE[q.dtype], build.stream_of(q))
    build.check(err, "flash_prefill")
    flash_prefill.launches += 1
    return out
