"""The quantized wire's kernels (the reference's kernels/quant_wire.py).

  * B27, ``quantize_stage_per_device``: the int8 staging encode, x (m, K)
    f32 / bf16 -> (q (m, K) int8, s (m, 1) f32), one scale per row (the
    codec's ``int8_block``: s = amax / 127, q = clip(round(x / s), ±127)).
    The hand-written CUDA kernel ``csrc/quant_wire.cu`` for CUDA tensors,
    ``plain.quantize_stage_ref`` for CPU tensors; the same bytes. Each hop
    of the int8 ring (kernels/allreduce.py QINT8) encodes with it.
  * B28, ``qint8_one_shot_per_device``: the one-shot all-reduce with int8
    on the wire: every rank encodes its x once and pushes the payload and
    scales to every rank, then folds src = 0 .. n-1 in f32 (its own term
    read back from its own slot) and casts once, so every rank's output is
    the same bytes. The kernel of ``csrc/quant_wire.cu`` for CUDA tensors,
    ``qint8_one_shot_reference_per_device`` for CPU tensors.

``qint8_one_shot_reference_per_device`` is B28's plain version and its
twin: encode (the codec), the process group's all-gather of q and s
(NCCL on the card, gloo on the CPU) and ``plain.qint8_fold``. It is also
the only vehicle of the dithered codec ``int8_stochastic``, as in the
reference. The error promise is QuantContract("allreduce", "qint8_os"):
each term quantized once. No fallback: a CUDA tensor a kernel does not
take raises.
"""

from __future__ import annotations

import ctypes

import torch

from triton_dist_tpu_torch.kernels.plain import (
    all_gather_list, qint8_fold, quantize_stage_ref,
)
from triton_dist_tpu_torch.quant.codec import codec as wire_codec
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.symm import op_workspace

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 256
_ROWS_PER_SM = 4        # B27's blocks: a row each, about 4 an SM at most


def _round_up(x: int, a: int = _ALIGN) -> int:
    return -(-x // a) * a


def _check(x: torch.Tensor, what: str) -> int:
    """kv (16-byte vectors a row) of an x the kernels take: 2-D, f32 or
    bf16, contiguous, 16-byte aligned, K a multiple of 16. Raises
    otherwise."""
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: dtype {x.dtype} not in "
                         f"{list(_DTYPE_CODE)}")
    if x.ndim != 2 or not x.is_contiguous() or x.data_ptr() % 16 or \
            x.numel() == 0 or x.shape[1] % 16:
        raise ValueError(f"{what}: x must be a non-empty contiguous 2-D "
                         "tensor, 16-byte aligned, K a multiple of 16; got "
                         f"{tuple(x.shape)}")
    return x.shape[1] * x.element_size() // 16


def quantize_stage_per_device(x: torch.Tensor):
    """B27: x (m, K) -> (q (m, K) int8, s (m, 1) f32), fresh tensors. CUDA
    tensors launch the kernel (counted in
    ``quantize_stage_per_device.launches``); CPU tensors run
    ``plain.quantize_stage_ref``."""
    if x.device.type == "cpu":
        return quantize_stage_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_stage: unsupported device {x.device}")
    kv = _check(x, "quantize_stage")
    m = x.shape[0]
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    fn = build.function("quant_wire", "td_quantize_stage", (
        *(ctypes.c_void_p,) * 3, *(ctypes.c_int,) * 4, ctypes.c_void_p))
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), m, kv,
                 min(m, _ROWS_PER_SM * sms), _DTYPE_CODE[x.dtype],
                 build.stream_of(x))
    build.check(err, "quantize_stage")
    quantize_stage_per_device.launches += 1
    return q, s


quantize_stage_per_device.launches = 0


def qint8_one_shot_reference_per_device(mesh, x: torch.Tensor,
                                        codec_name: str = "int8_block"
                                        ) -> torch.Tensor:
    """B28's plain version (and the dithered tier's vehicle) on this rank:
    encode x with ``codec_name``, all-gather every rank's q and s in rank
    order, fold them (``plain.qint8_fold``), cast to x's dtype."""
    q, s = wire_codec(codec_name).encode(x)
    return qint8_fold(all_gather_list(mesh, q), all_gather_list(mesh, s),
                      x.dtype)


def qint8_one_shot_ref_shards(xs, codec_name: str = "int8_block"):
    """B28's plain version over every rank's x in one process (the
    one-card world): one output, the same for every rank."""
    enc = [wire_codec(codec_name).encode(x) for x in xs]
    out = qint8_fold([q for q, _ in enc], [s for _, s in enc], xs[0].dtype)
    return [out] * len(xs)


def grid_blocks(m: int, sm_count: int, ranks_per_device: int) -> int:
    """B28's blocks: whole rows each, at most one an SM for each rank that
    shares the card (all resident at once)."""
    return max(1, min(m, sm_count // ranks_per_device))


def qint8_one_shot_per_device(mesh, x: torch.Tensor) -> torch.Tensor:
    """B28 on this rank: the sum over the ranks of x (m, K) with int8 on
    the wire, in x's dtype; a fresh tensor, the same bytes on every rank.
    CUDA tensors launch the kernel (counted in
    ``qint8_one_shot_per_device.launches``); CPU tensors run
    ``qint8_one_shot_reference_per_device``. Every rank calls it with the
    same shape, in the same order."""
    if x.device.type == "cpu":
        return qint8_one_shot_reference_per_device(mesh, x)
    if x.device.type != "cuda":
        raise ValueError(f"qint8_one_shot: unsupported device {x.device}")
    kv = _check(x, "qint8_one_shot")
    world, (m, k) = mesh.world, x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = grid_blocks(m, sms, mesh.ranks_per_device)
    s_off = _round_up(2 * world * m * k)
    flag_off = s_off + _round_up(2 * world * m * 4)
    ws = op_workspace(mesh, ("qint8_os", m, k, x.dtype),
                      (flag_off + grid * world * 8,), torch.uint8)
    out = torch.empty_like(x)
    fn = build.function("quant_wire", "td_qint8_one_shot", (
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p))
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), mesh.rank, world,
                 ws.buf.table.data_ptr(), ws.ctl.data_ptr(), m, kv, s_off,
                 flag_off, grid, mesh.ranks_per_device, _DTYPE_CODE[x.dtype],
                 build.stream_of(x))
    build.check(err, "qint8_one_shot")
    qint8_one_shot_per_device.launches += 1
    return out


qint8_one_shot_per_device.launches = 0
