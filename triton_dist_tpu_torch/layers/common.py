"""Shared layer math: RMSNorm, rotary embeddings, the TP context (the
reference's layers/common.py)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels.allgather_gemm import AgGemmMethod
from triton_dist_tpu_torch.kernels.allgather_group_gemm import (
    AgGroupGemmMethod,
)
from triton_dist_tpu_torch.kernels.allreduce import AllReduceMethod
from triton_dist_tpu_torch.kernels.ep_a2a import EpA2AMethod
from triton_dist_tpu_torch.kernels.gemm_allreduce import GemmArMethod
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import GemmRsMethod
from triton_dist_tpu_torch.kernels.moe_reduce_rs import MoeReduceRsMethod
from triton_dist_tpu_torch.kernels.plain import dot_f32  # noqa: F401
from triton_dist_tpu_torch.runtime.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class TPContext:
    """Parallelism context of a model, with the reference's fields and
    defaults. ``mesh`` is the ranks' Mesh (runtime/mesh.py); None means
    world 1 on one device, where the reference's collectives are the
    identity.

    ag_method / rs_method: the triton_dist mode's QKV and o (and dense
    MLP) projections (PALLAS = B10 and B13a at world n > 1, B12 at world
    1; PALLAS_BIDIR = B11 and B13b, the bidirectional rings, at n >= 3,
    B10 and B13a at n = 2; XLA_BIDIR their plain rings); ar_method: the triton_dist_AR mode's sum after the o and down
    products (XLA = the process group's all-reduce, ONE_SHOT = B5, RHD =
    B6, the int8 wire QINT8_OS = B28 and QINT8 = the int8 ring with B27);
    gemm_ar_method, when set, replaces that product and sum with the
    fused GEMM + all-reduce (PALLAS = B4; XLA_QINT8 the f32 product on
    the int8 ring); moe_ag_method / moe_rs_method:
    the triton_dist mode's MoE gate/up (PALLAS = B14) and down + top-k
    combine (PALLAS = B15), at world 1 and across ranks; AUTO picks the
    kernels on CUDA and the plain products on the CPU. ep_a2a_method: the
    triton_dist mode's transport of the expert-parallel MoE layer
    (``moe_parallel="ep"``; layers/ep_a2a_layer.py): XLA = the process
    group's all-to-all, PALLAS = B17 (B18 for the fp8 payload under
    TD_QUANT=always), PALLAS_FUSED = B16 (dispatch fused with the gate/up
    grouped GEMM), then B17 for the combine; ep_max_m caps the slots of a
    (src, dst) pair (None: the routing's worst case, which never drops).
    comm_blocks: the row blocks B14 pushes a shard in and B16 a payload
    slot in. tile_bm / tile_bn / tile_bk are the TPU kernels' tiles:
    carried for the reference's signatures, nothing on the card reads
    them.

    attn_method: "auto" (flash kernel when head_dim % 128 == 0 and the
    chunk has at least 128 keys), "pallas" (always the flash kernel —
    the reference's name for it) or "xla" (masked-einsum baseline)."""
    mesh: Mesh | None = None
    axis: str = "tp"
    ag_method: AgGemmMethod = AgGemmMethod.XLA_RING
    rs_method: GemmRsMethod = GemmRsMethod.XLA_RING
    ar_method: AllReduceMethod = AllReduceMethod.XLA
    gemm_ar_method: GemmArMethod | None = None
    moe_ag_method: AgGroupGemmMethod = AgGroupGemmMethod.AUTO
    moe_rs_method: MoeReduceRsMethod = MoeReduceRsMethod.AUTO
    ep_a2a_method: EpA2AMethod = EpA2AMethod.XLA
    attn_method: str = "auto"
    ep_max_m: int | None = None
    tile_bm: int = 256
    tile_bn: int = 256
    tile_bk: int = 512
    comm_blocks: int = 4

    def __post_init__(self):
        if self.ep_max_m is not None and self.ep_max_m < 1:
            raise ValueError(f"ep_max_m {self.ep_max_m} < 1")
        if self.mesh is not None and self.mesh.axis != self.axis:
            raise ValueError(f"mesh axis {self.mesh.axis!r} is not the TP "
                             f"axis {self.axis!r}")

    @property
    def world(self) -> int:
        return 1 if self.mesh is None else self.mesh.world


MODES = ("xla", "triton_dist", "triton_dist_AR")


def check_mode(mode: str) -> None:
    """The three forwards of the reference: "xla" (local matmuls, an
    all-reduce after the o and down projections), "triton_dist"
    (batch-sharded rows through AG + GEMM and GEMM + RS) and
    "triton_dist_AR" (as xla, the sums through ``ctx.ar_method`` or the
    fused ``ctx.gemm_ar_method``)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")


def psum(ctx: TPContext, y: torch.Tensor) -> torch.Tensor:
    """The reference's ``lax.psum`` over the TP axis: an in-place
    all-reduce of ``y`` across the mesh (the identity at world 1)."""
    if ctx.world > 1:
        dist.all_reduce(y, group=ctx.mesh.group)
    return y


def gather_vocab(ctx: TPContext, logits: torch.Tensor) -> torch.Tensor:
    """(b, V/n) f32 logits of this rank's vocabulary columns -> (b, V):
    the reference's all-gather along the vocabulary (the identity at world
    1)."""
    n, b = ctx.world, logits.shape[0]
    if n == 1:
        return logits
    logits = logits.contiguous()
    recv = torch.empty((n * b, logits.shape[1]), dtype=logits.dtype,
                       device=logits.device)
    dist.all_gather_into_tensor(recv, logits, group=ctx.mesh.group)
    # (n, b, V/n) blocks of vocabulary shards -> (b, V)
    return recv.view(n, b, -1).transpose(0, 1).reshape(b, -1)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in the reference's order: normalize in f32, cast to x's
    dtype, THEN multiply by w."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def make_cos_sin_cache(head_dim: int, max_length: int, theta: float,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """(max_length, 2, head_dim) f32 cos/sin table. The angles are the
    reference's f32 products; their cos and sin are taken in float64 on
    the host and rounded to f32 (within 2 ulp of the reference's f32
    table). torch's f32 cos on the CPU gave, on the first call of a loaded
    process, values 1.5e-4 off at angles near 160 rad."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim))
    t = torch.arange(max_length, dtype=torch.float32)
    freqs = torch.outer(t, inv_freq)                    # (S, D/2)
    emb = torch.cat([freqs, freqs], dim=-1).numpy().astype(np.float64)
    table = np.stack([np.cos(emb), np.sin(emb)], axis=1).astype(np.float32)
    return torch.from_numpy(table).to(device)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos_sin: torch.Tensor,
               positions: torch.Tensor):
    """Rotary embedding of q/k (B, T, H, D); positions (T,) shared or
    (B, T) per sequence. Computed in f32, returned in the inputs' dtypes.
    Positions past the table (the pad tail of a bucket-padded prefill
    chunk, whose outputs are discarded) read its last row, as the
    reference's clamping gather does."""
    idx = positions.long().clamp_max(cos_sin.shape[0] - 1)
    table = cos_sin[idx]                                # (..., T, 2, D)
    if positions.ndim == 2:
        cos = table[:, :, 0][:, :, None, :]             # (B, T, 1, D)
        sin = table[:, :, 1][:, :, None, :]
    else:
        cos = table[:, 0][None, :, None, :]             # (1, T, 1, D)
        sin = table[:, 1][None, :, None, :]
    qf, kf = q.float(), k.float()
    q_rot = qf * cos + _rotate_half(qf) * sin
    k_rot = kf * cos + _rotate_half(kf) * sin
    return q_rot.to(q.dtype), k_rot.to(k.dtype)
