"""GEMM + ReduceScatter (the reference's kernels/gemm_reduce_scatter.py).

Every rank holds A (n*m, K_loc) (the K dimension sharded over the mesh)
and a (K_loc, N) row shard of B; rank d returns rows [d*m, (d+1)*m) of
sum over ranks of a @ b: the row-parallel projection, from f32 partials
with one cast. Methods at world n > 1 (``mesh`` is the ranks' Mesh):

  * XLA — the f32 product, ``dist.reduce_scatter_tensor``, the cast:
    B13a's plain version and the unfused baseline;
  * XLA_RING — the reference's ring (its default): at step s a rank adds
    its partial of chunk (me - 1 - s) mod n to the one received from the
    left and passes it on (``dist.batch_isend_irecv``);
  * PALLAS — B13a, ``pallas_gemm_rs``: the hand-written CUDA kernel
    ``csrc/gemm_rs.cu`` for CUDA tensors, ``gemm_rs_ref`` for CPU tensors.
    Each rank stores its f32 partial of every destination's rows into that
    destination's landing slot for this sender; the owner adds its n slots
    in a FIXED order, slot 0 + slot 1 + ... + slot n-1 (ascending sender
    rank), and casts once. The reference's ring adds in a rank-dependent
    order, so the tiers agree to f32 rounding, not bit for bit. No
    fallback: a CUDA call the kernel does not take raises;
  * XLA_BIDIR, PALLAS_BIDIR — the bidirectional ring (B13b) raises,
    naming ROADMAP A9.

At world 1 the reduce-scatter is the identity: XLA, XLA_RING and XLA_BIDIR
compute the plain product, PALLAS and PALLAS_BIDIR B12 (as the reference's
n == 1 path runs ``_pallas_matmul``).
"""

from __future__ import annotations

import enum

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels.allgather_gemm import (
    _peer, check_bidir, check_mesh, matmul_ref, pallas_matmul,
)
from triton_dist_tpu_torch.kernels.gemm_allreduce import landing_launch
from triton_dist_tpu_torch.kernels.plain import dot_f32


class GemmRsMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    XLA_RING = "xla_ring"
    XLA_BIDIR = "xla_bidir"
    PALLAS = "pallas"
    PALLAS_BIDIR = "pallas_bidir"


def _rows_per_rank(mesh, a: torch.Tensor, what: str) -> int:
    if a.shape[0] % mesh.world:
        raise ValueError(f"{what}: M={a.shape[0]} not divisible by the "
                         f"world {mesh.world}")
    return a.shape[0] // mesh.world


def gemm_rs_ref(mesh, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of B13a (the XLA tier): the f32 product, a
    reduce-scatter of the f32 partials along rows, one cast."""
    m = _rows_per_rank(mesh, a, "gemm_rs")
    part = dot_f32(a, b).contiguous()
    out = torch.empty((m, b.shape[1]), dtype=torch.float32, device=a.device)
    dist.reduce_scatter_tensor(out, part, group=mesh.group)
    return out.to(torch.result_type(a, b))


def gemm_rs_ref_shards(a_shards, b_shards) -> list[torch.Tensor]:
    """Plain version of B13a over every rank's A and B in one process (the
    one-card world), one pass for all ranks: each sender's f32 partial,
    added in the kernel's order (ascending sender rank), then every rank's
    rows cast once. Returns the ranks' outputs in rank order."""
    world = len(a_shards)
    m = a_shards[0].shape[0] // world
    acc = dot_f32(a_shards[0], b_shards[0])
    for s in range(1, world):
        acc = acc + dot_f32(a_shards[s], b_shards[s])
    out = acc.to(torch.result_type(a_shards[0], b_shards[0]))
    return [out[r * m:(r + 1) * m] for r in range(world)]


def _ring_gemm_rs(mesh, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA_RING (the reference's _ring_gemm_rs_per_device): the partial of
    chunk (me - 1 - s) mod n plus the one from the left travels right; the
    last arrival is this rank's chunk, summed over every rank."""
    n, me = mesh.world, mesh.rank
    m = _rows_per_rank(mesh, a, "gemm_rs")
    right, left = _peer(mesh, (me + 1) % n), _peer(mesh, (me - 1) % n)
    acc = torch.zeros((m, b.shape[1]), dtype=torch.float32, device=a.device)
    for s in range(n - 1):
        c = (me - 1 - s) % n
        part = (dot_f32(a[c * m:(c + 1) * m], b) + acc).contiguous()
        acc = torch.empty_like(part)
        for r in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, part, right, mesh.group),
                dist.P2POp(dist.irecv, acc, left, mesh.group)]):
            r.wait()
    out = dot_f32(a[me * m:(me + 1) * m], b) + acc
    return out.to(torch.result_type(a, b))


def pallas_gemm_rs(mesh, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B13a on this rank: rows [rank*m, (rank+1)*m) of the sum over ranks of
    a @ b, a (n*m, K_loc), b (K_loc, N). CUDA tensors launch the kernel
    (counted in ``pallas_gemm_rs.launches``); CPU tensors run
    ``gemm_rs_ref``. Every rank calls it with the same shapes, in the same
    order."""
    if a.device.type == "cpu":
        return gemm_rs_ref(mesh, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"pallas_gemm_rs: unsupported device {a.device}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"pallas_gemm_rs: a {tuple(a.shape)} @ b "
                         f"{tuple(b.shape)}")
    out = landing_launch(mesh, a, b,
                         _rows_per_rank(mesh, a, "pallas_gemm_rs"),
                         "gemm_rs", "td_gemm_rs", "pallas_gemm_rs")
    pallas_gemm_rs.launches += 1
    return out


pallas_gemm_rs.launches = 0


def gemm_rs_per_device(n: int, method: GemmRsMethod, a: torch.Tensor,
                       b: torch.Tensor, mesh=None) -> torch.Tensor:
    """The reference's per-device entry: A (n*m, K_loc) and this rank's
    (K_loc, N) shard of B -> this rank's (m, N) rows of the sum. ``mesh``
    (the ranks' Mesh) is needed at n > 1."""
    check_bidir(n, method, "gemm_rs")
    if n == 1:
        if method in (GemmRsMethod.XLA, GemmRsMethod.XLA_RING,
                      GemmRsMethod.XLA_BIDIR):
            return matmul_ref(a, b)
        if method in (GemmRsMethod.PALLAS, GemmRsMethod.PALLAS_BIDIR):
            return pallas_matmul(a, b)
        raise ValueError(f"unresolved method {method}")
    check_mesh(n, mesh, "gemm_rs")
    if method == GemmRsMethod.XLA:
        return gemm_rs_ref(mesh, a, b)
    if method == GemmRsMethod.XLA_RING:
        return _ring_gemm_rs(mesh, a, b)
    if method == GemmRsMethod.PALLAS:
        return pallas_gemm_rs(mesh, a, b)
    raise ValueError(f"unresolved method {method}")
