"""ReduceScatter across ranks (the reference's kernels/reduce_scatter.py).

Every rank holds x (n*m, K); rank r returns rows [r*m, (r+1)*m) of the
sum over the ranks. Methods at world n > 1 (``mesh`` is the ranks' Mesh):

  * XLA — ``dist.reduce_scatter_tensor`` (NCCL on the card), the
    reference's ``psum_scatter``;
  * RING_1D — B9, ``ring_reduce_scatter``: the hand-written CUDA kernel
    ``csrc/ring_collectives.cu`` for CUDA tensors, ``ring_rs_ref`` for CPU
    tensors. The reference's ring: chunk c starts raw at rank c+1 and
    every hop adds the next rank's rows (incoming + local, in x's dtype),
    so rank c's chunk is x_{c+1} + x_{c+2} + ... + x_c; every chunk has
    one value, whichever rank computes it;
  * AUTO — RING_1D on CUDA at n > 1, XLA elsewhere (the reference's
    ``_resolve_auto``, with "on a TPU" read as "on CUDA").

At world 1 the reduce-scatter is the identity. n must divide the rows:
anything else raises a ValueError (the reference's per-device body
divides by ``full_m // n`` and fails). No fallback: a CUDA call the
kernel does not take raises. The mesh-level ``reduce_scatter_op`` (with
the reference's fault preamble) waits for ROADMAP A8.
"""

from __future__ import annotations

import ctypes
import enum

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels.allreduce import _DTYPE_CODE, grid_blocks
from triton_dist_tpu_torch.kernels.plain import all_gather_list, ring_rs_fold
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.symm import op_workspace

_ALIGN = 256


class ReduceScatterMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    RING_1D = "ring_1d"


def resolve_reduce_scatter_method(method: ReduceScatterMethod, n: int,
                                  cuda: bool) -> ReduceScatterMethod:
    """AUTO -> RING_1D on CUDA at n > 1, XLA elsewhere."""
    if method != ReduceScatterMethod.AUTO:
        return method
    return (ReduceScatterMethod.RING_1D if cuda and n > 1
            else ReduceScatterMethod.XLA)


def rows_per_rank(n: int, x: torch.Tensor, what: str) -> int:
    """x's rows per rank; raises unless n divides them."""
    if x.ndim != 2 or x.shape[0] % n:
        raise ValueError(f"{what} needs 2-D x with rows divisible by the "
                         f"world {n}; got {tuple(x.shape)}")
    return x.shape[0] // n


def ring_rs_ref(mesh, x: torch.Tensor) -> torch.Tensor:
    """Plain version of B9 over the process group: every rank's x, this
    rank's chunk folded in the ring's order, in x's dtype."""
    rows_per_rank(mesh.world, x, "reduce_scatter")
    return ring_rs_fold(all_gather_list(mesh, x), mesh.rank)


def ring_rs_ref_shards(xs) -> list[torch.Tensor]:
    """Plain version of B9 over every rank's x in one process (the
    one-card world): the ranks' outputs in rank order."""
    rows_per_rank(len(xs), xs[0], "reduce_scatter")
    return [ring_rs_fold(xs, r) for r in range(len(xs))]


def _round_up(x: int, a: int = _ALIGN) -> int:
    return -(-x // a) * a


def ring_workspace(kind: str, mesh, m: int, k: int, dtype: torch.dtype):
    """(workspace, grid, byte offset of the flags) of B9 (kind "ring_rs")
    or B7 ("ring_ag") at m rows per rank chunk of K columns: landing
    regions (B9: 2 parities x n-1 steps; B7: 2 parities x n chunks) then
    one flag per (block, step), made at the first call (a collective
    allocation; never under capture)."""
    n, es = mesh.world, dtype.itemsize
    kv = k * es // 16
    sms = torch.cuda.get_device_properties(mesh.device).multi_processor_count
    grid = grid_blocks(m, kv, sms, mesh.ranks_per_device)
    chunk = m * k * es
    regions = 2 * (n - 1) * chunk if kind == "ring_rs" else 2 * n * chunk
    flag_off = _round_up(regions)
    total = flag_off + grid * (n - 1) * 8
    ws = op_workspace(mesh, (kind, m, k, dtype), (total,), torch.uint8)
    return ws, grid, flag_off


def ring_launch(kind: str, mesh, x: torch.Tensor, m: int) -> torch.Tensor:
    """Launch B9 (kind "ring_rs": x (n*m, K) -> (m, K)) or B7 ("ring_ag":
    x (m, K) -> (n*m, K)) on this rank's x."""
    what = "ring_reduce_scatter" if kind == "ring_rs" else "ring_all_gather"
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: dtype {x.dtype} not in "
                         f"{list(_DTYPE_CODE)}")
    if x.ndim != 2 or not x.is_contiguous() or x.data_ptr() % 16 or \
            (x.shape[1] * x.element_size()) % 16 or x.numel() == 0:
        raise ValueError(f"{what}: x must be a non-empty contiguous 2-D "
                         "tensor, 16-byte aligned, rows a multiple of 16 "
                         f"bytes; got {tuple(x.shape)}")
    n, k = mesh.world, x.shape[1]
    kv = k * x.element_size() // 16
    ws, grid, flag_off = ring_workspace(kind, mesh, m, k, x.dtype)
    out = x.new_empty((m, k) if kind == "ring_rs" else (n * m, k))
    with torch.cuda.device(x.device):
        fn = build.function("ring_collectives", f"td_{kind}", (
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
        err = fn(x.data_ptr(), out.data_ptr(), mesh.rank, n,
                 ws.buf.table.data_ptr(), ws.ctl.data_ptr(), m, kv, 0,
                 flag_off, grid, mesh.ranks_per_device,
                 _DTYPE_CODE[x.dtype], build.stream_of(x))
    build.check(err, what)
    return out


def ring_reduce_scatter(mesh, x: torch.Tensor) -> torch.Tensor:
    """B9 on this rank: row chunk ``mesh.rank`` of the sum over the ranks
    of x (n*m, K), folded along the ring in x's dtype; a fresh (m, K)
    tensor. CUDA tensors launch the kernel (counted in
    ``ring_reduce_scatter.launches``); CPU tensors run ``ring_rs_ref``.
    Every rank calls it with the same shape, in the same order."""
    if x.device.type == "cpu":
        return ring_rs_ref(mesh, x)
    if x.device.type != "cuda":
        raise ValueError(f"ring_reduce_scatter: unsupported device "
                         f"{x.device}")
    m = rows_per_rank(mesh.world, x, "reduce_scatter")
    out = ring_launch("ring_rs", mesh, x, m)
    ring_reduce_scatter.launches += 1
    return out


ring_reduce_scatter.launches = 0


def reduce_scatter_per_device(n: int, method: ReduceScatterMethod,
                              x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The reference's per-device entry: this rank's x (n*m, K) -> its
    (m, K) chunk of the sum over the n ranks. ``mesh`` (the ranks' Mesh)
    is needed at n > 1."""
    if n == 1:
        return x
    rows_per_rank(n, x, "reduce_scatter")
    if mesh is None or mesh.world != n:
        raise ValueError(f"reduce_scatter at world {n} needs the mesh of "
                         f"its {n} ranks; got {mesh}")
    method = resolve_reduce_scatter_method(method, n, x.is_cuda)
    if method == ReduceScatterMethod.XLA:
        out = x.new_empty((x.shape[0] // n, x.shape[1]))
        dist.reduce_scatter_tensor(out, x.contiguous(), group=mesh.group)
        return out
    if method == ReduceScatterMethod.RING_1D:
        return ring_reduce_scatter(mesh, x)
    raise ValueError(f"unresolved method {method}")
