"""AllGather + GEMM (the reference's kernels/allgather_gemm.py).

Every rank holds an (m, K) shard of A (rows sharded over the mesh) and a
(K, N_loc) column shard of B; the op returns (allgather(a) @ b, allgather(a))
with f32 accumulation and one cast: out (n*m, N_loc), gathered A (n*m, K),
rank-major. Methods at world n > 1 (``mesh`` is the ranks' Mesh):

  * XLA — ``dist.all_gather_into_tensor`` then ``matmul_ref``: B10's plain
    version, and the unfused baseline;
  * XLA_RING — the reference's collective matmul (its default): n ring
    steps of ``dist.batch_isend_irecv``, step s multiplying the shard of
    rank (me - s) mod n while it travels on to the right;
  * PALLAS — B10, ``pallas_ag_gemm``: the hand-written CUDA kernel
    ``csrc/ag_gemm.cu`` for CUDA tensors (full-mesh push of the own shard
    into every rank's symmetric buffer, the split-K GEMM consuming each
    shard as its flag rises), ``ag_gemm_ref`` for CPU tensors. No
    fallback: a CUDA call the kernel does not take raises;
  * XLA_BIDIR, PALLAS_BIDIR — the bidirectional ring (B11) raises, naming
    ROADMAP A9.

At world 1 the gather is the identity and every method computes
out = cast(a @ b), returning (out, a): XLA, XLA_RING and XLA_BIDIR the
plain product, PALLAS and PALLAS_BIDIR B12 (``pallas_matmul``, the
reference's ``_pallas_matmul``, its n == 1 path; ``csrc/matmul.cu``).

The TPU tile sizes (bm, bn, bk) have nothing to choose on the card: the K
split is sized to fill it (``gemm_allreduce.split_plan``).
"""

from __future__ import annotations

import ctypes
import enum

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels.gemm_allreduce import (
    _DTYPE_CODE, split_plan, splitk_launch,
)
from triton_dist_tpu_torch.kernels.plain import dot_f32
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.symm import op_workspace


class AgGemmMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    XLA_RING = "xla_ring"
    XLA_BIDIR = "xla_bidir"
    PALLAS = "pallas"
    PALLAS_BIDIR = "pallas_bidir"


def check_mesh(n: int, mesh, what: str) -> None:
    """World n > 1 needs the ranks' mesh, of that size."""
    if n > 1 and (mesh is None or mesh.world != n):
        raise ValueError(f"{what} at world {n} needs the mesh of its {n} "
                         f"ranks; got {mesh}")


def check_bidir(n: int, method, what: str) -> None:
    if n > 1 and method.value in ("xla_bidir", "pallas_bidir"):
        raise NotImplementedError(
            f"{what} {method.name} at world {n} (the bidirectional ring, "
            "B11/B13b) waits for ROADMAP A9")


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of B12: (M, K) @ (K, N) with f32 accumulation, one
    cast to the inputs' result dtype."""
    return dot_f32(a, b).to(torch.result_type(a, b))


def pallas_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B12: cast(a @ b) with a K-split f32 accumulator, a (M, K), b (K, N).
    CUDA tensors launch the kernel (counted in ``pallas_matmul.launches``);
    CPU tensors run ``matmul_ref``."""
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"pallas_matmul: unsupported device {a.device}")
    out = splitk_launch(a.contiguous(), b, "matmul", "td_matmul",
                        "pallas_matmul")
    pallas_matmul.launches += 1
    return out


pallas_matmul.launches = 0


def _peer(mesh, r: int) -> int:
    return dist.get_global_rank(mesh.group, r)


def ag_gemm_ref(mesh, a: torch.Tensor, b: torch.Tensor):
    """Plain version of B10 (the XLA tier): all-gather the row shards,
    then one product with f32 accumulation and one cast."""
    ag = torch.empty((mesh.world * a.shape[0], a.shape[1]), dtype=a.dtype,
                     device=a.device)
    dist.all_gather_into_tensor(ag, a.contiguous(), group=mesh.group)
    return matmul_ref(ag, b), ag


def ag_gemm_ref_shards(a_shards, b: torch.Tensor):
    """Plain version of B10 over the shards of every rank in one process
    (the one-card world): concatenate, then ``matmul_ref``."""
    ag = torch.cat(list(a_shards), dim=0)
    return matmul_ref(ag, b), ag


def _ring_ag_gemm(mesh, a: torch.Tensor, b: torch.Tensor):
    """XLA_RING: step s multiplies the shard of rank (me - s) mod n while
    sending it to the right neighbour and receiving the next from the
    left (the reference's _ring_matmul_per_device)."""
    n, me, m = mesh.world, mesh.rank, a.shape[0]
    right, left = _peer(mesh, (me + 1) % n), _peer(mesh, (me - 1) % n)
    out = torch.empty((n * m, b.shape[1]), dtype=torch.result_type(a, b),
                      device=a.device)
    ag = torch.empty((n * m, a.shape[1]), dtype=a.dtype, device=a.device)
    cur = a.contiguous()
    for s in range(n):
        chunk = (me - s) % n
        reqs = []
        if s < n - 1:
            nxt = torch.empty_like(cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, cur, right, mesh.group),
                dist.P2POp(dist.irecv, nxt, left, mesh.group)])
        out[chunk * m:(chunk + 1) * m] = matmul_ref(cur, b)
        ag[chunk * m:(chunk + 1) * m] = cur
        for r in reqs:
            r.wait()
        if s < n - 1:
            cur = nxt
    return out, ag


def pallas_ag_gemm(mesh, a: torch.Tensor, b: torch.Tensor):
    """B10 on this rank: (allgather(a) @ b, allgather(a)), a (m, K) this
    rank's shard, b (K, N_loc). CUDA tensors launch the kernel (counted in
    ``pallas_ag_gemm.launches``; it copies the gathered A out of the rank's
    symmetric buffer into a fresh tensor); CPU tensors run
    ``ag_gemm_ref``. Every rank calls it with the same shapes, in the same
    order."""
    if a.device.type == "cpu":
        return ag_gemm_ref(mesh, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"pallas_ag_gemm: unsupported device {a.device}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"pallas_ag_gemm: a {tuple(a.shape)} @ b "
                         f"{tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"pallas_ag_gemm: a/b must share one dtype of "
                         f"{list(_DTYPE_CODE)}; got {a.dtype}/{b.dtype}")
    a = a.contiguous()
    if not b.is_contiguous() or b.data_ptr() % 16 or a.data_ptr() % 16:
        raise ValueError("pallas_ag_gemm: b contiguous, a/b 16-byte "
                         "aligned")
    m, k = a.shape
    n_cols, world = b.shape[1], mesh.world
    vec = 16 // a.element_size()
    if n_cols % vec or k % vec:
        raise ValueError(f"pallas_ag_gemm: K={k} and N={n_cols} must be "
                         f"multiples of {vec}")
    rows = world * m
    ws = op_workspace(mesh, ("ag_gemm", m, k, a.dtype), (rows, k), a.dtype)
    k_chunk, splits = split_plan(
        rows, k, n_cols, vec,
        torch.cuda.get_device_properties(a.device).multi_processor_count)
    out = torch.empty((rows, n_cols), dtype=a.dtype, device=a.device)
    ag = torch.empty((rows, k), dtype=a.dtype, device=a.device)
    part = (torch.empty((splits, rows, n_cols), dtype=torch.float32,
                        device=a.device) if splits > 1 else None)
    fn = build.function("ag_gemm", "td_ag_gemm", (
        *(ctypes.c_void_p,) * 5, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        *(ctypes.c_int,) * 7, ctypes.c_void_p))
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 out.data_ptr(), ag.data_ptr(), mesh.rank, world,
                 ws.buf.table.data_ptr(), ws.buf.sig_off, ws.ctl.data_ptr(),
                 m, k, n_cols, k_chunk, splits, mesh.ranks_per_device, _DTYPE_CODE[a.dtype],
                 build.stream_of(a))
    build.check(err, "pallas_ag_gemm")
    pallas_ag_gemm.launches += 1
    return out, ag


pallas_ag_gemm.launches = 0


def ag_gemm_per_device(n: int, method: AgGemmMethod, a: torch.Tensor,
                       b: torch.Tensor, mesh=None):
    """The reference's per-device entry: this rank's (m, K) shard of A and
    (K, N_loc) shard of B -> (out (n*m, N_loc), gathered A). ``mesh``
    (the ranks' Mesh) is needed at n > 1."""
    check_bidir(n, method, "ag_gemm")
    if n == 1:
        if method in (AgGemmMethod.XLA, AgGemmMethod.XLA_RING,
                      AgGemmMethod.XLA_BIDIR):
            return matmul_ref(a, b), a
        if method in (AgGemmMethod.PALLAS, AgGemmMethod.PALLAS_BIDIR):
            return pallas_matmul(a, b), a
        raise ValueError(f"unresolved method {method}")
    check_mesh(n, mesh, "ag_gemm")
    if method == AgGemmMethod.XLA:
        return ag_gemm_ref(mesh, a, b)
    if method == AgGemmMethod.XLA_RING:
        return _ring_ag_gemm(mesh, a, b)
    if method == AgGemmMethod.PALLAS:
        return pallas_ag_gemm(mesh, a, b)
    raise ValueError(f"unresolved method {method}")
