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
  * XLA_BIDIR — the reference's bidirectional collective matmul: the
    shard travels both ring directions at once (``dist.batch_isend_irecv``
    to both neighbours), kr = n // 2 rounds to the right and kl =
    (n - 1) // 2 to the left, one (2m, K) product per round;
  * PALLAS_BIDIR — B11 at n >= 3, ``pallas_ag_gemm_bidir``: the
    hand-written CUDA kernel of ``csrc/ag_gemm.cu`` for CUDA tensors (the
    reference's neighbour-forwarding schedule over both directions, B10's
    GEMM, so out is B10's bits), ``ag_gemm_ref`` for CPU tensors; at
    n <= 2 there is no second direction and it is B10, as in the
    reference.

The mesh-level ``ag_gemm(ctx, a, b)`` resolves the method from an
``AgGemmContext`` (``create_ag_gemm_context``) and runs the per-device
entry on this rank's shards. A context with ``dcn_axis`` set (the 2-D
schedule over a multi-axis mesh) raises naming ROADMAP A9 (tail). The
mesh-level op has no fault preamble and no fallback (ROADMAP A8).

At world 1 the gather is the identity and every method computes
out = cast(a @ b), returning (out, a): XLA, XLA_RING and XLA_BIDIR the
plain product, PALLAS and PALLAS_BIDIR B12 (``pallas_matmul``, the
reference's ``_pallas_matmul``, its n == 1 path; ``csrc/matmul.cu``).

The TPU tile sizes (bm, bn, bk) have nothing to choose on the card: the K
split is sized to fill it (``gemm_allreduce.split_plan``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels.gemm_allreduce import (
    _DTYPE_CODE, split_plan, splitk_launch,
)
from triton_dist_tpu_torch.kernels.plain import dot_f32
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.mesh import comm_axis_size
from triton_dist_tpu_torch.runtime.symm import op_workspace

_ALIGN = 256


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


def check_not_2d(dcn_axis, what: str) -> None:
    """The 2-D schedules (a context with dcn_axis) need a multi-axis
    mesh."""
    if dcn_axis is not None:
        raise NotImplementedError(
            f"{what} over a factored (dcn_axis x axis) mesh waits for "
            "ROADMAP A9 (tail): the 2-D variants need A1's multi-axis "
            "meshes")


@dataclasses.dataclass
class AgGemmContext:
    """The reference's AgGemmContext: the ranks' Mesh, its axis, the
    method and the TPU kernel's tiles (carried for the reference's
    signatures; nothing on the card reads them: the K split is sized to
    fill the card). dcn_axis, set, raises in ``ag_gemm``: ROADMAP A9
    (tail)."""
    mesh: object
    axis: str = "tp"
    method: AgGemmMethod = AgGemmMethod.AUTO
    bm: int = 512
    bn: int = 1024
    bk: int = 512
    dcn_axis: str | None = None

    @property
    def world(self) -> int:
        return comm_axis_size(self.mesh, self.axis)

    def resolve(self) -> AgGemmMethod:
        """The reference's rule, platform-neutral: an explicit method
        stands; AUTO is XLA at world 1, XLA_RING above."""
        if self.method != AgGemmMethod.AUTO:
            return self.method
        if self.world == 1:
            return AgGemmMethod.XLA
        return AgGemmMethod.XLA_RING

    def resolve_for(self, m: int, k: int, n_local: int, dtype=None):
        """(method, bm, bn, bk) for the local dims (m, k, n_local). The
        reference consults tools/tune.py's tables, measured on a TPU; the
        port has no tuned table until ROADMAP A16's tuner, so this is
        ``resolve()`` with the context's tiles."""
        return self.resolve(), self.bm, self.bn, self.bk


def create_ag_gemm_context(mesh, axis: str = "tp", **kw) -> AgGemmContext:
    return AgGemmContext(mesh, axis, **kw)


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


def _bidir_ring_ag_gemm(mesh, a: torch.Tensor, b: torch.Tensor):
    """XLA_BIDIR (the reference's _bidir_ring_matmul_per_device): the own
    shard first; at round s the shard of rank (me - s) arrives from the
    left (s <= kr = n // 2) and that of rank (me + s) from the right
    (s <= kl = (n - 1) // 2), both multiplied in one (2m, K) product."""
    n, me, m = mesh.world, mesh.rank, a.shape[0]
    kr, kl = n // 2, (n - 1) // 2
    right, left = _peer(mesh, (me + 1) % n), _peer(mesh, (me - 1) % n)
    dt = torch.result_type(a, b)
    out = torch.empty((n * m, b.shape[1]), dtype=dt, device=a.device)
    ag = torch.empty((n * m, a.shape[1]), dtype=a.dtype, device=a.device)
    a = a.contiguous()

    def put(c, prod, rows):
        out[c * m:(c + 1) * m] = prod.to(dt)
        ag[c * m:(c + 1) * m] = rows

    put(me, dot_f32(a, b), a)
    a_r = a_l = a
    for s in range(1, kr + 1):
        nr = torch.empty_like(a)
        ops = [dist.P2POp(dist.isend, a_r, right, mesh.group),
               dist.P2POp(dist.irecv, nr, left, mesh.group)]
        if s <= kl:
            nl = torch.empty_like(a)
            ops += [dist.P2POp(dist.isend, a_l, left, mesh.group),
                    dist.P2POp(dist.irecv, nl, right, mesh.group)]
        for r in dist.batch_isend_irecv(ops):
            r.wait()
        a_r = nr
        if s <= kl:
            a_l = nl
            prod = dot_f32(torch.cat([a_r, a_l]), b)
            put((me - s) % n, prod[:m], a_r)
            put((me + s) % n, prod[m:], a_l)
        else:
            put((me - s) % n, dot_f32(a_r, b), a_r)
    return out, ag


def _ag_launch(mesh, a: torch.Tensor, b: torch.Tensor, bidir: bool,
               what: str):
    """Launch B10 (td_ag_gemm) or B11 (td_ag_gemm_bidir) of
    ``csrc/ag_gemm.cu`` on this rank's shard: checks, the K split (the
    same for both, so B11 computes B10's bits), this op's symmetric
    buffer, the outputs and the f32 K-slice workspace."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{what}: a {tuple(a.shape)} @ b "
                         f"{tuple(b.shape)}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"{what}: a/b must share one dtype of "
                         f"{list(_DTYPE_CODE)}; got {a.dtype}/{b.dtype}")
    a = a.contiguous()
    if not b.is_contiguous() or b.data_ptr() % 16 or a.data_ptr() % 16:
        raise ValueError(f"{what}: b contiguous, a/b 16-byte aligned")
    m, k = a.shape
    n_cols, world = b.shape[1], mesh.world
    vec = 16 // a.element_size()
    if n_cols % vec or k % vec:
        raise ValueError(f"{what}: K={k} and N={n_cols} must be "
                         f"multiples of {vec}")
    rows = world * m
    if bidir:
        # the gathered rows (2 parities) then one flag per (chunk, row
        # block); m flags per chunk cover any row block
        data = 2 * rows * k * a.element_size()
        flag_off = -(-data // _ALIGN) * _ALIGN
        ws = op_workspace(mesh, ("ag_gemm_bidir", m, k, a.dtype),
                          (flag_off + rows * 8,), torch.uint8)
    else:
        flag_off = 0
        ws = op_workspace(mesh, ("ag_gemm", m, k, a.dtype), (rows, k),
                          a.dtype)
    k_chunk, splits = split_plan(
        rows, k, n_cols, vec,
        torch.cuda.get_device_properties(a.device).multi_processor_count)
    out = torch.empty((rows, n_cols), dtype=a.dtype, device=a.device)
    ag = torch.empty((rows, k), dtype=a.dtype, device=a.device)
    part = (torch.empty((splits, rows, n_cols), dtype=torch.float32,
                        device=a.device) if splits > 1 else None)
    fn = build.function("ag_gemm", "td_ag_gemm_bidir" if bidir
                        else "td_ag_gemm", (
        *(ctypes.c_void_p,) * 5, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        *(ctypes.c_int,) * 7, ctypes.c_void_p))
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(),
                 part.data_ptr() if part is not None else None,
                 out.data_ptr(), ag.data_ptr(), mesh.rank, world,
                 ws.buf.table.data_ptr(),
                 flag_off if bidir else ws.buf.sig_off, ws.ctl.data_ptr(),
                 m, k, n_cols, k_chunk, splits, mesh.ranks_per_device,
                 _DTYPE_CODE[a.dtype], build.stream_of(a))
    build.check(err, what)
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
    out = _ag_launch(mesh, a, b, False, "pallas_ag_gemm")
    pallas_ag_gemm.launches += 1
    return out


pallas_ag_gemm.launches = 0


def pallas_ag_gemm_bidir(mesh, a: torch.Tensor, b: torch.Tensor):
    """B11 on this rank, world >= 3: (allgather(a) @ b, allgather(a)) over
    both ring directions, B10's bits. CUDA tensors launch the kernel
    (counted in ``pallas_ag_gemm_bidir.launches``); CPU tensors run
    ``ag_gemm_ref``. Every rank calls it with the same shapes, in the
    same order."""
    if a.device.type == "cpu":
        return ag_gemm_ref(mesh, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"pallas_ag_gemm_bidir: unsupported device "
                         f"{a.device}")
    if mesh.world < 3:
        raise ValueError(f"pallas_ag_gemm_bidir needs a world of at least "
                         f"3 (both ring directions); got {mesh.world}")
    out = _ag_launch(mesh, a, b, True, "pallas_ag_gemm_bidir")
    pallas_ag_gemm_bidir.launches += 1
    return out


pallas_ag_gemm_bidir.launches = 0


def ag_gemm_per_device(n: int, method: AgGemmMethod, a: torch.Tensor,
                       b: torch.Tensor, mesh=None):
    """The reference's per-device entry: this rank's (m, K) shard of A and
    (K, N_loc) shard of B -> (out (n*m, N_loc), gathered A). ``mesh``
    (the ranks' Mesh) is needed at n > 1."""
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
    if method == AgGemmMethod.XLA_BIDIR:
        return _bidir_ring_ag_gemm(mesh, a, b)
    if method == AgGemmMethod.PALLAS:
        return pallas_ag_gemm(mesh, a, b)
    if method == AgGemmMethod.PALLAS_BIDIR:
        if n <= 2:      # no second direction to use: B10, as the reference
            return pallas_ag_gemm(mesh, a, b)
        return pallas_ag_gemm_bidir(mesh, a, b)
    raise ValueError(f"unresolved method {method}")


def ag_gemm(ctx: AgGemmContext, a: torch.Tensor, b: torch.Tensor):
    """The mesh-level AllGather + GEMM (the reference's ``ag_gemm``),
    called by every rank: a (m, K) this rank's row shard, b (K, N_loc) its
    column shard -> (allgather(a) @ b (n*m, N_loc), allgather(a)), the
    method resolved by ``ctx.resolve_for``."""
    check_not_2d(ctx.dcn_axis, "ag_gemm")
    n = ctx.world
    method = ctx.resolve_for(a.shape[0] * n, a.shape[1], b.shape[1],
                             a.dtype)[0]
    return ag_gemm_per_device(n, method, a, b, mesh=ctx.mesh)
