"""All-reduce across ranks (the reference's kernels/allreduce.py).

Every rank holds x (M, K) and returns the sum over the ranks, accumulated
in x's dtype. Methods at world n > 1 (``mesh`` is the ranks' Mesh):

  * XLA — ``dist.all_reduce`` (NCCL on the card), the reference's psum;
  * ONE_SHOT — B5, ``one_shot_all_reduce``: the hand-written CUDA kernel
    ``csrc/allreduce.cu`` for CUDA tensors, ``one_shot_ref`` for CPU
    tensors. Every rank pushes x into a sender-indexed slot on every peer
    and adds its own term first, then the others in ascending rank, each
    add rounded to x's dtype: the reference's order, which depends on the
    rank, so float results may differ from rank to rank in the last bit.
    On the card it is B6's one-shot regime with this fold, one launch, LL
    lines or flags by the bytes of a slot (``one_shot_plan``);
  * RHD — B6, ``rhd_all_reduce``: the reference's recursive
    halving-doubling, whose value is the halving tree's fold of the n
    terms (``rhd_fold``; ``rhd_ref`` for CPU tensors), power-of-two n and
    M a multiple of n (anything else raises: the reference's per-device
    kernel would drop rows there). Every rank ends with the same bytes.
    On the card (the same kernel source) the tree is folded where the
    terms land, after one hop (small x) or after a one-hop reduce-scatter
    and before a one-hop all-gather (large x): ``rhd_plan``;
  * TWO_SHOT — the ring reduce-scatter B9 (kernels/reduce_scatter.py)
    then the ring all-gather B7 (kernels/allgather.py), composed as the
    reference composes them. n must divide M: anything else raises (the
    reference's per-device body fails there; its mesh-level demotion to
    ONE_SHOT comes with ``all_reduce_op``, A9 (tail)). Every rank ends
    with the same bytes;
  * QINT8_OS — B28, ``quant_wire.qint8_one_shot_per_device``: int8 on
    the wire, every term quantized once at its sender, folded in f32 in
    rank order: the same bytes on every rank (QuantContract "qint8_os");
  * QINT8_OS_STOCHASTIC — B28's plain twin with the dithered codec
    (``quant_wire.qint8_one_shot_reference_per_device``, "int8_stochastic":
    encode, the process group's all-gather of q and s, the same fold), as
    in the reference, whose kernel has no dither either;
  * QINT8 — the int8 ring (``qint8_ring_per_device``, the reference's
    ``_qint8_ring_per_device``, which has no Pallas kernel): a ring
    reduce-scatter that requantizes the running f32 partial at every hop,
    then a ring all-gather of each reduced chunk quantized once by its
    reducer, every hop a ``batch_isend_irecv`` to the right neighbour
    (NCCL on the card, gloo on the CPU) and every hop's encode B27 on CUDA
    tensors (``quant_wire.quantize_stage_per_device``). The same bytes on
    every rank. n must divide M: anything else raises, as TWO_SHOT;
  * AUTO is resolved above the per-device level ("unresolved method"), as
    in the reference.

At world 1 the all-reduce is the identity: every method returns x. No
fallback: a CUDA call a kernel does not take raises. The mesh-level
``all_reduce_op`` (with its TWO_SHOT demotion and an AUTO rule measured
on the card) waits for ROADMAP A9 (tail), its fault preamble for A8.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum
import functools

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels.plain import (
    all_gather_list, one_shot_fold, rhd_fold,
)
from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.symm import op_workspace

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_BYTES = 8192     # bytes of x each block of the grid aims to own
_ALIGN = 256


class AllReduceMethod(enum.Enum):
    AUTO = "auto"
    XLA = "xla"
    ONE_SHOT = "one_shot"
    TWO_SHOT = "two_shot"
    RHD = "rhd"
    QINT8 = "qint8"
    QINT8_OS = "qint8_os"
    QINT8_OS_STOCHASTIC = "qint8_os_stochastic"


def one_shot_ref(mesh, x: torch.Tensor) -> torch.Tensor:
    """Plain version of B5 over the process group: every rank's x, folded
    own first, then the others in ascending rank, in x's dtype."""
    return one_shot_fold(all_gather_list(mesh, x), mesh.rank)


def rhd_ref(mesh, x: torch.Tensor) -> torch.Tensor:
    """Plain version of B6 over the process group: every rank's x, folded
    along the halving tree in x's dtype."""
    check_rhd(mesh.world, x)
    return rhd_fold(all_gather_list(mesh, x))


def one_shot_ref_shards(xs) -> list[torch.Tensor]:
    """Plain version of B5 over every rank's x in one process (the
    one-card world): the ranks' outputs in rank order."""
    return [one_shot_fold(xs, r) for r in range(len(xs))]


def rhd_ref_shards(xs) -> list[torch.Tensor]:
    """Plain version of B6 over every rank's x in one process: one value,
    the same for every rank."""
    out = rhd_fold(xs)
    return [out] * len(xs)


def check_rhd(n: int, x: torch.Tensor) -> None:
    if n & (n - 1):
        raise ValueError(f"all_reduce RHD needs a power-of-two world; got "
                         f"{n}")
    if x.shape[0] % n:
        raise ValueError(f"all_reduce RHD needs M={x.shape[0]} divisible by "
                         f"the world {n}")


def check_two_shot(n: int, x: torch.Tensor, name: str = "TWO_SHOT") -> None:
    """The rings' shape rule (TWO_SHOT, QINT8): 2-D x, M divisible by n."""
    if x.ndim != 2 or x.shape[0] % n:
        raise ValueError(f"all_reduce {name} needs 2-D x with M divisible "
                         f"by the world {n} (the ring reduce-scatter hands "
                         f"each rank M/n rows); got {tuple(x.shape)}")


def _ring_hop(mesh, q: torch.Tensor, s: torch.Tensor):
    """One hop of the int8 ring: send (q, s) to the right neighbour and
    receive the left neighbour's (one ``batch_isend_irecv``, every request
    waited on)."""
    n, me, grp = mesh.world, mesh.rank, mesh.group
    right = dist.get_global_rank(grp, (me + 1) % n)
    left = dist.get_global_rank(grp, (me - 1) % n)
    rq, rs = torch.empty_like(q), torch.empty_like(s)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, q, right, grp),
            dist.P2POp(dist.isend, s, right, grp),
            dist.P2POp(dist.irecv, rq, left, grp),
            dist.P2POp(dist.irecv, rs, left, grp)]):
        req.wait()
    return rq, rs


def qint8_ring_per_device(mesh, x: torch.Tensor) -> torch.Tensor:
    """The int8 ring all-reduce on this rank (the reference's
    ``_qint8_ring_per_device``): x (M, K) -> the sum over the ranks in x's
    dtype, the same bytes on every rank. Rows cut into n chunks of f32;
    reduce-scatter: the partial starts as chunk me and at hop s travels
    right as (q, scale) and lands as q * scale + chunk (me - s - 1);
    all-gather: the reduced chunk (me + 1) quantized once, then passed on
    n - 1 hops, chunk (me - s) landing at hop s. Each encode is B27
    (``quantize_stage_per_device``); the product and the sum are separate
    ops, as in the reference."""
    from triton_dist_tpu_torch.kernels.quant_wire import (
        quantize_stage_per_device,
    )
    n, me = mesh.world, mesh.rank
    check_two_shot(n, x, "QINT8")
    rows, d = x.shape
    chunks = x.float().reshape(n, rows // n, d)
    cur = chunks[me]
    for s in range(n - 1):
        q, sc = _ring_hop(mesh, *quantize_stage_per_device(cur))
        cur = q.float() * sc + chunks[(me - s - 1) % n]
    q, sc = quantize_stage_per_device(cur)
    out = torch.empty((n, rows // n, d), dtype=torch.float32,
                      device=x.device)
    out[(me + 1) % n] = q.float() * sc
    for s in range(n - 1):
        q, sc = _ring_hop(mesh, q, sc)
        out[(me - s) % n] = q.float() * sc
    return out.reshape(rows, d).to(x.dtype)


def _round_up(x: int, a: int = _ALIGN) -> int:
    return -(-x // a) * a


def grid_blocks(m: int, kv: int, sm_count: int, ranks_per_device: int) -> int:
    """Blocks of B8 (kernels/allgather.py) for an (m, kv-vector) shard:
    about _BLOCK_BYTES of it each, at most one column vector wide each,
    and few enough that every rank sharing the card is resident at once
    (one block per SM)."""
    want = -(-m * kv * 16 // _BLOCK_BYTES)
    return max(1, min(want, kv, sm_count // ranks_per_device))


# B6's regimes: one-shot (every rank's whole x into every peer, the tree
# folded locally: one signal latency, (n - 1) x on the wire a rank) while
# x holds at most this many bytes, two-shot above (a one-hop
# reduce-scatter whose owners fold the tree, then a one-hop all-gather of
# the folded chunks: one more signal latency, 2 (n - 1) / n x on the
# wire). The protocol of either (LL lines or flags) follows the bytes of a
# slot as B9 / B7's (reduce_scatter.LL_MAX_SLOT_BYTES). Four H100s
# (chip_smoke.py tp4_ring's rhd_sweep, rows of 5120 bf16, the slowest
# rank): one-shot 0.0072 / 0.0084 / 0.0103 / 0.0124 ms at 4 / 8 / 16 / 32
# rows (40-320 KiB) against two-shot's best 0.0099 / 0.0102 / 0.0115 /
# 0.0134; at 64 rows (640 KiB) two-shot 0.0175-0.0182 against 0.0197,
# and the gap grows with the rows (512: 0.0502 against 0.0852).
RHD_ONE_SHOT_MAX_BYTES = 320 * 1024


@dataclasses.dataclass(frozen=True)
class RhdPlan:
    """What a launch of B6 passes besides its tensors, the same on every
    rank of a world. two_shot: the regime; m: rows a slot (M / n
    two-shot, M one-shot); kv: 16-byte vectors a row; grid: blocks, block
    b owning vectors [b kv / grid, (b + 1) kv / grid) of every row; ll: LL
    lines or flags. The first region (B9 / B7's ``ring_layout``: slot j of
    parity P at byte (P (n - 1) + j) slot_bytes, rank r's rows for rank p
    in p's slot (r - p - 1) mod n) from byte 0, its flags (grid, n - 1)
    u64 at flag_off; two-shot: the second region (the folded chunks, the
    same layout) from byte ag_off, its flags at ag_flag_off. nbytes: the
    buffer's size."""
    two_shot: bool
    m: int
    kv: int
    grid: int
    ll: bool
    slot_bytes: int
    flag_off: int
    ag_off: int
    ag_flag_off: int
    nbytes: int


def rhd_layout(world: int, rows: int, kv: int, grid: int, ll: bool,
               two_shot: bool) -> RhdPlan:
    """The plan of B6 for x of ``rows`` rows of kv vectors on ``grid``
    blocks under the protocol ``ll`` and the regime ``two_shot``."""
    from triton_dist_tpu_torch.kernels.reduce_scatter import ring_layout
    m = rows // world if two_shot else rows
    first = ring_layout(world, m, kv, grid, ll)
    if not two_shot:
        return RhdPlan(False, m, kv, grid, ll, first.slot_bytes,
                       first.flag_off, 0, 0, max(first.nbytes, _ALIGN))
    ag_off = _round_up(first.nbytes)
    return RhdPlan(True, m, kv, grid, ll, first.slot_bytes, first.flag_off,
                   ag_off, ag_off + first.flag_off,
                   max(ag_off + first.nbytes, _ALIGN))


@functools.lru_cache(maxsize=None)
def rhd_plan(world: int, rows: int, k: int, itemsize: int, sm_count: int,
             ranks_per_device: int) -> RhdPlan:
    """The plan of B6 for x (rows, K): the regime by x's bytes
    (RHD_ONE_SHOT_MAX_BYTES), the grid as B9 / B7's (a vector a thread a
    slot, at most one block an SM per rank that shares the card and one a
    column vector), the protocol by a slot's bytes (LL_MAX_SLOT_BYTES)."""
    from triton_dist_tpu_torch.kernels.reduce_scatter import (
        LL_MAX_SLOT_BYTES,
    )
    kv = k * itemsize // 16
    two_shot = rows * kv * 16 > RHD_ONE_SHOT_MAX_BYTES
    m = rows // world if two_shot else rows
    return rhd_layout(world, rows, kv,
                      rhd_grid(m, kv, sm_count, ranks_per_device),
                      m * kv * 16 <= LL_MAX_SLOT_BYTES, two_shot)


def rhd_grid(m: int, kv: int, sm_count: int, ranks_per_device: int) -> int:
    """B6's blocks for slots of m rows of kv vectors: B9 / B7's grid."""
    from triton_dist_tpu_torch.kernels.reduce_scatter import _NT
    return max(1, min(kv, -(-m * kv // _NT), sm_count // ranks_per_device))


# B5's protocol: LL lines (the epoch in every 16-byte line, no fence, no
# flag, twice the bytes) while a slot (one rank's whole x) holds at most
# this many bytes, flags above. Four H100s (NVIDIA H100 80GB HBM3, 700.00
# W; chip_compare.py --ar --sweep, the slowest rank, rows of 5,120 bf16),
# LL against flags at 4 / 8 / 16 / 32 / 64 rows (40-640 KiB a slot),
# queued: 0.0076 / 0.0090 / 0.0111 / 0.0162 / 0.0319 ms against 0.0095 /
# 0.0100 / 0.0109 / 0.0128 / 0.0207 (in a graph at 16 rows 0.0118
# against 0.0116): LL up to 8 rows, flags from 16.
ONE_SHOT_LL_MAX_SLOT_BYTES = 128 * 1024


@functools.lru_cache(maxsize=None)
def one_shot_plan(world: int, rows: int, k: int, itemsize: int,
                  sm_count: int, ranks_per_device: int) -> RhdPlan:
    """The plan of B5 for x (rows, K): B6's one-shot regime (every rank's
    whole x into its slot of every peer) on B6's grid, LL lines while a
    slot holds at most ONE_SHOT_LL_MAX_SLOT_BYTES, flags above."""
    kv = k * itemsize // 16
    return rhd_layout(world, rows, kv,
                      rhd_grid(rows, kv, sm_count, ranks_per_device),
                      rows * kv * 16 <= ONE_SHOT_LL_MAX_SLOT_BYTES, False)


def _check_x(what: str, x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: dtype {x.dtype} not in "
                         f"{list(_DTYPE_CODE)}")
    if x.ndim != 2 or not x.is_contiguous() or x.data_ptr() % 16 or \
            (x.shape[1] * x.element_size()) % 16 or x.numel() == 0:
        raise ValueError(f"{what}: x must be a non-empty contiguous 2-D "
                         "tensor, 16-byte aligned, rows a multiple of 16 "
                         f"bytes; got {tuple(x.shape)}")


def _launch(mesh, x: torch.Tensor, plan: RhdPlan, tree: bool):
    """B6's (tree) or B5's launch on this rank's x under a given plan. The
    plan's symmetric buffer is made at its first call (a collective
    allocation; never under capture), with a control block of an epoch
    word a block."""
    what = "rhd_all_reduce" if tree else "one_shot_all_reduce"
    ws = op_workspace(mesh, ("rhd" if tree else "one_shot", x.dtype, plan),
                      (plan.nbytes,), torch.uint8, ctl_words=plan.grid)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        fn = build.function("allreduce", "td_all_reduce", (
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, *(ctypes.c_int,) * 6, ctypes.c_void_p))
        err = fn(x.data_ptr(), out.data_ptr(), mesh.rank, mesh.world,
                 ws.buf.table.data_ptr(), ws.ctl.data_ptr(), plan.m, plan.kv,
                 plan.slot_bytes, plan.flag_off, plan.ag_off,
                 plan.ag_flag_off, plan.grid, int(plan.ll),
                 int(plan.two_shot), int(tree), mesh.ranks_per_device,
                 _DTYPE_CODE[x.dtype], build.stream_of(x))
    build.check(err, what)
    return out


def _launch_rhd(mesh, x: torch.Tensor, plan: RhdPlan) -> torch.Tensor:
    """B6's launch under a given plan (chip_smoke.py's regime sweep forces
    one through ``rhd_layout``)."""
    return _launch(mesh, x, plan, True)


def _launch_one_shot(mesh, x: torch.Tensor, plan: RhdPlan) -> torch.Tensor:
    """B5's launch under a given plan (the protocol sweep forces one
    through ``rhd_layout`` with two_shot False)."""
    return _launch(mesh, x, plan, False)


def one_shot_all_reduce(mesh, x: torch.Tensor) -> torch.Tensor:
    """B5 on this rank: the sum over the ranks of x (M, K), own term
    first, then the others ascending, in x's dtype; a fresh tensor. CUDA
    tensors launch the kernel (counted in ``one_shot_all_reduce.launches``);
    CPU tensors run ``one_shot_ref``. Every rank calls it with the same
    shape, in the same order."""
    if x.device.type == "cpu":
        return one_shot_ref(mesh, x)
    if x.device.type != "cuda":
        raise ValueError(f"one_shot_all_reduce: unsupported device "
                         f"{x.device}")
    _check_x("one_shot_all_reduce", x)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = one_shot_plan(mesh.world, x.shape[0], x.shape[1],
                         x.element_size(), sms, mesh.ranks_per_device)
    out = _launch_one_shot(mesh, x, plan)
    one_shot_all_reduce.launches += 1
    return out


one_shot_all_reduce.launches = 0


def rhd_all_reduce(mesh, x: torch.Tensor) -> torch.Tensor:
    """B6 on this rank: the sum over the ranks of x (M, K) folded along
    the halving tree (recursive halving-doubling's value), in x's dtype; a
    fresh tensor, the same bytes on every rank. CUDA tensors launch the
    kernel under ``rhd_plan`` (counted in ``rhd_all_reduce.launches``);
    CPU tensors run ``rhd_ref``."""
    if x.device.type == "cpu":
        return rhd_ref(mesh, x)
    if x.device.type != "cuda":
        raise ValueError(f"rhd_all_reduce: unsupported device {x.device}")
    _check_x("rhd_all_reduce", x)
    check_rhd(mesh.world, x)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = rhd_plan(mesh.world, x.shape[0], x.shape[1], x.element_size(),
                    sms, mesh.ranks_per_device)
    out = _launch_rhd(mesh, x, plan)
    rhd_all_reduce.launches += 1
    return out


rhd_all_reduce.launches = 0


def all_reduce_per_device(n: int, method: AllReduceMethod, x: torch.Tensor,
                          mesh=None) -> torch.Tensor:
    """The reference's per-device entry: this rank's x (M, K) -> the sum
    over the n ranks. ``mesh`` (the ranks' Mesh) is needed at n > 1."""
    if method == AllReduceMethod.AUTO:
        raise ValueError(f"unresolved method {method}")
    if n == 1:
        return x
    if method == AllReduceMethod.RHD:
        check_rhd(n, x)
    if method in (AllReduceMethod.TWO_SHOT, AllReduceMethod.QINT8):
        check_two_shot(n, x, method.name)
    if mesh is None or mesh.world != n:
        raise ValueError(f"all_reduce at world {n} needs the mesh of its {n} "
                         f"ranks; got {mesh}")
    if method == AllReduceMethod.XLA:
        out = x.clone()
        dist.all_reduce(out, group=mesh.group)
        return out
    if method == AllReduceMethod.ONE_SHOT:
        return one_shot_all_reduce(mesh, x)
    if method == AllReduceMethod.RHD:
        return rhd_all_reduce(mesh, x)
    if method == AllReduceMethod.QINT8_OS:
        from triton_dist_tpu_torch.kernels.quant_wire import (
            qint8_one_shot_per_device,
        )
        return qint8_one_shot_per_device(mesh, x)
    if method == AllReduceMethod.QINT8_OS_STOCHASTIC:
        from triton_dist_tpu_torch.kernels.quant_wire import (
            qint8_one_shot_reference_per_device,
        )
        return qint8_one_shot_reference_per_device(mesh, x,
                                                   "int8_stochastic")
    if method == AllReduceMethod.QINT8:
        return qint8_ring_per_device(mesh, x)
    if method == AllReduceMethod.TWO_SHOT:
        from triton_dist_tpu_torch.kernels.allgather import ring_all_gather
        from triton_dist_tpu_torch.kernels.reduce_scatter import (
            ring_reduce_scatter, ring_workspace,
        )
        if x.is_cuda:
            # B7's buffer is made before B9 spins: an allocation behind a
            # spinning kernel can wait for ranks that share the card
            ring_workspace("ring_ag", mesh, x.shape[0] // n, x.shape[1],
                           x.dtype)
        return ring_all_gather(mesh, ring_reduce_scatter(mesh, x))
    raise ValueError(f"unresolved method {method}")
