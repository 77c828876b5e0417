"""Symmetric memory (the reference's runtime/symm.py): a buffer of the same
shape on every rank, which every rank's kernels can address.

On the card a symmetric buffer is one allocation per rank, ``cudaMalloc``'d
by the port's own library (``csrc/td_dist.cu``), with a signal pad of
64-bit flags right after the data. The ranks exchange CUDA IPC handles of
their allocations over the process group and open each other's, so every
rank holds the base address of every rank's buffer; kernels get that table
as a device array of pointers (``SymmTensor.table``) and store into a peer
through NVLink. The port takes this route rather than
``torch.distributed._symmetric_memory``: it needs nothing from a private
torch module, the same plain C interface as every kernel of the port, and
the same table serves the one-card world below.

``OneCardWorld`` has the same interface for n logical ranks on ONE card:
their buffers are n separate allocations of that card, and each rank's
table points at all of them. Its ranks' kernels run side by side on
separate streams, so the kernels of the tensor-parallel path can be held
to their plain versions on a machine with one card. No path of the port
runs on it; ``chip_smoke.py`` does.

On the CPU a symmetric buffer is a plain tensor (``SymmTensor.table`` is
None): the plain versions of the ops move data with torch.distributed.

Allocations are collective: every rank makes the same sequence of them.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.runtime import build
from triton_dist_tpu_torch.runtime.device import resolve_device
from triton_dist_tpu_torch.runtime.mesh import Mesh

PAD_WORDS = 64                 # flags per signal pad (td_dist.cuh kPadWords)
PAD_BYTES = 8 * PAD_WORDS
CTL_HEADER = 4                 # control-block words before op counters
_ALIGN = 256


def _fn(symbol, argtypes):
    return build.function("td_dist", symbol, argtypes)


_P = ctypes.c_void_p


def _malloc(nbytes: int) -> int:
    out = _P()
    build.check(_fn("td_malloc", (ctypes.c_long, ctypes.POINTER(_P)))(
        nbytes, ctypes.byref(out)), "td_malloc")
    return out.value


def _ipc_handle(ptr: int) -> bytes:
    buf = ctypes.create_string_buffer(64)
    build.check(_fn("td_ipc_handle", (_P, _P))(
        ptr, ctypes.cast(buf, _P)), "td_ipc_handle")
    return buf.raw


def _ipc_open(handle: bytes) -> int:
    out = _P()
    build.check(_fn("td_ipc_open", (ctypes.c_char_p, ctypes.POINTER(_P)))(
        handle, ctypes.byref(out)), "td_ipc_open")
    return out.value


class _DeviceBytes:
    """A raw device allocation seen through __cuda_array_interface__, so
    torch can alias it without a copy."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 3, "strides": None}


def _alias(ptr: int, nbytes: int, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(_DeviceBytes(ptr, nbytes), device=device)
    if t.data_ptr() != ptr:
        raise RuntimeError("symmetric buffer: torch copied the allocation "
                           "instead of aliasing it")
    return t


@dataclasses.dataclass(eq=False)
class SymmTensor:
    """One rank's handle on a symmetric buffer.

    tensor: this rank's data, ``local_shape`` of ``dtype``; table: int64
    device array of every rank's allocation base (None on the CPU);
    sig_off: byte offset of the signal pad in each allocation."""
    tensor: torch.Tensor
    table: torch.Tensor | None
    sig_off: int
    rank: int
    world: int


def _round_up(x: int, a: int) -> int:
    return -(-x // a) * a


def _view(ptr, nbytes, local_shape, dtype, device):
    """(this rank's data as a tensor, the signal pad's byte offset)."""
    sig_off = _round_up(max(nbytes, 1), _ALIGN)
    raw = _alias(ptr, sig_off + PAD_BYTES, device)
    return raw[:nbytes].view(dtype).view(local_shape), sig_off


def _nbytes(local_shape, dtype) -> int:
    n = 1
    for s in local_shape:
        n *= int(s)
    return n * torch.empty((), dtype=dtype).element_size()


def _alloc_process_world(mesh: Mesh, local_shape, dtype) -> SymmTensor:
    nbytes = _nbytes(local_shape, dtype)
    total = _round_up(max(nbytes, 1), _ALIGN) + PAD_BYTES
    with torch.cuda.device(mesh.device):
        ptr = _malloc(total)
        data, sig_off = _view(ptr, nbytes, local_shape, dtype, mesh.device)
        if mesh.world == 1:
            bases = [ptr]
        else:
            handles = [None] * mesh.world
            dist.all_gather_object(handles, _ipc_handle(ptr),
                                   group=mesh.group)
            bases = [ptr if r == mesh.rank else _ipc_open(h)
                     for r, h in enumerate(handles)]
    table = torch.tensor(bases, dtype=torch.int64, device=mesh.device)
    return SymmTensor(data, table, sig_off, mesh.rank, mesh.world)


def symm_zeros(mesh, local_shape, dtype=torch.float32) -> SymmTensor:
    """A zeroed symmetric buffer: every rank owns ``local_shape``.
    Collective: every rank of the mesh calls it, in the same order."""
    local_shape = tuple(int(s) for s in local_shape)
    if isinstance(mesh, _LogicalRank):
        return mesh.world_obj._take(mesh.rank, local_shape, dtype)
    if mesh.device.type == "cpu":
        return SymmTensor(torch.zeros(local_shape, dtype=dtype), None, 0,
                          mesh.rank, mesh.world)
    return _alloc_process_world(mesh, local_shape, dtype)


def symm_full(mesh, local_shape, fill, dtype=torch.float32) -> SymmTensor:
    buf = symm_zeros(mesh, local_shape, dtype)
    buf.tensor.fill_(fill)
    if buf.table is not None:
        torch.cuda.current_stream(buf.tensor.device).synchronize()
    return buf


@dataclasses.dataclass(eq=False)
class SymmetricWorkspace:
    """A named bundle of symmetric buffers owned by one op context (the
    reference's per-op workspaces)."""
    mesh: object
    axis: str = "tp"
    buffers: dict = dataclasses.field(default_factory=dict)

    def alloc(self, name: str, local_shape, dtype=torch.float32):
        buf = symm_zeros(self.mesh, local_shape, dtype)
        self.buffers[name] = buf
        return buf

    def __getitem__(self, name: str) -> SymmTensor:
        return self.buffers[name]

    def finalize(self) -> None:
        """Drop the references (the allocations stay mapped until the
        process ends: a peer may still hold this rank's mapping)."""
        self.buffers.clear()


@dataclasses.dataclass(eq=False)
class OpWorkspace:
    """What one overlapped op keeps across calls on one rank: its
    symmetric buffer and its local control block (int64 words: the epoch
    of the last finished call, the grid's counters, op counters)."""
    buf: SymmTensor
    ctl: torch.Tensor


def op_workspace(mesh, key, local_shape, dtype, ctl_words: int = 0):
    """The cached workspace of op ``key`` on ``mesh``, made on first use
    (a collective allocation: every rank's first call of ``key`` comes in
    the same order). Never made under CUDA-graph capture: the warm-up
    call before a capture makes it."""
    ws = mesh.workspaces.get(key)
    if ws is None:
        if (mesh.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(f"{key}: first call under CUDA-graph "
                               "capture; warm up before capturing")
        buf = symm_zeros(mesh, local_shape, dtype)
        ctl = torch.zeros((CTL_HEADER + ctl_words,), dtype=torch.int64,
                          device=mesh.device)
        ws = mesh.workspaces[key] = OpWorkspace(buf, ctl)
    return ws


@dataclasses.dataclass(eq=False)
class _LogicalRank(Mesh):
    """Rank ``rank`` of a OneCardWorld (a Mesh without a process group)."""
    world_obj: object = None

    @property
    def ranks_per_device(self) -> int:
        return self.world


class OneCardWorld:
    """n logical ranks on one card, with the symmetric-buffer interface of
    a world of n cards: ``mesh(r)`` is rank r's mesh, and the i-th
    ``symm_zeros`` of each rank returns that rank's handle on the i-th
    allocation (n separate allocations of the card, made at the first
    rank's call, each rank's table pointing at all n). Kernels of its
    ranks must run concurrently, one stream per rank (``streams``)."""

    def __init__(self, world: int, device="cuda"):
        self.world = world
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError("the one-card world is a world on a card")
        self._ranks = [_LogicalRank(None, "tp", r, world, self.device,
                                    world_obj=self) for r in range(world)]
        self._allocs: list[list[SymmTensor]] = []
        self._taken = [0] * world
        self.streams = [torch.cuda.Stream(self.device) for _ in range(world)]

    def mesh(self, rank: int) -> Mesh:
        return self._ranks[rank]

    def _take(self, rank: int, local_shape, dtype) -> SymmTensor:
        i = self._taken[rank]
        if i == len(self._allocs):
            nbytes = _nbytes(local_shape, dtype)
            total = _round_up(max(nbytes, 1), _ALIGN) + PAD_BYTES
            with torch.cuda.device(self.device):
                ptrs = [_malloc(total) for _ in range(self.world)]
            table = torch.tensor(ptrs, dtype=torch.int64, device=self.device)
            bufs = []
            for r, ptr in enumerate(ptrs):
                data, sig_off = _view(ptr, nbytes, local_shape, dtype,
                                      self.device)
                bufs.append(SymmTensor(data, table, sig_off, r, self.world))
            self._allocs.append(bufs)
        buf = self._allocs[i][rank]
        if tuple(buf.tensor.shape) != local_shape or buf.tensor.dtype != dtype:
            raise RuntimeError(
                f"one-card world: rank {rank}'s allocation {i} is "
                f"{tuple(buf.tensor.shape)} {buf.tensor.dtype}, rank 0's "
                f"was {local_shape} {dtype}: ranks allocate in one order")
        self._taken[rank] = i + 1
        return buf

    def run(self, fn):
        """[fn(r) for every rank r], each on its rank's stream (all
        enqueued before any is waited on); the current stream waits for
        all of them."""
        cur = torch.cuda.current_stream(self.device)
        outs = []
        for r, s in enumerate(self.streams):
            s.wait_stream(cur)
            with torch.cuda.stream(s):
                outs.append(fn(r))
        for s in self.streams:
            cur.wait_stream(s)
        return outs
