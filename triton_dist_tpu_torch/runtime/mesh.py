"""Process groups: the port's counterpart of the reference's runtime/mesh.py.

One process per card: rank r of a world of n runs on ``cuda:r`` (NCCL), or
on the CPU (gloo) when the caller asks for it. The reference's named
device mesh becomes a small ``Mesh`` object: the process group, the axis
name, this process's rank and the world size. Nothing here discovers a
cluster on its own: the caller gives the rendezvous (``init_method``: a
``tcp://localhost:<port>`` address or a ``file://`` store), the world size
and the rank, or sets the usual ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
``WORLD_SIZE`` variables.

Without ``initialize_distributed`` the mesh is world 1 on one device, with
no process group, which is what every single-card path of the port runs.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Sequence

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.runtime.device import resolve_device

TP_AXIS = "tp"   # tensor parallel

_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(eq=False)
class Mesh:
    """One axis of ranks: the process group (None at world 1), the axis
    name, this process's rank on it, the world size and this rank's
    device. ``workspaces`` caches the symmetric buffers of the ops that run
    on this mesh (runtime/symm.py), keyed by op and shape."""
    group: object
    axis: str
    rank: int
    world: int
    device: torch.device
    workspaces: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def ranks_per_device(self) -> int:
        """Ranks of this mesh that share one card: 1 (one process per
        card). The one-card world (runtime/symm.py) has n."""
        return 1


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           device: str = "cuda",
                           seed: int | None = None) -> None:
    """Join the process group: NCCL for ``device="cuda"`` (rank r on
    cuda:r, which becomes the current device), gloo for ``"cpu"``. The
    rendezvous, world size and rank come from the arguments, else from
    MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK. Safe to call again
    once joined. ``seed`` seeds torch's default generators with seed +
    rank."""
    if dist.is_initialized():
        return
    world_size = int(world_size if world_size is not None
                     else os.environ.get("WORLD_SIZE", "1"))
    rank = int(rank if rank is not None else os.environ.get("RANK", "0"))
    if init_method is None:
        init_method = "env://"
    dev = torch.device(device)
    if dev.type == "cuda":
        resolve_device("cuda")
        if torch.cuda.device_count() < world_size:
            raise RuntimeError(
                f"world {world_size} needs one card per rank; "
                f"{torch.cuda.device_count()} present")
        torch.cuda.set_device(rank)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device={device!r}: want 'cuda' or 'cpu'")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=_TIMEOUT)
    if seed is not None:
        torch.manual_seed(seed + rank)


def finalize_distributed() -> None:
    """Leave the process group (a barrier first, so no rank tears down
    buffers a peer still maps)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def make_comm_mesh(axes: Sequence[tuple[str, int]] | None = None,
                   axis: str = TP_AXIS, device: str = "cuda") -> Mesh:
    """The mesh over the default process group, axis ``axis``; world 1 on
    ``device`` when no group was joined (the current card unless the
    caller asks for the CPU; without a card that raises). ``axes`` may
    name one axis of the whole world; meshes of more axes (the
    reference's dp x tp layouts, split_axis) wait for ROADMAP A1's
    remainder."""
    if axes is not None:
        if len(axes) != 1:
            raise NotImplementedError(
                f"a mesh of {len(axes)} axes waits for ROADMAP A1 "
                "(multi-axis meshes, split_axis)")
        (axis, size), = axes
    else:
        size = None
    if not dist.is_initialized():
        if size not in (None, 1):
            raise ValueError(f"mesh axis {axis}={size} but no process group "
                             "was joined (initialize_distributed)")
        return Mesh(None, axis, 0, 1, resolve_device(device))
    group = dist.group.WORLD
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if size not in (None, world):
        raise ValueError(f"mesh axis {axis}={size} does not cover the "
                         f"{world} ranks of the group")
    if dist.get_backend(group) == "nccl":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    return Mesh(group, axis, rank, world, dev)


def comm_axis_size(mesh: Mesh, axis: str) -> int:
    if axis != mesh.axis:
        raise ValueError(f"mesh has axis {mesh.axis!r}, not {axis!r}")
    return mesh.world
