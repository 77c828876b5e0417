"""The port's host C++ (``csrc/host/*.cc``), built with g++ and loaded
with ctypes: the native schedule provider's block-aligned expert sort
(``moe_utils.cc``) and AllGather + MoE tile order (``tile_swizzle.cc``).

The library builds at first use into the git-ignored ``csrc/build/``
(``libtd_host-<hash>.so``), keyed by a hash of the sources and the flags,
so an edited source rebuilds; it is written to a temporary name and moved
into place, so processes that build at once do not clash. Numpy in, numpy
out; nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from triton_dist_tpu_torch.runtime.build import BUILD_DIR, CSRC

HOST_SRC = CSRC / "host"
GXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")


def sources() -> list[Path]:
    """Every ``csrc/host/*.cc`` of the port."""
    return sorted(HOST_SRC.glob("*.cc"))


def library_path() -> Path:
    """Where the host sources build to."""
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libtd_host-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native schedule provider "
                           "builds the port's host C++ at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp),
                          *map(str, sources())], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"host library build failed:\n{res.stderr}")
    os.replace(tmp, out)


@functools.cache
def load_native() -> ctypes.CDLL:
    """The loaded host library (built first if missing), its C functions'
    argument types declared."""
    path = library_path()
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.td_expert_histogram.argtypes = [i32p, ctypes.c_int64,
                                        ctypes.c_int32, i32p]
    lib.td_expert_histogram.restype = ctypes.c_int
    lib.td_moe_align_block_size.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i32p, i32p,
        i32p]
    lib.td_moe_align_block_size.restype = ctypes.c_int
    lib.td_ag_moe_tile_count.argtypes = [i32p, ctypes.c_int32,
                                         ctypes.c_int32, ctypes.c_int32]
    lib.td_ag_moe_tile_count.restype = ctypes.c_int64
    lib.td_ag_moe_tile_schedule.argtypes = [
        i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p]
    lib.td_ag_moe_tile_schedule.restype = ctypes.c_int64
    return lib


def _i32(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr, dtype=np.int32))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def expert_histogram(expert_ids, num_experts: int) -> np.ndarray:
    """Per-expert counts of a flat expert-id array."""
    lib = load_native()
    flat = _i32(expert_ids).reshape(-1)
    counts = np.zeros(num_experts, np.int32)
    if lib.td_expert_histogram(_ptr(flat), flat.size, num_experts,
                               _ptr(counts)) != 0:
        raise ValueError("td_expert_histogram failed")
    return counts


def moe_align_block_size(topk_ids, num_experts: int, block: int):
    """Block-aligned stable expert sort: (sorted_token_ids,
    block_expert_ids, num_tokens_post_pad); pad slots hold the sentinel
    len(topk_ids)."""
    lib = load_native()
    flat = _i32(topk_ids).reshape(-1)
    cap = flat.size + num_experts * (block - 1)
    sorted_ids = np.empty(cap, np.int32)
    block_experts = np.empty(max(cap // block, 1), np.int32)
    post_pad = np.zeros(1, np.int32)
    if lib.td_moe_align_block_size(
            _ptr(flat), flat.size, num_experts, block, _ptr(sorted_ids),
            _ptr(block_experts), _ptr(post_pad)) != 0:
        raise ValueError("td_moe_align_block_size failed")
    total = int(post_pad[0])
    return sorted_ids[:total], block_experts[:total // block], total


def ag_moe_tile_schedule(counts, n_ranks: int, num_experts: int,
                         block_m: int, rank: int):
    """The rank-rotated AllGather + MoE tile order: (stage, expert,
    row_off) arrays."""
    lib = load_native()
    c = _i32(counts).reshape(-1)
    if c.size != n_ranks * num_experts:
        raise ValueError(f"counts size {c.size} != {n_ranks}x{num_experts}")
    total = lib.td_ag_moe_tile_count(_ptr(c), n_ranks, num_experts, block_m)
    if total < 0:
        raise ValueError("td_ag_moe_tile_count failed")
    stage = np.empty(total, np.int32)
    expert = np.empty(total, np.int32)
    row = np.empty(total, np.int32)
    wrote = lib.td_ag_moe_tile_schedule(
        _ptr(c), n_ranks, num_experts, block_m, rank, _ptr(stage),
        _ptr(expert), _ptr(row))
    if wrote != total:
        raise ValueError(f"schedule wrote {wrote} != {total}")
    return stage, expert, row
