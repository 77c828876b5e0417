"""An emulation of the one-hop collectives' slots on the CPU, shared by
``test_torch_ring_plan.py`` (B9, B7), ``test_torch_rhd_plan.py`` (B6),
``test_torch_gemm_rs_bidir_plan.py`` (B13b) and ``test_torch_ll_a2a_plan.py``
(B17, B18):
rows as 16-byte vectors, stored into a rank's buffer as the kernels of
``csrc/td_oneshot.cuh`` store them (plain vectors, or LL lines that carry
the epoch), and read back as a receiver reads them.
"""

from __future__ import annotations

import numpy as np
import torch


def cols(plan):
    """Each block's (first vector, count) of a row (the kernel's Cols)."""
    kv, grid = plan.kv, plan.grid
    return [(b * kv // grid, (b + 1) * kv // grid - b * kv // grid)
            for b in range(grid)]


def slot(plan, par, j, n):
    """Byte offset of slot j of parity par in a region of slots (the
    kernel's par + j slot_bytes, par = (e & 1) (n - 1) slot_bytes)."""
    return (par * (n - 1) + j) * plan.slot_bytes


def vectors(t: torch.Tensor) -> np.ndarray:
    """t's bytes as (rows, kv, 4) u32 words (16-byte vectors)."""
    return t.contiguous().view(torch.uint8).numpy().view(np.uint32).reshape(
        t.shape[0], -1, 4)


def tensor(words: np.ndarray, dtype, k: int) -> torch.Tensor:
    return torch.from_numpy(words.copy().reshape(-1).view(np.uint8)).view(
        dtype).reshape(-1, k)


def store_vectors(buf, ll, off, words, index, f):
    """Store 16-byte vectors words[..., 4] (u32) at vector indices `index`
    (broadcast to words' leading shape) of the slot at byte `off` of buf
    (u32 view) as the kernels do: plain at vector v, or as LL lines 2v,
    2v + 1, each {lo, f, hi, f}."""
    if ll:
        lines = np.empty(words.shape[:-1] + (8,), dtype=np.uint32)
        lines[..., 0::2] = words
        lines[..., 1::2] = f
        buf[off // 4 + 8 * index[..., None] + np.arange(8)] = lines
    else:
        buf[off // 4 + 4 * index[..., None] + np.arange(4)] = words


def store(buf, plan, off, rows, block_cols, f):
    """Store vectors rows[:, block_cols] at byte `off` of buf (u32 view)
    as the kernel does, at vector r kv + c (``store_vectors``)."""
    c0, cw = block_cols
    v = (np.arange(rows.shape[0])[:, None] * plan.kv
         + np.arange(c0, c0 + cw)[None, :])                   # vector index
    store_vectors(buf, plan.ll, off, rows[:, c0:c0 + cw], v, f)


def load(buf, plan, off, f):
    """The (m, kv, 4) vectors at byte `off`; under LL every line's epoch
    words must equal f (what the receiver polls for)."""
    n_vec = plan.m * plan.kv
    if not plan.ll:
        return buf[off // 4:off // 4 + 4 * n_vec].reshape(plan.m, plan.kv, 4)
    lines = buf[off // 4:off // 4 + 8 * n_vec].reshape(n_vec, 2, 4)
    assert (lines[:, :, 1] == f).all() and (lines[:, :, 3] == f).all()
    return lines[:, :, [0, 2]].reshape(plan.m, plan.kv, 4)


def exchange(plan, n, chunks, epoch, nbytes=None, base=0):
    """Every rank's n - 1 received slots of one call through the slots at
    byte `base` of each rank's buffer: chunks[r][p] is the (m, kv, 4)
    vectors rank r sends to rank p, stored into p's slot (r - p - 1) mod n
    block by block; returns [p][j], slot j of rank p."""
    par = epoch & 1
    size = (plan.nbytes if nbytes is None else nbytes) // 4
    bufs = [np.zeros(size, dtype=np.uint32) for _ in range(n)]
    for r in range(n):
        for i in range(1, n):
            p = (r + i) % n
            off = base + slot(plan, par, (r - p - 1) % n, n)
            for bc in cols(plan):
                store(bufs[p], plan, off, chunks[r][p], bc, epoch)
    return [[load(bufs[p], plan, base + slot(plan, par, j, n), epoch)
             for j in range(n - 1)] for p in range(n)]
