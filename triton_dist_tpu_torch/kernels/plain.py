"""Plain products and folds shared by the kernels' plain versions and the
layers: the reference's ``preferred_element_type=f32`` products, and the
cross-rank folds of B4, B5, B6, B9 and B13b in each kernel's own order. A leaf
module: the kernel modules import it, and ``layers/common.py`` (which
imports the kernel modules' method enums) re-exports ``dot_f32``."""

from __future__ import annotations

import torch
import torch.distributed as dist


def dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as f32 from a's dtype with f32 accumulation (the reference's
    preferred_element_type=f32). A bf16 product rounded to bf16 would
    change greedy tokens; CUDA has an f32-output bf16 mm, the CPU build
    does not, so there the exact bf16 products are summed in f32."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (G, M, K) @ (G, K, N) as f32 with f32 accumulation, on the
    same rule as ``dot_f32``."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def all_gather_list(mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``x``, in rank order (the plain versions' exchange)."""
    xs = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(xs, x.contiguous(), group=mesh.group)
    return xs


def slot_fold(parts) -> torch.Tensor:
    """B4's fold: slot 0 + slot 1 + ... + slot n-1 of the ranks' f32
    partials (the same on every rank)."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def one_shot_fold(xs, me: int) -> torch.Tensor:
    """B5's fold on rank ``me``: its own term first, then the others in
    ascending rank, each add in the terms' dtype."""
    acc = xs[me]
    for i, x in enumerate(xs):
        if i != me:
            acc = acc + x
    return acc


def rhd_fold(xs) -> torch.Tensor:
    """B6's fold: the halving tree (pairs at distance n/2, then n/4, ...,
    1), each add in the terms' dtype. a + b == b + a, so every rank's
    shards hold this one value."""
    vals = list(xs)
    d = len(vals) // 2
    while d >= 1:
        vals = [vals[i] + vals[i ^ d] for i in range(len(vals))]
        d //= 2
    return vals[0]


def ring_rs_fold(xs, me: int) -> torch.Tensor:
    """B9's fold of rank ``me``'s row chunk of the ranks' (n*m, K) xs:
    the chunk starts raw at rank me+1 and each hop adds the next rank's
    rows, x_{me+1} + x_{me+2} + ... + x_{me} (ranks mod n), each add in
    the terms' dtype. Every rank's chunk has one value, whichever rank
    computes it."""
    n = len(xs)
    m = xs[0].shape[0] // n
    rows = slice(me * m, (me + 1) * m)
    acc = xs[(me + 1) % n][rows]
    for j in range(2, n + 1):
        acc = acc + xs[(me + j) % n][rows]
    return acc


def bidir_rs_fold(parts, me: int) -> torch.Tensor:
    """B13b's fold of rank ``me``'s row chunk of the ranks' f32 partials
    (each (n*m, N)): the reference's arcs (kr = n // 2, kl = (n - 1) //
    2). The right chain starts raw at rank me - kr and each hop adds its
    own partial to the arrival (own + arrival) up to rank me - 1; the left
    chain the same from rank me + kl down to me + 1; the owner adds own +
    right + left, in that order."""
    n = len(parts)
    m = parts[0].shape[0] // n
    rows = slice(me * m, (me + 1) * m)
    kr, kl = n // 2, (n - 1) // 2

    def chain(ranks):
        acc = None
        for r in ranks:
            own = parts[r % n][rows]
            acc = own if acc is None else own + acc
        return acc

    out = parts[me][rows] + chain(range(me - kr, me))
    if kl > 0:
        out = out + chain(range(me + kl, me, -1))
    return out
