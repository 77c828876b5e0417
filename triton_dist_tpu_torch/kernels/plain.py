"""Plain products and folds shared by the kernels' plain versions and the
layers: the reference's ``preferred_element_type=f32`` products, the
cross-rank folds of B4, B5, B6, B9 and B13b in each kernel's own order, and
the plain versions of the expert-parallel kernels: B17's and B18's slot
exchange (``all_to_all_slots``) and B16's dispatch + gate/up product
(``dispatch_gg_ref``). A leaf module: the kernel modules import it, and
``layers/common.py`` (which imports the kernel modules' method enums)
re-exports ``dot_f32``."""

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


def all_to_all_slots(mesh, x: torch.Tensor) -> torch.Tensor:
    """Plain version of B17 (and of B18, payload by payload) over the
    process group: slot p of this rank's x (n, ...) goes to rank p, and
    slot s of the result is what rank s sent here (NCCL's
    ``all_to_all_single``). Bytes are moved, not values: a one-byte dtype
    (fp8) travels as uint8. The identity at world 1."""
    if mesh is None or mesh.world == 1:
        return x
    src = x.contiguous()
    if src.element_size() == 1 and src.dtype not in (torch.uint8,
                                                     torch.int8):
        src = src.view(torch.uint8)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    return out.view(x.dtype)


def all_to_all_slots_shards(xs) -> list[torch.Tensor]:
    """Plain version of B17 over every rank's x in one process (the
    one-card world): rank r's result stacks slot r of every rank's x."""
    n = len(xs)
    return [torch.stack([xs[p][r] for p in range(n)]) for r in range(n)]


def slot_expert_product(recv: torch.Tensor, ids: torch.Tensor,
                        counts: torch.Tensor,
                        experts_w: torch.Tensor) -> torch.Tensor:
    """B16's product on the received slots: recv (n, max_m, K), ids (n,
    max_m) local expert per slot, counts (n,) live slots per sender,
    experts_w (E_loc, K, N) -> (n * max_m, N) in slot order, row s * max_m
    + j = cast(recv[s, j] @ experts_w[ids[s, j]]) with f32 accumulation
    for the live slots (j < counts[s]), 0 for the pad slots. Reads the
    routing on the host, expert by expert."""
    n, max_m, k = recv.shape
    rows = recv.reshape(n * max_m, k)
    flat = ids.reshape(-1).long()
    live = (torch.arange(max_m, device=recv.device)[None, :]
            < counts.to(recv.device)[:, None]).reshape(-1)
    out = torch.zeros((n * max_m, experts_w.shape[-1]),
                      dtype=torch.result_type(recv, experts_w),
                      device=recv.device)
    for e in torch.unique(flat[live]).tolist():
        sel = torch.nonzero(live & (flat == e))[:, 0]
        out[sel] = dot_f32(rows[sel], experts_w[e]).to(out.dtype)
    return out


def dispatch_gg_ref(mesh, send_x: torch.Tensor, ids: torch.Tensor,
                    counts: torch.Tensor, experts_w: torch.Tensor):
    """Plain version of B16 over the process group: this rank's payload
    send_x (n, max_m, K) exchanged by ``all_to_all_slots``, then
    ``slot_expert_product`` over the received ids (n, max_m) and counts
    (n,). Returns (received rows (n * max_m, K), inter (n * max_m, N))."""
    recv = all_to_all_slots(mesh, send_x)
    return (recv.reshape(-1, recv.shape[-1]),
            slot_expert_product(recv, ids, counts, experts_w))
