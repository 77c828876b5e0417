"""Plain products and folds shared by the kernels' plain versions and the
layers: the reference's ``preferred_element_type=f32`` products, the
cross-rank folds of B4, B5, B6, B9 and B13b in each kernel's own order, and
the plain versions of the expert-parallel kernels: B17's and B18's slot
exchange (``all_to_all_slots``) and B16's dispatch + gate/up product
(``dispatch_gg_ref``), and of the sequence-parallel ones: the LSE merge
of split-KV partials and B20's cross-rank combine (``combine_ref``), and
B21's fold order (``ring_block_fold``: the reference's XLA_BLOCK tier)
with its plain versions ``ring_attn_ref`` / ``ring_attn_shards_ref``;
the small collectives': the all-gather of B7, B8, B22 and B23
(``all_gather_cat``), B24's send / recv (``p2p_ref``), B25's barrier
(``barrier_ref``) and B26's ring shift (``ring_shift_ref``). A
leaf module: the kernel modules import it, and ``layers/common.py``
(which imports the kernel modules' method enums) re-exports
``dot_f32``."""

from __future__ import annotations

import torch
import torch.distributed as dist

NEG_INF = -1e30   # finite: keeps exp/max NaN-free in fully masked rows
SCORE_BYTES = 1 << 30   # f32 scores a torch attention fold makes at once


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


def all_gather_cat(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated in rank order: the plain version of
    the all-gathers B7, B8, B22 and B23."""
    return torch.cat(all_gather_list(mesh, x))


def p2p_ref(mesh, x: torch.Tensor, src_rank: int,
            dst_rank: int) -> torch.Tensor:
    """B24's plain version on this rank: a send / recv pair from src_rank
    to dst_rank (no broadcast); dst returns what src sent, every other
    rank a copy of its own x."""
    me = mesh.rank
    if src_rank == dst_rank or me not in (src_rank, dst_rank):
        return x.clone()
    if me == src_rank:
        dist.send(x.contiguous(), dist.get_global_rank(mesh.group, dst_rank),
                  group=mesh.group)
        return x.clone()
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    dist.recv(out, dist.get_global_rank(mesh.group, src_rank),
              group=mesh.group)
    return out


def barrier_ref(mesh, x: torch.Tensor) -> torch.Tensor:
    """B25's plain version: the process group's barrier, then a copy."""
    dist.barrier(group=mesh.group)
    return x.clone()


def ring_shift_ref(mesh, x: torch.Tensor, shift: int) -> torch.Tensor:
    """B26's plain version on this rank: the shard of rank (me - shift)
    mod n, by one send to (me + shift) and one receive from (me - shift)
    (``dist.batch_isend_irecv``, both requests waited on); a copy of x
    when shift is a multiple of n."""
    n, me = mesh.world, mesh.rank
    s = shift % n
    if s == 0:
        return x.clone()
    x = x.contiguous()
    out = torch.empty_like(x)
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x,
                       dist.get_global_rank(mesh.group, (me + s) % n),
                       mesh.group),
            dist.P2POp(dist.irecv, out,
                       dist.get_global_rank(mesh.group, (me - s) % n),
                       mesh.group)]):
        req.wait()
    return out


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


def lse_partial_merge(accs: torch.Tensor, ms: torch.Tensor,
                      ls: torch.Tensor):
    """Merge split-KV partials stacked on axis 0 — accs (n, B, Hq, D),
    ms/ls (n, B, Hq) — WITHOUT normalizing: returns the (acc, m, l) triple
    of one partial over the union of the inputs' key ranges."""
    m = ms.amax(dim=0)                                  # (B, Hq)
    scale = torch.exp(ms - m[None])                     # (n, B, Hq)
    acc = (accs * scale[..., None]).sum(dim=0)          # (B, Hq, D)
    l = (ls * scale).sum(dim=0)                         # (B, Hq)
    return acc, m, l


def lse_merge(accs: torch.Tensor, ms: torch.Tensor,
              ls: torch.Tensor) -> torch.Tensor:
    """Merge partials stacked on axis 0 and normalize: (B, Hq, D) f32."""
    acc, _, l = lse_partial_merge(accs, ms, ls)
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def gather_triple(mesh, acc, m, l):
    """Every rank's (acc, m, l), each stacked in rank order."""
    if mesh is None or mesh.world == 1:
        return acc[None], m[None], l[None]
    return tuple(torch.stack(all_gather_list(mesh, x)) for x in (acc, m, l))


def combine_ref(mesh, acc, m, l, partial: bool = False):
    """Plain version of B20 over the process group: the all-gather of the
    triple, then ``lse_partial_merge`` over the stack in rank order; the
    merged triple when partial, else normalized (B, Hq, D) f32."""
    a, mm, ll = lse_partial_merge(*gather_triple(mesh, acc, m, l))
    if partial:
        return a, mm, ll
    return a / torch.clamp_min(ll, 1e-30)[..., None]


def ring_block_fold(q, shards, me: int, n: int, nblk: int):
    """B21's fold order, the reference's XLA_BLOCK tier: q (B, T_loc, Hq,
    D) of rank ``me`` over ``shards``, an iterable of (src, (k, v)) in
    ring order (src = (me - s) mod n), each shard's nblk row blocks in
    ascending order, one online-softmax rescale per block, q pre-scaled in
    f32, P.V in f32; rows folded in chunks of at most SCORE_BYTES of
    scores. Returns (B, T_loc, Hq, D) in q.dtype."""
    b, t_loc, hq, d = q.shape
    bb = t_loc // nblk
    q2 = m = l = acc = q_pos = None
    hkv = rows = bh = gt = None
    for src, (k_cur, v_cur) in shards:
        if q2 is None:
            hkv = k_cur.shape[2]
            g = hq // hkv
            bh, gt = b * hkv, g * t_loc
            q2 = q.reshape(b, t_loc, hkv, g, d).permute(0, 2, 3, 1, 4) \
                .reshape(bh, gt, d).float() * (d ** -0.5)
            # (gt,) global query positions, g-major like the kernel layout
            q_pos = me * t_loc + torch.arange(t_loc, device=q.device) \
                .repeat(g)
            m = torch.full((bh, gt, 1), NEG_INF, device=q.device)
            l = torch.zeros((bh, gt, 1), device=q.device)
            acc = torch.zeros((bh, gt, d), device=q.device)
            rows = max(1, SCORE_BYTES // (bh * bb * 4))
        kw = k_cur.permute(0, 2, 1, 3).reshape(bh, t_loc, d)
        vw = v_cur.permute(0, 2, 1, 3).reshape(bh, t_loc, d)
        for blk in range(nblk):
            kb = kw[:, blk * bb:(blk + 1) * bb].float()
            vb = vw[:, blk * bb:(blk + 1) * bb].float()
            k_pos = src * t_loc + blk * bb + torch.arange(bb,
                                                          device=q.device)
            for r0 in range(0, gt, rows):
                sl = slice(r0, r0 + rows)
                valid = k_pos[None, None, :] <= q_pos[None, sl, None]
                s_mat = torch.bmm(q2[:, sl], kb.transpose(1, 2))
                s_mat = torch.where(valid, s_mat, NEG_INF)
                m_new = torch.maximum(m[:, sl], s_mat.amax(dim=-1,
                                                           keepdim=True))
                p = torch.where(valid, torch.exp(s_mat - m_new), 0.0)
                corr = torch.exp(m[:, sl] - m_new)
                l[:, sl] = l[:, sl] * corr + p.sum(dim=-1, keepdim=True)
                m[:, sl] = m_new
                acc[:, sl] = acc[:, sl] * corr + torch.bmm(p, vb)
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(b, hkv, hq // hkv, t_loc, d).permute(0, 3, 1, 2, 4) \
        .reshape(b, t_loc, hq, d).to(q.dtype)


def ring_attn_shards_ref(q, ks, vs, me: int, nblk: int):
    """Plain version of B21 over every rank's K and V shards in one
    process (lists in rank order): rank ``me``'s output."""
    n = len(ks)
    return ring_block_fold(q, (((me - s) % n, (ks[(me - s) % n],
                                               vs[(me - s) % n]))
                               for s in range(n)), me, n, nblk)


def ring_attn_ref(mesh, q, k, v, nblk: int):
    """Plain version of B21 over the process group: the all-gather of the
    K and V shards, then ``ring_attn_shards_ref``."""
    n = mesh.world
    ks = [k] if n == 1 else all_gather_list(mesh, k.contiguous())
    vs = [v] if n == 1 else all_gather_list(mesh, v.contiguous())
    return ring_attn_shards_ref(q, ks, vs, mesh.rank, nblk)
