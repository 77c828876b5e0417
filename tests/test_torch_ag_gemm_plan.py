"""The bf16 plan of B10 and B11 (``allgather_gemm.ag_plan``,
``csrc/ag_gemm.cu``, ``csrc/gemm_tile_sm90.cuh``), held on the CPU.

The launch has two regimes by the gathered rows: the decode regime runs
``gemm_stream_sm90.cuh``'s stream-K units over the landed rows, the prefill
regime ``gemm_tile_sm90.cuh``'s 128 x 256 tiles, in pairs by 2-block
clusters, in the order the launcher passes (``ag_row_order``). Both gather
the shards in row blocks of pq pieces, a block of the grid a piece, and
the last piece raises the row block's flag, one a (parity, chunk, row
block). This
file writes the kernel's rules down and holds them: the regime cut; every
stream unit and every (row tile, column tile) run exactly once; the own
shard's tiles first, then B10's by rank distance and B11's by ring round;
each tile waits on exactly the flags of the rows it reads; the landing
rows, flags, counters and tickets of both parities apart and inside the
workspace; every rank's blocks resident at once; shared memory, TMA boxes
and strides within the card's rules; the constants the CUDA source's; and
an emulation of both gather legs (which rows each rank stores where, in
which round, after which flag) that ends with every rank holding every
chunk. That the kernels' own addressing is these formulas is held on the
card: ``chip_smoke.py``'s ``b10_ag_gemm`` and ``b11_ag_gemm_bidir`` hold
every case to the plain version and B11's out to B10's bits.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest

from triton_dist_tpu_torch.kernels import allgather_gemm as agm
from triton_dist_tpu_torch.kernels import gemm_allreduce as ga

SMS = 132                  # an H100's SMs
L2 = 50 * 2 ** 20          # an H100's L2 bytes
SMEM_MAX = 232448          # shared memory a block may use (227 KB)
CSRC = Path(agm.__file__).resolve().parent.parent / "csrc"
TILE_SRC = (CSRC / "gemm_tile_sm90.cuh").read_text()
AG_SRC = (CSRC / "ag_gemm.cu").read_text()
STREAM_SRC = (CSRC / "gemm_stream_sm90.cuh").read_text()


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


# (name, world, m a rank, K, N_loc): Qwen3-32B's QKV and gate/up at TP=4
# (decode, prefill, ragged), two and eight ranks, a K and an N no tile
# divides
SHAPES = (("qkv_m4", 4, 4, 5120, 2560), ("gate_up_m4", 4, 4, 5120, 12800),
          ("qkv_m3", 4, 3, 5120, 2560), ("qkv_m16", 4, 16, 5120, 2560),
          ("qkv_m17", 4, 17, 5120, 2560),
          ("qkv_m130", 4, 130, 5120, 2560),
          ("qkv_m2048", 4, 2048, 5120, 2560),
          ("gate_up_m2048", 4, 2048, 5120, 12800),
          ("w2_m64", 2, 64, 4096, 6144), ("w8_m8", 8, 8, 4096, 1024),
          ("w8_m300", 8, 300, 4096, 1024), ("w3_m100", 3, 100, 1000, 136),
          ("w5_m77", 5, 77, 2048, 264))
RPD = (1, 4)               # ranks a card: four cards, the one-card world
# (shape, bidir): B11 needs both ring directions (n >= 3)
LEGS = [(s, bidir) for s in SHAPES for bidir in (False, True)
        if not bidir or s[1] >= 3]


def _leg_id(x):
    return f"{x[0][0]}_{'b11' if x[1] else 'b10'}"


def _plan(shape, rpd=1):
    _, world, m, k, n = shape
    return agm.ag_plan(world, m, k, n, SMS, rpd, L2)


TILE_SHAPES = [s for s in SHAPES if _plan(s).regime == "tile"]
TILE_LEGS = [(s, bidir) for s, bidir in LEGS if s in TILE_SHAPES]


# -- the kernel's formulas, written out ---------------------------------------

def _tile_at(plan, i):
    """The i-th pair tile of the order (gemm_tile_sm90.cuh's tile_at): (row
    pair q, column tile); block r of a cluster takes row position
    TILE_CLUSTER * q + r of the row order, none past its end. Groups of
    TILE_GM / TILE_CLUSTER row pairs; in a group, column groups of
    TILE_GN column tiles, each swept pair by pair."""
    gp, gn = agm.TILE_GM // agm.TILE_CLUSTER, agm.TILE_GN
    per_group = gp * plan.col_tiles
    g = i // per_group
    rows_g = min(gp, plan.row_pairs - g * gp)
    j = i - g * per_group
    cg = j // (rows_g * gn)
    cw = min(gn, plan.col_tiles - cg * gn)
    j -= cg * rows_g * gn
    return g * gp + j // cw, cg * gn + j % cw


def _tile_flags(plan, rank, rt):
    """The (chunk, row block) flags the tile kernel's producer acquires on
    `rank` before row tile rt's first A load (ag_gemm.cu's a_tile and
    wait_rows): none for a tile of the own shard's rows alone, which it
    reads from the caller's tensor."""
    r0 = rt * agm.TILE_BM
    r1 = min(plan.rows, r0 + agm.TILE_BM)
    if r0 >= rank * plan.m and r1 <= (rank + 1) * plan.m:
        return []
    out = []
    for c in agm.tile_chunks(plan.rows, plan.m, r0, r1):
        lo = max(r0, c * plan.m) - c * plan.m
        hi = min(r1, (c + 1) * plan.m) - c * plan.m
        out += [(c, j) for j in range(lo // plan.rb, (hi - 1) // plan.rb + 1)]
    return out


def _flag_index(plan, par, chunk, j):
    """Flag (parity, chunk, row block j): its u64 after flag_off (Gather's
    flag)."""
    return (par * plan.world + chunk) * plan.mb + j


def _row_offset(plan, par, chunk, j):
    """Byte offset of row block j of chunk c in the landing rows (Gather's
    rows)."""
    return par * plan.half_bytes + (chunk * plan.m + j * plan.rb) * \
        plan.k * 2


def _block_bytes(plan, j):
    return min(plan.rb, plan.m - j * plan.rb) * plan.k * 2


def _pq(plan):
    """Pieces a row block of the gather leg (gather_leg's pq): a block a
    piece."""
    return max(1, plan.grid // plan.mb)


def _piece(plan, j, q):
    """Piece q [lo, hi) of row block j (gather_leg's piece: pq equal
    16-byte pieces)."""
    nbytes = _block_bytes(plan, j)
    per = -(-(nbytes // 16) // _pq(plan)) * 16
    lo = min(nbytes, per * q)
    return lo, min(nbytes, lo + per)


def _units(plan, b):
    """The gather units (row block, piece) block b moves of a chunk: units
    b, b + G, ... of mb x pq."""
    return [(u // _pq(plan), u % _pq(plan))
            for u in range(b, plan.mb * _pq(plan), plan.grid)]


@pytest.mark.parametrize("world", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("m", [1, 3, 4, 8, 9, 16, 17, 32, 33, 130, 2048])
@pytest.mark.parametrize("n", [2560, 12800])
@pytest.mark.parametrize("rpd", RPD)
def test_the_regime_cut(world, m, n, rpd):
    """The stream at one 16-row M group of gathered rows
    (AG_STREAM_MAX_ROWS = 16) whatever W, and up to AG_STREAM_L2_ROWS =
    128 while the weights the card streams (W times the ranks it hosts)
    fit its L2; the tile GEMM else; the row block the push's granule
    (the shard for the stream, TILE_BM rows for tiles)."""
    plan = agm.ag_plan(world, m, 5120, n, SMS, rpd, L2)
    rows = world * m
    stream = rows <= 16 or (rows <= 128 and 5120 * n * 2 * rpd <= L2)
    assert (agm.AG_STREAM_MAX_ROWS, agm.AG_STREAM_L2_ROWS) == (16, 128)
    assert plan.regime == ("stream" if stream else "tile")
    assert plan.rb == (m if stream else agm.TILE_BM)
    assert (plan.stream is not None) == stream


# The faster regime of B10 in chip_compare.py --ag --sweep (NVIDIA H100
# 80GB HBM3, 700 W; PERF.md): (rows a rank at world 4, N at K 5,120,
# ranks a card) -> regime; the plan takes it at every reading
SWEEP = {**{(m, 2560, 1): "stream" for m in (4, 8, 16, 17, 32)},
         **{(m, 2560, 1): "tile" for m in (64, 128, 512)},
         (4, 12800, 1): "stream",
         **{(m, 12800, 1): "tile" for m in (8, 16, 17, 32, 64, 128, 512)},
         **{(4, n, 4): "stream" for n in (2560, 12800)},
         **{(m, n, 4): "tile" for m in (8, 16, 17, 32, 64, 128, 512)
            for n in (2560, 12800)}}


@pytest.mark.parametrize("reading", sorted(SWEEP), ids=str)
def test_the_cut_takes_the_faster_regime(reading):
    m, n, rpd = reading
    assert agm.ag_plan(4, m, 5120, n, SMS, rpd, L2).regime == SWEEP[reading]


def test_the_cut_is_the_kernels():
    """The cut lives in the plan alone: the launcher takes the plan's
    regime from its arguments (a row order for the tile GEMM, none for
    the stream) and checks the row block against it."""
    assert "constexpr int STREAM_MAX_ROWS" not in AG_SRC
    assert "const bool stream = order == nullptr;" in AG_SRC
    assert "rb != (stream ? m : tt::BM)" in AG_SRC
    src = Path(agm.__file__).read_text()
    assert 'if plan.regime == "stream":' in src
    assert "order = _row_order(mesh, m, bidir, dev)" in src


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("rpd", RPD)
def test_every_unit_or_tile_once(shape, rpd):
    """The stream's units [b U / G, (b + 1) U / G) (the kernel's unit0)
    cover every unit once; the tile order (_tile_at over ag_row_order)
    runs every (row tile, column tile) once: cluster c takes pair tiles
    c, c + G / 2, ..., and its block r row position 2 q + r of pair q
    (none past the order's end); the grid at most the SMs a rank gets,
    whole clusters, and at most the work."""
    plan = _plan(shape, rpd)
    assert 1 <= plan.grid <= SMS // rpd
    if plan.regime == "stream":
        sp = plan.stream
        assert sp.m == plan.rows and plan.grid == sp.grid <= sp.units
        seen = []
        for b in range(plan.grid):
            seen += range(b * sp.units // plan.grid,
                          (b + 1) * sp.units // plan.grid)
        assert seen == list(range(sp.units))
        return
    cl = agm.TILE_CLUSTER
    assert plan.grid % cl == 0 and plan.grid // cl <= plan.tiles
    assert plan.tiles == -(-plan.row_tiles // cl) * plan.col_tiles
    for bidir in (False, True):
        if bidir and plan.world < 3:
            continue
        order = agm.ag_row_order(plan.world, plan.world - 1, plan.m, bidir)
        assert sorted(order) == list(range(plan.row_tiles))
        tiles = []
        for c in range(plan.grid // cl):
            for i in range(c, plan.tiles, plan.grid // cl):
                q, ct = _tile_at(plan, i)
                for r in range(cl):
                    if cl * q + r < plan.row_tiles:
                        tiles.append((order[cl * q + r], ct))
        assert sorted(tiles) == [(r, c) for r in range(plan.row_tiles)
                                 for c in range(plan.col_tiles)]


@pytest.mark.parametrize("shape", TILE_SHAPES,
                         ids=[s[0] for s in TILE_SHAPES])
def test_the_column_groups_sweep_a_row_group(shape):
    """Inside a group of TILE_GM row positions (TILE_GM / 2 row pairs)
    the order sweeps one group of TILE_GN column tiles over every row pair
    of the group before the next, so a strip of W stays in L2 while the
    rows read it."""
    plan = _plan(shape)
    gp = agm.TILE_GM // agm.TILE_CLUSTER
    seq = [_tile_at(plan, i) for i in range(plan.tiles)]
    assert sorted(seq) == [(q, c) for q in range(plan.row_pairs)
                           for c in range(plan.col_tiles)]
    for i, (q, ct) in enumerate(seq):
        g = q // gp
        assert i // (gp * plan.col_tiles) == g
        rows_g = min(gp, plan.row_pairs - g * gp)
        j = i - g * gp * plan.col_tiles
        assert ct // agm.TILE_GN == j // (rows_g * agm.TILE_GN)


def _chunks_of_tile(plan, rt):
    r0, r1 = rt * agm.TILE_BM, min(plan.rows, (rt + 1) * agm.TILE_BM)
    return sorted({r // plan.m for r in range(r0, r1)})


@pytest.mark.parametrize("leg", TILE_LEGS, ids=_leg_id)
def test_the_own_shard_first_then_as_they_land(leg):
    """On every rank: the tiles that read only the own shard come first;
    then the tiles run in the order their last chunk lands: B10 (one hop
    from every rank) by rank distance, the next rank first; B11 by the
    ring round (chunk me - s from the left at round s <= n // 2, me + s
    from the right at s <= (n - 1) // 2)."""
    shape, bidir = leg
    plan = _plan(shape)
    n = plan.world
    for me in range(n):
        order = agm.ag_row_order(n, me, plan.m, bidir)

        def land(c):
            if not bidir:
                return ((c - me) % n, 0)
            s_left = (me - c) % n
            if s_left <= n // 2:
                return (s_left, 0)
            assert (c - me) % n <= (n - 1) // 2
            return ((c - me) % n, 1)
        keys = [max(land(c) for c in _chunks_of_tile(plan, rt))
                for rt in order]
        assert keys == sorted(keys)
        own = [rt for rt in order if _chunks_of_tile(plan, rt) == [me]]
        assert order[:len(own)] == own


@pytest.mark.parametrize("shape", TILE_SHAPES,
                         ids=[s[0] for s in TILE_SHAPES])
def test_each_tile_waits_on_exactly_its_rows_flags(shape):
    """_tile_flags(rank, rt), the (chunk, row block) flags the producer
    acquires before row tile rt's first A load, are exactly the row
    blocks holding the tile's rows, on every rank; none for a tile of the
    own shard's rows alone, which the kernel reads from the caller's
    tensor (the third map) and not from the landing rows."""
    plan = _plan(shape)
    for me in range(plan.world):
        for rt in range(plan.row_tiles):
            r0 = rt * agm.TILE_BM
            r1 = min(plan.rows, (rt + 1) * agm.TILE_BM)
            rows = range(r0, r1)
            own = all(r // plan.m == me for r in rows)
            want = [] if own else sorted(
                {(r // plan.m, (r % plan.m) // plan.rb) for r in rows})
            assert sorted(_tile_flags(plan, me, rt)) == want
    src = AG_SRC[AG_SRC.index("__device__ __forceinline__ void wait_rows("):]
    assert "for (int c = r0 / g.m; c <= (r1 - 1) / g.m; ++c)" in src
    assert "for (int j = lo / g.rb; j <= (hi - 1) / g.rb; ++j)" in src
    assert "if (r0 >= own0 && r1 <= own0 + g.m) {" in src
    assert "return maps[2];" in src and "return maps[e & 1];" in src


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_slots_flags_counters_apart_per_parity(shape):
    """The landing rows of (parity, chunk, row block) are disjoint and
    fill the two halves; the flags (parity, chunk, row block) are distinct
    u64 after the rows and inside the buffer; the counters (chunk, row
    block) and the stream kernel's tickets (4 int32 a block, for every
    grid a rank may get) lie apart in the control block."""
    plan = _plan(shape)
    spans, flags = [], set()
    for par in (0, 1):
        for c in range(plan.world):
            for j in range(plan.mb):
                lo = _row_offset(plan, par, c, j)
                spans.append((lo, lo + _block_bytes(plan, j)))
                flags.add(_flag_index(plan, par, c, j))
    spans.sort()
    assert spans[0][0] == 0 and spans[-1][1] == 2 * plan.half_bytes
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert flags == set(range(2 * plan.world * plan.mb))
    assert plan.flag_off >= 2 * plan.half_bytes
    assert plan.flag_off % 256 == 0
    assert plan.flag_off + 8 * len(flags) == plan.nbytes
    assert plan.ticket_word == plan.world * plan.mb
    assert plan.ctl_words - plan.ticket_word == 2 * (SMS // 1)
    # one workspace serves every N at this (m, K)
    # one workspace serves every N of this regime at this (m, K)
    for n in (8, plan.n + 8, 8 * plan.n + 8):
        other = agm.ag_plan(plan.world, plan.m, plan.k, n, SMS, 1, L2)
        if other.regime == plan.regime:
            assert (other.nbytes, other.ctl_words, other.flag_off) == \
                (plan.nbytes, plan.ctl_words, plan.flag_off)


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("rpd", RPD)
def test_the_pieces_cover_every_row_block(shape, rpd):
    """The gather leg's units: every (row block, piece) moved by exactly
    one block of the grid, at most one unit a block when the row blocks
    are fewer than the blocks (a block a piece: one system fence a
    block), each piece 16-byte aligned, the pq pieces covering the row
    block once."""
    plan = _plan(shape, rpd)
    assert _pq(plan) == max(1, plan.grid // plan.mb)
    taken = [u for b in range(plan.grid) for u in _units(plan, b)]
    assert sorted(taken) == [(j, q) for j in range(plan.mb)
                             for q in range(_pq(plan))]
    if plan.mb <= plan.grid:
        assert all(len(_units(plan, b)) <= 1 for b in range(plan.grid))
    for j in range(plan.mb):
        covered = 0
        for q in range(_pq(plan)):
            lo, hi = _piece(plan, j, q)
            assert lo % 16 == 0 and hi % 16 == 0
            assert lo == min(covered, _block_bytes(plan, j)) or lo == hi
            covered = max(covered, hi)
        assert covered == _block_bytes(plan, j)


def _gather(plan, bidir):
    """The gather legs, emulated per (rank, block) in rounds: each store
    of a piece of (chunk, row block) into a rank, the count of pieces per
    (rank that stores, chunk, row block), the flags raised by the last
    piece, and each forwarding step run only once the flag it waits on
    rose. Returns each rank's landed pieces and flags."""
    n, me_all = plan.world, range(plan.world)
    landed = {p: set() for p in me_all}
    flags = {p: set() for p in me_all}
    count = {}

    def store(src_rank, c, j, dsts):
        for b in range(plan.grid):
            for jj, q in _units(plan, b):
                if jj != j:
                    continue
                lo, hi = _piece(plan, j, q)
                for d in dsts:
                    landed[d].add((c, j, lo, hi))
                key = (src_rank, c, j)
                count[key] = count.get(key, 0) + 1
                if count[key] == _pq(plan):
                    for d in dsts:
                        flags[d].add((c, j))
    for me in me_all:
        right, left = (me + 1) % n, (me - 1) % n
        dsts = ([(me + i) % n for i in range(1, n + 1)] if not bidir
                else [right, left, me])
        for j in range(plan.mb):
            store(me, me, j, dsts)
    if bidir:
        kr, kl = n // 2, (n - 1) // 2
        for s in range(1, kr):
            for me in me_all:
                right, left = (me + 1) % n, (me - 1) % n
                steps = [((me - s) % n, right)]
                if s < kl:
                    steps.append(((me + s) % n, left))
                for c, to in steps:
                    for j in range(plan.mb):
                        assert (c, j) in flags[me]     # its wait
                        store(me, c, j, [to])
    return landed, flags, count


@pytest.mark.parametrize("leg", LEGS, ids=_leg_id)
def test_the_gather_lands_every_chunk_on_every_rank(leg):
    """Both gather legs end with every rank holding every chunk's every
    piece and every (chunk, row block) flag; every counter reached G (so
    the last piece raised its flags) and each (storing rank, chunk, row
    block) counted once a call; B11 forwards only what has landed."""
    shape, bidir = leg
    plan = _plan(shape)
    landed, flags, count = _gather(plan, bidir)
    want = {(c, j, *_piece(plan, j, q)) for c in range(plan.world)
            for j in range(plan.mb) for q in range(_pq(plan))}
    for p in range(plan.world):
        assert landed[p] == want
        assert flags[p] == {(c, j) for c in range(plan.world)
                            for j in range(plan.mb)}
    assert set(count.values()) == {_pq(plan)}
    if not bidir:
        assert len(count) == plan.world * plan.mb


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("rpd", RPD)
def test_every_rank_resident(shape, rpd):
    """One block an SM (the stream ring and the tile ring each take more
    than half the SM's shared memory), at most SMs / ranks a card blocks
    a rank: every block of every rank sharing the card is resident at
    once, so no spinning block keeps the one it waits for from running."""
    plan = _plan(shape, rpd)
    assert plan.grid * rpd <= SMS
    if plan.regime == "tile":
        assert (plan.grid // agm.TILE_CLUSTER) * rpd <= SMS // 2
    assert agm.TILE_SMEM_BYTES > SMEM_MAX // 2
    ring16 = 1024 + 5 * 128 * 128 * 2 + 5 * 16 * (128 + 8) * 2 + 2 * 5 * 8
    assert ring16 > SMEM_MAX // 2


def test_shared_memory_and_tma_rules():
    """The tile's shared memory fits a block; its boxes are 64 bf16 (one
    128-byte swizzled row) wide and at most 256 rows; every stage and box
    is 1024-byte aligned (the swizzle's atom); a k16 step of A moves 32
    bytes in the row, of W 16 rows (2,048 bytes); W's slabs are a box
    apart (the descriptor's leading byte offset); the maps' row strides
    (K and N bf16) are multiples of 16 bytes exactly when K and N are
    multiples of 8, the launcher's rule."""
    bm, bn, bk = agm.TILE_BM, agm.TILE_BN, agm.TILE_BK
    assert agm.TILE_SMEM_BYTES <= SMEM_MAX
    assert bk * 2 == 128 and bm <= 256 and bk <= 256
    a_bytes, box = bm * bk * 2, bk * 64 * 2
    stage = a_bytes + (bn // 64) * box
    assert a_bytes % 1024 == 0 and box % 1024 == 0 and stage % 1024 == 0
    assert bn % 64 == 0 and bn <= 256 and bm == 2 * 64
    assert "s9::desc_sw128(sa + wg * 64 * 128 + kk * 32, 16," in TILE_SRC
    assert "s9::desc_sw128(sa + A_BYTES + kk * 16 * 128," in TILE_SRC
    assert "WBOX_BYTES, 1024)" in TILE_SRC
    assert "p, 1, 1, 0, 1;" in TILE_SRC          # tnspB: W MN-major
    for k in (8, 1000, 5120):
        assert (k * 2) % 16 == 0
    assert all((x * 2) % 16 for x in (4, 12, 100))


def test_constants_match_the_kernel_source():
    """The Python plan's tile and order are the CUDA source's."""
    assert _const(TILE_SRC, "BM") == agm.TILE_BM
    assert _const(TILE_SRC, "BN") == agm.TILE_BN
    assert _const(TILE_SRC, "BK") == agm.TILE_BK
    assert _const(TILE_SRC, "STAGES") == agm.TILE_STAGES
    assert _const(TILE_SRC, "GM") == agm.TILE_GM
    assert _const(TILE_SRC, "GN") == agm.TILE_GN
    assert _const(TILE_SRC, "NWG") == 2
    assert _const(TILE_SRC, "CLUSTER") == agm.TILE_CLUSTER
    assert "__cluster_dims__(CLUSTER, 1, 1)" in TILE_SRC
    assert "s9::mbar_init(empty + st, CLUSTER * NWG * 4);" in TILE_SRC
    assert "(1u << CLUSTER) - 1" in TILE_SRC      # W to both blocks
    assert "1024 + size_t(STAGES) * STAGE_BYTES + 2 * STAGES * " \
        "sizeof(uint64_t);" in TILE_SRC
    assert _const(STREAM_SRC, "STAGES") == 5
    assert ga.STREAM_BN == 128 and ga.STREAM_BK == 128
    # tile_at, as the kernel writes it
    body = TILE_SRC[TILE_SRC.index("void tile_at("):]
    for line in ("constexpr int GP = GM / CLUSTER;",
                 "const int per_group = GP * p.col_tiles;",
                 "const int rows_g = min(GP, p.row_pairs - g * GP);",
                 "const int cg = j / (rows_g * GN);",
                 "const int cw = min(GN, p.col_tiles - cg * GN);",
                 "q = g * GP + j / cw;", "ct = cg * GN + j % cw;"):
        assert line in body
    # the gather leg's piece, as the kernel writes it
    assert "const long long per = (bytes / 16 + pq - 1) / pq * 16;" in AG_SRC
    assert "pq = max(1, G / g.mb), units = g.mb * pq;" in AG_SRC
    assert "const int round0[3] = {right, left, me};" in AG_SRC


def test_b11_runs_b10s_plan():
    """B11's launch is B10's plan (the same regime, grid, cut and K
    order: its out is B10's bits); the row order alone differs."""
    for shape in SHAPES:
        plan = _plan(shape)
        assert plan == agm.ag_plan(*shape[1:], SMS, 1, L2)
    src = (Path(agm.__file__)).read_text()
    assert "plan = ag_plan(world, m, k, n_cols, sms, mesh.ranks_per_device, " \
        "l2)" in src
