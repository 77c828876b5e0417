// B14 and B15: the expert grouped GEMMs of the tensor-parallel MoE layer,
// hand-written for Hopper (sm_90a), at world 1 and across ranks.
//
// Replace the TPU kernels kernels/allgather_group_gemm.py::
// _ag_group_gemm_kernel (B14, the token all-gather + gate/up grouped GEMM)
// and kernels/moe_reduce_rs.py::_moe_rs_kernel (B15, the down grouped
// GEMM + weighted top-k combine + reduce-scatter). Both walk the
// block-aligned schedule of kernels/moe_utils.py: tile t < used_tiles of a
// chunk holds bm slots of one expert tile_expert[t]; a slot maps to a
// source row and to a token-major flat output row of the chunk, or is
// padding (sentinel).
//
//  * B14: out[c*m*topk + f] = cast(tokens_c[row_token[s]] @ W_gate_up[e])
//    for every chunk c (rank c's m tokens) and live slot s with f =
//    row_flat[s]. The TPU kernel writes the aligned buffer and gathers it
//    by aligned_pos afterwards; writing through row_flat is the same
//    function, and padding slots are never written. Across ranks it also
//    returns the gathered tokens, rank-major.
//  * B15: P_c[tok] = sum over the token's top-k choices, in ascending
//    expert order (the tile order of the TPU kernel's fold), of w[f] *
//    (inter[f] @ W_down[e]) in f32, for each chunk c of M / n tokens; rank
//    c returns cast(sum over ranks of P_c). The TPU kernel folds each tile
//    through the dense combine matrix G, which has one nonzero per live
//    slot; the weighted add of each slot's f32 row is the same function.
//
// What bounds them on this card. At Qwen3-30B-A3B's decode shapes they
// are weight streams, bound by bytes. World 1, B=4 (top-8 of 128
// experts): ~28 live experts, B14 reads ~28 gate/up slabs of 2048 x 1536
// bf16 (6.3 MB each), B15 ~28 down slabs of 768 x 2048 (3.1 MB). TP=4,
// B=16: ~82 live experts per layer, the rank's gate/up slab 2048 x 384
// (1.57 MB), its down slab 192 x 2048 (0.79 MB); the tokens and partials
// that cross NVLink are a few KB.
//
// Design of the GEMM (both kernels, both worlds): the split-K streaming
// GEMM of B4 (gemm_splitk.cuh) with the A rows gathered per tile. A work
// item is (tile, column tile, K slice):
//  * the block's first warp compacts its tile's live slots in slot order
//    in shared memory (a ballot per 32 slots), then for each group of MT
//    live rows the block stages their K slice in shared memory as f32 and
//    streams its expert's weight rows, 8 warps x U independent 16-byte
//    loads per lane in flight, f32 accumulation;
//  * the warps' partials are added in warp order and written as f32 to a
//    (splits, rows, N) workspace at the slot's flat row;
//  * the K slices are summed in slice order afterwards: B14 casts each
//    flat row, B15 folds each token's choices in ascending expert order.
// No float atomics: every launch gives the same bits, and a row's bits
// depend only on its token, its expert and the K split, so B14 across
// ranks gives each row the bits of the world-1 kernel on that chunk.
//
// World 1: grid (column tile, K slice, tile); a block whose tile is >=
// used_tiles (read on the device) exits. The K split fills the card at
// decode (about 4 blocks per SM over the live tiles).
//
// Across ranks (td_dist.cuh's device language, symmetric buffers over
// CUDA IPC or the one-card world), a persistent grid small enough that
// every block of every rank sharing the card is resident (occupancy x
// SMs / ranks per card) walks the items; both kernels of a call are loaded
// before the first launch (lazy loading could synchronize the context
// behind a spinning kernel). Neither is a ring: NVSwitch is all to all.
//  * B14: each rank stores its (m, K) shard into slot `rank` of every
//    peer's gather buffer, in nblk row blocks (the blocks split over the
//    grid), and the last block of the grid to finish a (peer, row block)
//    raises one epoch flag for it on that peer. Then the grid runs the
//    local chunk's tiles with no wait, then each remote chunk's tiles in
//    the arrival-ordered schedule (moe_utils.arrival_ordered_schedule):
//    tile t waits, bounded, for the flags of row blocks 0..b, b the first
//    block with t < tiles_ready[c, b] (the last block the tile reads).
//    Last, the gathered rows are copied out to the caller's tensor, which
//    makes every rank wait for every flag of the call. A second kernel
//    sums the K slices in slice order and casts.
//  * B15: the grid runs every chunk's tiles, the other ranks' chunks
//    first; the last item of a (chunk, column tile) to finish (a counter
//    per pair) folds that column tile of the chunk's tokens in the world-1
//    kernel's order and stores the f32 rows into slot `rank` of the owner's
//    landing buffer (NVLink stores); the last column tile of a chunk
//    raises this rank's flag on the owner. Then every block folds a share
//    of the rank's own rows: it waits for all n senders' flags and adds
//    slot 0 + slot 1 + ... + slot n-1 (ascending sender) in f32, one cast
//    (B13a's landing discipline, gemm_land.cuh). The reference's
//    ring adds in a rank-dependent order: the two agree to f32 rounding.
//  * No barrier opens a call: the landing buffers are double-buffered by
//    the epoch's parity (as B5, B9, B7). A rank writes a peer's parity-p
//    slots of call e + 2 only after it finished call e + 1, which needed
//    that peer's data of call e + 1, which the peer sends only once it
//    finished call e.

#include <climits>

#include "moe_tile.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;

template <typename T, int MT, int U>
__global__ void __launch_bounds__(NT)
    tile_gemm_kernel(const T* __restrict__ a, int a_rows,
                     const int* __restrict__ slot_row,
                     const int* __restrict__ slot_out,
                     const int* __restrict__ tile_expert,
                     const int* __restrict__ used_tiles,
                     const T* __restrict__ w, float* __restrict__ part, int bm,
                     int k_dim, int n_cols, int k_chunk, int out_rows) {
  const int t = blockIdx.z;
  if (t >= used_tiles[0]) return;  // a dead tile: the whole block leaves
  const long s0 = static_cast<long>(t) * bm;
  tile_item<T, MT, U, false>(a, a_rows, slot_row + s0, slot_out + s0,
                             tile_expert[t], w, part, blockIdx.x, blockIdx.y,
                             bm, k_dim, n_cols, k_chunk, out_rows, 0,
                             out_rows);
}

// One token's fold: sum over its choices in ascending expert order of
// w[f] * (the K slices of flat row f summed in slice order). ids / wt: the
// token's top-k ids and weights; f0: its first flat row in part.
__device__ __forceinline__ float fold_choices(const float* __restrict__ part,
                                              const int* __restrict__ ids,
                                              const float* __restrict__ wt,
                                              long f0, int topk, int splits,
                                              long mn, int n_cols, int col) {
  float acc = 0.f;
  int prev = -1;
  for (int j = 0; j < topk; ++j) {
    // the choice with the next larger expert id (a token's ids differ)
    int best = -1, best_id = INT_MAX;
    for (int c = 0; c < topk; ++c) {
      const int id = ids[c];
      if (id > prev && id < best_id) {
        best_id = id;
        best = c;
      }
    }
    if (best < 0) break;
    prev = best_id;
    const long f = f0 + best;
    float p = 0.f;
    for (int s = 0; s < splits; ++s)
      p += __ldcg(part + s * mn + f * n_cols + col);
    acc = __fadd_rn(acc, __fmul_rn(wt[best], p));
  }
  return acc;
}

// y[tok] = cast(fold_choices); one thread per (token, column).
template <typename T>
__global__ void __launch_bounds__(NT)
    combine_kernel(const float* __restrict__ part,
                   const int* __restrict__ topk_ids,
                   const float* __restrict__ topk_w, T* __restrict__ out,
                   int splits, int topk, int out_rows, int n_cols) {
  const int tok = blockIdx.y;
  const int col = blockIdx.x * NT + threadIdx.x;
  if (col >= n_cols) return;
  const long f0 = static_cast<long>(tok) * topk;
  out[static_cast<long>(tok) * n_cols + col] = td::from_f<T>(fold_choices(
      part, topk_ids + f0, topk_w + f0, f0, topk, splits,
      static_cast<long>(out_rows) * n_cols, n_cols, col));
}

template <typename T, int MT, int U>
cudaError_t launch_tiles(const void* a, int a_rows, const int* slot_row,
                         const int* slot_out, const int* tile_expert,
                         const int* used_tiles, const void* w, float* part,
                         int t_tiles, int bm, int k_dim, int n_cols,
                         int k_chunk, int splits, int out_rows,
                         cudaStream_t st) {
  constexpr int BN = 32 * td::kVec<T>;
  const dim3 grid((n_cols + BN - 1) / BN, splits, t_tiles);
  tile_gemm_kernel<T, MT, U><<<grid, NT, 0, st>>>(
      static_cast<const T*>(a), a_rows, slot_row, slot_out, tile_expert,
      used_tiles, static_cast<const T*>(w), part, bm, k_dim, n_cols, k_chunk,
      out_rows);
  return cudaGetLastError();
}

// MT from the most live rows a tile can hold (a token's choices differ, so
// an expert has at most M rows): one pass over the weights at decode.
template <typename T>
cudaError_t dispatch_tiles(int max_rows, const void* a, int a_rows,
                           const int* slot_row, const int* slot_out,
                           const int* tile_expert, const int* used_tiles,
                           const void* w, float* part, int t_tiles, int bm,
                           int k_dim, int n_cols, int k_chunk, int splits,
                           int out_rows, cudaStream_t st) {
#define TD_TILES(MT, U)                                                     \
  launch_tiles<T, MT, U>(a, a_rows, slot_row, slot_out, tile_expert,        \
                         used_tiles, w, part, t_tiles, bm, k_dim, n_cols,   \
                         k_chunk, splits, out_rows, st)
  if (max_rows == 1) return TD_TILES(1, 8);
  if (max_rows == 2) return TD_TILES(2, 8);
  if (max_rows <= 4) return TD_TILES(4, 8);
  return TD_TILES(8, 4);
#undef TD_TILES
}

bool bad_args(int a_rows, int t_tiles, int bm, int k_dim, int n_cols,
              int k_chunk, int splits, int out_rows, int max_rows) {
  return a_rows <= 0 || t_tiles <= 0 || t_tiles > 65535 || bm <= 0 ||
         bm > BM_MAX || k_dim <= 0 || n_cols <= 0 || k_chunk <= 0 ||
         splits <= 0 || splits > 65535 ||
         static_cast<long>(k_chunk) * splits < k_dim || out_rows <= 0 ||
         max_rows <= 0;
}

// -- across ranks -------------------------------------------------------------

// B14's flag for row block b of sender s, on the receiving rank's pad.
__device__ __forceinline__ int b14_flag(int s, int b, int nblk) {
  return td::dist::kUser + s * nblk + b;
}

// B14 across ranks. a_loc: this rank's (m, K) tokens; the schedule fields
// are the arrival-ordered ones of every chunk ((world, R), (world, T),
// (world,), tiles_ready (world, nblk)); part: f32 (splits, world * m *
// topk, N); ag_out: (world * m, K). The symmetric buffer holds (2, world,
// m, K) of the dtype: [parity][sender] gathered shards.
template <typename T, int MT, int U>
__global__ void __launch_bounds__(NT, 2)
    ag_group_gemm_kernel(const T* __restrict__ a_loc,
                         const int* __restrict__ row_token,
                         const int* __restrict__ row_flat,
                         const int* __restrict__ tile_expert,
                         const int* __restrict__ used_tiles,
                         const int* __restrict__ tiles_ready,
                         const T* __restrict__ w, float* __restrict__ part,
                         T* __restrict__ ag_out, Team team, u64* ctl, int m,
                         int k_dim, int n_cols, int t_tiles, int bm,
                         int nblk, int topk, int k_chunk, int splits) {
  constexpr int VEC = td::kVec<T>;
  constexpr int BN = 32 * VEC;
  const int me = team.rank, world = team.world, tid = threadIdx.x;
  const u64 e = td::dist::begin_call(ctl);
  const long shard = static_cast<long>(m) * k_dim;     // elements
  const long par = static_cast<long>(e & 1) * world;   // slot row of parity
  const int bb = m / nblk;
  const long blk = static_cast<long>(bb) * k_dim;      // elements per block

  // 1. push the own shard's row blocks into every peer's slot `me`: unit
  //    u = (peer, row block), its bytes split over the blocks u, u +
  //    units, ... of the grid (or the grid's blocks take whole units)
  const int units = (world - 1) * nblk;
  auto push = [&](int u, int share, int cnt) {
    const int p = (me + 1 + u / nblk) % world, b = u % nblk;
    const long bytes = blk * static_cast<long>(sizeof(T));
    const long per = ((bytes / 16 + cnt - 1) / cnt) * 16;
    const long lo = per * share < bytes ? per * share : bytes;
    const long hi = lo + per < bytes ? lo + per : bytes;
    T* dst = reinterpret_cast<T*>(team.peer(p)) + (par + me) * shard +
             b * blk;
    td::dist::put(reinterpret_cast<char*>(dst) + lo,
                  reinterpret_cast<const char*>(a_loc + b * blk) + lo,
                  hi - lo);
    __threadfence_system();
    __syncthreads();
    u64* count = ctl + td::dist::kCtlHeader + u;
    if (tid == 0 && atomicAdd(count, 1ull) == static_cast<u64>(cnt - 1)) {
      *count = 0;
      __threadfence_system();
      td::dist::notify(team.pad(p) + b14_flag(me, b, nblk), e);
    }
  };
  if (units > 0 && static_cast<int>(gridDim.x) >= units) {
    const int u = blockIdx.x % units;
    push(u, blockIdx.x / units, (gridDim.x - 1 - u) / units + 1);
  } else {
    for (int u = blockIdx.x; u < units; u += gridDim.x) push(u, 0, 1);
  }

  // 2. the tiles: the own chunk first (no wait), then the other chunks
  const T* gathered = reinterpret_cast<const T*>(team.peer(me)) +
                      par * shard;
  const int n_tiles = (n_cols + BN - 1) / BN;
  const long r_len = static_cast<long>(t_tiles) * bm;
  const int nf = m * topk;
  const long rows = static_cast<long>(world) * nf;
  auto chunk_at = [&](int ci) { return (me - ci + world) % world; };
  __shared__ LiveItems live;
  __shared__ unsigned long long landed;  // (sender, block) flags seen
  if (tid == 0) landed = 0ull;
  live.count(used_tiles, world, n_tiles, splits, chunk_at);
  for (int it = blockIdx.x; it < live.total(world); it += gridDim.x) {
    const Item x = live.at(it, splits);
    const int c = chunk_at(x.ci);
    const long s0 = c * r_len + static_cast<long>(x.t) * bm;
    const int expert = tile_expert[c * t_tiles + x.t];
    if (c == me) {
      tile_item<T, MT, U, false>(a_loc, m, row_token + s0, row_flat + s0,
                                 expert, w, part, x.nt, x.ks, bm, k_dim,
                                 n_cols, k_chunk, nf,
                                 static_cast<long>(c) * nf, rows);
      continue;
    }
    if (tid == 0) {
      int need = 0;  // blocks 0..need release this tile
      while (need < nblk - 1 && x.t >= tiles_ready[c * nblk + need]) ++need;
      for (int b = 0; b <= need; ++b) {
        const unsigned long long bit = 1ull << (c * nblk + b);
        if (!(landed & bit)) {
          td::dist::wait(team.pad(me) + b14_flag(c, b, nblk), e,
                         "B14 row block", c);
          landed |= bit;
        }
      }
    }
    __syncthreads();
    tile_item<T, MT, U, true>(gathered + c * shard, m, row_token + s0,
                              row_flat + s0, expert, w, part, x.nt, x.ks,
                              bm, k_dim, n_cols, k_chunk, nf,
                              static_cast<long>(c) * nf, rows);
  }

  // 3. the gathered tokens out to the caller's tensor, row block by row
  //    block (every rank waits for every flag of the call here)
  for (int u = blockIdx.x; u < world * nblk; u += gridDim.x) {
    const int c = u / nblk, b = u % nblk;
    const T* src = c == me ? a_loc + b * blk : gathered + c * shard + b * blk;
    if (c != me) {
      if (tid == 0) {
        const unsigned long long bit = 1ull << (c * nblk + b);
        if (!(landed & bit))
          td::dist::wait(team.pad(me) + b14_flag(c, b, nblk), e,
                         "B14 row block", c);
      }
      __syncthreads();
    }
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(ag_out + c * shard + b * blk);
    for (long i = tid; i < blk / VEC; i += NT) d[i] = __ldcg(s + i);
  }
  td::dist::end_call(ctl, e);
}

// B15 across ranks. inter: (world * mc * topk, K) token-major; schedule
// fields of every chunk; topk_ids / topk_w: (world * mc, topk); part: f32
// (splits, world * mc * topk, N); out: this rank's (mc, N) rows. The
// symmetric buffer holds (2, world, mc, N) f32: [parity][sender] partials
// of this rank's chunk. ctl: the header, a counter per (chunk, column
// tile), a counter per chunk.
template <typename T, int MT, int U>
__global__ void __launch_bounds__(NT, 2)
    moe_rs_tp_kernel(const T* __restrict__ inter,
                     const int* __restrict__ row_flat,
                     const int* __restrict__ tile_expert,
                     const int* __restrict__ used_tiles,
                     const T* __restrict__ w,
                     const int* __restrict__ topk_ids,
                     const float* __restrict__ topk_w,
                     float* __restrict__ part, T* __restrict__ out, Team team,
                     u64* ctl, int mc, int topk, int k_dim, int n_cols,
                     int t_tiles, int bm, int k_chunk, int splits) {
  constexpr int BN = 32 * td::kVec<T>;
  const int me = team.rank, world = team.world, tid = threadIdx.x;
  const u64 e = td::dist::begin_call(ctl);
  const long slot = static_cast<long>(mc) * n_cols;    // floats per slot
  const long par = static_cast<long>(e & 1) * world;
  const int n_tiles = (n_cols + BN - 1) / BN;
  const long r_len = static_cast<long>(t_tiles) * bm;
  const int nf = mc * topk;
  const long rows = static_cast<long>(world) * nf;
  const long mn = rows * n_cols;
  u64* tile_done = ctl + td::dist::kCtlHeader;        // world * n_tiles
  u64* chunk_done = tile_done + world * n_tiles;       // world
  // the other ranks' chunks first, the own one last
  auto chunk_at = [&](int ci) { return (me - 1 - ci + 2 * world) % world; };
  __shared__ LiveItems live;
  __shared__ bool last;
  live.count(used_tiles, world, n_tiles, splits, chunk_at);

  for (int it = blockIdx.x; it < live.total(world); it += gridDim.x) {
    const Item x = live.at(it, splits);
    const int c = chunk_at(x.ci);
    const int used = live.used[x.ci];
    const long s0 = c * r_len + static_cast<long>(x.t) * bm;
    tile_item<T, MT, U, false>(inter + static_cast<long>(c) * nf * k_dim,
                               nf, row_flat + s0, row_flat + s0,
                               tile_expert[c * t_tiles + x.t], w, part, x.nt,
                               x.ks, bm, k_dim, n_cols, k_chunk, nf,
                               static_cast<long>(c) * nf, rows);
    // the last item of (chunk c, column tile nt) folds and ships it
    __threadfence();
    __syncthreads();
    u64* done = tile_done + c * n_tiles + x.nt;
    if (tid == 0)
      last = atomicAdd(done, 1ull) == static_cast<u64>(used) * splits - 1;
    __syncthreads();
    if (!last) continue;
    if (tid == 0) *done = 0;
    __threadfence();
    float* dst = reinterpret_cast<float*>(team.peer(c)) + (par + me) * slot;
    for (int i = tid; i < mc * BN; i += NT) {
      const int tok = i / BN, col = x.nt * BN + i % BN;
      if (col >= n_cols) continue;
      const long f0 = (static_cast<long>(c) * mc + tok) * topk;
      dst[static_cast<long>(tok) * n_cols + col] = fold_choices(
          part, topk_ids + f0, topk_w + f0, f0, topk, splits, mn, n_cols,
          col);
    }
    __threadfence_system();
    __syncthreads();
    if (tid == 0 && atomicAdd(chunk_done + c, 1ull) ==
                        static_cast<u64>(n_tiles - 1)) {
      chunk_done[c] = 0;
      __threadfence_system();
      td::dist::notify(team.pad(c) + td::dist::kUser + me, e);
    }
  }

  // fold the rank's own rows: slot 0 + slot 1 + ... + slot world-1
  const float* slots = reinterpret_cast<const float*>(team.peer(me)) +
                       par * slot;
  const long vecs = slot / 4;  // n_cols is a multiple of 4
  const long first = static_cast<long>(blockIdx.x) * NT;
  if (first < vecs) {
    if (tid == 0)
      for (int s = 0; s < world; ++s)
        td::dist::wait(team.pad(me) + td::dist::kUser + s, e,
                       "B15 partials", s);
    __syncthreads();
    for (long v = first + tid; v < vecs;
         v += static_cast<long>(gridDim.x) * NT) {
      float4 acc = __ldcg(reinterpret_cast<const float4*>(slots) + v);
      for (int s = 1; s < world; ++s) {
        const float4 y =
            __ldcg(reinterpret_cast<const float4*>(slots + s * slot) + v);
        acc.x += y.x;
        acc.y += y.y;
        acc.z += y.z;
        acc.w += y.w;
      }
      T* o = out + v * 4;
      o[0] = td::from_f<T>(acc.x);
      o[1] = td::from_f<T>(acc.y);
      o[2] = td::from_f<T>(acc.z);
      o[3] = td::from_f<T>(acc.w);
    }
  }
  td::dist::end_call(ctl, e);
}

// Occupancy of B14's and B15's kernels across ranks and the card's SMs,
// queried once per instantiation (the first call of either, never under a
// CUDA-graph capture: callers warm up first). It loads both kernels and
// B14's K-slice sum: a layer launches B14 then B15, and under lazy module
// loading a first launch may load its kernel, which may synchronize the
// context while a rank spins for a peer not yet launched.
struct TpLaunch {
  int sms = 0, occ14 = 0, occ15 = 0;
};

template <typename T, int MT, int U>
cudaError_t tp_launch_info(TpLaunch* out) {
  static TpLaunch info;
  cudaError_t err = cudaSuccess;
  if (info.occ14 == 0) {
    int dev = 0;
    TpLaunch q;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&q.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &q.occ14, ag_group_gemm_kernel<T, MT, U>, NT, 0);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &q.occ15, moe_rs_tp_kernel<T, MT, U>, NT, 0);
    cudaFuncAttributes attr;
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr, td_gemm::reduce_kernel<T>);
    if (err != cudaSuccess) return err;
    info = q;
  }
  *out = info;
  return err;
}

template <typename T, int MT, int U>
cudaError_t launch_ag_group(const void* a, const int* row_token,
                            const int* row_flat, const int* tile_expert,
                            const int* used_tiles, const int* tiles_ready,
                            const void* w, float* part, void* out,
                            void* ag_out, const Team& team, u64* ctl, int m,
                            int k_dim, int n_cols, int t_tiles, int bm,
                            int nblk, int topk, int k_chunk, int splits,
                            int rpd, cudaStream_t st) {
  constexpr int BN = 32 * td::kVec<T>;
  TpLaunch info;
  cudaError_t err = tp_launch_info<T, MT, U>(&info);
  if (err != cudaSuccess) return err;
  const long items = static_cast<long>(team.world) * t_tiles *
                     ((n_cols + BN - 1) / BN) * splits;
  const unsigned grid = resident_grid(info.occ14, info.sms, rpd, items);
  if (grid < 1) return cudaErrorInvalidConfiguration;
  ag_group_gemm_kernel<T, MT, U><<<grid, NT, 0, st>>>(
      static_cast<const T*>(a), row_token, row_flat, tile_expert, used_tiles,
      tiles_ready, static_cast<const T*>(w), part, static_cast<T*>(ag_out),
      team, ctl, m, k_dim, n_cols, t_tiles, bm, nblk, topk, k_chunk, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long mn = static_cast<long>(team.world) * m * topk * n_cols;
  td_gemm::reduce_kernel<T><<<static_cast<unsigned>((mn + NT - 1) / NT), NT,
                              0, st>>>(part, static_cast<T*>(out), splits,
                                       mn);
  return cudaGetLastError();
}

template <typename T, int MT, int U>
cudaError_t launch_moe_rs_tp(const void* inter, const int* row_flat,
                             const int* tile_expert, const int* used_tiles,
                             const void* w, const int* topk_ids,
                             const float* topk_w, float* part, void* out,
                             const Team& team, u64* ctl, int mc, int topk,
                             int k_dim, int n_cols, int t_tiles, int bm,
                             int k_chunk, int splits, int rpd,
                             cudaStream_t st) {
  constexpr int BN = 32 * td::kVec<T>;
  TpLaunch info;
  cudaError_t err = tp_launch_info<T, MT, U>(&info);
  if (err != cudaSuccess) return err;
  const long items = static_cast<long>(team.world) * t_tiles *
                     ((n_cols + BN - 1) / BN) * splits;
  const unsigned grid = resident_grid(info.occ15, info.sms, rpd, items);
  if (grid < 1) return cudaErrorInvalidConfiguration;
  moe_rs_tp_kernel<T, MT, U><<<grid, NT, 0, st>>>(
      static_cast<const T*>(inter), row_flat, tile_expert, used_tiles,
      static_cast<const T*>(w), topk_ids, topk_w, part, static_cast<T*>(out),
      team, ctl, mc, topk, k_dim, n_cols, t_tiles, bm, k_chunk, splits);
  return cudaGetLastError();
}

bool bad_team(int rank, int world, int rpd) {
  return world < 1 || world > td::dist::kMaxWorld || rank < 0 ||
         rank >= world || rpd < 1;
}

}  // namespace

// B14 at world 1. a: tokens (a_rows, K); row_token / row_flat /
// tile_expert / used_tiles: the chunk's schedule (R = t_tiles * bm slots,
// int32 on the device); w: (E, K, N); part: f32 (splits, out_rows, N)
// workspace; out: (out_rows = M * topk, N) token-major, f32 when out_f32 is
// set (the expert-parallel layer's down product) and else a's dtype; a
// row no live slot writes is the sum of its rows of `part`. One dtype
// (td::F32 or td::BF16) for a and w; w 16-byte aligned, N a multiple of
// the 16-byte vector. Returns a cudaError_t.
extern "C" int td_group_gemm(const void* a, int a_rows, const int* row_token,
                             const int* row_flat, const int* tile_expert,
                             const int* used_tiles, const void* w, void* part,
                             void* out, int t_tiles, int bm, int k_dim,
                             int n_cols, int k_chunk, int splits,
                             int out_rows, int max_rows, int dtype,
                             int out_f32, void* stream) {
  if (bad_args(a_rows, t_tiles, bm, k_dim, n_cols, k_chunk, splits,
               out_rows, max_rows))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const long mn = static_cast<long>(out_rows) * n_cols;
  const unsigned blocks = static_cast<unsigned>((mn + NT - 1) / NT);
  cudaError_t err;
  if (dtype == td::F32 && n_cols % td::kVec<float> == 0) {
    err = dispatch_tiles<float>(max_rows, a, a_rows, row_token, row_flat,
                                tile_expert, used_tiles, w, p, t_tiles, bm,
                                k_dim, n_cols, k_chunk, splits, out_rows, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    td_gemm::reduce_kernel<float><<<blocks, NT, 0, st>>>(
        p, static_cast<float*>(out), splits, mn);
  } else if (dtype == td::BF16 && n_cols % td::kVec<__nv_bfloat16> == 0) {
    err = dispatch_tiles<__nv_bfloat16>(
        max_rows, a, a_rows, row_token, row_flat, tile_expert, used_tiles, w,
        p, t_tiles, bm, k_dim, n_cols, k_chunk, splits, out_rows, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (out_f32)
      td_gemm::reduce_kernel<float><<<blocks, NT, 0, st>>>(
          p, static_cast<float*>(out), splits, mn);
    else
      td_gemm::reduce_kernel<__nv_bfloat16><<<blocks, NT, 0, st>>>(
          p, static_cast<__nv_bfloat16*>(out), splits, mn);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// B15 at world 1. inter: (a_rows = M * topk, K) token-major; row_flat /
// tile_expert / used_tiles: the chunk's schedule; w: (E, K, N); topk_ids
// (M, topk) int32 and topk_w (M, topk) f32; part: f32 (splits, M * topk, N)
// workspace; out: (M, N). One dtype (td::F32 or td::BF16) for inter, w and
// out. Returns a cudaError_t.
extern "C" int td_moe_rs(const void* inter, int a_rows, const int* row_flat,
                         const int* tile_expert, const int* used_tiles,
                         const void* w, const int* topk_ids,
                         const float* topk_w, void* part, void* out,
                         int t_tiles, int bm, int k_dim, int n_cols,
                         int k_chunk, int splits, int m_tokens, int topk,
                         int max_rows, int dtype, void* stream) {
  const int out_rows = m_tokens * topk;
  if (bad_args(a_rows, t_tiles, bm, k_dim, n_cols, k_chunk, splits,
               out_rows, max_rows) ||
      m_tokens <= 0 || m_tokens > 65535 || topk <= 0 || a_rows != out_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  const dim3 grid((n_cols + NT - 1) / NT, m_tokens);
  cudaError_t err;
  if (dtype == td::F32 && n_cols % td::kVec<float> == 0) {
    err = dispatch_tiles<float>(max_rows, inter, a_rows, row_flat, row_flat,
                                tile_expert, used_tiles, w, p, t_tiles, bm,
                                k_dim, n_cols, k_chunk, splits, out_rows, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    combine_kernel<float><<<grid, NT, 0, st>>>(
        p, topk_ids, topk_w, static_cast<float*>(out), splits, topk,
        out_rows, n_cols);
  } else if (dtype == td::BF16 && n_cols % td::kVec<__nv_bfloat16> == 0) {
    err = dispatch_tiles<__nv_bfloat16>(
        max_rows, inter, a_rows, row_flat, row_flat, tile_expert, used_tiles,
        w, p, t_tiles, bm, k_dim, n_cols, k_chunk, splits, out_rows, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    combine_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        p, topk_ids, topk_w, static_cast<__nv_bfloat16*>(out), splits, topk,
        out_rows, n_cols);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// MT and U from the most live rows a tile can hold, as dispatch_tiles.
#define TD_TP_DISPATCH(T, CALL)                         \
  (max_rows == 1   ? CALL(T, 1, 8)                      \
   : max_rows == 2 ? CALL(T, 2, 8)                      \
   : max_rows <= 4 ? CALL(T, 4, 8)                      \
                   : CALL(T, 8, 4))

// B14 across ranks. a: this rank's (m, K) tokens; row_token / row_flat
// (world, R), tile_expert (world, T), used_tiles (world,): every chunk's
// arrival-ordered schedule; tiles_ready (world, nblk); w: (E, K, N) the
// rank's gate/up shard; part: f32 (splits, world * m * topk, N); out:
// (world * m * topk, N) token-major; ag_out: (world * m, K); base: device
// table of every rank's symmetric buffer ((2, world, m, K) of the dtype,
// signal pad at sig_off); ctl: this rank's control block (4 + (world - 1)
// * nblk u64, zeroed once); ranks_per_device: ranks sharing this card.
// One dtype; K and N multiples of the 16-byte vector; m a multiple of
// nblk; 16-byte aligned pointers. Returns a cudaError_t.
extern "C" int td_ag_group_gemm(
    const void* a, const int* row_token, const int* row_flat,
    const int* tile_expert, const int* used_tiles, const int* tiles_ready,
    const void* w, void* part, void* out, void* ag_out, int rank, int world,
    const void* base, long long sig_off, void* ctl, int m, int k_dim,
    int n_cols, int t_tiles, int bm, int nblk, int topk, int k_chunk,
    int splits, int max_rows, int ranks_per_device, int dtype,
    void* stream) {
  if (bad_team(rank, world, ranks_per_device) ||
      bad_args(m, t_tiles, bm, k_dim, n_cols, k_chunk, splits, m * topk,
               max_rows) ||
      topk <= 0 || nblk <= 0 || m % nblk ||
      world * nblk > td::dist::kPadWords - td::dist::kUser ||
      part == nullptr || ag_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), sig_off};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* c = static_cast<u64*>(ctl);
  float* p = static_cast<float*>(part);
#define TD_AG_CALL(T, MT, U)                                                \
  launch_ag_group<T, MT, U>(a, row_token, row_flat, tile_expert, used_tiles, \
                            tiles_ready, w, p, out, ag_out, team, c, m,     \
                            k_dim, n_cols, t_tiles, bm, nblk, topk,         \
                            k_chunk, splits, ranks_per_device, st)
  if (dtype == td::F32 && n_cols % td::kVec<float> == 0 &&
      k_dim % td::kVec<float> == 0)
    return static_cast<int>(TD_TP_DISPATCH(float, TD_AG_CALL));
  if (dtype == td::BF16 && n_cols % td::kVec<__nv_bfloat16> == 0 &&
      k_dim % td::kVec<__nv_bfloat16> == 0)
    return static_cast<int>(TD_TP_DISPATCH(__nv_bfloat16, TD_AG_CALL));
#undef TD_AG_CALL
  return static_cast<int>(cudaErrorInvalidValue);
}

// B15 across ranks. inter: (world * mc * topk, K) token-major; row_flat
// (world, R), tile_expert (world, T), used_tiles (world,): every chunk's
// schedule; w: (E, K, N) the rank's down shard; topk_ids (world * mc,
// topk) int32 and topk_w f32; part: f32 (splits, world * mc * topk, N);
// out: this rank's (mc, N) rows; base: device table of every rank's
// symmetric buffer ((2, world, mc, N) f32, signal pad at sig_off); ctl:
// this rank's control block (4 + world * ceil(N / BN) + world u64, zeroed
// once). One dtype for inter, w and out; N a multiple of the 16-byte
// vector. Returns a cudaError_t.
extern "C" int td_moe_rs_tp(
    const void* inter, const int* row_flat, const int* tile_expert,
    const int* used_tiles, const void* w, const int* topk_ids,
    const float* topk_w, void* part, void* out, int rank, int world,
    const void* base, long long sig_off, void* ctl, int mc, int topk,
    int k_dim, int n_cols, int t_tiles, int bm, int k_chunk, int splits,
    int max_rows, int ranks_per_device, int dtype, void* stream) {
  if (bad_team(rank, world, ranks_per_device) ||
      bad_args(mc * topk, t_tiles, bm, k_dim, n_cols, k_chunk, splits,
               mc * topk, max_rows) ||
      mc <= 0 || topk <= 0 || part == nullptr ||
      world > td::dist::kPadWords - td::dist::kUser)
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), sig_off};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* c = static_cast<u64*>(ctl);
  float* p = static_cast<float*>(part);
#define TD_RS_CALL(T, MT, U)                                                 \
  launch_moe_rs_tp<T, MT, U>(inter, row_flat, tile_expert, used_tiles, w,    \
                             topk_ids, topk_w, p, out, team, c, mc, topk,    \
                             k_dim, n_cols, t_tiles, bm, k_chunk, splits,    \
                             ranks_per_device, st)
  if (dtype == td::F32 && n_cols % td::kVec<float> == 0)
    return static_cast<int>(TD_TP_DISPATCH(float, TD_RS_CALL));
  if (dtype == td::BF16 && n_cols % td::kVec<__nv_bfloat16> == 0)
    return static_cast<int>(TD_TP_DISPATCH(__nv_bfloat16, TD_RS_CALL));
#undef TD_RS_CALL
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef TD_TP_DISPATCH
