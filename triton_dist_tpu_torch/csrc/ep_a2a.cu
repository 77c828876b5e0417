// B17 (the low-latency all-to-all), B18 (its fp8 form) and B16 (the
// expert-parallel dispatch fused with the gate/up grouped GEMM) across
// ranks, hand-written for Hopper (sm_90a).
//
// Replace the TPU kernels kernels/low_latency_all_to_all.py::_ll_a2a_kernel
// (B17) and ::_ll_a2a_kernel_q (B18), and kernels/ep_a2a.py::
// _ep_a2a_gg_kernel (B16) of the JAX package.
//  * B17: every rank holds x (n, max_m, K), slot p the rows for peer p;
//    rank r returns (n, max_m, K) whose slot s is what rank s sent to r
//    (lax.all_to_all's tiled layout, NCCL all_to_all_single's). Bytes are
//    moved, not values: any dtype whose rows are multiples of 16 bytes.
//  * B18: B17 over two payloads in one launch, the fp8 rows (n, max_m, K)
//    and their packed f32 scales (n, ceil(max_m / 128), 128), one flag per
//    (block, sender) raised after both. The quantize and dequantize steps
//    stay outside (kernels/low_latency_all_to_all.py), as in the reference.
//  * B16: B17's exchange of the dispatch payload, in row blocks, with the
//    receiver's gate/up grouped GEMM over its experts fused in:
//    inter[s * max_m + j] = cast(recv[s][j] @ W[expert of slot j of sender
//    s]) with f32 accumulation for every live slot (j below the count that
//    sender s sent), 0 for the pad slots; also the received rows
//    (n * max_m, K), bytes unchanged.
//
// What bounds them on this card. Qwen3-30B-A3B at EP=4, decode (B=16: 4
// tokens a rank, max_m = 4 x top-8 = 32): a payload slot is 32 x 2048 bf16
// = 128 KB, so B17 sends 3 x 128 KB out of each card, ~0.9 us at 450 GB/s:
// bound by the flag round trip and the launch, not by bytes. B16 reads the
// live experts' gate/up slabs (2048 x 1536 bf16, 6.3 MB each, ~20 live
// experts a rank): ~126 MB, ~38 us at 3.35 TB/s, bound by bytes.
//
// Design:
//  * B17 / B18: a plan (kernels/low_latency_all_to_all.py::a2a_plan, the
//    same on every rank) fixes the grid G, the protocol and the landing
//    slots ([parity][sender] of each payload). Block b owns a fixed
//    contiguous share, 1/G, of the 16-byte vectors of every slot of each
//    payload (column slices left 32-byte runs per row: at a 512-token
//    chunk the one-card world's four ranks took 1.42 ms on an H100, plain
//    copies 0.19 ms). Block b stores its share of slot p into peer p's
//    landing slot `rank` (a thread loads its item of every peer's slot
//    before it stores any) and copies its share of its own slot straight
//    to the output, with no wait; then it copies its share of the landed
//    slots out. Two protocols, by the bytes of a slot of the first
//    payload (A2A_LL_MAX_SLOT_BYTES, from a four-card sweep), through
//    td_oneshot.cuh's put_vec / get_vec and waits: LL lines (each 16-byte
//    vector as two lines that carry the call's epoch; no fence, no flag:
//    the receiver reads each line as it lands, straight into the output;
//    the decode dispatch and combine, B18's fp8 rows and scales), or
//    flags (plain stores, then one flag per (block, sender) raised after
//    a system fence, td_oneshot.cuh exchange_flags: the 512-token chunk).
//    An epoch word a block in the control block. No block waits for
//    another block of its own rank;
//  * B16: the push of B14 across ranks (moe_group_gemm.cu), from slot p of
//    the payload to peer p: each (peer, row block) is split over the grid,
//    and the last block to finish it raises one epoch flag per (sender,
//    row block) on the peer. Then the persistent grid runs the expert tiles
//    (moe_tile.cuh tile_item, B14's work item): the own slot's first, with
//    no wait, then each sender's in the arrival-ordered schedule over the
//    received ids (moe_utils.arrival_ordered_schedule), a tile waiting only
//    for the row blocks it reads. Each live slot's f32 sums go to the
//    slot's own row, so the result is in slot order with no aligned buffer
//    and the pad slots (the sentinel expert's tiles) are never computed; a
//    second kernel sums the K slices in slice order, casts, and writes 0
//    to the pad slots. Last, the received rows are copied out;
//  * flags carry the call's epoch, waits are bounded and trap naming the
//    flag, and no barrier opens a call: every landing region is
//    double-buffered by the epoch's parity (as B5, B7, B8, B14). A rank
//    writes a peer's parity-p region of call e + 2 only after it finished
//    call e + 1, which needed that peer's data of call e + 1, which the
//    peer sends only once its call e kernel, the last reader of the
//    region, had ended;
//  * the grids are small enough that every block of every rank sharing the
//    card is resident at once (occupancy x SMs / ranks per card), and the
//    first call of B16 loads B17's kernel too (a layer launches B16, then
//    B17 for the combine; a lazy load behind a spinning kernel could wait
//    for ranks not yet launched on a shared card).

#include "moe_tile.cuh"
#include "td_oneshot.cuh"

namespace {

namespace os = td::oneshot;

using td::dist::Team;
using td::dist::u64;

// One payload of the all-to-all: x and out hold (world, rows, kv) 16-byte
// vectors; its landing slots (2, world) of rows x kv vectors (as plain
// vectors or LL lines) start at byte `land` of every rank's symmetric
// buffer. rows == 0: no payload.
struct Payload {
  const uint4* x;
  uint4* out;
  int rows, kv;
  long land;
};

// This block's share of every slot of a payload: the contiguous vectors
// [v0, v0 + nv) of the slot's rows * kv (nv may be 0 when the grid is
// wider than the payload).
struct Share {
  long v0, nv;
  __device__ explicit Share(long slot) {
    v0 = static_cast<long>(blockIdx.x) * slot / gridDim.x;
    nv = static_cast<long>(blockIdx.x + 1) * slot / gridDim.x - v0;
  }
};

// Sender s's landing slot of parity par on rank p.
template <bool LL>
__device__ __forceinline__ char* landing(const Payload& pl, const Team& t,
                                         int p, int par, int s) {
  const long slot = static_cast<long>(pl.rows) * pl.kv * (LL ? 32 : 16);
  return t.peer(p) + pl.land + (static_cast<long>(par) * t.world + s) * slot;
}

// Block b's share of slot q of every peer q into that peer's landing slot
// `rank` (parity `par`, tagged f under LL), and of the own slot into the
// output. A thread loads its item of every peer's slot before it stores
// any, so their latencies overlap.
template <bool LL>
__device__ __forceinline__ void push_payload(const Payload& p, const Team& t,
                                             int par, unsigned f) {
  const long slot = static_cast<long>(p.rows) * p.kv;
  const int me = t.rank, n = t.world;
  const Share sh(slot);
  for (long j = threadIdx.x; j < sh.nv; j += NT) {
    const long v = sh.v0 + j;
    uint4 val[os::kPeers];
#pragma unroll
    for (int i = 0; i < os::kPeers; ++i)
      if (i < n - 1) val[i] = p.x[((me + 1 + i) % n) * slot + v];
#pragma unroll
    for (int i = 0; i < os::kPeers; ++i)
      if (i < n - 1)
        os::put_vec<LL>(landing<LL>(p, t, (me + 1 + i) % n, par, me), v,
                        val[i], f);
    p.out[me * slot + v] = p.x[me * slot + v];
  }
}

// Block b's share of the landed slots (parity `par`) into the output, each
// vector as its LL lines land (or after the flags).
template <bool LL>
__device__ __forceinline__ void take_payload(const Payload& p, const Team& t,
                                             int par, unsigned f) {
  const long slot = static_cast<long>(p.rows) * p.kv;
  const Share sh(slot);
  for (int i = 1; i < t.world; ++i) {
    const int s = (t.rank + i) % t.world;
    const char* land = landing<LL>(p, t, t.rank, par, s);
    uint4* out = p.out + s * slot;
    for (long j = threadIdx.x; j < sh.nv; j += NT)
      out[sh.v0 + j] = os::get_vec<LL>(land, sh.v0 + j, f,
                                       "B17 all-to-all line", s);
  }
}

// B17 (p1.rows == 0) and B18 (both payloads). Flags (G, world - 1) u64 at
// flag_off of the symmetric buffer (flags protocol only); the block's
// epoch word at ctl[kCtlHeader + b].
template <bool LL>
__global__ void __launch_bounds__(NT)
    ll_a2a_kernel(Payload p0, Payload p1, Team team, u64* ctl,
                  long flag_off) {
  const os::Epoch ep(ctl);
  const int par = static_cast<int>(ep.e & 1);
  const unsigned f = static_cast<unsigned>(ep.e);
  push_payload<LL>(p0, team, par, f);
  if (p1.rows > 0) push_payload<LL>(p1, team, par, f);
  if (!LL) os::exchange_flags(team, flag_off, ep.e, "B17 all-to-all slot");
  take_payload<LL>(p0, team, par, f);
  if (p1.rows > 0) take_payload<LL>(p1, team, par, f);
  ep.close();
}

// B16's flag for row block b of sender s, on the receiving rank's pad.
__device__ __forceinline__ int gg_flag(int s, int b, int nblk) {
  return td::dist::kUser + s * nblk + b;
}

// B16. send: (world, max_m, K), slot p the payload for peer p; the
// schedule fields are the arrival-ordered ones of every sender's slot
// ((world, R), (world, T), (world,), tiles_ready (world, nblk)); part: f32
// (splits, world * max_m, N); recv_out: (world, max_m, K). The symmetric
// buffer holds (2, world, max_m, K) of the dtype: [parity][sender] slots.
template <typename T, int MT, int U>
__global__ void __launch_bounds__(NT, 2)
    dispatch_gg_kernel(const T* __restrict__ send,
                       const int* __restrict__ row_token,
                       const int* __restrict__ row_flat,
                       const int* __restrict__ tile_expert,
                       const int* __restrict__ used_tiles,
                       const int* __restrict__ tiles_ready,
                       const T* __restrict__ w, float* __restrict__ part,
                       T* __restrict__ recv_out, Team team, u64* ctl,
                       int max_m, int k_dim, int n_cols, int t_tiles, int bm,
                       int nblk, int k_chunk, int splits) {
  constexpr int VEC = td::kVec<T>;
  constexpr int BN = 32 * VEC;
  const int me = team.rank, world = team.world, tid = threadIdx.x;
  const u64 e = td::dist::begin_call(ctl);
  const long shard = static_cast<long>(max_m) * k_dim;  // elements a slot
  const long par = static_cast<long>(e & 1) * world;
  const int bb = max_m / nblk;
  const long blk = static_cast<long>(bb) * k_dim;      // elements a block

  // 1. slot p's row blocks into peer p's landing slot `me`: unit u =
  //    (peer, row block), its bytes split over the blocks u, u + units,
  //    ... of the grid (or the grid's blocks take whole units)
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
                  reinterpret_cast<const char*>(send + p * shard + b * blk) +
                      lo,
                  hi - lo);
    __threadfence_system();
    __syncthreads();
    u64* count = ctl + td::dist::kCtlHeader + u;
    if (tid == 0 && atomicAdd(count, 1ull) == static_cast<u64>(cnt - 1)) {
      *count = 0;
      __threadfence_system();
      td::dist::notify(team.pad(p) + gg_flag(me, b, nblk), e);
    }
  };
  if (units > 0 && static_cast<int>(gridDim.x) >= units) {
    const int u = blockIdx.x % units;
    push(u, blockIdx.x / units, (gridDim.x - 1 - u) / units + 1);
  } else {
    for (int u = blockIdx.x; u < units; u += gridDim.x) push(u, 0, 1);
  }

  // 2. the tiles: the own slot first (no wait), then the other senders'
  const T* landed = reinterpret_cast<const T*>(team.peer(me)) + par * shard;
  const T* own = send + me * shard;
  const int n_tiles = (n_cols + BN - 1) / BN;
  const long r_len = static_cast<long>(t_tiles) * bm;
  const long rows = static_cast<long>(world) * max_m;
  auto chunk_at = [&](int ci) { return (me - ci + world) % world; };
  __shared__ LiveItems live;
  __shared__ unsigned long long seen;  // (sender, block) flags seen
  if (tid == 0) seen = 0ull;
  live.count(used_tiles, world, n_tiles, splits, chunk_at);
  for (int it = blockIdx.x; it < live.total(world); it += gridDim.x) {
    const Item x = live.at(it, splits);
    const int c = chunk_at(x.ci);
    const long s0 = c * r_len + static_cast<long>(x.t) * bm;
    const int expert = tile_expert[c * t_tiles + x.t];
    if (c == me) {
      tile_item<T, MT, U, false>(own, max_m, row_token + s0, row_flat + s0,
                                 expert, w, part, x.nt, x.ks, bm, k_dim,
                                 n_cols, k_chunk, max_m,
                                 static_cast<long>(c) * max_m, rows);
      continue;
    }
    if (tid == 0) {
      int need = 0;  // blocks 0..need release this tile
      while (need < nblk - 1 && x.t >= tiles_ready[c * nblk + need]) ++need;
      for (int b = 0; b <= need; ++b) {
        const unsigned long long bit = 1ull << (c * nblk + b);
        if (!(seen & bit)) {
          td::dist::wait(team.pad(me) + gg_flag(c, b, nblk), e,
                         "B16 row block", c);
          seen |= bit;
        }
      }
    }
    __syncthreads();
    tile_item<T, MT, U, true>(landed + c * shard, max_m, row_token + s0,
                              row_flat + s0, expert, w, part, x.nt, x.ks, bm,
                              k_dim, n_cols, k_chunk, max_m,
                              static_cast<long>(c) * max_m, rows);
  }

  // 3. the received rows out to the caller's tensor, row block by row
  //    block (every rank waits for every flag of the call here)
  constexpr int EV = 16 / static_cast<int>(sizeof(T));
  for (int u = blockIdx.x; u < world * nblk; u += gridDim.x) {
    const int c = u / nblk, b = u % nblk;
    const T* src = c == me ? own + b * blk : landed + c * shard + b * blk;
    if (c != me) {
      if (tid == 0) {
        const unsigned long long bit = 1ull << (c * nblk + b);
        if (!(seen & bit))
          td::dist::wait(team.pad(me) + gg_flag(c, b, nblk), e,
                         "B16 row block", c);
      }
      __syncthreads();
    }
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(recv_out + c * shard + b * blk);
    for (long i = tid; i < blk / EV; i += NT) d[i] = __ldcg(s + i);
  }
  td::dist::end_call(ctl, e);
}

// inter[i] = cast(sum of the K slices of part, in slice order) for the
// rows of live slots (slot j of sender s with j < counts[s]), 0 for the
// pad slots.
template <typename T>
__global__ void __launch_bounds__(NT)
    slot_reduce_kernel(const float* __restrict__ part,
                       const int* __restrict__ counts, T* __restrict__ out,
                       int splits, int max_m, int n_cols, long mn) {
  const long i = static_cast<long>(blockIdx.x) * NT + threadIdx.x;
  if (i >= mn) return;
  const long row = i / n_cols;
  float sum = 0.f;
  if (row % max_m < counts[row / max_m])
    for (int s = 0; s < splits; ++s) sum += part[s * mn + i];
  out[i] = td::from_f<T>(sum);
}

// Occupancy of B17 / B18's kernel (the lower of its two protocols' forms)
// and the card's SMs, queried once (the first call; never under a
// CUDA-graph capture: callers warm up first). The query also loads both
// forms.
struct A2aLaunch {
  int sms = 0, occ = 0;
};

cudaError_t a2a_launch_info(A2aLaunch* out) {
  static A2aLaunch info;
  cudaError_t err = cudaSuccess;
  if (info.occ == 0) {
    int dev = 0;
    A2aLaunch q;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&q.sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    int occ_ll = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &q.occ, ll_a2a_kernel<false>, NT, 0);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ_ll, ll_a2a_kernel<true>, NT, 0);
    if (err != cudaSuccess) return err;
    q.occ = q.occ < occ_ll ? q.occ : occ_ll;
    info = q;
  }
  *out = info;
  return err;
}

// B16's occupancy, queried once per instantiation; it loads B16's kernels
// and B17's.
template <typename T, int MT, int U>
cudaError_t gg_launch_info(int* occ, int* sms) {
  static int occ_gg = 0;
  A2aLaunch a2a;
  cudaError_t err = a2a_launch_info(&a2a);
  if (err != cudaSuccess) return err;
  if (occ_gg == 0) {
    int q = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &q, dispatch_gg_kernel<T, MT, U>, NT, 0);
    cudaFuncAttributes attr;
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr, slot_reduce_kernel<T>);
    if (err != cudaSuccess) return err;
    occ_gg = q;
  }
  *occ = occ_gg;
  *sms = a2a.sms;
  return err;
}

template <typename T, int MT, int U>
cudaError_t launch_dispatch_gg(const void* send, const int* row_token,
                               const int* row_flat, const int* tile_expert,
                               const int* used_tiles, const int* tiles_ready,
                               const int* counts, const void* w, float* part,
                               void* inter, void* recv, const Team& team,
                               u64* ctl, int max_m, int k_dim, int n_cols,
                               int t_tiles, int bm, int nblk, int k_chunk,
                               int splits, int rpd, cudaStream_t st) {
  constexpr int BN = 32 * td::kVec<T>;
  int occ = 0, sms = 0;
  cudaError_t err = gg_launch_info<T, MT, U>(&occ, &sms);
  if (err != cudaSuccess) return err;
  const long items = static_cast<long>(team.world) * t_tiles *
                     ((n_cols + BN - 1) / BN) * splits;
  const unsigned grid = resident_grid(occ, sms, rpd, items);
  if (grid < 1) return cudaErrorInvalidConfiguration;
  dispatch_gg_kernel<T, MT, U><<<grid, NT, 0, st>>>(
      static_cast<const T*>(send), row_token, row_flat, tile_expert,
      used_tiles, tiles_ready, static_cast<const T*>(w), part,
      static_cast<T*>(recv), team, ctl, max_m, k_dim, n_cols, t_tiles, bm,
      nblk, k_chunk, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long mn = static_cast<long>(team.world) * max_m * n_cols;
  slot_reduce_kernel<T><<<static_cast<unsigned>((mn + NT - 1) / NT), NT, 0,
                          st>>>(part, counts, static_cast<T*>(inter), splits,
                                max_m, n_cols, mn);
  return cudaGetLastError();
}

bool bad_team(int rank, int world, int rpd) {
  return world < 1 || world > td::dist::kMaxWorld || rank < 0 ||
         rank >= world || rpd < 1;
}

}  // namespace

extern "C" {

// B17 (rows1 == 0) and B18, under kernels/low_latency_all_to_all.py::
// a2a_plan. Payload i: x_i and out_i (world, rows_i, kv_i) 16-byte
// vectors, contiguous, 16-byte aligned; its landing slots (2, world) of
// rows_i x kv_i vectors (ll: as LL lines, 32 bytes a vector) at byte
// land_i of every rank's symmetric buffer; under flags the flags (grid,
// world - 1) u64 at flag_off (zeroed once); base: device table of every
// rank's symmetric buffer; ctl: this rank's control block (4 u64, then an
// epoch word a block, zeroed once); grid: blocks, the same on every rank,
// at most rows0 * kv0; ranks_per_device: ranks that share this card.
// Returns a cudaError_t.
int td_ll_a2a(const void* x0, void* out0, int rows0, int kv0,
              long long land0, const void* x1, void* out1, int rows1,
              int kv1, long long land1, int rank, int world, const void* base,
              void* ctl, long long flag_off, int grid, int ll,
              int ranks_per_device, void* stream) {
  if (bad_team(rank, world, ranks_per_device) || rows0 <= 0 || kv0 <= 0 ||
      grid < 1 || static_cast<long>(grid) > static_cast<long>(rows0) * kv0 ||
      rows1 < 0 || (rows1 > 0 && kv1 <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  A2aLaunch info;
  cudaError_t err = a2a_launch_info(&info);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (static_cast<long>(grid) * ranks_per_device >
      static_cast<long>(info.occ) * info.sms)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const Team team{rank, world, static_cast<const long long*>(base), 0};
  const Payload p0{static_cast<const uint4*>(x0), static_cast<uint4*>(out0),
                   rows0, kv0, static_cast<long>(land0)};
  const Payload p1{static_cast<const uint4*>(x1), static_cast<uint4*>(out1),
                   rows1, kv1, static_cast<long>(land1)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* c = static_cast<u64*>(ctl);
  if (ll)
    ll_a2a_kernel<true><<<grid, NT, 0, st>>>(p0, p1, team, c,
                                             static_cast<long>(flag_off));
  else
    ll_a2a_kernel<false><<<grid, NT, 0, st>>>(p0, p1, team, c,
                                              static_cast<long>(flag_off));
  return static_cast<int>(cudaGetLastError());
}

// MT and U from the most live rows a tile can hold, as B14's dispatch.
#define TD_GG_DISPATCH(T, CALL)                         \
  (max_rows == 1   ? CALL(T, 1, 8)                      \
   : max_rows == 2 ? CALL(T, 2, 8)                      \
   : max_rows <= 4 ? CALL(T, 4, 8)                      \
                   : CALL(T, 8, 4))

// B16. send: (world, max_m, K) this rank's payload, slot p for peer p;
// row_token / row_flat (world, R), tile_expert (world, T), used_tiles
// (world,), tiles_ready (world, nblk): the arrival-ordered schedule of the
// received ids, sender by sender (pad slots binned past the live tiles);
// counts (world,) the live slots each sender sent; w: (E_loc, K, N) this
// rank's experts; part: f32 (splits, world * max_m, N); inter: (world *
// max_m, N) in slot order; recv: (world * max_m, K); base: device table of
// every rank's symmetric buffer ((2, world, max_m, K) of the dtype, signal
// pad at sig_off); ctl: this rank's control block (4 + (world - 1) * nblk
// u64, zeroed once); ranks_per_device: ranks sharing this card. One dtype;
// K and N multiples of the 16-byte vector; max_m a multiple of nblk;
// 16-byte aligned pointers. Returns a cudaError_t.
int td_dispatch_gg(const void* send, const int* row_token, const int* row_flat,
                   const int* tile_expert, const int* used_tiles,
                   const int* tiles_ready, const int* counts, const void* w,
                   void* part, void* inter, void* recv, int rank, int world,
                   const void* base, long long sig_off, void* ctl, int max_m,
                   int k_dim, int n_cols, int t_tiles, int bm, int nblk,
                   int k_chunk, int splits, int max_rows,
                   int ranks_per_device, int dtype, void* stream) {
  if (bad_team(rank, world, ranks_per_device) || max_m <= 0 || k_dim <= 0 ||
      n_cols <= 0 || t_tiles <= 0 || bm <= 0 || bm > BM_MAX || nblk <= 0 ||
      max_m % nblk || k_chunk <= 0 || splits <= 0 ||
      static_cast<long>(k_chunk) * splits < k_dim || max_rows <= 0 ||
      world * nblk > td::dist::kPadWords - td::dist::kUser ||
      part == nullptr || inter == nullptr || recv == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), sig_off};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* c = static_cast<u64*>(ctl);
  float* p = static_cast<float*>(part);
#define TD_GG_CALL(T, MT, U)                                                 \
  launch_dispatch_gg<T, MT, U>(send, row_token, row_flat, tile_expert,       \
                               used_tiles, tiles_ready, counts, w, p, inter, \
                               recv, team, c, max_m, k_dim, n_cols, t_tiles, \
                               bm, nblk, k_chunk, splits, ranks_per_device,  \
                               st)
  if (dtype == td::F32 && n_cols % td::kVec<float> == 0 &&
      k_dim % td::kVec<float> == 0)
    return static_cast<int>(TD_GG_DISPATCH(float, TD_GG_CALL));
  if (dtype == td::BF16 && n_cols % td::kVec<__nv_bfloat16> == 0 &&
      k_dim % td::kVec<__nv_bfloat16> == 0)
    return static_cast<int>(TD_GG_DISPATCH(__nv_bfloat16, TD_GG_CALL));
#undef TD_GG_CALL
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef TD_GG_DISPATCH

}  // extern "C"
