// B10 and B11: the overlapped AllGather + GEMM across ranks, hand-written
// for Hopper (sm_90a).
//
// Replace the TPU kernels kernels/allgather_gemm.py::_ag_gemm_kernel (B10,
// the fused ring kernel that _run_fused_ag_gemm launches for
// ag_gemm_per_device at n > 1, method PALLAS) and ::_ag_gemm_bidir_kernel
// (B11, method PALLAS_BIDIR at n >= 3): every rank holds an (m, K)
// shard of A and a (K, N_loc) column shard of W; the kernel returns
// out = cast(allgather(A) @ W), (n*m, N_loc), with f32 accumulation and
// one cast, and the gathered A (n*m, K), rank-major, copied out of the
// rank's symmetric buffer into a fresh tensor (the next call overwrites
// the buffer).
//
// What bounds it on this card. Decode (Qwen3-32B at TP=4, batch 16: m =
// 4, 16 gathered rows): the product streams the weight shard (QKV K 5120
// x N_loc 2560, 26.2 MB of bf16; gate/up N_loc 12800, 131 MB) for 0.4 and
// 2.1 GFLOP, bound by HBM bytes (7.8 us and 39 us at 3.35 TB/s); the
// gather moves 40 KB a peer, whose cost is a round trip, not bytes.
// Prefill (2,048 rows a rank, 8,192 gathered): 215 GFLOP (QKV) and 1.07
// TFLOP (gate/up), bound by the tensor cores (0.217 and 1.086 ms at 989
// TFLOP/s); the own shard goes to three peers, 21 MB each, ~0.14 ms of
// NVLink, which has to hide under the own shard's tiles.
//
// bf16: two regimes by the gathered rows, chosen by
// kernels/allgather_gemm.py's ag_plan (AG_STREAM_MAX_ROWS, set where the
// two cross on the card) and taken by the launcher from the plan's
// arguments (a row order: the tile GEMM), one launch a call in both, no
// opening barrier:
//  * decode (rows up to the cut): gemm_stream_sm90.cuh's TMA weight stream
//    (128 x 128 W tiles through its 5-stage ring, mma.sync with the operands
//    swapped, the persistent stream-K grid, the split-K fold by tickets in the
//    same launch) with A's rows read from this rank's landing buffer
//    (GatherA). The producer warp issues its first STAGES weight tiles, then
//    stores its share of the own shard into slot `rank` of every rank's buffer
//    (one hop, the next rank first), publishes it, and only then waits
//    (acquire) for the shards of the M group it stages: the ~160 KB of weights
//    in flight on every SM hide the gather's round trip. The gathered A goes
//    out to ag_out from the A rows staged for column tile 0's units;
//  * prefill (rows above the cut): gemm_tile_sm90.cuh's wgmma tile GEMM (128 x
//    256 tiles, 4 TMA stages of A and W, two consumer warpgroups on
//    m64n256k16, whole K a tile, one cast) with A by TMA (GatherTiles): a tile
//    of the own shard's rows alone from the caller's tensor, any other from
//    the landing buffer (a map a parity). The producer warpgroup's three spare
//    warps push the own shard while the consumers run its tiles; the row tiles
//    run in the order the launcher gives (allgather_gemm.py's ag_row_order:
//    the own shard's first, then the others as they land); before a landed
//    tile's first A load the producer acquires the flags of the (sender,
//    128-row block)s it reads and fences the async proxy; the gathered A goes
//    out from column tile 0's stages.
// The gather leg, shared by both regimes (gather_leg): a shard travels in
// row blocks (the whole shard at decode, 128 rows at prefill), each cut
// into pq = max(1, G / row blocks) pieces, a block of the grid a piece
// (each vector loaded once and stored to every destination, eight a
// thread in flight; a block that stored one piece of every row block
// waited out a system fence per row block, 0.3 ms on one rank at 8,192
// rows); the last of a row block's pieces to be stored (a counter per
// (chunk, row block) in the control block) raises its flag on the ranks
// that got it. B10 stores the own shard into every rank; B11 keeps the reference's
// schedule over both ring directions (td_ring.cuh's rounds): round 0 into
// this rank and both neighbours, at round s >= 1 chunk me - s travels on
// to the right (s < n / 2) and chunk me + s to the left (s < (n - 1) / 2)
// once its flag rose here. B11's flags feed the same waits, and B11 runs
// B10's plan, so its out is B10's bits whatever order its rows land in.
// The landing rows and their flags are double-buffered by the epoch's
// parity: rank r writes rank p's rows of parity P in call e + 2 only
// after its call e + 1, which waited for p's rows of call e + 1 (every
// rank reads every row in every call; B11's rows come from both
// neighbours), stored only after p's call e (the last reader of parity
// P) had ended. An epoch word a call in the control block: every block
// reads it and counts itself in, the last to count stores the next.
// Every block of every rank sharing the card is resident at once (one
// block an SM, at most SMs / ranks per card), and every wait is bounded
// and traps. A CUDA call that neither regime takes raises.
//
// f32 (the gates): the parent's kernels, kept: gemm_splitk.cuh's split-K
// FMA items in a persistent grid, the partials summed in slice order by a
// second kernel. B10: an opening barrier, then every block pushes its
// share of the own shard into every rank (one flag a shard); B11: the
// row-block forwarding of td_ring.cuh (bidir_ring_forward) before the
// items, the rows double-buffered by parity. Each item waits (acquire) for
// the shards its row tile reads; items of column tile 0 copy their rows
// out to ag_out.

#include "gemm_splitk.cuh"
#include "gemm_stream_sm90.cuh"
#include "gemm_tile_sm90.cuh"
#include "td_dist.cuh"
#include "td_ring.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;
using td::ring::RowBlocks;
using namespace td_gemm;

// The GEMM items of B10 and B11 over the gathered rows ag (world * m, K):
// (row tile, K slice, column tile), row tiles fastest. tile_of(i) gives
// the i-th row tile to run, wait_rows(mt) (thread 0) waits until tile
// mt's rows have landed. Items of column tile 0 also copy their rows' K
// slice out to ag_out.
template <typename T, int MT, int U, typename TileOf, typename WaitRows>
__device__ __forceinline__ void gather_gemm_items(
    const T* ag, const T* __restrict__ w, float* __restrict__ part,
    T* __restrict__ out, T* __restrict__ ag_out, int rows, int k_dim,
    int n_cols, int k_chunk, int splits, TileOf tile_of,
    WaitRows wait_rows) {
  constexpr int BN = 32 * td::kVec<T>;
  const int m_tiles = (rows + MT - 1) / MT;
  const int n_tiles = (n_cols + BN - 1) / BN;
  const long items = static_cast<long>(m_tiles) * splits * n_tiles;
  for (long it = blockIdx.x; it < items; it += gridDim.x) {
    const int i_m = static_cast<int>(it % m_tiles);
    const long rest = it / m_tiles;
    const int ks = static_cast<int>(rest % splits);
    const int nt = static_cast<int>(rest / splits);
    const int mt = tile_of(i_m);
    if (threadIdx.x == 0) wait_rows(mt);
    __syncthreads();
    if (nt == 0) {  // this tile's rows, K slice ks, to the caller's tensor
      constexpr int VEC = td::kVec<T>;
      const int k0 = ks * k_chunk;
      const int vecs = (min(k_dim, k0 + k_chunk) - k0) / VEC;
      const int n_rows = min(rows, mt * MT + MT) - mt * MT;
      for (int i = threadIdx.x; i < n_rows * vecs; i += NT) {
        const long off = static_cast<long>(mt * MT + i / vecs) * k_dim + k0 +
                         (i % vecs) * VEC;
        *reinterpret_cast<uint4*>(ag_out + off) =
            __ldcg(reinterpret_cast<const uint4*>(ag + off));
      }
    }
    gemm_tile<T, MT, U, true>(
        ag, w, rows, k_dim, n_cols, k_chunk, nt, ks, mt,
        [&](int row, int col, float sum) {
          if (splits > 1)
            part[(static_cast<long>(ks) * rows + row) * n_cols + col] = sum;
          else
            out[static_cast<long>(row) * n_cols + col] = td::from_f<T>(sum);
        });
  }
}

template <typename T, int MT, int U>
__global__ void __launch_bounds__(NT)
    ag_gemm_kernel(const T* __restrict__ a_loc, const T* __restrict__ w,
                   float* __restrict__ part, T* __restrict__ out,
                   T* __restrict__ ag_out, Team team, u64* ctl, int m,
                   int k_dim, int n_cols, int k_chunk, int splits, int,
                   long) {
  const int me = team.rank, world = team.world;
  const u64 e = td::dist::begin_call(ctl);
  if (blockIdx.x == 0) td::dist::arrive_all(team, e);
  td::dist::wait_all_arrived(team, e, "B10 arrival");

  // this block's share of the own shard, stored into slot `me` of every
  // rank's gathered buffer, the next rank first
  const long shard = static_cast<long>(m) * k_dim * sizeof(T);
  td::dist::push_all(team, me * shard, a_loc, shard);
  td::dist::publish(team, ctl, e, gridDim.x);

  const int rows = world * m;
  const int m_tiles = (rows + MT - 1) / MT;
  __shared__ unsigned landed_s;         // shards known to have landed
  unsigned* landed = &landed_s;
  if (threadIdx.x == 0) *landed = 0u;
  __syncthreads();
  gather_gemm_items<T, MT, U>(
      reinterpret_cast<const T*>(team.peer(me)), w, part, out, ag_out, rows,
      k_dim, n_cols, k_chunk, splits,
      [&](int i_m) { return (i_m + me * m / MT) % m_tiles; },
      [&](int mt) {
        const int c0 = mt * MT / m;
        const int c1 = (min(rows, mt * MT + MT) - 1) / m;
        for (int c = c0; c <= c1; ++c)
          if (!(*landed >> c & 1u)) {
            td::dist::wait(team.pad(me) + td::dist::kData + c, e,
                           "B10 shard", c);
            *landed |= 1u << c;
          }
      });
  td::dist::end_call(ctl, e);
}

template <typename T, int MT, int U>
__global__ void __launch_bounds__(NT)
    ag_gemm_bidir_kernel(const T* __restrict__ a_loc,
                         const T* __restrict__ w, float* __restrict__ part,
                         T* __restrict__ out, T* __restrict__ ag_out,
                         Team team, u64* ctl, int m, int k_dim, int n_cols,
                         int k_chunk, int splits, int rb, long flag_off) {
  const int me = team.rank, world = team.world;
  const int right = (me + 1) % world, left = (me + world - 1) % world;
  const u64 e = td::dist::begin_call(ctl);
  const int rows = world * m;
  const long row_bytes = static_cast<long>(k_dim) * sizeof(T);
  const RowBlocks rbk{team, static_cast<long>(e & 1) * rows * row_bytes,
                      flag_off, row_bytes, m, rb, (m + rb - 1) / rb};

  // round 0: the own shard into this rank's rows and both neighbours';
  // rounds 1 .. kr - 1: what landed travels on in its direction
  const int round0[3] = {me, right, left};
  td::ring::bidir_ring_forward(rbk, reinterpret_cast<const char*>(a_loc),
                               round0, 3, e, "B11 row block");

  // the GEMM: the own shard's tiles first, then by the round they land in
  const int m_tiles = (rows + MT - 1) / MT;
  const int per_chunk = m % MT == 0 ? m / MT : 0;
  gather_gemm_items<T, MT, U>(
      reinterpret_cast<const T*>(rbk.at(me, 0, 0)), w, part, out, ag_out,
      rows, k_dim, n_cols, k_chunk, splits,
      [&](int i_m) {
        if (per_chunk == 0) return (i_m + me * m / MT) % m_tiles;
        const int q = i_m / per_chunk, d = (q + 1) / 2;
        const int c = (q & 1 ? me - d + world : me + d) % world;
        return c * per_chunk + i_m % per_chunk;
      },
      [&](int mt) {
        const int r0 = mt * MT, r1 = min(rows, r0 + MT);
        for (int c = r0 / m; c <= (r1 - 1) / m; ++c) {
          const int lo = max(r0, c * m) - c * m;
          const int hi = min(r1, (c + 1) * m) - c * m;
          for (int j = lo / rb; j <= (hi - 1) / rb; ++j)
            td::dist::wait(rbk.flag(me, c, j), e, "B11 row block", c);
        }
      });
  td::dist::end_call(ctl, e);
}

template <typename T, int MT, int U>
using AgKernel = void (*)(const T*, const T*, float*, T*, T*, Team, u64*,
                          int, int, int, int, int, int, long);

template <typename T, int MT, int U, bool kBidir>
cudaError_t launch_ag(const void* a, const void* w, void* part, void* out,
                      void* ag_out, const Team& team, u64* ctl, int m,
                      int k_dim, int n_cols, int k_chunk, int splits,
                      int ranks_per_device, long flag_off,
                      cudaStream_t stream) {
  constexpr int BN = 32 * td::kVec<T>;
  const AgKernel<T, MT, U> kernel =
      kBidir ? ag_gemm_bidir_kernel<T, MT, U> : ag_gemm_kernel<T, MT, U>;
  // queried once per instantiation (the first call, never under a CUDA
  // graph capture: callers warm up first)
  static int sms = 0, occ = 0;
  cudaError_t err = cudaSuccess;
  if (occ == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, NT,
                                                          0);
    // Load the reduce kernel now. Under CUDA's lazy module loading its
    // first launch would load it, and loading may synchronize the
    // context: after the spinning kernel's launch that waits for a kernel
    // which, when the ranks share the card, is not launched yet.
    cudaFuncAttributes attr;
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr, reduce_kernel<T>);
    if (err != cudaSuccess) {
      occ = 0;
      return err;
    }
  }
  const int rows = team.world * m;
  const long items = static_cast<long>((rows + MT - 1) / MT) * splits *
                     ((n_cols + BN - 1) / BN);
  const long resident = static_cast<long>(occ) * sms / ranks_per_device;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const unsigned grid = static_cast<unsigned>(items < resident ? items
                                                               : resident);
  // B11's row blocks: the GEMM's row tile, or the shard when smaller
  const int rb = m < MT ? m : MT;
  kernel<<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w),
      static_cast<float*>(part), static_cast<T*>(out),
      static_cast<T*>(ag_out), team, ctl, m, k_dim, n_cols, k_chunk, splits,
      rb, flag_off);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long mn = static_cast<long>(rows) * n_cols;
  reduce_kernel<T><<<static_cast<unsigned>((mn + NT - 1) / NT), NT, 0,
                     stream>>>(static_cast<const float*>(part),
                               static_cast<T*>(out), splits, mn);
  return cudaGetLastError();
}

template <typename T, bool kBidir>
cudaError_t dispatch_ag(const void* a, const void* w, void* part, void* out,
                        void* ag_out, const Team& team, u64* ctl, int m,
                        int k_dim, int n_cols, int k_chunk, int splits,
                        int rpd, long flag_off, cudaStream_t st) {
  const int rows = team.world * m;
  if (rows == 1)
    return launch_ag<T, 1, 8, kBidir>(a, w, part, out, ag_out, team, ctl, m,
                                      k_dim, n_cols, k_chunk, splits, rpd,
                                      flag_off, st);
  if (rows == 2)
    return launch_ag<T, 2, 8, kBidir>(a, w, part, out, ag_out, team, ctl, m,
                                      k_dim, n_cols, k_chunk, splits, rpd,
                                      flag_off, st);
  if (rows <= 4)
    return launch_ag<T, 4, 8, kBidir>(a, w, part, out, ag_out, team, ctl, m,
                                      k_dim, n_cols, k_chunk, splits, rpd,
                                      flag_off, st);
  return launch_ag<T, 8, 4, kBidir>(a, w, part, out, ag_out, team, ctl, m,
                                    k_dim, n_cols, k_chunk, splits, rpd,
                                    flag_off, st);
}


// -- bf16 ---------------------------------------------------------------------

namespace agb {

namespace ts = td_stream;
namespace tt = td_tile;
namespace s9 = td::sm90;
using bf16 = __nv_bfloat16;

// A flag's bounded wait (one thread): acquire until *flag >= e, a trap
// after kMaxPolls polls. No printf: a function call in the wgmma kernel
// would serialize its products.
__device__ __forceinline__ void await(const u64* flag, u64 e) {
  long long polls = 0;
  while (td::dist::ld_acquire(flag) < e) {
    if (++polls > td::dist::kMaxPolls) __trap();
    __nanosleep(128);
  }
}

// The epoch of this call. Every block reads the control block's epoch
// word, then counts itself in; the last block to count stores the next
// epoch, which no block of this call reads any more.
__device__ __forceinline__ u64 open_call(u64* ctl) {
  __shared__ u64 epoch;
  if (threadIdx.x == 0) {
    const u64 e =
        *reinterpret_cast<const volatile u64*>(ctl + td::dist::kEpoch) + 1;
    epoch = e;
    __threadfence();
    if (atomicAdd(ctl + td::dist::kDone, 1ull) == gridDim.x - 1) {
      ctl[td::dist::kDone] = 0;
      ctl[td::dist::kEpoch] = e;
    }
  }
  __syncthreads();
  return epoch;
}

// The landing buffer of every rank: rows (2, world * m, K) bf16 from byte
// 0 (halves by the epoch's parity), then at flag_off the flags u64 [2]
// [world][mb], one a (parity, chunk, row block of rb rows); this rank's
// control block: the header, a counter per (chunk, row block), the
// stream kernel's tickets.
struct Gather {
  Team team;
  int m, rb, mb;          // rows a shard, a row block; row blocks a shard
  int bidir;
  long long row_bytes;    // K * 2
  long long half;         // a parity half: world * m rows
  long long flag_off;
  u64* ctl;
  __device__ __forceinline__ char* rows(int p, int par, int c, int j) const {
    return team.peer(p) + par * half +
           (static_cast<long long>(c) * m + static_cast<long long>(j) * rb) *
               row_bytes;
  }
  __device__ __forceinline__ long long bytes(int j) const {
    return static_cast<long long>(min(rb, m - j * rb)) * row_bytes;
  }
  __device__ __forceinline__ u64* flag(int p, int par, int c, int j) const {
    return reinterpret_cast<u64*>(team.peer(p) + flag_off) +
           (static_cast<long long>(par) * team.world + c) * mb + j;
  }
  __device__ __forceinline__ u64* count(int c, int j) const {
    return ctl + td::dist::kCtlHeader + c * mb + j;
  }
};

// Bytes [lo, hi) of src into [lo, hi) of each of dst[0 .. nd), by nth
// threads: U 16-byte vectors a thread loaded once, all before the first
// store, then stored to every destination (a copy that waited for each
// load before its store would keep one vector a thread in flight).
template <int U>
__device__ __forceinline__ void copy_to(const char* src, char* const* dst,
                                        int nd, long long lo, long long hi,
                                        int tid, int nth) {
  const uint4* s = reinterpret_cast<const uint4*>(src + lo);
  const long long n = (hi - lo) / 16;
  for (long long b0 = 0; b0 < n; b0 += static_cast<long long>(U) * nth) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = b0 + static_cast<long long>(u) * nth + tid;
      if (i < n) v[u] = __ldcg(s + i);
    }
    for (int d = 0; d < nd; ++d) {
      uint4* t = reinterpret_cast<uint4*>(dst[d] + lo);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = b0 + static_cast<long long>(u) * nth + tid;
        if (i < n) t[i] = v[u];
      }
    }
  }
}

// This block's part of the gather, by nth threads (tid 0 .. nth - 1) that
// sync() together: each chunk it moves is cut into mb x pq units (row
// block j, piece q of pq = max(1, G / mb)) and block b takes units b, b +
// G, ...; after a unit's stores its row block's count, and the row
// block's flags by the last of its pq units.
template <typename Sync>
__device__ __forceinline__ void gather_leg(const Gather& g, const char* own,
                                           u64 e, int tid, int nth,
                                           Sync&& sync) {
  const int me = g.team.rank, n = g.team.world, par = static_cast<int>(e & 1);
  const int G = gridDim.x, pq = max(1, G / g.mb), units = g.mb * pq;
  const auto piece = [&](int j, int q, long long& lo, long long& hi) {
    const long long bytes = g.bytes(j);
    const long long per = (bytes / 16 + pq - 1) / pq * 16;
    lo = min(bytes, per * q);
    hi = min(bytes, lo + per);
  };
  const auto done = [&](int c, int j, const int* dst, int nd) {
    __threadfence_system();
    sync();
    if (tid == 0 && atomicAdd(g.count(c, j), 1ull) == pq - 1) {
      *g.count(c, j) = 0;
      __threadfence_system();
      for (int d = 0; d < nd; ++d)
        td::dist::notify(g.flag(dst[d], par, c, j), e);
    }
  };
  // unit u (row block u / pq, piece u % pq) of chunk c from src (the
  // row block's first byte) into the ranks dst[0 .. nd)
  const auto move = [&](const char* src, int c, int u, const int* dst,
                        int nd) {
    const int j = u / pq;
    long long lo, hi;
    piece(j, u % pq, lo, hi);
    char* to[td::dist::kMaxWorld];
    for (int d = 0; d < nd; ++d) to[d] = g.rows(dst[d], par, c, j);
    copy_to<8>(src, to, nd, lo, hi, tid, nth);
    done(c, j, dst, nd);
  };
  const auto own_block = [&](int j) {
    return own + static_cast<long long>(j) * g.rb * g.row_bytes;
  };
  if (!g.bidir) {
    int dst[td::dist::kMaxWorld];   // the next rank first, this one last
    for (int i = 1; i <= n; ++i) dst[i - 1] = (me + i) % n;
    for (int u = blockIdx.x; u < units; u += G)
      move(own_block(u / pq), me, u, dst, n);
    return;
  }
  const int right = (me + 1) % n, left = (me + n - 1) % n;
  const int kr = n / 2, kl = (n - 1) / 2;
  const int round0[3] = {right, left, me};
  for (int u = blockIdx.x; u < units; u += G)
    move(own_block(u / pq), me, u, round0, 3);
  for (int s = 1; s < kr; ++s)
    for (int dir = 0; dir < (s < kl ? 2 : 1); ++dir) {
      const int c = dir == 0 ? (me - s + n) % n : (me + s) % n;
      const int to = dir == 0 ? right : left;
      for (int u = blockIdx.x; u < units; u += G) {
        if (tid == 0) await(g.flag(me, par, c, u / pq), e);
        sync();
        move(g.rows(me, par, c, u / pq), c, u, &to, 1);
      }
    }
}

// One thread: wait (acquire) until the gathered rows [r0, r1) landed here.
__device__ __forceinline__ void wait_rows(const Gather& g, u64 e, int r0,
                                          int r1) {
  const int par = static_cast<int>(e & 1), me = g.team.rank;
  for (int c = r0 / g.m; c <= (r1 - 1) / g.m; ++c) {
    const int lo = max(r0, c * g.m) - c * g.m;
    const int hi = min(r1, (c + 1) * g.m) - c * g.m;
    for (int j = lo / g.rb; j <= (hi - 1) / g.rb; ++j)
      await(g.flag(me, par, c, j), e);
  }
}

// Decode: gemm_stream_sm90.cuh's A source over the landing buffer.
struct GatherA {
  static constexpr bool kDefer = true;
  Gather g;
  const bf16* a_loc;
  bf16* ag_out;
  u64 e;
  const bf16* land;   // this rank's rows of this call's parity
  int lo, hi;         // rows known to have landed (producer)

  __device__ __forceinline__ void begin() {
    e = open_call(g.ctl);
    land = reinterpret_cast<const bf16*>(g.team.peer(g.team.rank) +
                                         static_cast<long long>(e & 1) *
                                             g.half);
    lo = hi = 0;
  }
  __device__ __forceinline__ void ready(const ts::Plan&, int lane) {
    gather_leg(g, reinterpret_cast<const char*>(a_loc), e, lane, 32,
               [] { __syncwarp(); });
  }
  __device__ __forceinline__ const bf16* rows(const ts::Plan&, int r0, int r1,
                                              int lane) {
    if (r0 < lo || r1 > hi) {
      if (lane == 0) wait_rows(g, e, r0, r1);
      __syncwarp();
      lo = r0;
      hi = r1;
    }
    return land;
  }
  // column tile 0's units: the stage's rows [r0, r1), K tile kt, out
  __device__ __forceinline__ void staged(const ts::Plan& p, int r0, int r1,
                                         int ct, int kt, const bf16* st,
                                         int tid) {
    if (ct != 0) return;
    constexpr int VPR = ts::BK / 8;
    const int k0 = kt * ts::BK;
    for (int v = tid; v < (r1 - r0) * VPR; v += ts::NCW * 32) {
      const int r = v / VPR, c = v % VPR;
      if (k0 + 8 * c < p.k)
        *reinterpret_cast<uint4*>(ag_out +
                                  static_cast<long long>(r0 + r) * p.k + k0 +
                                  8 * c) =
            *reinterpret_cast<const uint4*>(st + r * ts::A_LD + 8 * c);
    }
  }
};

// Prefill: gemm_tile_sm90.cuh's source over the landing buffer.
struct GatherTiles {
  Gather g;
  const bf16* a_loc;
  bf16* ag_out;
  const int* order;   // the row tiles in the order they run
  u64 e;

  __device__ __forceinline__ void begin() { e = open_call(g.ctl); }
  __device__ __forceinline__ void side(int tid, int nth) {
    gather_leg(g, reinterpret_cast<const char*>(a_loc), e, tid, nth,
               [] { s9::named_sync(1, 96); });
  }
  __device__ __forceinline__ int row_tile(int q) const {
    return __ldg(order + q);
  }
  // maps: the landing rows of parity 0 and 1, the own shard. A tile of
  // the own shard's rows alone reads them from the caller's tensor, with
  // nothing to wait for; any other from the landing rows once they landed.
  __device__ __forceinline__ const CUtensorMap* a_tile(
      int r0, int r1, int& row, const CUtensorMap* const* maps) const {
    const int own0 = g.team.rank * g.m;
    if (r0 >= own0 && r1 <= own0 + g.m) {
      row = r0 - own0;
      return maps[2];
    }
    agb::wait_rows(g, e, r0, r1);
    // the peers' generic stores, then TMA's reads
    s9::fence_proxy_async_global();
    row = r0;
    return maps[e & 1];
  }
  // column tile 0's tiles: the warpgroup's 64 swizzled rows from r0, out
  __device__ __forceinline__ void staged(const tt::Plan& p, int r0, int ct,
                                         int kt, const bf16* a,
                                         int tid) const {
    if (ct != 0) return;
    const int k0 = kt * tt::BK;
    for (int i = tid; i < 64 * 8; i += 128) {
      const int r = i >> 3, c = i & 7;
      if (r0 + r < p.m && k0 + 8 * c < p.k)
        *reinterpret_cast<uint4*>(ag_out +
                                  static_cast<long long>(r0 + r) * p.k + k0 +
                                  8 * c) =
            *reinterpret_cast<const uint4*>(a + r * 64 + ((c ^ (r & 7)) << 3));
    }
  }
};

template <int MG>
cudaError_t launch_stream(const Gather& g, const void* a_loc, const void* w,
                          void* ws, void* out, void* ag_out, int k, int n,
                          int grid, int rpd, int dev, cudaStream_t st) {
  using Epi = ts::CastStore<MG>;
  // blocks resident on a card at once, asked once per device (0: not yet)
  static std::atomic<int> resident[64];
  cudaError_t err = ts::set_smem<MG, Epi, GatherA>(dev);
  int cap = dev < 64 ? resident[dev].load(std::memory_order_acquire) : 0;
  if (err == cudaSuccess && cap == 0) {
    int sms = 0, occ = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, ts::stream_kernel<MG, Epi, GatherA>, ts::NTH,
          ts::smem_bytes<MG, Epi>());
    cap = sms * occ;
    if (err == cudaSuccess && dev < 64)
      resident[dev].store(cap, std::memory_order_release);
  }
  if (err != cudaSuccess) return err;
  if (static_cast<long>(grid) * rpd > cap)
    return cudaErrorInvalidConfiguration;
  ts::Plan p;
  ts::plan_of(&p, nullptr, g.team.world * g.m, k, n, grid);
  p.a_vec = 1;   // the landing rows: 256-byte aligned, K % 8 == 0
  if (grid > p.units) return cudaErrorInvalidConfiguration;
  CUtensorMap map;
  if (!ts::rows_map(&map, w, k, n, ts::BK, dev))
    return cudaErrorNotSupported;
  int* tickets = reinterpret_cast<int*>(
      g.ctl + td::dist::kCtlHeader + g.team.world * g.mb);
  const GatherA src{g, static_cast<const bf16*>(a_loc),
                    static_cast<bf16*>(ag_out), 0, nullptr, 0, 0};
  return ts::launch_src<MG, Epi>(map, src, Epi{static_cast<bf16*>(out)},
                                 static_cast<float*>(ws), tickets, p, dev,
                                 st);
}

cudaError_t launch_tiles(const Gather& g, const void* a_loc, const void* w,
                         void* out, void* ag_out, const int* order,
                         const void* land, int k, int n, int grid, int rpd,
                         int dev, cudaStream_t st) {
  int clusters = 0;
  const cudaError_t err = tt::prepare<GatherTiles>(dev, &clusters);
  if (err != cudaSuccess) return err;
  // whole clusters, every rank's resident at once
  if (grid % tt::CLUSTER != 0 ||
      static_cast<long>(grid / tt::CLUSTER) * rpd > clusters)
    return cudaErrorInvalidConfiguration;
  const int rows = g.team.world * g.m;
  const tt::Plan p = tt::plan_of(rows, k, n);
  if (grid / tt::CLUSTER > p.tiles) return cudaErrorInvalidConfiguration;
  CUtensorMap mw, ma[3];
  if (!ts::rows_map(&mw, w, k, n, tt::BK, dev) ||
      !ts::rows_map(&ma[2], a_loc, g.m, k, tt::BM, dev))
    return cudaErrorNotSupported;
  for (int par = 0; par < 2; ++par)
    if (!ts::rows_map(&ma[par], static_cast<const char*>(land) + par * g.half,
                      rows, k, tt::BM, dev))
      return cudaErrorNotSupported;
  const GatherTiles src{g, static_cast<const bf16*>(a_loc),
                        static_cast<bf16*>(ag_out), order, 0};
  return tt::launch(mw, ma, src, static_cast<bf16*>(out), p, grid, st);
}

template <bool kBidir>
int launch(const void* a_loc, const void* w, void* ws, void* out,
           void* ag_out, const int* order, const void* land, int rank,
           int world, const void* base, long long flag_off, void* ctl, int m,
           int k, int n, int grid, int rb, int rpd, cudaStream_t st) {
  const int rows = world * m;
  // the plan's regime: the tile GEMM gets its row order, the stream none
  const bool stream = order == nullptr;
  if (n % 8 != 0 || k % 8 != 0 || grid < 1 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      rb != (stream ? m : tt::BM) || (stream && ws == nullptr) ||
      (!stream && (order == nullptr || land == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Gather g{Team{rank, world, static_cast<const long long*>(base), 0},
                 m,
                 rb,
                 (m + rb - 1) / rb,
                 kBidir ? 1 : 0,
                 static_cast<long long>(k) * 2,
                 static_cast<long long>(rows) * k * 2,
                 flag_off,
                 static_cast<u64*>(ctl)};
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!stream)
    return static_cast<int>(launch_tiles(g, a_loc, w, out, ag_out, order,
                                         land, k, n, grid, rpd, dev, st));
  return static_cast<int>(
      rows <= 8 ? launch_stream<8>(g, a_loc, w, ws, out, ag_out, k, n, grid,
                                   rpd, dev, st)
                : launch_stream<16>(g, a_loc, w, ws, out, ag_out, k, n, grid,
                                    rpd, dev, st));
}

}  // namespace agb

template <bool kBidir>
int td_ag_gemm_any(const void* a_loc, const void* w, void* part, void* out,
                   void* ag_out, const void* order, const void* land,
                   int rank, int world, const void* base, long long sig_off,
                   long long flag_off, void* ctl, int m, int k_dim,
                   int n_cols, int k_chunk, int splits, int grid, int rb,
                   int ranks_per_device, int dtype, void* stream) {
  if (world < (kBidir ? 3 : 1) || world > td::dist::kMaxWorld || rank < 0 ||
      rank >= world || m <= 0 || k_dim <= 0 || n_cols <= 0 ||
      ranks_per_device < 1 || ag_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == td::BF16)
    return agb::launch<kBidir>(a_loc, w, part, out, ag_out,
                               static_cast<const int*>(order), land, rank,
                               world, base, flag_off, ctl, m, k_dim, n_cols,
                               grid, rb, ranks_per_device, st);
  if (dtype != td::F32 || n_cols % td::kVec<float> != 0 ||
      k_dim % td::kVec<float> != 0 || k_chunk <= 0 || splits <= 0 ||
      static_cast<long>(k_chunk) * splits < k_dim ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), sig_off};
  return static_cast<int>(dispatch_ag<float, kBidir>(
      a_loc, w, part, out, ag_out, team, static_cast<u64*>(ctl), m, k_dim,
      n_cols, k_chunk, splits, ranks_per_device, flag_off, st));
}

}  // namespace

// B10. a_loc: this rank's (m, K) shard; w: (K, N) weight shard; out:
// (world*m, N); ag_out: (world*m, K), the gathered A; base: device table of
// every rank's symmetric buffer; ctl: this rank's control block, zeroed
// once; ranks_per_device: ranks that share this card (1 on n cards, n in
// the one-card world). Returns a cudaError_t.
//  bf16 (the launcher's ag_plan): the buffer holds the landing rows (2,
//  world*m, K) from byte 0 and the flags (2, world, ceil(m / rb)) u64 at
//  flag_off; ctl: 4 u64, a counter per (chunk, row block), then at decode
//  the stream kernel's tickets (4 int a block); grid: blocks, at most the
//  SMs / ranks_per_device; rb: rows a row block (m at decode, 128 at
//  prefill); the regime is the plan's: decode (order null): part the
//  stream kernel's workspace (2 grid x 128 x 16 f32); prefill: order the
//  row tiles in the order they run (int32, ceil(world*m / 128)), land
//  this rank's buffer. K and N
//  multiples of 8, w 16-byte aligned. sig_off, k_chunk, splits unused.
//  f32: the buffer holds the gathered rows (world*m, K) and the signal pad
//  at sig_off; part the f32 (splits, world*m, N) workspace when splits >
//  1; K and N multiples of 4. order, land, flag_off, grid, rb unused.
extern "C" int td_ag_gemm(const void* a_loc, const void* w, void* part,
                          void* out, void* ag_out, const void* order,
                          const void* land, int rank, int world,
                          const void* base, long long sig_off,
                          long long flag_off, void* ctl, int m, int k_dim,
                          int n_cols, int k_chunk, int splits, int grid,
                          int rb, int ranks_per_device, int dtype,
                          void* stream) {
  return td_ag_gemm_any<false>(a_loc, w, part, out, ag_out, order, land,
                               rank, world, base, sig_off, flag_off, ctl, m,
                               k_dim, n_cols, k_chunk, splits, grid, rb,
                               ranks_per_device, dtype, stream);
}

// B11, world >= 3: as td_ag_gemm. bf16: the same layout and plan as B10.
// f32: every rank's buffer holds the gathered rows (2, world*m, K) from
// byte 0 (halves by the epoch's parity) and the row blocks' flags (world *
// ceil(m / rb) u64, rb = min(m, the row tile), zeroed once) at byte
// flag_off; sig_off unused. Returns a cudaError_t.
extern "C" int td_ag_gemm_bidir(const void* a_loc, const void* w, void* part,
                                void* out, void* ag_out, const void* order,
                                const void* land, int rank, int world,
                                const void* base, long long sig_off,
                                long long flag_off, void* ctl, int m,
                                int k_dim, int n_cols, int k_chunk,
                                int splits, int grid, int rb,
                                int ranks_per_device, int dtype,
                                void* stream) {
  return td_ag_gemm_any<true>(a_loc, w, part, out, ag_out, order, land, rank,
                              world, base, sig_off, flag_off, ctl, m, k_dim,
                              n_cols, k_chunk, splits, grid, rb,
                              ranks_per_device, dtype, stream);
}
