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
// What bounds it on this card. On the decode path (Qwen3-32B at TP=4,
// batch 16: m = 4) the product streams the weight shard (QKV K 5120 x
// N_loc 2560, 26.2 MB of bf16; gate/up N_loc 12800, 131 MB) for 0.4 and
// 2.1 GFLOP: bound by HBM bytes (7.8 us and 39 us at 3.35 TB/s). The
// gather moves 40 KB per peer over NVLink (450 GB/s each way), well under
// a microsecond of wire time; its cost is latency, not bytes.
//
// Design:
//  * push, full mesh: on NVSwitch every peer is one hop away, so each rank
//    stores its own shard straight into slot `rank` of every rank's
//    gathered buffer (16-byte peer stores, the work split over all blocks
//    of the grid) instead of forwarding it around a ring: one hop of
//    latency instead of n - 1;
//  * a barrier opens the call (each rank's block 0 raises its arrival flag
//    on every rank; a block stores into a peer only after every rank
//    arrived), so no rank overwrites a slot that a peer still reads from
//    the previous call;
//  * the last block to finish its stores raises the data flag of this
//    rank on every rank (release at system scope, epoch-valued);
//  * the consumer is the split-K weight-streaming GEMM of gemm_splitk.cuh
//    (B4/B12's device code), run as work items by a persistent grid; an
//    item waits (acquire) on the flags of the shards its rows come from,
//    once per block, and reads them with L1-bypassing loads. Row tiles go
//    fastest in the item order, so the tiles that share a weight slice
//    run side by side and read it once from HBM (the rest from L2); the
//    order starts at the row tile that holds the rank's first row, so a
//    block begins with its own shard (alone in its tile when m is a
//    multiple of the tile, prefill-sized m; beside the next rank's at
//    decode, m = 4 in a tile of 8);
//  * the items of column tile 0 also copy their rows' K slice of the
//    gathered A out to the caller's tensor, once they have landed;
//  * the grid is persistent and small enough that every block of every
//    rank that shares the card is resident at once (occupancy x SMs /
//    ranks per card): a block that spins never keeps the block it waits
//    for from running. The K-split partials are summed in slice order by
//    a second kernel, as in B12, so every launch is deterministic; that
//    kernel is loaded before the first launch (lazy module loading may
//    synchronize the context, which must not happen while a rank spins).
//
// B11 is the same GEMM over the same items, with B10's gather leg
// replaced by the TPU kernel's schedule over both ring directions: round
// 0 stores the own shard into this rank's gathered rows and into the
// right and the left neighbour's; at round s >= 1 chunk (me - s) has
// landed from the left and chunk (me + s) from the right, and a rank
// forwards each on in the direction it travels while s < kr = n / 2 (or
// s < kl = (n - 1) / 2). So a shard needs ceil((n - 1) / 2) forwarding
// rounds instead of B10's single full-mesh hop: the point of the port is
// to measure that schedule on NVSwitch. Design:
//  * a shard travels in row blocks of rb rows (the GEMM's row tile, or
//    the shard when it is smaller), each with its own flag per rank
//    (epoch-valued), raised by whoever stored it: this rank for its own
//    shard, a neighbour for the others;
//  * block b of every rank forwards the row blocks j = b, b + G, ...
//    first, round by round: it waits only for block b of a neighbour in
//    the round before, so the forwarding never waits on a GEMM item, and
//    every rank's forwarding finishes; then it runs GEMM items, each of
//    which waits (acquire) for the row blocks its tile reads. The tiles
//    of the own shard go first, then those landing at round 1 (me - 1,
//    me + 1), round 2, ...;
//  * the gathered rows are double-buffered by the epoch's parity, with no
//    opening barrier: rank r writes a neighbour's rows of call e + 2 only
//    after call e + 1, which waited for rows that both neighbours stored
//    in call e + 1, after their call e kernels had ended;
//  * with the same K split as B10 (split_plan), every item computes
//    B10's sums in B10's order, so out is B10's bits and the gathered A
//    B10's bytes, whatever the order the row blocks land in.

#include "gemm_splitk.cuh"
#include "td_dist.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;
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

// B11's row blocks: row block j (rb rows; the last may be short) of chunk
// c, at the same place in every rank's gathered rows (this call's parity
// half), and its flag there.
struct RowBlocks {
  Team team;
  long par, flag_off, row_bytes;
  int m, rb, mb;
  __device__ __forceinline__ char* at(int p, int c, int j) const {
    return team.peer(p) + par +
           (static_cast<long>(c) * m + static_cast<long>(j) * rb) * row_bytes;
  }
  __device__ __forceinline__ long bytes(int j) const {
    return static_cast<long>(min(rb, m - j * rb)) * row_bytes;
  }
  __device__ __forceinline__ u64* flag(int p, int c, int j) const {
    return reinterpret_cast<u64*>(team.peer(p) + flag_off) +
           static_cast<long>(c) * mb + j;
  }
};

// This block stores row block j of chunk c (from src) into the ranks
// dst[0..nd), then raises its flag on each of them.
__device__ __forceinline__ void store_row_block(const RowBlocks& rbk,
                                                const char* src, int c, int j,
                                                const int* dst, int nd,
                                                u64 e) {
  for (int d = 0; d < nd; ++d)
    td::dist::put(rbk.at(dst[d], c, j), src, rbk.bytes(j));
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int d = 0; d < nd; ++d) td::dist::notify(rbk.flag(dst[d], c, j), e);
}

// Wait (thread 0) for row block j of chunk c on this rank, then let the
// block on.
__device__ __forceinline__ void wait_row_block(const RowBlocks& rbk, int c,
                                               int j, u64 e, int from) {
  if (threadIdx.x == 0)
    td::dist::wait(rbk.flag(rbk.team.rank, c, j), e, "B11 row block", from);
  __syncthreads();
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
  const int kr = world / 2, kl = (world - 1) / 2;
  const u64 e = td::dist::begin_call(ctl);
  const int rows = world * m;
  const long row_bytes = static_cast<long>(k_dim) * sizeof(T);
  const RowBlocks rbk{team, static_cast<long>(e & 1) * rows * row_bytes,
                      flag_off, row_bytes, m, rb, (m + rb - 1) / rb};

  // round 0: the own shard into this rank's rows and both neighbours'
  const int round0[3] = {me, right, left};
  for (int j = blockIdx.x; j < rbk.mb; j += gridDim.x)
    store_row_block(rbk, reinterpret_cast<const char*>(a_loc) +
                             static_cast<long>(j) * rb * row_bytes,
                    me, j, round0, 3, e);
  // rounds 1 .. kr - 1: what landed travels on in its direction
  for (int s = 1; s < kr; ++s) {
    const int cr = (me - s + world) % world, cl = (me + s) % world;
    for (int j = blockIdx.x; j < rbk.mb; j += gridDim.x) {
      wait_row_block(rbk, cr, j, e, left);
      store_row_block(rbk, rbk.at(me, cr, j), cr, j, &right, 1, e);
      if (s < kl) {
        wait_row_block(rbk, cl, j, e, right);
        store_row_block(rbk, rbk.at(me, cl, j), cl, j, &left, 1, e);
      }
    }
  }

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

template <bool kBidir>
int td_ag_gemm_any(const void* a_loc, const void* w, void* part, void* out,
                   void* ag_out, int rank, int world, const void* base,
                   long long sig_off, long long flag_off, void* ctl, int m,
                   int k_dim, int n_cols, int k_chunk, int splits,
                   int ranks_per_device, int dtype, void* stream) {
  if (world < (kBidir ? 3 : 1) || world > td::dist::kMaxWorld || rank < 0 ||
      rank >= world || m <= 0 || k_dim <= 0 || n_cols <= 0 ||
      k_chunk <= 0 || splits <= 0 || ranks_per_device < 1 ||
      static_cast<long>(k_chunk) * splits < k_dim ||
      ag_out == nullptr || (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), sig_off};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* c = static_cast<u64*>(ctl);
  if (dtype == td::F32 && n_cols % td::kVec<float> == 0 &&
      k_dim % td::kVec<float> == 0)
    return static_cast<int>(dispatch_ag<float, kBidir>(
        a_loc, w, part, out, ag_out, team, c, m, k_dim, n_cols, k_chunk,
        splits, ranks_per_device, flag_off, st));
  if (dtype == td::BF16 && n_cols % td::kVec<__nv_bfloat16> == 0 &&
      k_dim % td::kVec<__nv_bfloat16> == 0)
    return static_cast<int>(dispatch_ag<__nv_bfloat16, kBidir>(
        a_loc, w, part, out, ag_out, team, c, m, k_dim, n_cols, k_chunk,
        splits, ranks_per_device, flag_off, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// B10. a_loc: this rank's (m, K) shard; w: (K, N) weight shard; out:
// (world*m, N); ag_out: (world*m, K), the gathered A; part: f32 (splits,
// world*m, N) workspace when splits > 1; base: device table of every
// rank's symmetric buffer (world*m*K elements of the dtype, signal pad at
// sig_off); ctl: this rank's control block (4 u64, zeroed once);
// ranks_per_device: ranks that share this card (1 on n cards, n in the
// one-card world). One dtype (td::F32 or td::BF16); K and N multiples of
// the 16-byte vector; 16-byte aligned pointers. Returns a cudaError_t.
extern "C" int td_ag_gemm(const void* a_loc, const void* w, void* part,
                          void* out, void* ag_out, int rank, int world,
                          const void* base, long long sig_off, void* ctl,
                          int m, int k_dim, int n_cols, int k_chunk,
                          int splits, int ranks_per_device, int dtype,
                          void* stream) {
  return td_ag_gemm_any<false>(a_loc, w, part, out, ag_out, rank, world,
                               base, sig_off, 0, ctl, m, k_dim, n_cols,
                               k_chunk, splits, ranks_per_device, dtype,
                               stream);
}

// B11, world >= 3: as td_ag_gemm, with every rank's symmetric buffer
// holding the gathered rows (2, world*m, K) of the dtype from byte 0
// (halves by the epoch's parity) and the row blocks' flags (world *
// ceil(m / rb) u64, rb = min(m, the row tile), zeroed once) at byte
// flag_off. Returns a cudaError_t.
extern "C" int td_ag_gemm_bidir(const void* a_loc, const void* w, void* part,
                                void* out, void* ag_out, int rank, int world,
                                const void* base, long long flag_off,
                                void* ctl, int m, int k_dim, int n_cols,
                                int k_chunk, int splits,
                                int ranks_per_device, int dtype,
                                void* stream) {
  return td_ag_gemm_any<true>(a_loc, w, part, out, ag_out, rank, world,
                              base, 0, flag_off, ctl, m, k_dim, n_cols,
                              k_chunk, splits, ranks_per_device, dtype,
                              stream);
}
