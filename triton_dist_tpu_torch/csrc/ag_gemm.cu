// B10: the overlapped AllGather + GEMM across ranks, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/allgather_gemm.py::_ag_gemm_kernel (the
// fused ring kernel that _run_fused_ag_gemm launches for
// ag_gemm_per_device at n > 1, method PALLAS): every rank holds an (m, K)
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

#include "gemm_splitk.cuh"
#include "td_dist.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;
using namespace td_gemm;

template <typename T, int MT, int U>
__global__ void __launch_bounds__(NT)
    ag_gemm_kernel(const T* __restrict__ a_loc, const T* __restrict__ w,
                   float* __restrict__ part, T* __restrict__ out,
                   T* __restrict__ ag_out, Team team, u64* ctl, int m,
                   int k_dim, int n_cols, int k_chunk, int splits) {
  constexpr int BN = 32 * td::kVec<T>;
  const int me = team.rank, world = team.world;
  const u64 e = td::dist::begin_call(ctl);
  if (blockIdx.x == 0) td::dist::arrive_all(team, e);
  td::dist::wait_all_arrived(team, e, "B10 arrival");

  // this block's share of the own shard, stored into slot `me` of every
  // rank's gathered buffer, the next rank first
  const long shard = static_cast<long>(m) * k_dim * sizeof(T);
  const long per = ((shard / 16 + gridDim.x - 1) / gridDim.x) * 16;
  const long lo = per * blockIdx.x < shard ? per * blockIdx.x : shard;
  const long hi = lo + per < shard ? lo + per : shard;
  for (int i = 1; i <= world; ++i) {
    const int p = (me + i) % world;
    td::dist::put(team.peer(p) + me * shard + lo,
                  reinterpret_cast<const char*>(a_loc) + lo, hi - lo);
  }
  td::dist::publish(team, ctl, e, gridDim.x);

  const T* ag = reinterpret_cast<const T*>(team.peer(me));
  const int rows = world * m;
  const int m_tiles = (rows + MT - 1) / MT;
  const int n_tiles = (n_cols + BN - 1) / BN;
  const long items = static_cast<long>(m_tiles) * splits * n_tiles;
  __shared__ unsigned landed;           // shards known to have landed
  if (threadIdx.x == 0) landed = 0u;
  __syncthreads();
  for (long it = blockIdx.x; it < items; it += gridDim.x) {
    const int i_m = static_cast<int>(it % m_tiles);
    const long rest = it / m_tiles;
    const int ks = static_cast<int>(rest % splits);
    const int nt = static_cast<int>(rest / splits);
    const int mt = (i_m + me * m / MT) % m_tiles;
    if (threadIdx.x == 0) {
      const int c0 = mt * MT / m;
      const int c1 = (min(rows, mt * MT + MT) - 1) / m;
      for (int c = c0; c <= c1; ++c)
        if (!(landed >> c & 1u)) {
          td::dist::wait(team.pad(me) + td::dist::kData + c, e,
                         "B10 shard", c);
          landed |= 1u << c;
        }
    }
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
  td::dist::end_call(ctl, e);
}

template <typename T, int MT, int U>
cudaError_t launch_ag(const void* a, const void* w, void* part, void* out,
                   void* ag_out, const Team& team, u64* ctl, int m,
                   int k_dim, int n_cols, int k_chunk, int splits,
                   int ranks_per_device, cudaStream_t stream) {
  constexpr int BN = 32 * td::kVec<T>;
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
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, ag_gemm_kernel<T, MT, U>, NT, 0);
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
  ag_gemm_kernel<T, MT, U><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w),
      static_cast<float*>(part), static_cast<T*>(out),
      static_cast<T*>(ag_out), team, ctl, m, k_dim,
      n_cols, k_chunk, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long mn = static_cast<long>(rows) * n_cols;
  reduce_kernel<T><<<static_cast<unsigned>((mn + NT - 1) / NT), NT, 0,
                     stream>>>(static_cast<const float*>(part),
                               static_cast<T*>(out), splits, mn);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_ag(const void* a, const void* w, void* part, void* out,
                     void* ag_out, const Team& team, u64* ctl, int m, int k_dim,
                     int n_cols, int k_chunk, int splits, int rpd,
                     cudaStream_t st) {
  const int rows = team.world * m;
  if (rows == 1)
    return launch_ag<T, 1, 8>(a, w, part, out, ag_out, team, ctl, m, k_dim,
                              n_cols, k_chunk, splits, rpd, st);
  if (rows == 2)
    return launch_ag<T, 2, 8>(a, w, part, out, ag_out, team, ctl, m, k_dim,
                              n_cols, k_chunk, splits, rpd, st);
  if (rows <= 4)
    return launch_ag<T, 4, 8>(a, w, part, out, ag_out, team, ctl, m, k_dim,
                              n_cols, k_chunk, splits, rpd, st);
  return launch_ag<T, 8, 4>(a, w, part, out, ag_out, team, ctl, m, k_dim,
                            n_cols, k_chunk, splits, rpd, st);
}

}  // namespace

// a_loc: this rank's (m, K) shard; w: (K, N) weight shard; out: (world*m,
// N); ag_out: (world*m, K), the gathered A; part: f32 (splits, world*m,
// N) workspace when splits > 1; base: device table of every rank's
// symmetric buffer (world*m*K elements of the dtype, signal pad at
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
  if (world < 1 || world > td::dist::kMaxWorld || rank < 0 ||
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
    return static_cast<int>(dispatch_ag<float>(
        a_loc, w, part, out, ag_out, team, c, m, k_dim, n_cols, k_chunk,
        splits, ranks_per_device, st));
  if (dtype == td::BF16 && n_cols % td::kVec<__nv_bfloat16> == 0 &&
      k_dim % td::kVec<__nv_bfloat16> == 0)
    return static_cast<int>(dispatch_ag<__nv_bfloat16>(
        a_loc, w, part, out, ag_out, team, c, m, k_dim, n_cols, k_chunk,
        splits, ranks_per_device, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
