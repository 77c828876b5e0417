// B13a's row-parallel GEMM whose f32 partials land in the owners'
// symmetric buffers (gemm_rs.cu, GEMM + ReduceScatter): every rank computes
// the product of A (world * m, K_loc) with a (K_loc, N) row shard of W,
// and rank d keeps rows [d*m, (d+1)*m), the ranks' f32 partials reduced
// with one cast. (B13b and B4 across ranks land the stream GEMM's tiles
// in one hop instead: gemm_land_stream.cuh.)
//
// What bounds it on this card. On the decode path (Qwen3-32B at TP=4,
// batch 16) the product streams the weight shard (o K_loc 2048 x N 5120,
// 21 MB of bf16; down K_loc 6400, 65.5 MB): bound by HBM bytes (6.3 us and
// 19.6 us at 3.35 TB/s). The partials that cross NVLink are 3 x 80 KB of
// f32 per rank, about a microsecond of wire time or less.
//
// Design:
//  * the GEMM is the split-K weight-streaming GEMM of gemm_splitk.cuh (the
//    f32 device code of B4's world-1 body and B12), run as work items by a
//    persistent grid over all rows: row tiles fastest, so the tiles that
//    share a weight slice run side by side and read it once from HBM;
//  * each item stores its f32 K-slice partial locally; the last of a
//    tile's K slices to finish (a per-tile counter) sums the slices in
//    slice order and stores the tile's rows into slot `rank` of the
//    (world, m, N) f32 landing buffer of the rank that keeps them (full
//    mesh, one NVLink hop);
//  * the block that lands the last tile of this rank raises this rank's
//    data flag on every rank (release at system scope, epoch-valued); a
//    barrier at the start (every rank's arrival flag) keeps a sender from
//    overwriting a slot before its owner folded the previous call;
//  * every block then folds a share of the rank's own (m, N) rows: it
//    waits (acquire) until every sender's flag is up and adds the n slots
//    in a FIXED order, slot 0 + slot 1 + ... + slot n-1 (ascending sender
//    rank), in f32, and casts once;
//  * the grid is persistent and small enough that every block of every
//    rank that shares the card is resident at once (occupancy x SMs /
//    ranks per card), so no spinning block keeps the block it waits for
//    from running.
#pragma once

#include "gemm_splitk.cuh"
#include "td_dist.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;
using namespace td_gemm;

// At least 2 blocks per SM: at most 128 registers a thread. The widest
// tile (bf16, MT = 8) is near that line; compiled with external linkage
// it took 140 registers, one block per SM, and ran B13a 1.6x slower on
// the card, so the kernels stay in an anonymous namespace of each source
// that includes this header.
template <typename T, int MT, int U>
__global__ void __launch_bounds__(NT, 2)
    gemm_land_kernel(const T* __restrict__ a, const T* __restrict__ w,
                     float* __restrict__ part, T* __restrict__ out, Team team,
                     u64* ctl, int m, int k_dim, int n_cols, int k_chunk,
                     int splits) {
  constexpr int BN = 32 * td::kVec<T>;
  const int me = team.rank, world = team.world, tid = threadIdx.x;
  const u64 e = td::dist::begin_call(ctl);
  if (blockIdx.x == 0) td::dist::arrive_all(team, e);
  td::dist::wait_all_arrived(team, e, "B13a arrival");

  const int rows = world * m;
  const int m_tiles = (rows + MT - 1) / MT;
  const int n_tiles = (n_cols + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles;
  const long items = static_cast<long>(tiles) * splits;
  const long slot = static_cast<long>(m) * n_cols;   // floats per slot
  u64* tile_done = ctl + td::dist::kCtlHeader;
  __shared__ bool last_slice;
  for (long it = blockIdx.x; it < items; it += gridDim.x) {
    const int mt = static_cast<int>(it % m_tiles);
    const long rest = it / m_tiles;
    const int ks = static_cast<int>(rest % splits);
    const int nt = static_cast<int>(rest / splits);
    gemm_tile<T, MT, U, false>(
        a, w, rows, k_dim, n_cols, k_chunk, nt, ks, mt,
        [&](int row, int col, float sum) {
          part[(static_cast<long>(ks) * rows + row) * n_cols + col] = sum;
        });
    // the last K slice of this tile to finish lands the tile
    __threadfence();
    __syncthreads();
    const int tile = nt * m_tiles + mt;
    if (tid == 0)
      last_slice = atomicAdd(tile_done + tile, 1ull) == splits - 1;
    __syncthreads();
    if (!last_slice) continue;
    __threadfence();
    const int col = nt * BN + tid;
    if (tid < BN && col < n_cols) {
      for (int r = 0; r < MT; ++r) {
        const int row = mt * MT + r;
        if (row >= rows) break;
        float sum = 0.f;
        for (int s = 0; s < splits; ++s)
          sum += __ldcg(part + (static_cast<long>(s) * rows + row) * n_cols +
                        col);
        const int d = row / m;
        reinterpret_cast<float*>(team.peer(d))[
            me * slot + static_cast<long>(row - d * m) * n_cols + col] = sum;
      }
    }
    if (tid == 0) tile_done[tile] = 0;
    td::dist::publish(team, ctl, e, tiles);
  }

  // fold the rank's own rows: slot 0 + slot 1 + ... + slot world-1
  const float* slots = reinterpret_cast<const float*>(team.peer(me));
  const long vecs = slot / 4;            // n_cols is a multiple of 4
  const long first = static_cast<long>(blockIdx.x) * NT;
  if (first < vecs) {
    if (tid == 0)
      for (int s = 0; s < world; ++s)
        td::dist::wait(team.pad(me) + td::dist::kData + s, e,
                       "B13a partials", s);
    __syncthreads();
    for (long v = first + tid; v < vecs; v += static_cast<long>(gridDim.x) *
                                               NT) {
      float4 acc = __ldcg(reinterpret_cast<const float4*>(slots) + v);
      for (int s = 1; s < world; ++s) {
        const float4 x =
            __ldcg(reinterpret_cast<const float4*>(slots + s * slot) + v);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
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

template <typename T, int MT, int U>
cudaError_t launch_land(const void* a, const void* w, void* part, void* out,
                        const Team& team, u64* ctl, int m, int k_dim,
                        int n_cols, int k_chunk, int splits,
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
          &occ, gemm_land_kernel<T, MT, U>, NT, 0);
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
  gemm_land_kernel<T, MT, U><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w),
      static_cast<float*>(part), static_cast<T*>(out), team, ctl, m, k_dim,
      n_cols, k_chunk, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_land(const void* a, const void* w, void* part,
                          void* out, const Team& team, u64* ctl, int m,
                          int k_dim, int n_cols, int k_chunk, int splits,
                          int rpd, cudaStream_t st) {
  const int rows = team.world * m;
  if (rows == 1)
    return launch_land<T, 1, 8>(a, w, part, out, team, ctl, m, k_dim,
                                      n_cols, k_chunk, splits, rpd, st);
  if (rows == 2)
    return launch_land<T, 2, 8>(a, w, part, out, team, ctl, m, k_dim,
                                      n_cols, k_chunk, splits, rpd, st);
  if (rows <= 4)
    return launch_land<T, 4, 8>(a, w, part, out, team, ctl, m, k_dim,
                                      n_cols, k_chunk, splits, rpd, st);
  return launch_land<T, 8, 4>(a, w, part, out, team, ctl, m, k_dim,
                                    n_cols, k_chunk, splits, rpd, st);
}

}  // namespace

// The C entry point's body (td_gemm_rs): a (world*m, K) rows of the
// product; w: (K, N) weight shard; out: this rank's (m, N) rows; part:
// f32 (splits, world*m, N) workspace; base: device table of every rank's
// landing slots ((world, m, N) f32, signal pad at sig_off); ctl: this
// rank's control block, zeroed once: 4 u64, then one counter per (row,
// BN-column tile) (rows * ceil(N / BN) words cover any row tile);
// ranks_per_device: ranks that share this card. One dtype (td::F32 or
// td::BF16); N a multiple of the 16-byte vector; 16-byte aligned
// pointers. Returns a cudaError_t.
inline int td_gemm_land(const void* a, const void* w, void* part, void* out,
                        int rank, int world, const void* base,
                        long long sig_off, void* ctl, int m, int k_dim,
                        int n_cols, int k_chunk, int splits,
                        int ranks_per_device, int dtype, void* stream) {
  using td::dist::u64;
  if (world < 1 || world > td::dist::kMaxWorld || rank < 0 ||
      rank >= world || m <= 0 || k_dim <= 0 || n_cols <= 0 ||
      k_chunk <= 0 || splits <= 0 || ranks_per_device < 1 ||
      static_cast<long>(k_chunk) * splits < k_dim || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const td::dist::Team team{rank, world, static_cast<const long long*>(base),
                            sig_off};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* c = static_cast<u64*>(ctl);
  if (dtype == td::F32 && n_cols % td::kVec<float> == 0)
    return static_cast<int>(dispatch_land<float>(
        a, w, part, out, team, c, m, k_dim, n_cols, k_chunk, splits,
        ranks_per_device, st));
  if (dtype == td::BF16 && n_cols % td::kVec<__nv_bfloat16> == 0)
    return static_cast<int>(dispatch_land<__nv_bfloat16>(
        a, w, part, out, team, c, m, k_dim, n_cols, k_chunk, splits,
        ranks_per_device, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
