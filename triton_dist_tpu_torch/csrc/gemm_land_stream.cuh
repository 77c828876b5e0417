// The one-hop landing of a row-parallel GEMM's f32 partials on an
// NVSwitch full mesh, shared by B13b (gemm_rs.cu: each row lands only on
// the rank that keeps it, kAll = false) and B4 across ranks (gemm_ar.cu:
// every row lands on every rank, kAll = true). Every rank computes the
// product of its A (rows, K_loc) with its (K_loc, N) shard of W in one
// pass over W, stores each finished f32 row into its own (sender-indexed)
// landing slot on the ranks that keep the row, and each rank folds the n
// senders' slots of its rows in f32 and casts once:
//  * B13b (rows = world * m, rank d keeps rows [d m, (d + 1) m)): the
//    arcs' fold of kernels/plain.py::bidir_rs_fold, own + the right chain
//    + the left chain;
//  * B4 (rows = m, every rank keeps all m rows): slot 0 + slot 1 + ... +
//    slot n-1 (kernels/plain.py::slot_fold, the TPU kernel's reduce_chunk
//    order), the same on every rank, so every rank returns the same
//    bytes.
//
// Design:
//  * bf16: the Hopper decode GEMM of gemm_stream_sm90.cuh (W in 128 x 128
//    tiles by TMA through its 5-stage ring, mma.sync m16n8k16 with the
//    operands swapped, the persistent stream-K grid and its split-K fold
//    in block order; with many M groups, whole tiles taken column-tile
//    major) over all rows, with the epilogue LandStream: each consumer
//    warp stages its finished 32 columns of a tile's f32 rows in shared
//    memory and stores each row, as 16-byte vectors, into this sender's
//    slot on every rank that keeps the row (one NVLink hop; the own rows
//    into the own slot), while the other warps and blocks stream on. f32
//    (the gates): gemm_splitk.cuh's FMA item over all rows, the last K
//    slice of a tile summing the slices in slice order and landing the
//    tile the same way;
//  * two signalling protocols, by the bytes of a slot (one sender's m
//    rows of N f32; the launchers' plans, from four-card sweeps): LL lines
//    (td_oneshot.cuh: each 16-byte vector as two lines that carry the
//    call's epoch; no fence, no flag) or flags (a u64 per (sender, row
//    group, 32-column quarter) on every rank that keeps the group's rows,
//    set to the epoch after one system fence by every storing lane);
//  * after its items every consumer warp folds a share of the rank's own
//    rows, a (row group, quarter) at a time: it reads the n senders'
//    vectors as their LL lines land (or once their flags are up), adds
//    them in the op's order in f32 and casts once. No block waits while
//    it still has a product to compute, so the grid never waits on
//    itself;
//  * an epoch word a block in the control block (read before the kernel's
//    first barrier, stored at the end); the slots are double-buffered by
//    the epoch's parity, with no opening barrier: a rank writes rank p's
//    slots of parity P in call e + 2 only after it finished call e + 1,
//    whose fold waited for p's rows of call e + 1 (every rank receives
//    from every sender in every call), which p stored only after its call
//    e kernel (the last reader of parity P) had ended. Two ops that share
//    a plan (B4's o and down at decode) share one workspace: every call
//    of either advances every block's epoch once;
//  * the grid is at most the SMs / ranks per card (one block an SM), so
//    every block of every rank that shares the card is resident at once.
#pragma once

#include "gemm_splitk.cuh"
#include "gemm_stream_sm90.cuh"
#include "td_oneshot.cuh"

namespace {
namespace land {

namespace os = td::oneshot;
namespace ts = td_stream;
using td::dist::Team;
using td::dist::u64;
using td_gemm::gemm_tile;
using td_gemm::NT;

// What a launch passes besides its tensors: the same on every rank (the
// launchers' plans: kernels/gemm_allreduce.py::land_layout).
struct Land {
  Team team;
  int m;                  // rows a rank keeps (B13b: a chunk; B4: all)
  int rows;               // the product's rows (B13b: world * m; B4: m)
  int n;                  // columns, a multiple of 4
  int rg;                 // rows a landing group: the GEMM's row tile
  int ll;                 // LL lines (1) or flags (0)
  long long slot_bytes;   // one sender's m rows on a rank
  long long flag_off;     // flags: u64 [sender][group][quarter]
  u64* epoch;             // this rank's epoch words, one a block
};

__device__ __forceinline__ int quarters(const Land& L) {
  return (L.n + 31) / 32;
}

__device__ __forceinline__ u64* flag(const Land& L, int p, int s, int g,
                                     int q) {
  const long groups = (L.rows + L.rg - 1) / L.rg;
  return os::flags(L.team, p, L.flag_off) +
         (s * groups + g) * quarters(L) + q;
}

// Sender s's slot of parity par on rank p.
__device__ __forceinline__ char* slot(const Land& L, int p, int par, int s) {
  return L.team.peer(p) +
         (static_cast<long long>(par) * L.team.world + s) * L.slot_bytes;
}

__device__ __forceinline__ void put(const Land& L, char* dst, long v,
                                    const uint4& val, unsigned f) {
  if (L.ll)
    os::put_vec<true>(dst, v, val, f);
  else
    os::put_vec<false>(dst, v, val, f);
}

// Columns [4 c4, 4 c4 + 4) of the product's row `row`, f32, into this
// sender's slot on each rank that keeps the row: B13b its owner, B4 every
// rank, the next rank first and this rank last.
template <bool kAll>
__device__ __forceinline__ void land_vec(const Land& L, int par, unsigned f,
                                         int row, int c4, const uint4& val) {
  const int me = L.team.rank, world = L.team.world;
  if (kAll) {
    const long v = static_cast<long>(row) * (L.n / 4) + c4;
    for (int i = 1; i <= world; ++i)
      put(L, slot(L, (me + i) % world, par, me), v, val, f);
    return;
  }
  const int c = row / L.m;
  const long v = static_cast<long>(row - c * L.m) * (L.n / 4) + c4;
  put(L, slot(L, c, par, me), v, val, f);
}

// The ranks that keep row group g's rows: [first, last].
template <bool kAll>
__device__ __forceinline__ int2 owners(const Land& L, int g) {
  if (kAll) return make_int2(0, L.team.world - 1);
  const int r1 = min((g + 1) * L.rg, L.rows);
  return make_int2(g * L.rg / L.m, (r1 - 1) / L.m);
}

// Under flags, after this thread's (and its group's) stores: raise flag
// (this sender, g, q) on owner ow.x + i, for thread i of the group.
template <bool kAll>
__device__ __forceinline__ void raise_flag(const Land& L, u64 e, int g,
                                           int q, int i) {
  const int2 ow = owners<kAll>(L, g);
  if (i <= ow.y - ow.x)
    td::dist::notify(flag(L, ow.x + i, L.team.rank, g, q), e);
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// The fold of the n terms y[d]: B4 (kAll; y[d] the partial of rank d)
// slot 0 + slot 1 + ... + slot n-1; B13b (y[d] the partial of rank me + d
// mod n) bidir_rs_fold: own + the right chain (distances n - kr .. n - 1,
// each hop own + arrival) + the left chain (distances kl .. 1).
template <bool kAll>
__device__ __forceinline__ float4 fold(const float4 (&y)[td::dist::kMaxWorld],
                                       int n) {
  if (kAll) {
    float4 acc = y[0];
#pragma unroll
    for (int d = 1; d < td::dist::kMaxWorld; ++d)
      if (d < n) acc = add4(acc, y[d]);
    return acc;
  }
  const int kr = n / 2, kl = (n - 1) / 2;
  float4 right = y[0], left = y[0];
#pragma unroll
  for (int d = 1; d < td::dist::kMaxWorld; ++d)
    if (d >= n - kr && d < n) right = d == n - kr ? y[d] : add4(y[d], right);
#pragma unroll
  for (int d = td::dist::kMaxWorld - 1; d >= 1; --d)
    if (d <= kl) left = d == kl ? y[d] : add4(y[d], left);
  const float4 out = add4(y[0], right);
  return kl > 0 ? add4(out, left) : out;
}

__device__ __forceinline__ void store4(float* out, const float4& v) {
  *reinterpret_cast<float4*>(out) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* out, const float4& v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v.x, v.y),
                         __floats2bfloat162_rn(v.z, v.w)};
  *reinterpret_cast<uint2*>(out) = *reinterpret_cast<const uint2*>(h);
}

// The first of the product's rows that this rank keeps.
template <bool kAll>
__device__ __forceinline__ int first_row(const Land& L) {
  return kAll ? 0 : L.team.rank * L.m;
}

// One warp folds this rank's rows of row group g, columns [32 q, 32 q +
// 32), into out (m, N).
template <typename T, bool kAll>
__device__ __forceinline__ void fold_unit(const Land& L, u64 e, int g, int q,
                                          T* __restrict__ out, int lane) {
  const int me = L.team.rank, n = L.team.world, kv = L.n / 4;
  const int par = static_cast<int>(e & 1);
  const unsigned f = static_cast<unsigned>(e);
  const int lo = first_row<kAll>(L);
  const int r0 = max(g * L.rg, lo);
  const int r1 = min(min((g + 1) * L.rg, L.rows), lo + L.m);
  const int c0 = 8 * q, cw = min(8, kv - c0);
  if (!L.ll) {
    if (lane < n)
      os::await_flag(flag(L, me, lane, g, q), e,
                     kAll ? "B4 tile" : "B13b tile", lane);
    __syncwarp();
  }
  for (int i = lane; i < (r1 - r0) * cw; i += 32) {
    const int lr = r0 - lo + i / cw, c4 = c0 + i % cw;
    const long v = static_cast<long>(lr) * kv + c4;
    float4 y[td::dist::kMaxWorld];
#pragma unroll
    for (int d = 0; d < td::dist::kMaxWorld; ++d)
      if (d < n) {
        const int s = kAll ? d : (me + d) % n;
        const char* src = slot(L, me, par, s);
        const char* what = kAll ? "B4 line" : "B13b line";
        const uint4 u = L.ll ? os::get_vec<true>(src, v, f, what, s)
                             : os::get_vec<false>(src, v, f, what, s);
        y[d] = make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                           __uint_as_float(u.z), __uint_as_float(u.w));
      }
    store4(out + static_cast<long>(lr) * L.n + 4 * c4, fold<kAll>(y, n));
  }
}

// The fold of this rank's rows, (row group, quarter) units spread over
// `nw` warps; warp gw of them.
template <typename T, bool kAll>
__device__ __forceinline__ void fold_all(const Land& L, u64 e,
                                         T* __restrict__ out, int gw, int nw,
                                         int lane) {
  const int nq = quarters(L), lo = first_row<kAll>(L);
  const int g0 = lo / L.rg, g1 = (lo + L.m - 1) / L.rg;
  const long units = static_cast<long>(g1 - g0 + 1) * nq;
  for (long u = gw; u < units; u += nw)
    fold_unit<T, kAll>(L, e, g0 + static_cast<int>(u / nq),
                       static_cast<int>(u % nq), out, lane);
}

constexpr int SLD = 36;   // a staged row (floats): 32 columns, 16-byte rows

// gemm_stream_sm90.cuh's epilogue: a consumer warp's finished 32 columns
// of a tile, staged as (MG rows x 32) f32, then landed row by row in
// 16-byte vectors; under flags the warp raises (sender, group, quarter)
// on each rank that keeps the group's rows. end: the fold.
template <int MG, bool kAll>
struct LandStream {
  static constexpr size_t kSmemBytes = size_t(ts::NCW) * MG * SLD * 4;
  Land L;
  __nv_bfloat16* out;
  u64 e;
  float* stage;

  __device__ __forceinline__ void begin(void* smem) {
    e = __ldcg(L.epoch + blockIdx.x) + 1;
    stage = static_cast<float*>(smem);
  }

  __device__ __forceinline__ void tile(const ts::Plan& p, long long t,
                                       int warp, int lane,
                                       const float (&acc)[ts::NS][MG / 8][4]) {
    float* st = stage + warp * MG * SLD;
#pragma unroll
    for (int s = 0; s < ts::NS; ++s)
#pragma unroll
      for (int j = 0; j < MG / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          st[(8 * j + 2 * (lane & 3) + (r & 1)) * SLD + 16 * s +
             (lane >> 2) + 8 * (r >> 1)] = acc[s][j][r];
    __syncwarp();
    const int mg = static_cast<int>(t / p.n_tiles);
    const int col0 = static_cast<int>(t % p.n_tiles) * ts::BN + 32 * warp;
    const int par = static_cast<int>(e & 1);
    for (int i = lane; i < MG * 8; i += 32) {
      const int r = i >> 3, col = col0 + 4 * (i & 7);
      const int row = mg * MG + r;
      if (row < L.rows && col < L.n)
        land_vec<kAll>(
            L, par, static_cast<unsigned>(e), row, col / 4,
            *reinterpret_cast<const uint4*>(st + r * SLD + 4 * (i & 7)));
    }
    __syncwarp();
    if (!L.ll && col0 < L.n) {
      __threadfence_system();
      __syncwarp();
      raise_flag<kAll>(L, e, mg, col0 / 32, lane);
    }
  }

  __device__ __forceinline__ void end(const ts::Plan&, int warp, int lane) {
    fold_all<__nv_bfloat16, kAll>(L, e, out, blockIdx.x * ts::NCW + warp,
                                  gridDim.x * ts::NCW, lane);
    if (threadIdx.x == 0) L.epoch[blockIdx.x] = e;
  }
};

// f32: gemm_splitk.cuh's FMA item over all rows, items (row tile, K slice,
// column tile) in a persistent grid; the last K slice of a tile (a counter
// per tile after the epoch words) sums the slices in slice order, stages
// the tile and lands it; then the fold, by the block's 8 warps.
template <int MT, int U, bool kAll>
__global__ void __launch_bounds__(NT)
    land_f32_kernel(const float* __restrict__ a, const float* __restrict__ w,
                    float* __restrict__ part, float* __restrict__ out,
                    Land L, int k_dim, int k_chunk, int splits) {
  constexpr int BN = 32 * td::kVec<float>;
  constexpr int SW = BN + 4;
  const os::Epoch ep(L.epoch - td::dist::kCtlHeader);
  const int tid = threadIdx.x, par = static_cast<int>(ep.e & 1);
  const unsigned f = static_cast<unsigned>(ep.e);
  const int m_tiles = (L.rows + MT - 1) / MT;
  const int n_tiles = (L.n + BN - 1) / BN;
  const long items = static_cast<long>(m_tiles) * n_tiles * splits;
  const long mn = static_cast<long>(L.rows) * L.n;
  u64* done = L.epoch + gridDim.x;
  __shared__ bool last_slice;
  __shared__ __align__(16) float stage[MT][SW];
  for (long it = blockIdx.x; it < items; it += gridDim.x) {
    const int mt = static_cast<int>(it % m_tiles);
    const long rest = it / m_tiles;
    const int ks = static_cast<int>(rest % splits);
    const int nt = static_cast<int>(rest / splits);
    gemm_tile<float, MT, U, false>(
        a, w, L.rows, k_dim, L.n, k_chunk, nt, ks, mt,
        [&](int row, int col, float sum) {
          part[ks * mn + static_cast<long>(row) * L.n + col] = sum;
        });
    __threadfence();
    __syncthreads();
    u64* cnt = done + static_cast<long>(nt) * m_tiles + mt;
    if (tid == 0) last_slice = atomicAdd(cnt, 1ull) == splits - 1;
    __syncthreads();
    if (!last_slice) continue;
    __threadfence();
    for (int i = tid; i < MT * BN; i += NT) {
      const int r = i / BN, row = mt * MT + r, col = nt * BN + i % BN;
      float sum = 0.f;
      if (row < L.rows && col < L.n)
        for (int q = 0; q < splits; ++q)
          sum += __ldcg(part + q * mn + static_cast<long>(row) * L.n + col);
      stage[r][i % BN] = sum;
    }
    __syncthreads();
    for (int i = tid; i < MT * BN / 4; i += NT) {
      const int r = i / (BN / 4), c = i % (BN / 4);
      const int row = mt * MT + r, col = nt * BN + 4 * c;
      if (row < L.rows && col < L.n)
        land_vec<kAll>(L, par, f, row, col / 4,
                       *reinterpret_cast<const uint4*>(&stage[r][4 * c]));
    }
    if (!L.ll) {
      __threadfence_system();
      __syncthreads();
      const int q = nt * 4 + tid % 4;
      if (q < quarters(L)) raise_flag<kAll>(L, ep.e, mt, q, tid / 4);
    }
    __syncthreads();
    if (tid == 0) *cnt = 0;
  }
  fold_all<float, kAll>(L, ep.e, out, blockIdx.x * (NT / 32) + tid / 32,
                        gridDim.x * (NT / 32), tid & 31);
  ep.close();
}

template <int MG, bool kAll>
cudaError_t launch_bf16(const void* a, const void* w, void* ws, void* out,
                        const Land& L, int k_dim, int grid, int rpd,
                        cudaStream_t st) {
  using Epi = LandStream<MG, kAll>;
  // queried once per instantiation (the first call, never under a CUDA
  // graph capture: callers warm up first)
  static int sms = 0, occ = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = ts::set_smem<MG, Epi>(dev);
  if (err == cudaSuccess && occ == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, ts::stream_kernel<MG, Epi>, ts::NTH,
          ts::smem_bytes<MG, Epi>());
  }
  if (err != cudaSuccess) {
    occ = 0;
    return err;
  }
  if (static_cast<long>(grid) * rpd > static_cast<long>(occ) * sms)
    return cudaErrorInvalidConfiguration;
  ts::Plan p;
  ts::plan_of(&p, a, L.rows, k_dim, L.n, grid);
  if (grid > p.units) return cudaErrorInvalidConfiguration;
  // many M groups (prefill): whole tiles, column-tile major
  const long long tiles = p.units / p.n_kt;
  p.whole = tiles > p.n_tiles && tiles >= 4LL * grid;
  CUtensorMap map;
  if (!ts::rows_map(&map, w, k_dim, L.n, ts::BK, dev))
    return cudaErrorNotSupported;
  const Epi epi{L, static_cast<__nv_bfloat16*>(out), 0, nullptr};
  return ts::launch<MG, Epi>(map, static_cast<const __nv_bfloat16*>(a), epi,
                             static_cast<float*>(ws),
                             reinterpret_cast<int*>(L.epoch + grid), p, dev,
                             st);
}

template <int MT, int U, bool kAll>
cudaError_t launch_f32(const void* a, const void* w, void* part, void* out,
                       const Land& L, int k_dim, int k_chunk, int splits,
                       int grid, int rpd, cudaStream_t st) {
  static int occ = 0;
  const cudaError_t err =
      os::check_resident(land_f32_kernel<MT, U, kAll>, &occ, grid, rpd);
  if (err != cudaSuccess) return err;
  land_f32_kernel<MT, U, kAll><<<grid, NT, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(w),
      static_cast<float*>(part), static_cast<float*>(out), L, k_dim, k_chunk,
      splits);
  return cudaGetLastError();
}

// The C entry points' common body (td_gemm_rs_bidir, td_gemm_ar_tp),
// under the launcher's plan (kernels/gemm_allreduce.py::land_layout). a:
// (rows, K) rows of the product (rows = world * m for B13b, m for B4);
// w: (K, N) weight shard, 16-byte aligned; out: this rank's (m, N) rows;
// base: device table of every rank's symmetric buffer (landing slots (2,
// world) of slot_bytes from byte 0, [parity][sender], m rows of N f32
// plain or as LL lines; under flags the u64 flags (world, groups,
// ceil(N / 32)) at flag_off, zeroed once); ctl: this rank's control
// block, zeroed once: 4 u64, an epoch word a block, then bf16: the stream
// kernel's tickets (4 int a block), f32: a counter per (column tile, row
// tile); rg: rows a landing group (bf16: 8 up to 8 rows, else 16; f32:
// the row tile, 1, 2, 4 or 8 by the rows); part: bf16 the stream kernel's
// workspace (2 grid x 128 x rg f32), f32 (splits, rows, N) with k_chunk *
// splits >= K; grid: blocks, at most the SMs / ranks_per_device. N a
// multiple of 8 (bf16) or 4 (f32). Returns a cudaError_t.
template <bool kAll>
int land_gemm(const void* a, const void* w, void* part, void* out, int rank,
              int world, const void* base, void* ctl, int m, int k_dim,
              int n_cols, int rg, int ll, long long slot_bytes,
              long long flag_off, int grid, int k_chunk, int splits,
              int ranks_per_device, int dtype, void* stream) {
  const int rows = kAll ? m : world * m;
  if (world < 1 || world > td::dist::kMaxWorld || rank < 0 ||
      rank >= world || m <= 0 || k_dim <= 0 || n_cols <= 0 ||
      n_cols % 4 != 0 || grid < 1 || ranks_per_device < 1 || part == nullptr ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      slot_bytes < static_cast<long long>(m) * n_cols * 4 * (ll ? 2 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Land L{Team{rank, world, static_cast<const long long*>(base), 0},
               m, rows, n_cols, rg, ll, slot_bytes, flag_off,
               static_cast<u64*>(ctl) + td::dist::kCtlHeader};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == td::BF16 && n_cols % 8 == 0) {
    if (rg != (rows <= 8 ? 8 : 16))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        rows <= 8 ? launch_bf16<8, kAll>(a, w, part, out, L, k_dim, grid,
                                         ranks_per_device, st)
                  : launch_bf16<16, kAll>(a, w, part, out, L, k_dim, grid,
                                          ranks_per_device, st));
  }
  if (dtype != td::F32 || k_chunk <= 0 || splits <= 0 ||
      static_cast<long>(k_chunk) * splits < k_dim ||
      rg != (rows == 1 ? 1 : rows == 2 ? 2 : rows <= 4 ? 4 : 8))
    return static_cast<int>(cudaErrorInvalidValue);
#define TD_LAND_F32(MT, U)                                                  \
  launch_f32<MT, U, kAll>(a, w, part, out, L, k_dim, k_chunk, splits, grid, \
                          ranks_per_device, st)
  return static_cast<int>(rg == 1   ? TD_LAND_F32(1, 8)
                          : rg == 2 ? TD_LAND_F32(2, 8)
                          : rg == 4 ? TD_LAND_F32(4, 8)
                                    : TD_LAND_F32(8, 4));
#undef TD_LAND_F32
}

}  // namespace land
}  // namespace
