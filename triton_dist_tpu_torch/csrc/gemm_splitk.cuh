// The split-K weight-streaming GEMM of the f32 forms of B4's world-1 body
// (gemm_ar.cu) and B12 (matmul.cu): out = cast(A @ W) with f32
// accumulation, A (M, K), W (K, N); their bf16 forms run the Hopper kernel
// of gemm_stream_sm90.cuh. The overlapped kernels across ranks (ag_gemm.cu,
// B10; gemm_rs.cu, B13a; gemm_land.cuh, B4 across ranks) run this file's
// work item, gemm_tile, in bf16 and f32, from a persistent grid.
//
// What bounds it on this card. On the decode path M is the batch (4): the
// o projection (K = N = 4096) and the down projection (K = 12288, N = 4096)
// read 33.5 MB and 100.7 MB of bf16 weights for 0.13 and 0.40 GFLOP, so they
// are bound by bytes (10 us and 30 us at 3.35 TB/s), 260x below the
// tensor-core line. A kernel that reaches the bound must keep megabytes of
// weight loads in flight; the tensor cores would not help at M = 4.
//
// Design:
//  * a block owns 32 lanes x one 16-byte vector of columns (256 bf16 or 128
//    f32 columns), a K slice and an M tile of MT rows; each weight element
//    is read once for M <= 8 (larger M loops over M tiles in the grid and
//    re-reads W through L2);
//  * the 8 warps of a block split the block's K rows; each lane issues U
//    independent 16-byte weight loads before it uses any, so every SM keeps
//    tens of KB of loads in flight; A's rows for the current K step are
//    staged in shared memory as f32 and broadcast to the lanes;
//  * accumulation in f32 registers; the warps' partial sums are added in
//    warp order through shared memory, then either cast and stored (one K
//    slice) or stored as f32 partials that a second kernel sums in slice
//    order and casts, so every launch is deterministic;
//  * the K split is chosen by the caller so that enough blocks run to fill
//    the card at small M.

#pragma once

#include "td_common.cuh"

namespace td_gemm {

constexpr int NT = 256;
constexpr int WARPS = NT / 32;
constexpr int KC = 256;  // K rows of A staged per step

// One work item: rows [mt * MT, mt * MT + MT) of A against the BN
// columns of column tile nt over K slice ks. The block's f32 sums are
// handed to store(row, col, sum) by threads tid < BN, one output row at a
// time. kCoherentA reads A with L1-bypassing loads (__ldcg): for an A that
// other ranks wrote during this launch (the gathered A of B10). Any block
// may run items back to back: the shared tiles are guarded by barriers.
template <typename T, int MT, int U, bool kCoherentA, typename Store>
__device__ __forceinline__ void gemm_tile(const T* __restrict__ a,
                                          const T* __restrict__ w,
                                          int m_rows, int k_dim, int n_cols,
                                          int k_chunk, int nt, int ks,
                                          int mt, Store store) {
  constexpr int VEC = td::kVec<T>;
  constexpr int BN = 32 * VEC;
  __shared__ float a_s[MT][KC];
  __shared__ float red[WARPS][BN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n = nt * BN + lane * VEC;
  const bool n_ok = n < n_cols;  // n_cols is a multiple of VEC
  const int k_begin = ks * k_chunk;
  const int k_end = min(k_dim, k_begin + k_chunk);
  const int m0 = mt * MT;

  float acc[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[m][j] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += KC) {
    const int kn = min(KC, k_end - kc);
    __syncthreads();  // the previous step's readers of a_s are done
    for (int i = tid; i < MT * KC; i += NT) {
      const int m = i / KC, kk = i % KC;
      float v = 0.f;
      if (m0 + m < m_rows && kk < kn) {
        const T* p = a + static_cast<long>(m0 + m) * k_dim + kc + kk;
        v = td::to_f(kCoherentA ? __ldcg(p) : *p);
      }
      a_s[m][kk] = v;
    }
    __syncthreads();
    if (n_ok) {
      for (int k0 = warp * U; k0 < kn; k0 += WARPS * U) {
        uint4 wv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          wv[u] = make_uint4(0u, 0u, 0u, 0u);
          if (k0 + u < kn)
            wv[u] = __ldg(reinterpret_cast<const uint4*>(
                w + static_cast<long>(kc + k0 + u) * n_cols + n));
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (k0 + u >= kn) break;
          float wf[VEC];
          td::unpack(wv[u], wf, static_cast<const T*>(nullptr));
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float av = a_s[m][k0 + u];
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[m][j] = fmaf(av, wf[j], acc[m][j]);
          }
        }
      }
    }
  }

  // sum the warps' partials in warp order, one output row at a time
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < VEC; ++j) red[warp][lane * VEC + j] = acc[m][j];
    __syncthreads();
    const int col = nt * BN + tid;
    if (tid < BN && col < n_cols && m0 + m < m_rows) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) sum += red[i][tid];
      store(m0 + m, col, sum);
    }
  }
}

template <typename T, int MT, int U>
__global__ void __launch_bounds__(NT)
    gemm_kernel(const T* __restrict__ a, const T* __restrict__ w,
                float* __restrict__ part, T* __restrict__ out, int m_rows,
                int k_dim, int n_cols, int k_chunk) {
  const long ks = blockIdx.y;
  gemm_tile<T, MT, U, false>(
      a, w, m_rows, k_dim, n_cols, k_chunk, blockIdx.x, blockIdx.y,
      blockIdx.z, [&](int row, int col, float sum) {
        if (part != nullptr)
          part[(ks * m_rows + row) * n_cols + col] = sum;
        else
          out[static_cast<long>(row) * n_cols + col] = td::from_f<T>(sum);
      });
}

// out = cast(sum of the K slices' f32 partials, in slice order)
template <typename T>
__global__ void __launch_bounds__(NT)
    reduce_kernel(const float* __restrict__ part, T* __restrict__ out,
                  int splits, long mn) {
  const long i = static_cast<long>(blockIdx.x) * NT + threadIdx.x;
  if (i >= mn) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += part[s * mn + i];
  out[i] = td::from_f<T>(sum);
}

template <typename T, int MT, int U>
cudaError_t launch(const void* a, const void* w, void* part, void* out,
                   int m_rows, int k_dim, int n_cols, int k_chunk,
                   int splits, cudaStream_t stream) {
  constexpr int BN = 32 * td::kVec<T>;
  const dim3 grid((n_cols + BN - 1) / BN, splits, (m_rows + MT - 1) / MT);
  gemm_kernel<T, MT, U><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w),
      splits > 1 ? static_cast<float*>(part) : nullptr, static_cast<T*>(out),
      m_rows, k_dim, n_cols, k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long mn = static_cast<long>(m_rows) * n_cols;
  reduce_kernel<T><<<static_cast<unsigned>((mn + NT - 1) / NT), NT, 0,
                     stream>>>(static_cast<const float*>(part),
                               static_cast<T*>(out), splits, mn);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* a, const void* w, void* part, void* out,
                     int m_rows, int k_dim, int n_cols, int k_chunk,
                     int splits, cudaStream_t st) {
  if (m_rows == 1)
    return launch<T, 1, 8>(a, w, part, out, m_rows, k_dim, n_cols, k_chunk,
                           splits, st);
  if (m_rows == 2)
    return launch<T, 2, 8>(a, w, part, out, m_rows, k_dim, n_cols, k_chunk,
                           splits, st);
  if (m_rows <= 4)
    return launch<T, 4, 8>(a, w, part, out, m_rows, k_dim, n_cols, k_chunk,
                           splits, st);
  return launch<T, 8, 4>(a, w, part, out, m_rows, k_dim, n_cols, k_chunk,
                         splits, st);
}

}  // namespace td_gemm

// The f32 forms' launch (see gemm_ar.cu and matmul.cu): validates the
// arguments and launches; returns a cudaError_t.
inline int td_gemm_splitk_f32(const void* a, const void* w, void* part,
                              void* out, int m_rows, int k_dim, int n_cols,
                              int k_chunk, int splits, void* stream) {
  using namespace td_gemm;
  if (m_rows <= 0 || k_dim <= 0 || n_cols <= 0 || k_chunk <= 0 ||
      splits <= 0 || static_cast<long>(k_chunk) * splits < k_dim ||
      (splits > 1 && part == nullptr) || n_cols % td::kVec<float> != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<float>(a, w, part, out, m_rows, k_dim,
                                          n_cols, k_chunk, splits,
                                          static_cast<cudaStream_t>(stream)));
}
