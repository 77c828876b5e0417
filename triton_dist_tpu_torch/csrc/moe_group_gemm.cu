// B14 and B15 at world 1: the expert grouped GEMMs of the tensor-parallel
// MoE layer, hand-written for Hopper (sm_90a).
//
// Replace the TPU kernels kernels/allgather_group_gemm.py::
// _ag_group_gemm_kernel (B14, the gate/up grouped GEMM; its token ring is
// empty at n = 1) and kernels/moe_reduce_rs.py::_moe_rs_kernel (B15, the
// down grouped GEMM + weighted top-k combine; no ring at n = 1). Both walk
// the block-aligned schedule of kernels/moe_utils.py: tile t < used_tiles
// holds bm slots of one expert tile_expert[t]; a slot maps to a source row
// and to a token-major flat output row, or is padding (sentinel).
//
//  * B14: out[f] = cast(tokens[row_token[s]] @ W_gate_up[e]) for every live
//    slot s with f = row_flat[s]. The TPU kernel writes the aligned buffer
//    and gathers it by aligned_pos afterwards; writing through row_flat is
//    the same function, and padding slots are never written.
//  * B15: y[tok] = cast(sum over the token's top-k choices, in ascending
//    expert order (the tile order of the TPU kernel's fold), of
//    w[f] * (inter[f] @ W_down[e]) in f32). The TPU kernel folds each tile
//    through the dense combine matrix G, which has one nonzero per live
//    slot; the weighted add of each slot's f32 row is the same function.
//
// What bounds them on this card. At the decode shape of Qwen3-30B-A3B (4
// tokens, top-8 of 128 experts) about 28 distinct experts are live per
// layer, each tile with one or two real rows: B14 reads ~28 gate/up slabs
// of 2048 x 1536 bf16 (6.3 MB each), B15 ~28 down slabs of 768 x 2048
// (3.1 MB), for a few MFLOP. They are weight streams, bound by bytes.
//
// Design: the split-K streaming GEMM of B4 (gemm_splitk.cuh) with the A
// rows gathered per tile. Phase 1, grid (column tile, K slice, tile):
//  * a block whose tile is >= used_tiles (read on the device) exits;
//  * the block compacts its tile's live slots in slot order in shared
//    memory, then for each group of MT live rows stages their K slice in
//    shared memory as f32 and streams its expert's weight rows, 8 warps x
//    U independent 16-byte loads per lane in flight, f32 accumulation;
//  * the warps' partials are added in warp order and written as f32 to a
//    (splits, M * topk, N) workspace at the slot's flat row.
// Phase 2 sums the K slices in slice order: B14 casts each flat row, B15
// folds each token's choices in ascending expert order. No float atomics:
// every launch gives the same bits. The K split fills the card at decode
// (about 4 blocks per SM over the live tiles).

#include <climits>

#include "gemm_splitk.cuh"

namespace {

using td_gemm::KC;
using td_gemm::NT;
using td_gemm::WARPS;

constexpr int BM_MAX = 128;  // the largest tile the schedule gives

template <typename T, int MT, int U>
__global__ void __launch_bounds__(NT)
    tile_gemm_kernel(const T* __restrict__ a, int a_rows,
                     const int* __restrict__ slot_row,
                     const int* __restrict__ slot_out,
                     const int* __restrict__ tile_expert,
                     const int* __restrict__ used_tiles,
                     const T* __restrict__ w, float* __restrict__ part, int bm,
                     int k_dim, int n_cols, int k_chunk, int out_rows) {
  constexpr int VEC = td::kVec<T>;
  constexpr int BN = 32 * VEC;
  __shared__ float a_s[MT][KC];
  __shared__ float red[WARPS][BN];
  __shared__ int live_src[BM_MAX];
  __shared__ int live_dst[BM_MAX];
  __shared__ int n_live;

  const int t = blockIdx.z;
  if (t >= used_tiles[0]) return;  // a dead tile: the whole block leaves
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    int c = 0;
    for (int i = 0; i < bm; ++i) {
      const long s = static_cast<long>(t) * bm + i;
      const int dst = slot_out[s];
      if (dst >= 0 && dst < out_rows) {  // padding slots are skipped
        live_dst[c] = dst;
        live_src[c] = min(max(slot_row[s], 0), a_rows - 1);
        ++c;
      }
    }
    n_live = c;
  }
  __syncthreads();
  const int nl = n_live;
  const int n = blockIdx.x * BN + lane * VEC;
  const bool n_ok = n < n_cols;  // n_cols is a multiple of VEC
  const int k_begin = blockIdx.y * k_chunk;
  const int k_end = min(k_dim, k_begin + k_chunk);
  const T* we = w + static_cast<long>(tile_expert[t]) * k_dim * n_cols;

  for (int r0 = 0; r0 < nl; r0 += MT) {
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
        a_s[m][kk] = (r0 + m < nl && kk < kn)
                         ? td::to_f(a[static_cast<long>(live_src[r0 + m]) *
                                          k_dim +
                                      kc + kk])
                         : 0.f;
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
                  we + static_cast<long>(kc + k0 + u) * n_cols + n));
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
              for (int j = 0; j < VEC; ++j)
                acc[m][j] = fmaf(av, wf[j], acc[m][j]);
            }
          }
        }
      }
    }

    // the warps' partials in warp order, one live row at a time
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      __syncthreads();
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[warp][lane * VEC + j] = acc[m][j];
      __syncthreads();
      const int col = blockIdx.x * BN + tid;
      if (tid < BN && col < n_cols && r0 + m < nl) {
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < WARPS; ++i) sum += red[i][tid];
        part[(static_cast<long>(blockIdx.y) * out_rows + live_dst[r0 + m]) *
                 n_cols +
             col] = sum;
      }
    }
  }
}

// y[tok] = cast(sum over the token's choices in ascending expert order of
// w[f] * (the K slices of row f summed in slice order)); one thread per
// (token, column).
template <typename T>
__global__ void __launch_bounds__(NT)
    combine_kernel(const float* __restrict__ part,
                   const int* __restrict__ topk_ids,
                   const float* __restrict__ topk_w, T* __restrict__ out,
                   int splits, int topk, int out_rows, int n_cols) {
  const int tok = blockIdx.y;
  const int col = blockIdx.x * NT + threadIdx.x;
  if (col >= n_cols) return;
  const int* ids = topk_ids + static_cast<long>(tok) * topk;
  const long mn = static_cast<long>(out_rows) * n_cols;
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
    const long f = static_cast<long>(tok) * topk + best;
    float p = 0.f;
    for (int s = 0; s < splits; ++s) p += part[s * mn + f * n_cols + col];
    acc = __fadd_rn(acc, __fmul_rn(topk_w[f], p));
  }
  out[static_cast<long>(tok) * n_cols + col] = td::from_f<T>(acc);
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

}  // namespace

// B14. a: tokens (a_rows, K); row_token / row_flat / tile_expert /
// used_tiles: the chunk's schedule (R = t_tiles * bm slots, int32 on the
// device); w: (E, K, N); part: f32 (splits, out_rows, N) workspace; out:
// (out_rows = M * topk, N) token-major. One dtype (td::F32 or td::BF16) for
// a, w and out; w 16-byte aligned, N a multiple of the 16-byte vector.
// Returns a cudaError_t.
extern "C" int td_group_gemm(const void* a, int a_rows, const int* row_token,
                             const int* row_flat, const int* tile_expert,
                             const int* used_tiles, const void* w, void* part,
                             void* out, int t_tiles, int bm, int k_dim,
                             int n_cols, int k_chunk, int splits,
                             int out_rows, int max_rows, int dtype,
                             void* stream) {
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
    td_gemm::reduce_kernel<__nv_bfloat16><<<blocks, NT, 0, st>>>(
        p, static_cast<__nv_bfloat16*>(out), splits, mn);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// B15. inter: (a_rows = M * topk, K) token-major; row_flat / tile_expert /
// used_tiles: the chunk's schedule; w: (E, K, N); topk_ids (M, topk) int32
// and topk_w (M, topk) f32; part: f32 (splits, M * topk, N) workspace; out:
// (M, N). One dtype (td::F32 or td::BF16) for inter, w and out. Returns a
// cudaError_t.
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
