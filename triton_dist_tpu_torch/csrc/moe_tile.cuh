// The expert-tile GEMM of the port's grouped-GEMM kernels, shared by B14
// and B15 (moe_group_gemm.cu) and B16 (ep_a2a.cu): a work item multiplies
// the live slots of one tile of a block-aligned expert schedule
// (kernels/moe_utils.py) by its expert's weight over one column tile and
// one K slice, and stores each live slot's f32 sum at the slot's output
// row of a (splits, rows, N) workspace; LiveItems counts a call's live
// items from used_tiles on the device, so a persistent grid walks live
// items only. See moe_group_gemm.cu for the design.
//
// Everything here sits in an anonymous namespace, so each source gets its
// own copy with internal linkage: with external linkage the bf16 tile took
// 140 registers and ran 1.65x slower.
#pragma once

#include "gemm_splitk.cuh"
#include "td_dist.cuh"

namespace {

using td_gemm::KC;
using td_gemm::NT;
using td_gemm::WARPS;

constexpr int BM_MAX = 128;  // the largest tile the schedule gives

// One work item: tile t of a chunk's schedule (its bm slots at slot_row /
// slot_out, expert `expert`) against the BN columns of column tile nt over
// K slice ks. A: the chunk's a_rows source rows. Each live slot's f32 sum
// goes to part[(ks * part_rows + row_base + dst) * n_cols + col]. kCoherentA
// reads A with L1-bypassing loads (rows other ranks wrote in this launch).
// A block may run items back to back: the shared arrays are guarded.
template <typename T, int MT, int U, bool kCoherentA>
__device__ __forceinline__ void tile_item(
    const T* __restrict__ a, int a_rows, const int* __restrict__ slot_row,
    const int* __restrict__ slot_out, int expert, const T* __restrict__ w,
    float* __restrict__ part, int nt, int ks, int bm, int k_dim, int n_cols,
    int k_chunk, int out_rows, long row_base, long part_rows) {
  constexpr int VEC = td::kVec<T>;
  constexpr int BN = 32 * VEC;
  __shared__ float a_s[MT][KC];
  __shared__ float red[WARPS][BN];
  __shared__ int live_src[BM_MAX];
  __shared__ int live_dst[BM_MAX];
  __shared__ int n_live;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  __syncthreads();  // the previous item's readers of live_* are done
  if (warp == 0) {
    // compact the live slots in slot order, 32 at a time (a ballot and a
    // prefix count: one load latency per 32 slots, not one per slot)
    int c = 0;
    for (int i0 = 0; i0 < bm; i0 += 32) {
      const int i = i0 + lane;
      int dst = -1, src = 0;
      if (i < bm) {
        dst = slot_out[i];
        src = slot_row[i];
      }
      const bool live = dst >= 0 && dst < out_rows;  // padding is skipped
      const unsigned mask = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int at = c + __popc(mask & ((1u << lane) - 1u));
        live_dst[at] = dst;
        live_src[at] = min(max(src, 0), a_rows - 1);
      }
      c += __popc(mask);
    }
    if (lane == 0) n_live = c;
  }
  __syncthreads();
  const int nl = n_live;
  const int n = nt * BN + lane * VEC;
  const bool n_ok = n < n_cols;  // n_cols is a multiple of VEC
  const int k_begin = ks * k_chunk;
  const int k_end = min(k_dim, k_begin + k_chunk);
  const T* we = w + static_cast<long>(expert) * k_dim * n_cols;

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
        float v = 0.f;
        if (r0 + m < nl && kk < kn) {
          const T* p = a + static_cast<long>(live_src[r0 + m]) * k_dim +
                       kc + kk;
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
      const int col = nt * BN + tid;
      if (tid < BN && col < n_cols && r0 + m < nl) {
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < WARPS; ++i) sum += red[i][tid];
        part[(static_cast<long>(ks) * part_rows + row_base +
              live_dst[r0 + m]) *
                 n_cols +
             col] = sum;
      }
    }
  }
}

// The live work items of a call across ranks, K slices fastest so a
// tile's items run side by side: chunk order ci (chunk chunk_at(ci)), then
// tile t < used_tiles of that chunk, column tile nt, K slice ks. One
// thread of each block counts them from used_tiles (on the device) into
// shared memory; a block then walks live items only, no dead tile.
struct Item {
  int ci, t, nt, ks;
};

struct LiveItems {
  int end[td::dist::kMaxWorld];   // live items of chunk orders 0..ci
  int used[td::dist::kMaxWorld];  // used tiles of chunk order ci
  int per_tile;                   // column tiles x K slices

  // Called by every thread; thread 0 fills the block's shared copy.
  template <typename ChunkAt>
  __device__ __forceinline__ void count(const int* used_tiles, int world,
                                        int n_tiles, int splits,
                                        ChunkAt chunk_at) {
    if (threadIdx.x == 0) {
      per_tile = n_tiles * splits;
      int acc = 0;
      for (int ci = 0; ci < world; ++ci) {
        used[ci] = used_tiles[chunk_at(ci)];
        acc += used[ci] * per_tile;
        end[ci] = acc;
      }
    }
    __syncthreads();
  }

  __device__ __forceinline__ int total(int world) const {
    return end[world - 1];
  }

  __device__ __forceinline__ Item at(int it, int splits) const {
    Item x;
    x.ci = 0;
    while (it >= end[x.ci]) ++x.ci;
    const int rest = it - (x.ci ? end[x.ci - 1] : 0);
    x.t = rest / per_tile;
    x.nt = rest % per_tile / splits;
    x.ks = rest % splits;
    return x;
  }
};

// A persistent grid that every block of every rank sharing the card can
// hold at once: occupancy x SMs / ranks per card, at most `items`.
unsigned resident_grid(int occ, int sms, int ranks_per_device, long items) {
  const long resident = static_cast<long>(occ) * sms / ranks_per_device;
  return static_cast<unsigned>(items < resident ? items : resident);
}

}  // namespace
