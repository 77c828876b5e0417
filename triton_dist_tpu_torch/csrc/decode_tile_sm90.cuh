// The Hopper (sm_90a) body of the port's split-KV decode partials in bf16:
// B19 over a dense key shard (flash_decode.cu) and B2 over a paged pool
// (paged_flash_decode.cu). One block folds one split of one (batch row, kv
// head): the g query heads of the kv head against the split's live keys,
// into an unnormalized (acc, m, l) partial.
//
// What bounds it on this card. A decode step reads each live key and value
// row once and does ~4 g D flops on it, about g flops a byte: far below the
// ~295 at which the tensor cores, and not the memory, become the limit. So
// bytes bound it, and every SM has to keep tens of KB of loads in flight.
//
// Design:
//  * one producer warp keeps STAGES tiles of KT keys of K and V in flight
//    by TMA (in the 128-byte swizzle: attn_tile_sm90.cuh's layout) through
//    an mbarrier ring; where a tile's rows come from is the source's
//    (Src::load_tile): B19's 4-D maps over the shard's strides, B2's 2-D
//    map over the pool's rows, a box per page of the tile, each page
//    translated by the block table;
//  * four consumer warps: warp w takes keys [16w, 16w + 16) of every tile
//    with its own online softmax. QK^T and P.V run on mma.sync m16n8k16
//    (bf16 -> f32) with the g query heads as the 16-row side, padded with
//    zero rows; P is reused from the QK^T accumulator as the A fragment of
//    P.V (FA2's register layout), K read by ldmatrix, V by ldmatrix.trans.
//    The reference's numerics: scores scaled after Q.K, keys at or past
//    the split's end set to the finite NEG_INF by a select, l summed
//    before P is rounded to bf16, f32 accumulators. Value rows at or past
//    the end are zeroed in shared memory before P.V: a tile loads whole
//    rows, and what lies past the end may be anything, NaN included;
//  * at the split's end the warps merge by exact LSE, warp 0 first
//    (warp_merge), and the source stores the split's partial
//    (Src::finish): B19 into its split slot (a second kernel merges the
//    splits), B2 merges its splits inside the launch (lse_fold).
//
// Internal linkage: two libraries include this header, and each keeps its
// own kernels (static locals of inline functions with external linkage
// would be one object across loaded libraries).
#pragma once

#include "attn_tile_sm90.cuh"
#include "td_common.cuh"

namespace {
namespace td_decode {

namespace s9 = td::sm90;
using bf16 = __nv_bfloat16;

constexpr int KT = 64;             // keys a tile
constexpr int STAGES = 4;          // tiles in the ring
constexpr int NCW = 4;             // consumer warps: warp w keys [16w, 16w+16)
constexpr int NTH = NCW * 32 + 32; // and one producer warp
constexpr int MAXG = 8;            // query heads of a kv head, at most
constexpr int SLAB = KT * 64;      // bf16 of one 64-column slab of a tile

// What every source shares: q (B, Hq, D) and the softmax scale.
struct Heads {
  const bf16* q;
  int hq, hkv;
  float scale;
};

// A block's live keys [k_lo, k_hi) (k_hi == k_lo: none).
struct Range {
  int k_lo, k_hi;
};

// Dynamic shared memory of the ring, its barriers and the warps' merge
// rows (1024 bytes of it align the ring); a source's own bytes follow.
template <int D>
constexpr size_t ring_smem_bytes() {
  return 1024 + size_t(STAGES) * 2 * (D / 64) * SLAB * sizeof(bf16) +
         2 * STAGES * sizeof(uint64_t) +
         size_t(NCW) * MAXG * (D + 2) * sizeof(float);
}

// D (16 x 8 f32) += A (16 x 16 bf16: rows 0-7 of the fragment, rows 8-15
// zero) x B (16 x 8)
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  const uint32_t a[4] = {a0, 0u, a2, 0u};
  s9::mma_m16n8k16(d, a, b0, b1);
}

// byte address of 16-byte chunk c (0..D/8) of tile row r in a tile of
// 64-column slabs in the 128-byte swizzle
template <int D>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int r, int c) {
  return base + (c >> 3) * SLAB * 2 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// The exact-LSE merge of n partials of one (acc, m, l) row: partial s at
// p + s * stride holds acc at [0, d), m at [d], l at [d + 1]. m = max_s
// m_s; acc (column c) and l summed over s in ascending order, each term
// scaled by e^(m_s - m). Rows another block stored in this launch are read
// through L2 only (CG).
template <bool CG>
__device__ __forceinline__ float ld_part(const float* p) {
  return CG ? __ldcg(p) : *p;
}
template <bool CG>
__device__ __forceinline__ void lse_fold(const float* p, long stride, int n,
                                         int d, int c, float& acc, float& m,
                                         float& l) {
  float mx = td::NEG_INF;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, ld_part<CG>(p + s * stride + d));
  float a = 0.f, ls = 0.f;
  for (int s = 0; s < n; ++s) {
    const float* ps = p + s * stride;
    const float sc = expf(ld_part<CG>(ps + d) - mx);
    a = __fadd_rn(a, __fmul_rn(ld_part<CG>(ps + c), sc));
    ls = __fadd_rn(ls, __fmul_rn(ld_part<CG>(ps + d + 1), sc));
  }
  acc = a;
  m = mx;
  l = ls;
}

// Column c of query head r of the block: the four warps' rows in shared
// memory merged, warp 0 first.
template <int D>
__device__ __forceinline__ void warp_merge(const float* mrg, int r, int c,
                                           float& acc, float& m, float& l) {
  lse_fold<false>(mrg + r * (D + 2), MAXG * (D + 2), NCW, D, c, acc, m, l);
}

// Block (split, kv head, batch). Src supplies (see DenseSrc in
// flash_decode.cu, PagedSrc in paged_flash_decode.cu):
//   Heads heads;
//   Range range(sp, hk, b): the block's live keys (read on the device);
//   bool skip(rg, sp): the block has nothing to do at all;
//   void prologue(rg, hk, b, lane, extra): the producer warp, all lanes,
//     before the first tile (ends with the warp in step);
//   void load_tile<D>(&tm_k, &tm_v, k_dst, v_dst, bar, k0, rg, hk, b,
//     extra): lane 0 of the producer, the tile of keys [k0, k0 + KT):
//     announces its bytes on bar and issues its TMA loads;
//   void finish<D>(mrg, rg, sp, hk, b, extra): the consumer warps, after
//     the warps' rows are in mrg.
// `extra` is the source's dynamic shared memory past the ring's.
template <int D, typename Src>
__global__ void __launch_bounds__(NTH, 1)
    decode_tile_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ Src src) {
  constexpr int NH = D / 64;                       // slabs a row
  extern __shared__ uint8_t smem_raw[];
  bf16* const ks = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* const vs = ks + STAGES * NH * SLAB;  // [STAGES][NH][KT][64]
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(vs + STAGES * NH * SLAB);
  uint64_t* const empty = full + STAGES;
  float* const mrg = reinterpret_cast<float*>(empty + STAGES);
  void* const extra = mrg + NCW * MAXG * (D + 2);

  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const Heads hd = src.heads;
  const int g = hd.hq / hd.hkv;
  const Range rg = src.range(sp, hk, b);
  if (src.skip(rg, sp)) return;
  const int k_lo = rg.k_lo, k_hi = rg.k_hi;
  const int ntiles = (k_hi - k_lo + KT - 1) / KT;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      s9::mbar_init(full + st, 1);
      s9::mbar_init(empty + st, NCW * 32);
    }
    s9::mbar_init_fence();
  }
  __syncthreads();

  if (warp == NCW) {
    // producer: K and V tiles into the ring
    src.prologue(rg, hk, b, lane, extra);
    if (lane == 0) {
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) s9::mbar_wait(empty + st, ((i / STAGES) & 1) ^ 1);
        src.template load_tile<D>(&tm_k, &tm_v, ks + st * NH * SLAB,
                                  vs + st * NH * SLAB, full + st,
                                  k_lo + i * KT, rg, hk, b, extra);
      }
    }
    return;
  }

  // consumer warp: query row `row` (a head of the group, rows >= g zero)
  const int row = lane >> 2, cq = 2 * (lane & 3);
  uint32_t qa[D / 16][2];
  {
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        hd.q + (static_cast<long>(b) * hd.hq + hk * g + row) * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = row < g ? __ldg(qr + (16 * kk + cq) / 2) : 0u;
      qa[kk][1] = row < g ? __ldg(qr + (16 * kk + 8 + cq) / 2) : 0u;
    }
  }
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) o[j][u] = 0.f;
  float m_r = td::NEG_INF, l_r = 0.f;
  const uint32_t ks_base = s9::smem_addr(ks), vs_base = s9::smem_addr(vs);
  // this lane's ldmatrix rows: K (non-transposed) and V (transposed)
  const int rk = 16 * warp + (lane & 7) + ((lane >> 4) << 3);
  const int ck = (lane >> 3) & 1;
  const int rv = 16 * warp + (lane & 7) + (((lane >> 3) & 1) << 3);
  const int cv = lane >> 4;

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % STAGES;
    s9::mbar_wait(full + st, (i / STAGES) & 1);
    const int kw0 = k_lo + i * KT + 16 * warp;  // this warp's first key
    if (kw0 < k_hi) {
      const uint32_t kb = ks_base + st * NH * SLAB * 2;
      const uint32_t vb = vs_base + st * NH * SLAB * 2;
      if (kw0 + 16 > k_hi) {
        // the group's value rows at or past k_hi: zeros (they may hold
        // anything; their probabilities are 0), then made visible to the
        // TMA that refills the stage
        bf16* vt = vs + st * NH * SLAB;
        for (int x = lane; x < 16 * NH * 8; x += 32) {
          const int r = x / (NH * 8), c = x % (NH * 8);
          if (kw0 + r >= k_hi)
            *reinterpret_cast<uint4*>(
                reinterpret_cast<uint8_t*>(vt) +
                (tile_addr<D>(0, 16 * warp + r, c))) =
                make_uint4(0u, 0u, 0u, 0u);
        }
        s9::fence_proxy_async();
        __syncwarp();
      }
      // S = Q K^T over the group's 16 keys: two n-tiles of 8 keys
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4];
        s9::ldsm_x4(bk, tile_addr<D>(kb, rk, 2 * kk + ck));
        mma_bf16(sc[0], qa[kk][0], qa[kk][1], bk[0], bk[1]);
        mma_bf16(sc[1], qa[kk][0], qa[kk][1], bk[2], bk[3]);
      }
      // online softmax of row `row` over its 4 scores in this lane
      float p[2][2], tmax = td::NEG_INF;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const bool valid = kw0 + 8 * nt + cq + u < k_hi;
          sc[nt][u] = valid ? sc[nt][u] * hd.scale : td::NEG_INF;
          tmax = fmaxf(tmax, sc[nt][u]);
        }
      tmax = s9::quad_max(tmax);
      const float m_new = fmaxf(m_r, tmax);
      float psum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const bool valid = kw0 + 8 * nt + cq + u < k_hi;
          p[nt][u] = valid ? expf(sc[nt][u] - m_new) : 0.f;
          psum += p[nt][u];
        }
      const float alpha = expf(m_r - m_new);
      l_r = l_r * alpha + s9::quad_sum(psum);
      m_r = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= alpha;
        o[j][1] *= alpha;
      }
      // P (rounded to bf16) as the A fragment of P.V
      const uint32_t pa0 = s9::pack_bf16(p[0][0], p[0][1]);
      const uint32_t pa2 = s9::pack_bf16(p[1][0], p[1][1]);
#pragma unroll
      for (int j2 = 0; j2 < D / 16; ++j2) {
        uint32_t bv[4];
        s9::ldsm_x4_t(bv, tile_addr<D>(vb, rv, 2 * j2 + cv));
        mma_bf16(o[2 * j2], pa0, pa2, bv[0], bv[1]);
        mma_bf16(o[2 * j2 + 1], pa0, pa2, bv[2], bv[3]);
      }
    }
    s9::mbar_arrive(empty + st);
  }

  // the warp's (acc, m, l) rows into shared memory for warp_merge
  float* const mo = mrg + (warp * MAXG + row) * (D + 2);
  if (row < g) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      mo[8 * j + cq] = o[j][0];
      mo[8 * j + cq + 1] = o[j][1];
    }
    if ((lane & 3) == 0) {
      mo[D] = m_r;
      mo[D + 1] = l_r;
    }
  }
  s9::named_sync(1, NCW * 32);
  src.template finish<D>(mrg, rg, sp, hk, b, extra);
}

}  // namespace td_decode
}  // namespace
