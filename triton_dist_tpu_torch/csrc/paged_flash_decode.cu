// B2: paged split-KV flash decode, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/paged_flash_decode.py::_paged_decode_kernel
// of the JAX package (launched by paged_flash_decode_partial), in both its
// full-width (bf16/f32 pages) and int8-resident (int8 pages + f32 row
// scales) modes.
//
// What bounds it on this card. One decode step reads each live KV page once
// and does 4*Hq*D flops per cached token, about g flops per byte read, far
// below the ~295 flops/byte where the tensor cores would bound it: the bound
// is bytes (the live pages, at 3.35 TB/s).
//
// bf16 (the main path's pools; the Hopper kernel of decode_tile_sm90.cuh,
// shared with B19, over PagedSrc):
//  * the TPU grid (B, Hkv, NP) folds a row's pages in order; here each
//    (row, kv head) is cut into `splits` splits of `pages` whole logical
//    pages (kernels/paged_flash_decode.py::paged_plan: the grid (splits,
//    Hkv, B) fills the SMs, from B, Hkv, the table's width, the page size
//    and the SM count only, so a CUDA graph captured once stays right as
//    the lengths advance on the device);
//  * a block reads its row's length, and from it its live pages: a split
//    wholly past ceil(len / ps) pages loads nothing and exits; the
//    producer warp reads the table entries of its live pages only (never a
//    dead one) into shared memory, keeping the reference's clamp
//    clip(tab, 0, P - 1), and issues each 64-key tile as TMA boxes of
//    min(ps, 64) rows of the pool seen as (Hkv * P * ps, D) rows, one box
//    a page (ps a multiple of 64: one box a tile; ps 8, 16 or 32: 64 / ps
//    boxes, a box past the length not issued), in the 128-byte swizzle;
//    the map is encoded once per pool and cached (pool_map);
//  * the consumer warps' math is B19's (mma.sync m16n8k16, the heads
//    padded to 16 rows, the reference's numerics); rows of the last live
//    page past len reach shared memory with the tile and may be stale or
//    NaN: their scores are set to NEG_INF by a select and their value rows
//    zeroed before P.V;
//  * the splits of a (row, kv head) merge in the same launch: each live
//    split stores its partial in the workspace, fences, and counts itself
//    on the pair's ticket (acq_rel); the last of the live splits merges
//    them in ascending order by exact LSE into the outputs and resets the
//    ticket to 0. The workspace and tickets are the calling stream's
//    (paged_flash_decode.py::_workspace): two launches that may run at
//    once never count on one ticket. A row with one live split stores its
//    result directly;
//    an empty row (len 0) returns m = NEG_INF, l = 0, acc = 0 from split
//    0. One launch a call and no memset between graph replays.
//
// f32 and int8 (the f32 gates; the int8-resident mode), and bf16 pools
// whose page size a TMA box does not cut (neither a multiple of 64 nor 8,
// 16 or 32: 24, 48, 96, ...; paged_flash_decode.py's paged_route): the FMA
// body below on a (B, Hkv) grid, each block walking its row's pages in
// order:
//  * the TPU's scalar-prefetched block table and its kv_index clamp become a
//    block that reads its own table row: it loops over the ceil(len/ps) live
//    pages only and keeps the value clamp clip(tab, 0, P-1), so a stale or
//    uninitialized entry never reads outside the pool;
//  * one block serves the g = Hq/Hkv query heads that share a kv head, so
//    each page is read from HBM once for all of them, through 16-byte
//    loads with several in flight per thread; g is a template parameter,
//    so the per-head loops hold no idle lanes;
//  * the online softmax keeps the reference's numerics: finite NEG_INF for
//    keys past len, the K scale multiplying the scores after QK^T, the V
//    scale multiplying the probability row (after l is summed), and bf16
//    rounding of the probabilities only when V is bf16;
//  * V rows past len are zero-filled, so garbage in a page's tail cannot
//    reach the output through 0 * NaN;
//  * a row with len == 0 reads nothing and returns m = NEG_INF, l = 0,
//    acc = 0.
// Outputs are the unnormalized partials (acc, m, l), merged by lse_merge.

#include <atomic>
#include <mutex>
#include <type_traits>
#include <unordered_map>

#include "decode_tile_sm90.cuh"
#include "td_common.cuh"

namespace {

constexpr int NT = 128;    // 4 warps

size_t smem_bytes(int g, int ps, int d) {
  return sizeof(float) * (static_cast<size_t>(g) * d + ps * (d + 1) + ps * d +
                          g * ps + 2 * ps + 3 * g);
}

template <typename KV, typename QT, int D, int G>
__global__ void __launch_bounds__(NT) paged_decode_kernel(
    const QT* __restrict__ q, const KV* __restrict__ kpool,
    const KV* __restrict__ vpool, const float* __restrict__ kscale,
    const float* __restrict__ vscale, const int* __restrict__ table,
    const int* __restrict__ lengths, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int hq, int hkv,
    int num_pages, int ps, int np_table, float scale) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int LD = D + 1;
  constexpr int CPT = (D + NT - 1) / NT;  // output columns per thread
  extern __shared__ float smem[];
  constexpr int g = G;       // q heads per kv head, fixed at compile time
  float* qs = smem;          // [g][D] the block's query heads
  float* kt = qs + g * D;    // [ps][LD] key page
  float* vt = kt + ps * LD;  // [ps][D] value page
  float* pr = vt + ps * D;   // [g][ps] scores, then probabilities
  float* ksv = pr + g * ps;  // [ps] K row scales of the page (int8)
  float* vsv = ksv + ps;     // [ps] V row scales of the page (int8)
  float* m_s = vsv + ps;     // [g] running max
  float* l_s = m_s + g;      // [g] running sum
  float* a_s = l_s + g;      // [g] rescale factor of this page

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int len = lengths[b];
  const int n_live = min((max(len, 0) + ps - 1) / ps, np_table);
  const QT* qp = q + ((long)b * hq + (long)h * g) * D;
  for (int i = tid; i < g * D; i += NT) qs[i] = td::to_f(qp[i]);
  for (int i = tid; i < g; i += NT) {
    m_s[i] = td::NEG_INF;
    l_s[i] = 0.f;
  }

  float acc[G][CPT];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[gi][c] = 0.f;

  for (int p = 0; p < n_live; ++p) {
    const int tab = table[(long)b * np_table + p];
    const int phys = min(max(tab, 0), num_pages - 1);
    const long row0 = ((long)h * num_pages + phys) * ps;  // (h, phys, 0)
    const int valid_rows = min(ps, len - p * ps);
    __syncthreads();  // the previous page's readers are done
    td::load_rows<KV, D, NT, 4>(kpool + row0 * D, D, ps, ps, kt, LD);
    td::load_rows<KV, D, NT, 4>(vpool + row0 * D, D, ps, valid_rows, vt, D);
    if (QUANT) {
      for (int r = tid; r < ps; r += NT) {
        ksv[r] = kscale[row0 + r];
        vsv[r] = vscale[row0 + r];
      }
    }
    __syncthreads();

    // scores: thread j takes key j of the page for every query head
    for (int j = tid; j < ps; j += NT) {
      float s[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) s[gi] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kv = kt[j * LD + d];
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
          s[gi] = fmaf(qs[gi * D + d], kv, s[gi]);
      }
      const bool valid = j < valid_rows;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float sc = s[gi] * scale;
        if (QUANT) sc *= ksv[j];
        pr[gi * ps + j] = valid ? sc : td::NEG_INF;
      }
    }
    __syncthreads();

    // online softmax: warp w takes query heads w, w + 4, ...
    for (int gi = warp; gi < g; gi += NT / 32) {
      float mx = td::NEG_INF;
      for (int j = lane; j < ps; j += 32) mx = fmaxf(mx, pr[gi * ps + j]);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, td::warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < ps; j += 32) {
        const float e = j < valid_rows ? expf(pr[gi * ps + j] - m_new) : 0.f;
        sum += e;
        pr[gi * ps + j] = QUANT ? e * vsv[j] : td::p_cast<KV>(e);
      }
      sum = td::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[gi] = l_s[gi] * alpha + sum;
        m_s[gi] = m_new;
        a_s[gi] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V: thread t owns columns t, t + NT, ...
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tid + c * NT;
      if (d >= D) continue;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) acc[gi][c] *= a_s[gi];
#pragma unroll 4
      for (int j = 0; j < ps; ++j) {
        const float vv = vt[j * D + d];
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
          acc[gi][c] = fmaf(pr[gi * ps + j], vv, acc[gi][c]);
      }
    }
  }
  __syncthreads();

  const long out_row = (long)b * hq + (long)h * g;  // first q head
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = tid + c * NT;
    if (d >= D) continue;
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
      acc_out[(out_row + gi) * D + d] = acc[gi][c];
  }
  for (int gi = tid; gi < g; gi += NT) {
    m_out[out_row + gi] = m_s[gi];
    l_out[out_row + gi] = l_s[gi];
  }
}

template <typename KV, typename QT, int D, int G>
cudaError_t launch(const void* q, const void* kpool, const void* vpool,
                   const void* kscale, const void* vscale, const void* table,
                   const void* lengths, void* acc, void* m, void* l, int b,
                   int hq, int hkv, int num_pages, int ps, int np_table,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, ps, D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<KV, QT, D, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(b, hkv);
  paged_decode_kernel<KV, QT, D, G><<<grid, NT, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KV*>(kpool),
      static_cast<const KV*>(vpool), static_cast<const float*>(kscale),
      static_cast<const float*>(vscale), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), hq, hkv, num_pages, ps,
      np_table, scale);
  return cudaGetLastError();
}

// the group sizes the kernel is built for: Hq/Hkv of the Qwen3 family
template <typename KV, typename QT, int D>
cudaError_t launch_group(int g, const void* q, const void* kpool,
                         const void* vpool, const void* kscale,
                         const void* vscale, const void* table,
                         const void* lengths, void* acc, void* m, void* l,
                         int b, int hq, int hkv, int num_pages, int ps,
                         int np_table, float scale, cudaStream_t stream) {
#define TD_GROUP(GS)                                                        \
  if (g == GS)                                                              \
    return launch<KV, QT, D, GS>(q, kpool, vpool, kscale, vscale, table,    \
                                 lengths, acc, m, l, b, hq, hkv, num_pages, \
                                 ps, np_table, scale, stream);
  TD_GROUP(1)
  TD_GROUP(2)
  TD_GROUP(4)
  TD_GROUP(8)
#undef TD_GROUP
  return cudaErrorInvalidValue;
}

// -- bf16: the Hopper kernel ---------------------------------------------------

namespace hop {

using namespace td_decode;

// table entries a split stages in shared memory, at most (the plan's pages)
constexpr int MAX_SPLIT_PAGES = 8192;

// B2's source of tiles (decode_tile_sm90.cuh's Src): a split of whole
// logical pages of row b, its tiles' rows translated by the block table,
// its partial merged with the row's other live splits in this launch.
struct PagedSrc {
  Heads heads;
  const int* table;    // (B, NP)
  const int* lengths;  // (B,) keys attended per row
  float* acc;          // (B, Hq, D)
  float* m;            // (B, Hq)
  float* l;            // (B, Hq)
  float* part;         // (B, Hkv, splits, g, D + 2): live splits' partials
  int* tickets;        // (B, Hkv): zero between calls
  int num_pages, ps, np_table;
  int pages, splits;   // the plan: pages a split, splits a (row, kv head)
  int box;             // rows of a TMA box: min(ps, KT)

  // keys attended in row b, within the table's width
  __device__ __forceinline__ int row_keys(int b) const {
    const int len = lengths[b];
    const int cap = np_table * ps;
    return len < 0 ? 0 : (len < cap ? len : cap);
  }
  __device__ __forceinline__ Range range(int sp, int, int b) const {
    const int k_lo = sp * pages * ps;
    const int hi = min(k_lo + pages * ps, row_keys(b));
    return {k_lo, hi > k_lo ? hi : k_lo};
  }
  // a split past the row's length does nothing (split 0 always runs: it
  // writes an empty row's result)
  __device__ __forceinline__ bool skip(Range rg, int sp) const {
    return sp > 0 && rg.k_hi == rg.k_lo;
  }
  // the physical page of each live page of the split, clamped to the pool
  __device__ __forceinline__ void prologue(Range rg, int, int b, int lane,
                                           void* extra) const {
    int* const tab = static_cast<int*>(extra);
    const int n = (rg.k_hi - rg.k_lo + ps - 1) / ps;
    const int* row = table + static_cast<long>(b) * np_table + rg.k_lo / ps;
    for (int i = lane; i < n; i += 32) {
      const int t = row[i];
      tab[i] = t < 0 ? 0 : (t < num_pages ? t : num_pages - 1);
    }
    __syncwarp();
  }

  // keys [k0, k0 + KT) of the split: a box of `box` rows a page, boxes
  // past the length not issued
  template <int D>
  __device__ __forceinline__ void load_tile(const CUtensorMap* tm_k,
                                            const CUtensorMap* tm_v,
                                            bf16* kd, bf16* vd,
                                            uint64_t* bar, int k0, Range rg,
                                            int hk, int,
                                            const void* extra) const {
    constexpr int NH = D / 64;
    const int* const tab = static_cast<const int*>(extra);
    int nbox = (rg.k_hi - k0 + box - 1) / box;
    if (nbox > KT / box) nbox = KT / box;
    s9::mbar_expect_tx(bar, static_cast<uint32_t>(nbox * box * 128 * NH * 2));
    for (int j = 0; j < nbox; ++j) {
      const int key = k0 - rg.k_lo + j * box;  // within the split
      const int row = (hk * num_pages + tab[key / ps]) * ps + key % ps;
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        s9::tma_load_2d(kd + h * SLAB + j * box * 64, tm_k, bar, 64 * h, row);
        s9::tma_load_2d(vd + h * SLAB + j * box * 64, tm_v, bar, 64 * h, row);
      }
    }
  }

  // the warps merged; with one live split into the outputs, else into the
  // workspace, then the last live split merges them all
  template <int D>
  __device__ __forceinline__ void finish(const float* mrg, Range, int sp,
                                         int hk, int b, void*) const {
    __shared__ int arrived_s;
    const int g = heads.hq / heads.hkv;
    const int tid = threadIdx.x;
    const int span = pages * ps;
    const int live = (row_keys(b) + span - 1) / span;  // live splits
    const long row0 = static_cast<long>(b) * heads.hq + hk * g;
    if (live <= 1) {
      for (int x = tid; x < g * D; x += NCW * 32) {
        const int r = x / D, c = x % D;
        float a, mx, ls;
        warp_merge<D>(mrg, r, c, a, mx, ls);
        acc[(row0 + r) * D + c] = a;
        if (c == 0) {
          m[row0 + r] = mx;
          l[row0 + r] = ls;
        }
      }
      return;
    }
    const long pair = static_cast<long>(b) * heads.hkv + hk;
    float* const slots = part + pair * splits * g * (D + 2);
    float* const mine = slots + static_cast<long>(sp) * g * (D + 2);
    for (int x = tid; x < g * D; x += NCW * 32) {
      const int r = x / D, c = x % D;
      float a, mx, ls;
      warp_merge<D>(mrg, r, c, a, mx, ls);
      mine[r * (D + 2) + c] = a;
      if (c == 0) {
        mine[r * (D + 2) + D] = mx;
        mine[r * (D + 2) + D + 1] = ls;
      }
    }
    // the block's stores, then one acq_rel arrival on the pair's ticket
    // (release: the stores before it; acquire: the other splits' stores,
    // for the last)
    __threadfence();
    s9::named_sync(1, NCW * 32);
    if (tid == 0) {
      int n;
      asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                   : "=r"(n)
                   : "l"(tickets + pair)
                   : "memory");
      arrived_s = n;
    }
    s9::named_sync(1, NCW * 32);
    if (arrived_s != live - 1) return;
    __threadfence();
    for (int x = tid; x < g * D; x += NCW * 32) {
      const int r = x / D, c = x % D;
      float a, mx, ls;
      lse_fold<true>(slots + r * (D + 2), static_cast<long>(g) * (D + 2),
                     live, D, c, a, mx, ls);
      acc[(row0 + r) * D + c] = a;
      if (c == 0) {
        m[row0 + r] = mx;
        l[row0 + r] = ls;
      }
    }
    if (tid == 0) tickets[pair] = 0;
  }
};

// The map of a bf16 pool (Hkv, P, ps, D) seen as (rows, D): boxes of 64
// columns x `box` rows in the 128-byte swizzle, made once per (pool,
// rows, D, box, device) and cached (a pool keeps its address for the
// engine's life; the map holds only address, shape and layout). False if
// the CUDA driver refuses it.
bool pool_map(CUtensorMap* map, const void* base, long rows, int d, int box,
              int dev) {
  struct Key {
    const void* base;
    long rows;
    int d, box, dev;
    bool operator==(const Key& o) const {
      return base == o.base && rows == o.rows && d == o.d && box == o.box &&
             dev == o.dev;
    }
  };
  struct Hash {
    size_t operator()(const Key& x) const {
      return std::hash<const void*>()(x.base) ^
             (static_cast<size_t>(x.rows) * 0x9E3779B97F4A7C15ull) ^
             (static_cast<size_t>(x.box) << 20) ^
             (static_cast<size_t>(x.d) << 28) ^ static_cast<size_t>(x.dev);
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> cache;
  const Key key{base, rows, d, box, dev};
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return true;
  }
  const s9::EncodeTiledFn fn = s9::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(bf16)};
  const cuuint32_t boxes[2] = {64, (cuuint32_t)box};
  const cuuint32_t elem[2] = {1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
         dims, strides, boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

template <int D>
cudaError_t launch(const PagedSrc& s, const void* kpool, const void* vpool,
                   int b, cudaStream_t st) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const long rows = static_cast<long>(s.heads.hkv) * s.num_pages * s.ps;
  CUtensorMap tm_k, tm_v;
  if (!pool_map(&tm_k, kpool, rows, D, s.box, dev) ||
      !pool_map(&tm_v, vpool, rows, D, s.box, dev))
    return cudaErrorNotSupported;
  // the shared-memory attribute is set once per device (a bit per device),
  // to the most any plan asks
  static std::atomic<uint64_t> smem_set{0};
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(smem_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(
        decode_tile_kernel<D, PagedSrc>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(ring_smem_bytes<D>() +
                         MAX_SPLIT_PAGES * sizeof(int)));
    if (err != cudaSuccess) return err;
    smem_set.fetch_or(bit, std::memory_order_release);
  }
  const size_t smem = ring_smem_bytes<D>() + s.pages * sizeof(int);
  decode_tile_kernel<D, PagedSrc>
      <<<dim3(s.splits, s.heads.hkv, b), NTH, smem, st>>>(tm_k, tm_v, s);
  return cudaGetLastError();
}

}  // namespace hop

}  // namespace

// q: (B, Hq, D); kpool, vpool: (Hkv, P, ps, D); kscale, vscale:
// (Hkv, P, ps) f32 for int8 pools, else null; table: (B, NP) i32; lengths:
// (B,) i32 keys attended per row; acc: (B, Hq, D) f32; m, l: (B, Hq) f32.
// All contiguous. q_dtype: td::F32 | td::BF16; kv_dtype: td::F32 | td::BF16
// (equal to q_dtype) | td::I8. D in {64, 128}, Hq/Hkv in {1, 2, 4, 8}.
// bf16 pools of ps a multiple of 64 or one of 8, 16, 32 (the Hopper kernel):
// the plan's `pages` a split (1 .. MAX_SPLIT_PAGES) and `splits` covering
// the table's NP pages, none empty; tickets (B, Hkv) i32, zero before the
// first call and left zero; part (B, Hkv, splits, g, D + 2) f32 scratch
// (may be null when splits is 1); no launch that may run at the same time
// uses the same tickets or part; pools 16-byte aligned, Hkv * P * ps < 2^31.
// f32 and int8 pools and bf16 pools of other page sizes (the FMA body):
// part, tickets, pages and splits are not read. Returns a cudaError_t.
extern "C" int td_paged_decode(const void* q, const void* kpool,
                               const void* vpool, const void* kscale,
                               const void* vscale, const void* table,
                               const void* lengths, void* acc, void* m,
                               void* l, void* part, void* tickets, int b,
                               int hq, int hkv, int num_pages, int ps,
                               int np_table, int d, int pages, int splits,
                               float scale, int q_dtype, int kv_dtype,
                               void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || num_pages <= 0 || ps <= 0 ||
      np_table <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype == td::I8 && (kscale == nullptr || vscale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool box_ok = ps % hop::KT == 0 || ps == 8 || ps == 16 || ps == 32;
  if (q_dtype == td::BF16 && kv_dtype == td::BF16 && box_ok) {
    const int g = hq / hkv;
    if ((g != 1 && g != 2 && g != 4 && g != 8) ||
        (d != 64 && d != 128) || pages <= 0 ||
        pages > hop::MAX_SPLIT_PAGES || splits <= 0 ||
        static_cast<long>(pages) * splits < np_table ||
        static_cast<long>(pages) * (splits - 1) >= np_table ||
        static_cast<long>(hkv) * num_pages * ps >= (1L << 31) ||
        static_cast<long>(np_table) * ps >= (1L << 31) ||
        tickets == nullptr || (splits > 1 && part == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    const hop::PagedSrc s{
        {static_cast<const __nv_bfloat16*>(q), hq, hkv, scale},
        static_cast<const int*>(table), static_cast<const int*>(lengths),
        static_cast<float*>(acc), static_cast<float*>(m),
        static_cast<float*>(l), static_cast<float*>(part),
        static_cast<int*>(tickets), num_pages, ps, np_table, pages, splits,
        ps < hop::KT ? ps : hop::KT};
    return static_cast<int>(d == 64 ? hop::launch<64>(s, kpool, vpool, b, st)
                                    : hop::launch<128>(s, kpool, vpool, b,
                                                       st));
  }
#define TD_CASE(QC, QT, KC, KV, DIM)                                        \
  if (q_dtype == QC && kv_dtype == KC && d == DIM)                          \
    return static_cast<int>(launch_group<KV, QT, DIM>(                      \
        hq / hkv, q, kpool, vpool, kscale, vscale, table, lengths, acc, m,  \
        l, b, hq, hkv, num_pages, ps, np_table, scale, st));
  TD_CASE(td::F32, float, td::F32, float, 64)
  TD_CASE(td::F32, float, td::F32, float, 128)
  TD_CASE(td::F32, float, td::I8, int8_t, 64)
  TD_CASE(td::F32, float, td::I8, int8_t, 128)
  TD_CASE(td::BF16, __nv_bfloat16, td::I8, int8_t, 64)
  TD_CASE(td::BF16, __nv_bfloat16, td::I8, int8_t, 128)
  TD_CASE(td::BF16, __nv_bfloat16, td::BF16, __nv_bfloat16, 64)
  TD_CASE(td::BF16, __nv_bfloat16, td::BF16, __nv_bfloat16, 128)
#undef TD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
