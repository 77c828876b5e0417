// B2: paged split-KV flash decode, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/paged_flash_decode.py::_paged_decode_kernel
// of the JAX package (launched by paged_flash_decode_partial), in both its
// full-width (bf16/f32 pages) and int8-resident (int8 pages + f32 row
// scales) modes.
//
// What bounds it on this card. One decode step reads each live KV page once
// and does 4*Hq*D flops per cached token, about one flop per byte read, far
// below the ~295 flops/byte where the tensor cores would bound it: the bound
// is bytes (the live pages, at 3.35 TB/s). This kernel stages each
// page in shared memory and computes with FP32 FMAs; its grid is
// (B, Hkv) blocks, 32 at the main-path B=4, Hkv=8, so it fills a quarter of
// the 132 SMs and each block walks its pages in sequence. A split over pages
// across blocks (the partials already merge by LSE) is the later step.
//
// Design:
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

#include <type_traits>

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

}  // namespace

// q: (B, Hq, D); kpool, vpool: (Hkv, P, ps, D); kscale, vscale:
// (Hkv, P, ps) f32 for int8 pools, else null; table: (B, NP) i32; lengths:
// (B,) i32 keys attended per row; acc: (B, Hq, D) f32; m, l: (B, Hq) f32.
// All contiguous. q_dtype: td::F32 | td::BF16; kv_dtype: td::F32 | td::BF16
// (equal to q_dtype) | td::I8. D in {64, 128}, Hq/Hkv in {1, 2, 4, 8}.
// Returns a cudaError_t.
extern "C" int td_paged_decode(const void* q, const void* kpool,
                               const void* vpool, const void* kscale,
                               const void* vscale, const void* table,
                               const void* lengths, void* acc, void* m,
                               void* l, int b, int hq, int hkv, int num_pages,
                               int ps, int np_table, int d, float scale,
                               int q_dtype, int kv_dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || num_pages <= 0 || ps <= 0 ||
      np_table <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype == td::I8 && (kscale == nullptr || vscale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TD_CASE(QC, QT, KC, KV, DIM)                                        \
  if (q_dtype == QC && kv_dtype == KC && d == DIM)                          \
    return static_cast<int>(launch_group<KV, QT, DIM>(                      \
        hq / hkv, q, kpool, vpool, kscale, vscale, table, lengths, acc, m,  \
        l, b, hq, hkv, num_pages, ps, np_table, scale, st));
  TD_CASE(td::F32, float, td::F32, float, 64)
  TD_CASE(td::F32, float, td::F32, float, 128)
  TD_CASE(td::BF16, __nv_bfloat16, td::BF16, __nv_bfloat16, 64)
  TD_CASE(td::BF16, __nv_bfloat16, td::BF16, __nv_bfloat16, 128)
  TD_CASE(td::F32, float, td::I8, int8_t, 64)
  TD_CASE(td::F32, float, td::I8, int8_t, 128)
  TD_CASE(td::BF16, __nv_bfloat16, td::I8, int8_t, 64)
  TD_CASE(td::BF16, __nv_bfloat16, td::I8, int8_t, 128)
#undef TD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
