// B1: causal GQA flash prefill, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/flash_attention.py::_prefill_kernel of the
// JAX package (launched by flash_prefill through _flash_launch), in its
// prefill form: no emit_stats output, no cu_seqlens segments (both serve
// sequence parallelism and are still to port).
//
// What bounds it on this card. At the main-path shape (B=4, T=S=512, Hq=32,
// Hkv=8, D=128, bf16) the function must move ~42 MB (q, k, v read once, o
// written once): 12.5 us at 3.35 TB/s. Its causal QK^T and PV take ~8.6
// GFLOP: 8.7 us at the 989 TFLOP/s bf16 tensor-core peak. So the card's
// bound is bytes. This kernel computes with FP32 FMAs out of shared
// memory and uses no tensor cores, so it is bound by FMA issue and shared-
// memory reads well above that bound; mma/wgmma tiles and TMA loads are the
// later step.
//
// Design:
//  * the query offset is read from device memory when the caller passes a
//    pointer (the dense cache's on-device offset), so the launch needs no
//    host read and a CUDA graph that captures it stays right as the offset
//    advances between replays; the grid depends only on T;
//  * one block = (64-query tile, one q head, one batch row). The TPU grid's
//    sequential key-block axis (a sum carried in VMEM scratch across grid
//    steps) becomes a loop inside the block, bounded by the causal diagonal
//    exactly like the reference's block_live test, so key blocks above the
//    diagonal are never loaded;
//  * q head h reads kv head h / (Hq/Hkv) (GQA) straight from the
//    (B, S, Hkv, D) layout through strides: no head-major copies in HBM;
//  * tiles are staged through 16-byte loads, several in flight per
//    thread; loads past T and S are masked (zero-filled) and stores past
//    T are skipped, so nothing is read or written out of bounds (the TPU
//    kernel reads padded tails and zeroes V's tail rows instead);
//  * online softmax with the running (m, l) of each row in shared memory,
//    the reference's numerics kept: finite NEG_INF, probabilities rounded
//    to bf16 before P.V when V is bf16, the sum l taken before that
//    rounding, the final division by max(l, 1e-30);
//  * each thread holds a 4 x (D/16) register tile of scores and outputs
//    (rows rg + 16i, columns cg + 16j), so shared-memory reads stay
//    conflict-free (rows padded to D+1 floats).

#include "td_common.cuh"

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per loop step
constexpr int NT = 256;  // 16 row groups x 16 column groups

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, T* __restrict__ o, int t_len,
                   int s_len, int hq, int hkv,
                   const int* __restrict__ offset_ptr, int offset_arg,
                   float scale) {
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int CPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // [BQ][LD] query tile
  float* ks = qs + BQ * LD;    // [BK][LD] key tile
  float* vs = ks + BK * LD;    // [BK][LD] value tile
  float* ps = vs + BK * LD;    // [BQ][LP] scores, then probabilities
  float* m_s = ps + BQ * LP;   // [BQ] running max
  float* l_s = m_s + BQ;       // [BQ] running sum
  float* a_s = l_s + BQ;       // [BQ] rescale factor of this key step

  const int offset = offset_ptr != nullptr ? *offset_ptr : offset_arg;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const long q_stride = (long)hq * D;  // between consecutive tokens
  const long kv_stride = (long)hkv * D;
  const T* qp = q + ((long)b * t_len * hq + h) * D;
  const T* kp = k + ((long)b * s_len * hkv + hk) * D;
  const T* vp = v + ((long)b * s_len * hkv + hk) * D;
  T* op = o + ((long)b * t_len * hq + h) * D;

  td::load_rows<T, D, NT, 4>(qp + q0 * q_stride, q_stride, BQ, t_len - q0,
                             qs, LD);
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = td::NEG_INF;
    l_s[r] = 0.f;
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // causal bound: key step kb is live iff its first key sits at or before
  // the tile's last query position (the reference's block_live)
  const int last_q = offset + q0 + BQ - 1;
  const int nk = min((s_len + BK - 1) / BK, last_q / BK + 1);

  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous step's readers are done
    td::load_rows<T, D, NT, 4>(kp + k0 * kv_stride, kv_stride, BK,
                               s_len - k0, ks, LD);
    td::load_rows<T, D, NT, 4>(vp + k0 * kv_stride, kv_stride, BK,
                               s_len - k0, vs, LD);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(rg + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(cg + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rg + 16 * i, c = cg + 16 * j;
        const int kpos = k0 + c;
        const bool valid = kpos <= offset + q0 + r && kpos < s_len;
        ps[r * LP + c] = valid ? sc[i][j] * scale : td::NEG_INF;
      }
    __syncthreads();

    // online softmax: warp w owns rows 8w..8w+7, each lane two keys
    {
      const int warp = tid >> 5, lane = tid & 31;
      for (int rr = 0; rr < BQ / (NT / 32); ++rr) {
        const int r = warp * (BQ / (NT / 32)) + rr;
        const int qpos = offset + q0 + r;
        const float s0 = ps[r * LP + lane];
        const float s1 = ps[r * LP + lane + 32];
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, td::warp_max(fmaxf(s0, s1)));
        const int c0 = k0 + lane, c1 = k0 + lane + 32;
        const float p0 = (c0 <= qpos && c0 < s_len) ? expf(s0 - m_new) : 0.f;
        const float p1 = (c1 <= qpos && c1 < s_len) ? expf(s1 - m_new) : 0.f;
        const float psum = td::warp_sum(p0 + p1);
        ps[r * LP + lane] = td::p_cast<T>(p0);
        ps[r * LP + lane + 32] = td::p_cast<T>(p1);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          l_s[r] = l_s[r] * alpha + psum;
          m_s[r] = m_new;
          a_s[r] = alpha;
        }
      }
    }
    __syncthreads();

    float al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) al[i] = a_s[rg + 16 * i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] *= al[i];
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(rg + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) vv[j] = vs[kk * LD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    const int t = q0 + r;
    if (t >= t_len) continue;
    const float den = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < CPT; ++j)
      op[t * q_stride + cg + 16 * j] = td::from_f<T>(acc[i][j] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int t_len, int s_len, int hq, int hkv,
                   const int* offset_ptr, int offset, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + BQ - 1) / BQ, hq, b);
  prefill_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t_len, s_len, hq, hkv,
      offset_ptr, offset, scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, T, Hq, D); k, v: (B, S, Hkv, D); all contiguous, one dtype
// (td::F32 or td::BF16), D in {64, 128}. Query i sits at position
// offset + i and attends keys [0, offset + i], where offset is *offset_ptr
// (one int32 in device memory) when offset_ptr is not null, else the value
// passed. Returns a cudaError_t.
extern "C" int td_flash_prefill(const void* q, const void* k, const void* v,
                                void* o, int b, int t_len, int s_len, int hq,
                                int hkv, int d, const void* offset_ptr,
                                int offset, float scale, int dtype,
                                void* stream) {
  if (b <= 0 || t_len <= 0 || s_len <= 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TD_CASE(CODE, TYPE, DIM)                                           \
  if (dtype == CODE && d == DIM)                                           \
    return static_cast<int>(launch<TYPE, DIM>(                             \
        q, k, v, o, b, t_len, s_len, hq, hkv,                              \
        static_cast<const int*>(offset_ptr), offset, scale, st));
  TD_CASE(td::F32, float, 64)
  TD_CASE(td::F32, float, 128)
  TD_CASE(td::BF16, __nv_bfloat16, 64)
  TD_CASE(td::BF16, __nv_bfloat16, 128)
#undef TD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
