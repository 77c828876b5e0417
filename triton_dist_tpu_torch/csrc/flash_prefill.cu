// B1: causal GQA flash attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/flash_attention.py::_prefill_kernel of the
// JAX package (launched by flash_prefill and flash_fold_partial through
// _flash_launch) in all three of its forms:
//  * prefill: the normalized output over a cache, queries at offset + i;
//  * varlen (cu_seqlens): the causal mask further confined to each
//    position's segment of a packed batch, the segment of a position being
//    the count of boundaries cu_seqlens[1..n_seq] at or below it;
//  * fold (emit_stats): the unnormalized f32 (acc, m, l) of q against one
//    key chunk whose global origin is k_start, for the sequence-parallel
//    ring's cross-chunk LSE merge.
//
// What bounds it on this card. At the main-path prefill shape (B=4,
// T=S=512, Hq=32, Hkv=8, D=128, bf16) the function must move ~42 MB (q, k,
// v read once, o written once): 12.5 us at 3.35 TB/s; its causal QK^T and
// PV take ~8.6 GFLOP: 8.7 us at the 989 TFLOP/s bf16 tensor-core peak, so
// the bound is bytes. At the sequence-parallel fold (2,048 queries against
// a 2,048-key chunk at Qwen3-32B's 64 heads) it is operations: ~137 GFLOP
// for the full chunk, ~0.14 ms. This kernel computes with FP32 FMAs out of
// shared memory and uses no tensor cores, so it is bound by FMA issue and
// shared-memory reads well above either bound; mma/wgmma tiles and TMA
// loads are the later step.
//
// Design:
//  * the query start, the key start and the segment boundaries are read
//    from device memory when the caller passes pointers (the dense cache's
//    on-device offset, a ring step's chunk origin), so the launch needs no
//    host read and a CUDA graph that captures it stays right as they
//    advance; the grid depends only on T;
//  * one block = (64-query tile, one q head, one batch row). The TPU grid's
//    sequential key-block axis (a sum carried in VMEM scratch across grid
//    steps) becomes a loop inside the block, bounded by the causal diagonal
//    exactly like the reference's block_live test (with the key start:
//    k_start + kb * BK <= the tile's last query), so key blocks above the
//    diagonal are never loaded;
//  * q head h reads kv head h / (Hq/Hkv) (GQA) straight from the
//    (B, S, Hkv, D) layout through strides: no head-major copies in HBM;
//  * tiles are staged through 16-byte loads, several in flight per
//    thread; loads past T and S are masked (zero-filled) and stores past
//    T are skipped, so nothing is read or written out of bounds (the TPU
//    kernel reads padded tails and zeroes V's tail rows instead; the
//    in-chunk mask k < k_start + S of its fold form is this bound);
//  * online softmax with the running (m, l) of each row in shared memory,
//    the reference's numerics kept: finite NEG_INF, probabilities rounded
//    to bf16 before P.V when V is bf16, the sum l taken before that
//    rounding, and for the normalized form the final division by
//    max(l, 1e-30); the fold form stores acc, m and l as they stand;
//  * segment ids of the tile's queries are computed once, those of each
//    key step beside its tile, from the boundaries in device memory;
//  * each thread holds a 4 x (D/16) register tile of scores and outputs
//    (rows rg + 16i, columns cg + 16j), so shared-memory reads stay
//    conflict-free (rows padded to D+1 floats).

#include "td_common.cuh"

namespace {

constexpr int BQ = 64;   // queries per block
constexpr int BK = 64;   // keys per loop step
constexpr int NT = 256;  // 16 row groups x 16 column groups

template <int D, bool VARLEN>
constexpr size_t smem_bytes() {
  return sizeof(float) *
             (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 3 * BQ) +
         (VARLEN ? sizeof(int) * (BQ + BK) : 0);
}

// The arguments of one launch (one struct keeps the three forms' launches
// in one signature).
template <typename T>
struct Args {
  const T* q;
  const T* k;
  const T* v;
  T* o;          // normalized output (B, T, Hq, D), or null
  float* acc;    // fold form: (B, T, Hq, D) f32, or null
  float* m_out;  //            (B, T, Hq) f32
  float* l_out;  //            (B, T, Hq) f32
  int t_len, s_len, hq, hkv;
  const int* q_start_ptr;
  int q_start;
  const int* k_start_ptr;
  int k_start;
  const int* cu;  // (n_seq + 1,) segment boundaries, or null
  int n_seq;
  float scale;
};

// The segment of a position: boundaries cu[1..n_seq] at or below it.
__device__ __forceinline__ int segment(const int* __restrict__ cu, int n_seq,
                                       int pos) {
  int s = 0;
  for (int j = 1; j <= n_seq; ++j) s += pos >= __ldg(cu + j);
  return s;
}

// VARLEN: the segment mask (cu_seqlens) is compiled in; the prefill and
// fold forms without segments run the kernel without it.
template <typename T, int D, bool VARLEN>
__global__ void __launch_bounds__(NT) prefill_kernel(const Args<T> a) {
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
  int* qseg = reinterpret_cast<int*>(a_s + BQ);  // [BQ] query segments
  int* kseg = qseg + BQ;                         // [BK] key segments

  const int offset = a.q_start_ptr != nullptr ? *a.q_start_ptr : a.q_start;
  const int k_base = a.k_start_ptr != nullptr ? *a.k_start_ptr : a.k_start;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const int t_len = a.t_len, s_len = a.s_len;
  const long q_stride = (long)a.hq * D;  // between consecutive tokens
  const long kv_stride = (long)a.hkv * D;
  const T* qp = a.q + ((long)b * t_len * a.hq + h) * D;
  const T* kp = a.k + ((long)b * s_len * a.hkv + hk) * D;
  const T* vp = a.v + ((long)b * s_len * a.hkv + hk) * D;

  td::load_rows<T, D, NT, 4>(qp + q0 * q_stride, q_stride, BQ, t_len - q0,
                             qs, LD);
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = td::NEG_INF;
    l_s[r] = 0.f;
    if (VARLEN) qseg[r] = segment(a.cu, a.n_seq, offset + q0 + r);
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  // causal bound: key step kb is live iff its first key sits at or before
  // the tile's last query position (the reference's block_live)
  const int last_q = offset + q0 + BQ - 1;
  const int nk = last_q < k_base
                     ? 0
                     : min((s_len + BK - 1) / BK, (last_q - k_base) / BK + 1);

  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous step's readers are done
    td::load_rows<T, D, NT, 4>(kp + k0 * kv_stride, kv_stride, BK,
                               s_len - k0, ks, LD);
    td::load_rows<T, D, NT, 4>(vp + k0 * kv_stride, kv_stride, BK,
                               s_len - k0, vs, LD);
    if (VARLEN)
      for (int c = tid; c < BK; c += NT)
        kseg[c] = segment(a.cu, a.n_seq, k_base + k0 + c);
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
        const int kpos = k_base + k0 + c;
        const bool valid = kpos <= offset + q0 + r && k0 + c < s_len &&
                           (!VARLEN || kseg[c] == qseg[r]);
        ps[r * LP + c] = valid ? sc[i][j] * a.scale : td::NEG_INF;
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
        const int c0 = lane, c1 = lane + 32;
        const bool v0 = k_base + k0 + c0 <= qpos && k0 + c0 < s_len &&
                        (!VARLEN || kseg[c0] == qseg[r]);
        const bool v1 = k_base + k0 + c1 <= qpos && k0 + c1 < s_len &&
                        (!VARLEN || kseg[c1] == qseg[r]);
        const float p0 = v0 ? expf(s0 - m_new) : 0.f;
        const float p1 = v1 ? expf(s1 - m_new) : 0.f;
        const float psum = td::warp_sum(p0 + p1);
        ps[r * LP + c0] = td::p_cast<T>(p0);
        ps[r * LP + c1] = td::p_cast<T>(p1);
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
    const long row = ((long)b * t_len + t) * a.hq + h;  // (b, t, h)
    if (a.acc != nullptr) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) a.acc[row * D + cg + 16 * j] = acc[i][j];
      if (cg == 0) {
        a.m_out[row] = m_s[r];
        a.l_out[row] = l_s[r];
      }
    } else {
      const float den = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        a.o[row * D + cg + 16 * j] = td::from_f<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int D, bool VARLEN>
cudaError_t launch_form(const Args<T>& a, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes<D, VARLEN>();
  cudaError_t err = cudaFuncSetAttribute(
      prefill_kernel<T, D, VARLEN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t_len + BQ - 1) / BQ, a.hq, b);
  prefill_kernel<T, D, VARLEN><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Args<T>& a, int b, cudaStream_t stream) {
  return a.cu != nullptr ? launch_form<T, D, true>(a, b, stream)
                         : launch_form<T, D, false>(a, b, stream);
}

}  // namespace

// q: (B, T, Hq, D); k, v: (B, S, Hkv, D); all contiguous, one dtype
// (td::F32 or td::BF16), D in {64, 128}. Query i sits at position
// q_start + i and attends the keys j (at position k_start + j) at or before
// it, of its own segment when cu (n_seq + 1 int32 boundaries in device
// memory) is not null. q_start / k_start are read from device memory (one
// int32 each) when their pointers are not null, else the values passed.
// Exactly one output form: o (B, T, Hq, D) of the dtype, normalized; or
// acc (B, T, Hq, D), m, l (B, T, Hq) f32, unnormalized. Returns a
// cudaError_t.
extern "C" int td_flash_attn(const void* q, const void* k, const void* v,
                             void* o, void* acc, void* m_out, void* l_out,
                             int b, int t_len, int s_len, int hq, int hkv,
                             int d, const void* q_start_ptr, int q_start,
                             const void* k_start_ptr, int k_start,
                             const void* cu, int n_seq, float scale,
                             int dtype, void* stream) {
  if (b <= 0 || t_len <= 0 || s_len <= 0 || hkv <= 0 || hq % hkv != 0 ||
      (o == nullptr) == (acc == nullptr) ||
      (acc != nullptr && (m_out == nullptr || l_out == nullptr)) ||
      (cu != nullptr && n_seq <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TD_CASE(CODE, TYPE, DIM)                                             \
  if (dtype == CODE && d == DIM) {                                           \
    const Args<TYPE> a{static_cast<const TYPE*>(q),                          \
                       static_cast<const TYPE*>(k),                          \
                       static_cast<const TYPE*>(v),                          \
                       static_cast<TYPE*>(o),                                \
                       static_cast<float*>(acc),                             \
                       static_cast<float*>(m_out),                           \
                       static_cast<float*>(l_out),                           \
                       t_len, s_len, hq, hkv,                                \
                       static_cast<const int*>(q_start_ptr), q_start,        \
                       static_cast<const int*>(k_start_ptr), k_start,        \
                       static_cast<const int*>(cu), n_seq, scale};           \
    return static_cast<int>(launch<TYPE, DIM>(a, b, st));                    \
  }
  TD_CASE(td::F32, float, 64)
  TD_CASE(td::F32, float, 128)
  TD_CASE(td::BF16, __nv_bfloat16, 64)
  TD_CASE(td::BF16, __nv_bfloat16, 128)
#undef TD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
