// B3: fused residual add + RMSNorm, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/fused_chain.py::_add_rms_kernel of the JAX
// package (launched by fused_add_rms_per_device): the mega decode step's
// attention->MLP boundary, s = h + a and normed = RMSNorm(s) * w, with both
// outputs from one read of h and a.
//
// What bounds it on this card. It reads h, a (rows x d) and w (d) and
// writes s and normed: at the decode shape (4 rows, d = 4096, bf16) that is
// 139 KB, 0.04 us at 3.35 TB/s, so a launch is bound by its latency, not by
// bytes or by its ~5 FLOP per element. At 2048 rows it moves 34 MB: bytes.
//
// Design:
//  * one block per row; each thread loads its share of the row as 16-byte
//    vectors of h and a, keeps the rounded sum in registers (VPT vectors a
//    thread), so the row is read from memory once;
//  * the reference's cast points are kept: s is rounded to the input dtype
//    before it is stored and before it is squared; the normalized value is
//    rounded to the input dtype before the multiply by w, and that product
//    is rounded again, as PyTorch's and XLA's dtype rules do;
//  * the square sum is a warp-shuffle reduction and then a fixed-order sum
//    over the warps, so a launch is deterministic.

#include "td_common.cuh"

namespace {

constexpr int MAX_THREADS = 256;

template <typename T>
__device__ __forceinline__ void pack(const float* f, uint4* out) {
  T* p = reinterpret_cast<T*>(out);
#pragma unroll
  for (int i = 0; i < td::kVec<T>; ++i) p[i] = td::from_f<T>(f[i]);
}

template <typename T, int VPT>
__global__ void __launch_bounds__(MAX_THREADS)
    add_rms_kernel(const T* __restrict__ h, const T* __restrict__ a,
                   const T* __restrict__ w, T* __restrict__ s,
                   T* __restrict__ o, int d, float eps) {
  constexpr int VEC = td::kVec<T>;
  __shared__ float warp_ss[MAX_THREADS / 32];
  __shared__ float inv_rms;
  const long base = static_cast<long>(blockIdx.x) * d;
  const int nvec = d / VEC;

  float x[VPT][VEC];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      const uint4 hu =
          __ldg(reinterpret_cast<const uint4*>(h + base + v * VEC));
      const uint4 au =
          __ldg(reinterpret_cast<const uint4*>(a + base + v * VEC));
      float hf[VEC], af[VEC];
      td::unpack(hu, hf, static_cast<const T*>(nullptr));
      td::unpack(au, af, static_cast<const T*>(nullptr));
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        // s in the input dtype, as PyTorch's h + a rounds it
        x[i][j] = td::to_f(td::from_f<T>(hf[j] + af[j]));
        ss = fmaf(x[i][j], x[i][j], ss);
      }
      uint4 su;
      pack<T>(x[i], &su);
      *reinterpret_cast<uint4*>(s + base + v * VEC) = su;
    }
  }

  ss = td::warp_sum(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_ss[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int i = 0; i < (blockDim.x >> 5); ++i) tot += warp_ss[i];
    inv_rms = rsqrtf(tot / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = inv_rms;

#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      const uint4 wu = __ldg(reinterpret_cast<const uint4*>(w + v * VEC));
      float wf[VEC], out[VEC];
      td::unpack(wu, wf, static_cast<const T*>(nullptr));
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        out[j] = td::to_f(td::from_f<T>(x[i][j] * r)) * wf[j];
      uint4 ou;
      pack<T>(out, &ou);
      *reinterpret_cast<uint4*>(o + base + v * VEC) = ou;
    }
  }
}

template <typename T>
cudaError_t launch(const void* h, const void* a, const void* w, void* s,
                   void* o, int rows, int d, float eps, cudaStream_t stream) {
  constexpr int VEC = td::kVec<T>;
  const int nvec = d / VEC;
  const int warps = (nvec + 31) / 32;
  const int threads = warps * 32 < MAX_THREADS ? warps * 32 : MAX_THREADS;
  const int vpt = (nvec + threads - 1) / threads;
#define TD_VPT(N)                                                         \
  if (vpt <= N) {                                                         \
    add_rms_kernel<T, N><<<rows, threads, 0, stream>>>(                   \
        static_cast<const T*>(h), static_cast<const T*>(a),               \
        static_cast<const T*>(w), static_cast<T*>(s), static_cast<T*>(o), \
        d, eps);                                                          \
    return cudaGetLastError();                                            \
  }
  TD_VPT(1)
  TD_VPT(2)
  TD_VPT(4)
  TD_VPT(8)
#undef TD_VPT
  return cudaErrorInvalidValue;
}

}  // namespace

// h, a, s, o: (rows, d); w: (d); all contiguous, one dtype (td::F32 or
// td::BF16), 16-byte aligned, d a multiple of the 16-byte vector and at
// most 8 vectors per thread of 256. s = h + a; o = RMSNorm(s) * w.
// Returns a cudaError_t.
extern "C" int td_fused_add_rms(const void* h, const void* a, const void* w,
                                void* s, void* o, int rows, int d, float eps,
                                int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == td::F32 && d % td::kVec<float> == 0)
    return static_cast<int>(launch<float>(h, a, w, s, o, rows, d, eps, st));
  if (dtype == td::BF16 && d % td::kVec<__nv_bfloat16> == 0)
    return static_cast<int>(
        launch<__nv_bfloat16>(h, a, w, s, o, rows, d, eps, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
