// Shared device helpers of the port's attention kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace td {

// finite: keeps exp/max NaN-free in fully masked rows (the reference's
// NEG_INF in kernels/flash_attention.py)
constexpr float NEG_INF = -1e30f;

// dtype codes of the C interface (the Python wrappers pass these)
enum DType : int { F32 = 0, BF16 = 1, I8 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Probabilities enter the P.V product in V's dtype: rounded to bf16 when
// V is bf16 (the reference's _p_cast), exact when V is f32 or int8 (the
// int8 path keeps P in f32).
template <typename V>
__device__ __forceinline__ float p_cast(float p) {
  return p;
}
template <>
__device__ __forceinline__ float p_cast<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16(p));
}

// 16-byte vectors: 4 f32, 8 bf16 or 16 int8 values, unpacked to f32
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       const float*) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       const int8_t*) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = static_cast<float>(b[i]);
}

// Stage rows [0, nrows) of a (rows, D) tile whose rows start row_stride
// elements apart into shared memory as f32 with leading dimension ld.
// Rows at or past nvalid are zero-filled and never read. Each thread
// issues U independent 16-byte loads before it converts and stores any,
// so loads overlap instead of waiting one by one. base and row_stride
// must keep every row 16-byte aligned (the wrappers check the pointers).
// CG: read through L2 only (__ldcg), for rows another rank stored during
// the kernel; else through the read-only cache (__ldg).
template <typename T, int D, int NT, int U, bool CG = false>
__device__ __forceinline__ void load_rows(const T* __restrict__ base,
                                          long row_stride, int nrows,
                                          int nvalid, float* dst, int ld) {
  constexpr int VEC = kVec<T>;
  constexpr int VPR = D / VEC;  // vectors per row
  static_assert(D % VEC == 0, "head_dim must be a multiple of the vector");
  const int total = nrows * VPR;
  for (int v0 = threadIdx.x; v0 < total; v0 += NT * U) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * NT;
      const int r = v / VPR;
      raw[u] = make_uint4(0u, 0u, 0u, 0u);
      if (v < total && r < nvalid) {
        const uint4* src = reinterpret_cast<const uint4*>(
            base + r * row_stride + (v % VPR) * VEC);
        raw[u] = CG ? __ldcg(src) : __ldg(src);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * NT;
      if (v < total) {
        float f[VEC];
        unpack(raw[u], f, static_cast<const T*>(nullptr));
        float* out = dst + (v / VPR) * ld + (v % VPR) * VEC;
#pragma unroll
        for (int i = 0; i < VEC; ++i) out[i] = f[i];
      }
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace td
