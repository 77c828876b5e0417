// B27 (the int8 staging encode) and B28 (the int8 one-shot all-reduce),
// hand-written for Hopper (sm_90a).
//
// Replace the TPU kernels of the JAX package kernels/quant_wire.py
// ::_quantize_stage_kernel (B27) and ::_qint8_one_shot_kernel (B28):
//  * B27: x (m, K) f32 or bf16 -> q (m, K) int8 and s (m) f32 per row:
//    s = amax / 127 (an IEEE division; 1 for an all-zero row), q =
//    clamp(rint(x / s), -127, 127) (an IEEE division, round half to
//    even). The plain version (quant/codec.py encode_int8_nearest) does
//    the same operations in torch, so the bytes agree exactly;
//  * B28: every rank holds x (m, K) and returns the sum over the ranks
//    with int8 on the wire: each rank encodes its rows once (B27's row
//    encode) straight into slot `rank` of every rank's landing buffer (its
//    own included), then folds src = 0 .. n-1 as acc = acc + q * s in f32
//    (__fadd_rn / __fmul_rn: no contraction to a fused multiply-add, as
//    the plain version's separate torch ops), one cast. Every rank folds
//    the same terms in the same order, its own read back from its own
//    slot, so every rank's output is the same bytes.
//
// What bounds them on this card. B27 reads x once and writes q and s:
// m K (es + 1) + 4 m bytes of HBM, a few microseconds at the ring's hop
// shapes. B28 at the decode shape (16 x 5120 per rank) sends (n - 1)(m K
// + 4 m) = 246 KB per rank over NVLink, ~0.5 us at 450 GB/s: it is bound
// by one flag round trip and the launch, not by bytes; at a 512-row
// prefill chunk, 7.9 MB per rank, ~17 us.
//
// Design:
//  * one block reduces a whole row (the scale spans it): 16-byte loads of
//    x, a warp and block max, then the row again for the payload, 4 (f32)
//    or 8 (bf16) int8 values stored at once;
//  * B28 takes B5's scheme (csrc/allreduce.cu): block b of a rank owns
//    rows [b m / G, (b + 1) m / G) on every rank and talks only to block b
//    of its peers; one epoch-valued flag per (block, sender) in the
//    symmetric buffer; landing slots (q and s) double-buffered by the
//    epoch's parity, and no opening barrier: a rank in call e + 2 writes
//    the slots of call e only after it finished call e + 1, which needed
//    every peer's data of call e + 1, sent only after that peer finished
//    call e;
//  * the grid is small enough that every block of every rank that shares
//    the card is resident at once.

#include "td_common.cuh"
#include "td_dist.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;

constexpr int NT = 256;

// VEC int8 values stored as one word
template <int VEC>
struct QWord;
template <>
struct QWord<4> {
  using type = unsigned;
};
template <>
struct QWord<8> {
  using type = uint2;
};

__device__ __forceinline__ uint4 pack(const float* f, const float*) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float* f, const __nv_bfloat16*) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __halves2bfloat162(__float2bfloat16(f[2 * i]),
                              __float2bfloat16(f[2 * i + 1]));
  return u;
}

// The max of v over the block (every thread gets it); red: NT / 32 floats
// of shared memory, free again on return.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = td::warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = td::warp_max(lane < NT / 32 ? red[lane] : 0.0f);
    if (lane == 0) red[NT / 32] = v;
  }
  __syncthreads();
  const float out = red[NT / 32];
  __syncthreads();
  return out;
}

// The int8 row encode of B27 and B28: one row x of kv 16-byte vectors of
// T; its payload stored to dst[0 .. nd) (int8 rows of kv * VEC bytes);
// returns the row's scale to every thread.
template <typename T>
__device__ __forceinline__ float encode_row(const uint4* __restrict__ x,
                                            int kv, int8_t* const* dst,
                                            int nd, float* red) {
  constexpr int VEC = td::kVec<T>;
  using W = typename QWord<VEC>::type;
  float amax = 0.0f;
  for (int j = threadIdx.x; j < kv; j += NT) {
    float f[VEC];
    td::unpack(__ldg(x + j), f, static_cast<const T*>(nullptr));
#pragma unroll
    for (int i = 0; i < VEC; ++i) amax = fmaxf(amax, fabsf(f[i]));
  }
  amax = block_max(amax, red);
  float s = __fdiv_rn(amax, 127.0f);
  if (s == 0.0f) s = 1.0f;
  for (int j = threadIdx.x; j < kv; j += NT) {
    float f[VEC];
    td::unpack(__ldg(x + j), f, static_cast<const T*>(nullptr));
    W w;
    int8_t* b = reinterpret_cast<int8_t*>(&w);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float v = fminf(fmaxf(rintf(__fdiv_rn(f[i], s)), -127.0f),
                            127.0f);
      b[i] = static_cast<int8_t>(static_cast<int>(v));
    }
    for (int d = 0; d < nd; ++d) reinterpret_cast<W*>(dst[d])[j] = w;
  }
  return s;
}

// B27. q: (m, K) int8, s: (m) f32; rows r = blockIdx.x, + G, ...
template <typename T>
__global__ void __launch_bounds__(NT)
    stage_kernel(const uint4* __restrict__ x, int8_t* __restrict__ q,
                 float* __restrict__ s, int m, int kv) {
  __shared__ float red[NT / 32 + 1];
  constexpr int VEC = td::kVec<T>;
  for (int r = blockIdx.x; r < m; r += gridDim.x) {
    int8_t* row = q + static_cast<long>(r) * kv * VEC;
    const float sc =
        encode_row<T>(x + static_cast<long>(r) * kv, kv, &row, 1, red);
    if (threadIdx.x == 0) s[r] = sc;
  }
}

// B28. Symmetric buffer: q landing (2, world, m, K) int8 from byte 0, s
// landing (2, world, m) f32 at s_off, flags (G, world) u64 at flag_off.
template <typename T>
__global__ void __launch_bounds__(NT)
    qint8_one_shot_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                          Team team, u64* ctl, int m, int kv, long s_off,
                          long flag_off) {
  __shared__ float red[NT / 32 + 1];
  constexpr int VEC = td::kVec<T>;
  using W = typename QWord<VEC>::type;
  const int me = team.rank, world = team.world, b = blockIdx.x;
  const u64 e = td::dist::begin_call(ctl);
  const long k = static_cast<long>(kv) * VEC;   // int8 bytes a row
  const long slot = static_cast<long>(m) * k;   // one sender's payload
  const long par = static_cast<long>(e & 1) * world;
  const int r0 = static_cast<int>(static_cast<long>(b) * m / gridDim.x);
  const int r1 = static_cast<int>(static_cast<long>(b + 1) * m / gridDim.x);

  int8_t* dst[td::dist::kMaxWorld];
  for (int r = r0; r < r1; ++r) {
    for (int p = 0; p < world; ++p)
      dst[p] = reinterpret_cast<int8_t*>(team.peer(p)) + (par + me) * slot +
               r * k;
    const float sc =
        encode_row<T>(x + static_cast<long>(r) * kv, kv, dst, world, red);
    if (threadIdx.x < world)
      reinterpret_cast<float*>(team.peer(threadIdx.x) + s_off)
          [(par + me) * m + r] = sc;
  }
  __threadfence_system();
  __syncthreads();
  u64* my_flags = reinterpret_cast<u64*>(team.peer(me) + flag_off) +
                  static_cast<long>(b) * world;
  if (threadIdx.x < world && threadIdx.x != me)
    td::dist::notify(reinterpret_cast<u64*>(team.peer(threadIdx.x) +
                                            flag_off) +
                         static_cast<long>(b) * world + me,
                     e);
  if (threadIdx.x == 0)
    for (int src = 0; src < world; ++src)
      if (src != me)
        td::dist::wait(my_flags + src, e, "B28 int8 one-shot payload", src);
  __syncthreads();

  const int8_t* qland =
      reinterpret_cast<const int8_t*>(team.peer(me)) + par * slot;
  const float* sland =
      reinterpret_cast<const float*>(team.peer(me) + s_off) + par * m;
  for (int r = r0; r < r1; ++r) {
    float sc[td::dist::kMaxWorld];
    for (int src = 0; src < world; ++src)
      sc[src] = __ldcg(sland + static_cast<long>(src) * m + r);
    for (int j = threadIdx.x; j < kv; j += NT) {
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
      for (int src = 0; src < world; ++src) {
        const W w = __ldcg(reinterpret_cast<const W*>(qland + src * slot +
                                                      r * k) + j);
        const int8_t* q = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(static_cast<float>(q[i]),
                                               sc[src]));
      }
      out[static_cast<long>(r) * kv + j] =
          pack(acc, static_cast<const T*>(nullptr));
    }
  }
  td::dist::end_call(ctl, e);
}

// Checks that `grid` blocks of kernel fn fit on the card at once with the
// other ranks that share it (queried once per kernel, never under a CUDA
// graph capture: callers warm up first; the query also loads the kernel
// before any spinning launch).
template <typename K>
cudaError_t check_resident(K fn, int* occ, int grid, int ranks_per_device) {
  static int sms = 0;
  cudaError_t err = cudaSuccess;
  if (*occ == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, fn, NT, 0);
    if (err != cudaSuccess) {
      *occ = 0;
      return err;
    }
  }
  if (static_cast<long>(grid) * ranks_per_device >
      static_cast<long>(*occ) * sms)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_stage(const void* x, void* q, void* s, int m, int kv,
                         int grid, cudaStream_t st) {
  stage_kernel<T><<<grid, NT, 0, st>>>(static_cast<const uint4*>(x),
                                       static_cast<int8_t*>(q),
                                       static_cast<float*>(s), m, kv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_one_shot(const void* x, void* out, const Team& team,
                            u64* ctl, int m, int kv, long s_off,
                            long flag_off, int grid, int rpd,
                            cudaStream_t st) {
  static int occ = 0;
  cudaError_t err =
      check_resident(qint8_one_shot_kernel<T>, &occ, grid, rpd);
  if (err != cudaSuccess) return err;
  qint8_one_shot_kernel<T><<<grid, NT, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), team, ctl, m,
      kv, s_off, flag_off);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B27. x: (m, K) of one dtype (td::F32 or td::BF16), contiguous, 16-byte
// aligned, kv = K * itemsize / 16 vectors a row; q: (m, K) int8, s: (m)
// f32. Returns a cudaError_t.
int td_quantize_stage(const void* x, void* q, void* s, int m, int kv,
                      int grid, int dtype, void* stream) {
  if (m <= 0 || kv <= 0 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == td::F32)
    return static_cast<int>(launch_stage<float>(x, q, s, m, kv, grid, st));
  if (dtype == td::BF16)
    return static_cast<int>(
        launch_stage<__nv_bfloat16>(x, q, s, m, kv, grid, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// B28. x, out: (m, K) of one dtype (td::F32 or td::BF16), contiguous,
// 16-byte aligned, kv vectors a row; base: device table of every rank's
// symmetric buffer (q landing (2, world, m, K) int8 at byte 0, s landing
// (2, world, m) f32 at s_off, flags (grid, world) u64 at flag_off, zeroed
// once); ctl: this rank's control block (4 u64, zeroed once); grid:
// blocks (<= m), the same on every rank; ranks_per_device: ranks that
// share this card. Returns a cudaError_t.
int td_qint8_one_shot(const void* x, void* out, int rank, int world,
                      const void* base, void* ctl, int m, int kv,
                      long long s_off, long long flag_off, int grid,
                      int ranks_per_device, int dtype, void* stream) {
  if (world < 1 || world > td::dist::kMaxWorld || rank < 0 ||
      rank >= world || m <= 0 || kv <= 0 || grid < 1 || grid > m ||
      ranks_per_device < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* c = static_cast<u64*>(ctl);
  if (dtype == td::F32)
    return static_cast<int>(launch_one_shot<float>(
        x, out, team, c, m, kv, s_off, flag_off, grid, ranks_per_device, st));
  if (dtype == td::BF16)
    return static_cast<int>(launch_one_shot<__nv_bfloat16>(
        x, out, team, c, m, kv, s_off, flag_off, grid, ranks_per_device, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
