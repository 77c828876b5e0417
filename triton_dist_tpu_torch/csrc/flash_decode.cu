// B19 (the split-KV decode partial over a dense key shard) and B20 (the
// cross-rank LSE combine of the distributed decode), hand-written for
// Hopper (sm_90a).
//
// Replace the TPU kernels kernels/flash_attention.py::_decode_kernel (B19,
// launched by flash_decode_partial) and kernels/flash_decode.py::
// _combine_kernel (B20, launched by _pallas_combine_per_device) of the JAX
// package.
//  * B19: q (B, Hq, D) against this rank's key shard, (B, S_loc, Hkv, D) or
//    head-major (B, Hkv, S_loc, D) (strides are passed), keys at global
//    positions start + j attended when start + j <= q_pos; returns the
//    unnormalized acc (B, Hq, D) f32 and its row max m and sum l (B, Hq).
//  * B20: every rank's (acc, m, l) of B * Hq rows merged by exact LSE in
//    rank order: m = max_s m_s, acc = sum_s e^(m_s - m) acc_s, l likewise;
//    returned normalized (acc / max(l, 1e-30)) or as the merged triple.
//
// What bounds them on this card. B19 at the sequence-parallel decode shape
// (B=4, S_loc = 32,768, Hq 64, Hkv 8, D 128, bf16) reads 537 MB of keys and
// values: 0.16 ms at 3.35 TB/s; its 2 x 4 x 64 x 32,768 x 128 FMAs (4.3
// GFLOP) are far below the tensor cores' bound, so bytes bound it. B20
// moves 256 rows of 130 f32 a rank to three peers (~0.4 MB over NVLink):
// a few microseconds, bound by the flag round trip and the launch.
//
// Design of B19. The TPU grid (B, Hkv, ns) carries the fold of the ns key
// blocks through VMEM in order, which at the decode shape would leave 32
// blocks for 132 SMs. Here the shard is split across blocks, as the source
// project's kernel_gqa_fwd_batch_decode_split_kv does: block (split, kv
// head, batch) folds its split's keys into a partial (acc, m, l); a second
// small kernel in the same call merges the splits in ascending order by
// exact LSE. The floats therefore differ from the sequential fold by
// rounding only. start and q_pos are read from device memory when
// pointers are given, so the launch reads nothing on the host and a CUDA
// graph that captures it stays right as q_pos advances; keys past the
// causal horizon or the shard are neither scored nor read for P.V, and a
// split wholly past q_pos issues no load. The reference's numerics:
// scores scaled after Q.K, finite NEG_INF, probabilities rounded to bf16
// before P.V when V is bf16, l summed before that rounding, f32
// accumulators.
//  * bf16 (the Hopper kernel): bytes bound it, so the design keeps HBM
//    busy. The plan (kernels/flash_attention.py::decode_plan) gives about
//    one block an SM, each split a long run of keys; each block runs
//    decode_tile_sm90.cuh's kernel (a producer warp keeping STAGES 64-key
//    K and V tiles in flight by TMA, four consumer warps on mma.sync
//    m16n8k16, shared with B2) over DenseSrc: 4-D tensor maps over the
//    strides the launcher passes, the split's partial into its slot. The
//    padding of the g heads to 16 rows costs tensor-core operations the
//    card has to spare; B1's wgmma tile (64 rows) would pad 8x more and
//    needs a warpgroup a tile, so it was not taken;
//  * f32 (decode_split_kernel): the FMA body, unchanged by the bf16 form: block
//    (split, kv head, batch) scores a key a thread against the g queries
//    (its key row read straight from device memory in 16-byte loads, the
//    queries from shared memory), reduces the tile's row max and sum
//    across the four warps, and for P.V each thread owns one column of the
//    g output rows, reading the value rows coalesced across the block.
//
// Design of B20 (on td_dist.cuh):
//  * block b of the grid owns row block b of the flattened B * Hq rows
//    (comm_blocks blocks). It stores its rows' acc and (m, l) as plain f32
//    (row stride D + 4: the TPU's 128-lane broadcast of m and l is a
//    layout artifact and is not carried over) into slot `rank` of every
//    peer's landing buffer with 16-byte stores over NVLink, fences, and
//    raises one epoch flag per (block, sender) on each peer; then it waits
//    for the n - 1 flags of its block and merges the block's rows across
//    sources 0..n-1 in slot order (its own rows read from its input);
//  * flags carry the call's epoch, waits are bounded and trap naming the
//    flag, and no barrier opens a call: the landing slots are
//    double-buffered by the epoch's parity (as B17). A rank writes a
//    peer's parity-p slot of call e + 2 only after it finished call e + 1,
//    which needed that peer's rows of call e + 1, which the peer sends only
//    once its call e kernel, the last reader of the slot, had ended. The
//    epoch advances on the device, so the call can be captured in a graph.

#include <atomic>

#include "decode_tile_sm90.cuh"
#include "td_common.cuh"
#include "td_dist.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;

constexpr int NT = 128;    // B19: threads a block, one key each a step
constexpr int TILE = NT;   // B19: keys a step
constexpr int NT_C = 256;  // B20: threads a block

template <typename T, int D, int G>
__global__ void __launch_bounds__(NT)
    decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, float* __restrict__ part,
                        int b_len, int hq, int s_loc, long sb, long sh,
                        long sk, const int* start_ptr, int start_arg,
                        const int* qpos_ptr, int qpos_arg, int chunk,
                        float scale) {
  constexpr int VEC = td::kVec<T>;
  __shared__ __align__(16) float qs[G][D];
  __shared__ float ps[TILE][G];
  __shared__ float red_m[NT / 32][G];
  __shared__ float red_l[NT / 32][G];

  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int start = start_ptr != nullptr ? *start_ptr : start_arg;
  const int qpos = qpos_ptr != nullptr ? *qpos_ptr : qpos_arg;
  const int h0 = hk * G;
  // this split's live keys: [k_lo, k_hi) of the shard
  const int k_lo = sp * chunk;
  const long long horizon = static_cast<long long>(qpos) - start + 1;
  long long hi = k_lo + chunk < s_loc ? k_lo + chunk : s_loc;
  if (horizon < hi) hi = horizon;  // keys at or before q_pos only
  const int k_hi = hi > k_lo ? static_cast<int>(hi) : k_lo;

  for (int i = tid; i < G * D; i += NT)
    qs[i / D][i % D] = td::to_f(q[(static_cast<long>(b) * hq + h0 + i / D) *
                                      D + i % D]);
  float m[G], l[G], acc[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    m[i] = td::NEG_INF;
    l[i] = 0.f;
    acc[i] = 0.f;
  }
  const T* kb = k + b * sb + hk * sh;
  const T* vb = v + b * sb + hk * sh;
  __syncthreads();

  for (int k0 = k_lo; k0 < k_hi; k0 += TILE) {
    const int j = k0 + tid;
    const bool valid = j < k_hi;
    float s[G];
#pragma unroll
    for (int i = 0; i < G; ++i) s[i] = 0.f;
    if (valid) {
      const T* kr = kb + j * sk;
#pragma unroll 4
      for (int d0 = 0; d0 < D; d0 += VEC) {
        float kf[VEC];
        td::unpack(__ldg(reinterpret_cast<const uint4*>(kr + d0)), kf,
                   static_cast<const T*>(nullptr));
#pragma unroll
        for (int i = 0; i < G; ++i)
#pragma unroll
          for (int u = 0; u < VEC; ++u) s[i] = fmaf(qs[i][d0 + u], kf[u], s[i]);
      }
    }
    float mt[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      s[i] = valid ? s[i] * scale : td::NEG_INF;
      const float w = td::warp_max(s[i]);
      if (lane == 0) red_m[warp][i] = w;
    }
    __syncthreads();
    float p[G], alpha[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      mt[i] = red_m[0][i];
#pragma unroll
      for (int w = 1; w < NT / 32; ++w) mt[i] = fmaxf(mt[i], red_m[w][i]);
      const float m_new = fmaxf(m[i], mt[i]);
      p[i] = valid ? expf(s[i] - m_new) : 0.f;
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
      const float w = td::warp_sum(p[i]);
      if (lane == 0) red_l[warp][i] = w;
      ps[tid][i] = td::p_cast<T>(p[i]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < G; ++i) {
      float sum = red_l[0][i];
#pragma unroll
      for (int w = 1; w < NT / 32; ++w) sum += red_l[w][i];
      l[i] = l[i] * alpha[i] + sum;
      acc[i] *= alpha[i];
    }
    if (tid < D) {
      const int n_live = min(TILE, k_hi - k0);
      const T* vc = vb + static_cast<long>(k0) * sk + tid;
      for (int kk = 0; kk < n_live; ++kk) {
        const float vv = td::to_f(vc[kk * sk]);
#pragma unroll
        for (int i = 0; i < G; ++i) acc[i] = fmaf(ps[kk][i], vv, acc[i]);
      }
    }
    __syncthreads();  // ps and the reductions are reused next step
  }

  // partial (splits, B, Hq, D + 2): acc, then m and l
  float* out = part + ((static_cast<long>(sp) * b_len + b) * hq + h0) *
                          (D + 2);
  if (tid < D) {
#pragma unroll
    for (int i = 0; i < G; ++i) out[i * (D + 2) + tid] = acc[i];
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      out[i * (D + 2) + D] = m[i];
      out[i * (D + 2) + D + 1] = l[i];
    }
  }
}

// The splits of each (batch, q head) row merged in ascending order by
// exact LSE. Block = one row, thread = one column.
__global__ void __launch_bounds__(NT)
    decode_merge_kernel(const float* __restrict__ part,
                        float* __restrict__ acc, float* __restrict__ m_out,
                        float* __restrict__ l_out, int rows, int d,
                        int splits) {
  const int r = blockIdx.x, c = threadIdx.x;
  if (c >= d) return;
  float a, m, l;
  td_decode::lse_fold<false>(part + static_cast<long>(r) * (d + 2),
                             static_cast<long>(rows) * (d + 2), splits, d, c,
                             a, m, l);
  acc[static_cast<long>(r) * d + c] = a;
  if (c == 0) {
    m_out[r] = m;
    l_out[r] = l;
  }
}

// The merge kernel is loaded before the first launch of either form: no
// lazy load between the two kernels of a call.
cudaError_t load_merge() {
  static bool loaded = false;
  if (!loaded) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, decode_merge_kernel);
    if (err != cudaSuccess) return err;
    loaded = true;
  }
  return cudaSuccess;
}

template <typename T, int D, int G>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          float* part, int b, int hq, int hkv, int s_loc,
                          long sb, long sh, long sk, const int* start_ptr,
                          int start, const int* qpos_ptr, int qpos, int chunk,
                          int splits, float scale, cudaStream_t st) {
  decode_split_kernel<T, D, G><<<dim3(splits, hkv, b), NT, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part, b, hq, s_loc, sb, sh, sk, start_ptr,
      start, qpos_ptr, qpos, chunk, scale);
  return cudaGetLastError();
}

// -- B19, bf16: the Hopper kernel --------------------------------------------

namespace hop {

using namespace td_decode;

// B19's source of tiles (decode_tile_sm90.cuh's Src): the dense shard by
// 4-D maps, the split's partial into its slot of `part`.
struct DenseSrc {
  Heads heads;
  float* part;
  int b_len, s_loc;
  const int* start_ptr;
  int start;
  const int* qpos_ptr;
  int qpos;
  int chunk;
  int hs;  // the maps' dims: (d, h, s, b) if 1, (d, s, h, b) if 0

  // this split's live keys: [k_lo, k_hi) of the shard, at or before q_pos
  __device__ __forceinline__ Range range(int sp, int, int) const {
    const int st = start_ptr != nullptr ? *start_ptr : start;
    const int qp = qpos_ptr != nullptr ? *qpos_ptr : qpos;
    const int k_lo = sp * chunk;
    const long long horizon = static_cast<long long>(qp) - st + 1;
    long long hi = k_lo + chunk < s_loc ? k_lo + chunk : s_loc;
    if (horizon < hi) hi = horizon;
    return {k_lo, hi > k_lo ? static_cast<int>(hi) : k_lo};
  }
  __device__ __forceinline__ bool skip(Range, int) const { return false; }
  __device__ __forceinline__ void prologue(Range, int, int, int,
                                           void*) const {}

  template <int D>
  __device__ __forceinline__ void load_tile(const CUtensorMap* tm_k,
                                            const CUtensorMap* tm_v,
                                            bf16* kd, bf16* vd,
                                            uint64_t* bar, int s0, Range,
                                            int hk, int b,
                                            const void*) const {
    constexpr int NH = D / 64;
    s9::mbar_expect_tx(bar, 2 * NH * SLAB * sizeof(bf16));
    const int c1 = hs ? hk : s0, c2 = hs ? s0 : hk;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      s9::tma_load_4d(kd + h * SLAB, tm_k, bar, 64 * h, c1, c2, b);
      s9::tma_load_4d(vd + h * SLAB, tm_v, bar, 64 * h, c1, c2, b);
    }
  }

  // the warps merged, into the split's partial rows
  template <int D>
  __device__ __forceinline__ void finish(const float* mrg, Range, int sp,
                                         int hk, int b, void*) const {
    const int g = heads.hq / heads.hkv;
    float* const out =
        part + ((static_cast<long>(sp) * b_len + b) * heads.hq + hk * g) *
                   (D + 2);
    for (int x = threadIdx.x; x < g * D; x += NCW * 32) {
      const int r = x / D, c = x % D;
      float acc, mx, l;
      warp_merge<D>(mrg, r, c, acc, mx, l);
      out[r * (D + 2) + c] = acc;
      if (c == 0) {
        out[r * (D + 2) + D] = mx;
        out[r * (D + 2) + D + 1] = l;
      }
    }
  }
};

// The map of one dense bf16 shard, K or V: dims (d, h, s, b) or (d, s, h,
// b), whichever keeps the strides ascending (hs), a box of one 64-column
// slab of KT keys of one (b, h), 128-byte swizzle; rows past S read as
// zeros. Strides in elements. False if the CUDA driver refuses it.
bool shard_map(CUtensorMap* map, const void* base, int b, int s, int h,
               int d, long sb, long sh, long sk, bool hs) {
  const s9::EncodeTiledFn fn = s9::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)(hs ? h : s),
                              (cuuint64_t)(hs ? s : h), (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)(hs ? sh : sk) * 2,
                                 (cuuint64_t)(hs ? sk : sh) * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, hs ? 1u : (cuuint32_t)KT,
                             hs ? (cuuint32_t)KT : 1u, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const DenseSrc& a, const void* k, const void* v,
                   long sb, long sh, long sk, int splits, cudaStream_t st) {
  CUtensorMap tm_k, tm_v;
  if (!shard_map(&tm_k, k, a.b_len, a.s_loc, a.heads.hkv, D, sb, sh, sk,
                 a.hs) ||
      !shard_map(&tm_v, v, a.b_len, a.s_loc, a.heads.hkv, D, sb, sh, sk,
                 a.hs))
    return cudaErrorInvalidValue;
  const size_t smem = ring_smem_bytes<D>();
  // the shared-memory attribute is set once per device (a bit per device)
  static std::atomic<uint64_t> smem_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(smem_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(decode_tile_kernel<D, DenseSrc>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set.fetch_or(bit, std::memory_order_release);
  }
  decode_tile_kernel<D, DenseSrc>
      <<<dim3(splits, a.heads.hkv, a.b_len), NTH, smem, st>>>(tm_k, tm_v, a);
  return cudaGetLastError();
}

}  // namespace hop

// -- B20 ----------------------------------------------------------------------

// Landing slots (2, world, rows, d + 4) f32 at byte 0 of every rank's
// symmetric buffer; flags (nblk, world) u64 at flag_off.
__global__ void __launch_bounds__(NT_C)
    combine_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                   const float* __restrict__ l, float* __restrict__ out,
                   float* __restrict__ acc_out, float* __restrict__ m_out,
                   float* __restrict__ l_out, int rows, int d, Team team,
                   u64* ctl, long flag_off) {
  const int me = team.rank, world = team.world, b = blockIdx.x;
  const int tid = threadIdx.x;
  const int w = d + 4;                      // landing row stride (floats)
  const int bb = rows / gridDim.x;
  const int r0 = b * bb;
  const u64 e = td::dist::begin_call(ctl);
  const long par = static_cast<long>(e & 1) * world;

  // 1. this block's rows into slot `me` of every peer, 16 bytes a store
  const int vpr = w / 4;                    // float4s a landing row
  for (int i = 1; i < world; ++i) {
    const int p = (me + i) % world;
    float4* dst = reinterpret_cast<float4*>(team.peer(p)) +
                  ((par + me) * rows + r0) * vpr;
    for (int x = tid; x < bb * vpr; x += NT_C) {
      const int r = r0 + x / vpr, c = x % vpr;
      dst[x] = c < d / 4
                   ? reinterpret_cast<const float4*>(acc + static_cast<long>(
                                                               r) * d)[c]
                   : make_float4(m[r], l[r], 0.f, 0.f);
    }
  }
  __threadfence_system();
  __syncthreads();
  u64* flags_of = nullptr;
  if (tid < world && tid != me) {
    flags_of = reinterpret_cast<u64*>(team.peer(tid) + flag_off);
    td::dist::notify(flags_of + static_cast<long>(b) * world + me, e);
  }
  if (tid == 0) {
    const u64* mine = reinterpret_cast<const u64*>(team.peer(me) + flag_off);
    for (int s = 0; s < world; ++s)
      if (s != me)
        td::dist::wait(mine + static_cast<long>(b) * world + s, e,
                       "B20 decode combine block", s);
  }
  __syncthreads();

  // 2. merge the block's rows across sources 0..n-1 in slot order
  const float* land = reinterpret_cast<const float*>(team.peer(me)) +
                      par * static_cast<long>(rows) * w;
  for (int x = tid; x < bb * d; x += NT_C) {
    const int r = r0 + x / d, c = x % d;
    float mx = td::NEG_INF;
    for (int s = 0; s < world; ++s) {
      const float ms = s == me ? m[r] : __ldcg(land + (static_cast<long>(s) *
                                                    rows + r) * w + d);
      mx = fmaxf(mx, ms);
    }
    float a = 0.f, ls = 0.f;
    for (int s = 0; s < world; ++s) {
      const float* src = land + (static_cast<long>(s) * rows + r) * w;
      const float ms = s == me ? m[r] : __ldcg(src + d);
      const float lv = s == me ? l[r] : __ldcg(src + d + 1);
      const float av = s == me ? acc[static_cast<long>(r) * d + c]
                               : __ldcg(src + c);
      const float sc = expf(ms - mx);
      a = __fadd_rn(a, __fmul_rn(av, sc));
      ls = __fadd_rn(ls, __fmul_rn(lv, sc));
    }
    if (out != nullptr) {
      out[static_cast<long>(r) * d + c] = a / fmaxf(ls, 1e-30f);
    } else {
      acc_out[static_cast<long>(r) * d + c] = a;
      if (c == 0) {
        m_out[r] = mx;
        l_out[r] = ls;
      }
    }
  }
  td::dist::end_call(ctl, e);
}

bool bad_team(int rank, int world) {
  return world < 1 || world > td::dist::kMaxWorld || rank < 0 ||
         rank >= world;
}

}  // namespace

extern "C" {

// B19. q: (B, Hq, D); k, v: dense shards with element strides sb (batch),
// sh (kv head), sk (key); acc (B, Hq, D), m, l (B, Hq) f32 outputs; part:
// (splits, B, Hq, D + 2) f32 scratch; the shard's keys split in `chunk`
// keys (a multiple of 128), `splits` of them covering s_loc. start / q_pos
// read from device memory (one int32 each) when their pointers are not
// null. One dtype (td::F32: the FMA body; td::BF16: the Hopper kernel,
// every stride 16-byte aligned), D in {64, 128}, Hq / Hkv in {1, 2, 4, 8};
// contiguous, 16-byte aligned key rows. Returns a cudaError_t.
int td_flash_decode_partial(const void* q, const void* k, const void* v,
                            void* acc, void* m, void* l, void* part, int b,
                            int hq, int hkv, int s_loc, int d, long long sb,
                            long long sh, long long sk, const void* start_ptr,
                            int start, const void* qpos_ptr, int qpos,
                            int chunk, int splits, float scale, int dtype,
                            void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || s_loc <= 0 || chunk <= 0 ||
      chunk % TILE != 0 || splits <= 0 ||
      static_cast<long>(chunk) * splits < s_loc ||
      static_cast<long>(chunk) * (splits - 1) >= s_loc)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = hq / hkv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(start_ptr);
  const int* qp = static_cast<const int*>(qpos_ptr);
  float* pp = static_cast<float*>(part);
  cudaError_t err = load_merge();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaErrorInvalidValue;
  if (dtype == td::BF16 && (g == 1 || g == 2 || g == 4 || g == 8) &&
      (d == 64 || d == 128)) {
    const hop::DenseSrc a{
        {static_cast<const __nv_bfloat16*>(q), hq, hkv, scale},
        pp, b, s_loc, sp, start, qp, qpos, chunk, sh <= sk ? 1 : 0};
    err = d == 64 ? hop::launch<64>(a, k, v, sb, sh, sk, splits, st)
                  : hop::launch<128>(a, k, v, sb, sh, sk, splits, st);
  }
#define TD_CASE(DIM, G)                                                      \
  if (dtype == td::F32 && d == DIM && g == G)                                \
    err = launch_decode<float, DIM, G>(q, k, v, pp, b, hq, hkv, s_loc, sb,   \
                                       sh, sk, sp, start, qp, qpos, chunk,   \
                                       splits, scale, st);
#define TD_GROUPS(DIM) \
  TD_CASE(DIM, 1)      \
  TD_CASE(DIM, 2)      \
  TD_CASE(DIM, 4)      \
  TD_CASE(DIM, 8)
  TD_GROUPS(64)
  TD_GROUPS(128)
#undef TD_GROUPS
#undef TD_CASE
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge_kernel<<<b * hq, NT, 0, st>>>(
      pp, static_cast<float*>(acc), static_cast<float*>(m),
      static_cast<float*>(l), b * hq, d, splits);
  return static_cast<int>(cudaGetLastError());
}

// B20. acc (rows, d), m, l (rows) f32: this rank's partial; exactly one
// output form: out (rows, d) f32 normalized, or acc_out, m_out, l_out the
// merged triple. rows = B * Hq, a multiple of nblk (the grid); d a multiple
// of 4. base: device table of every rank's symmetric buffer ((2, world,
// rows, d + 4) f32 landing slots, flags (nblk, world) u64 at flag_off,
// zeroed once); ctl: this rank's control block (4 u64, zeroed once).
// Returns a cudaError_t.
int td_decode_combine(const void* acc, const void* m, const void* l,
                      void* out, void* acc_out, void* m_out, void* l_out,
                      int rows, int d, int nblk, int rank, int world,
                      const void* base, void* ctl, long long flag_off,
                      void* stream) {
  if (bad_team(rank, world) || rows <= 0 || d <= 0 || d % 4 != 0 ||
      nblk <= 0 || rows % nblk != 0 ||
      (out == nullptr) == (acc_out == nullptr) ||
      (acc_out != nullptr && (m_out == nullptr || l_out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), 0};
  combine_kernel<<<nblk, NT_C, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<float*>(out),
      static_cast<float*>(acc_out), static_cast<float*>(m_out),
      static_cast<float*>(l_out), rows, d, team, static_cast<u64*>(ctl),
      static_cast<long>(flag_off));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
