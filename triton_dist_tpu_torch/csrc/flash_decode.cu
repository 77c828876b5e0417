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
//  * bf16 (the Hopper kernel, decode_tma_kernel): bytes bound it, so the
//    design keeps HBM busy. The plan (kernels/flash_attention.py::
//    decode_plan) gives about one block an SM, each split a long run of
//    keys. One producer warp keeps STAGES 64-key K and V tiles in flight by
//    TMA (4-D tensor maps over the strides the launcher passes, in the
//    128-byte swizzle, through an mbarrier ring: attn_tile_sm90.cuh), up
//    to 128 KB a block; four consumer warps each take 16 keys of every
//    tile with their own online softmax and merge by exact LSE at the end
//    of the split. QK^T and P.V run on the tensor cores (mma.sync
//    m16n8k16, bf16 -> f32) with the g query heads of the kv head as the
//    16-row side, padded with zero rows; P is reused from the QK^T
//    accumulator as the A fragment of P.V (FA2's register layout), K read
//    by ldmatrix, V by ldmatrix.trans. The padding costs tensor-core
//    operations the card has to spare; B1's wgmma tile (64 rows) would pad
//    8x more and needs a warpgroup a tile, so it was not taken;
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

#include "attn_tile_sm90.cuh"
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
  const long stride = static_cast<long>(rows) * (d + 2);
  const float* pr = part + static_cast<long>(r) * (d + 2);
  float m = td::NEG_INF;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, pr[s * stride + d]);
  float a = 0.f, l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float sc = expf(pr[s * stride + d] - m);
    if (c < d) a = __fadd_rn(a, __fmul_rn(pr[s * stride + c], sc));
    l = __fadd_rn(l, __fmul_rn(pr[s * stride + d + 1], sc));
  }
  if (c < d) acc[static_cast<long>(r) * d + c] = a;
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

namespace s9 = td::sm90;
using bf16 = __nv_bfloat16;

constexpr int KT = 64;             // keys a tile
constexpr int STAGES = 4;          // tiles in the ring
constexpr int NCW = 4;             // consumer warps: warp w keys [16w, 16w+16)
constexpr int NTH = NCW * 32 + 32; // and one producer warp
constexpr int MAXG = 8;            // query heads of a kv head, at most
constexpr int SLAB = KT * 64;      // bf16 of one 64-column slab of a tile

struct DecodeArgs {
  const bf16* q;
  float* part;
  int b_len, hq, hkv, s_loc;
  const int* start_ptr;
  int start;
  const int* qpos_ptr;
  int qpos;
  int chunk;
  float scale;
  int hs;  // the maps' dims: (d, h, s, b) if 1, (d, s, h, b) if 0
};

template <int D>
constexpr size_t smem_bytes() {
  return 1024 + size_t(STAGES) * 2 * (D / 64) * SLAB * sizeof(bf16) +
         2 * STAGES * sizeof(uint64_t) +
         size_t(NCW) * MAXG * (D + 2) * sizeof(float);
}

// D (16 x 8 f32) += A (16 x 16 bf16, row-major fragment) x B (16 x 8,
// "col" fragment)
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// byte address of 16-byte chunk c (0..D/8) of tile row r in a tile of
// 64-column slabs in the 128-byte swizzle
template <int D>
__device__ __forceinline__ uint32_t tile_addr(uint32_t base, int r, int c) {
  return base + (c >> 3) * SLAB * 2 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// Block (split, kv head, batch): the g query heads of kv head hk of batch
// row b against keys [k_lo, k_hi) of the shard, written as the split's
// partial (acc, m, l) rows.
template <int D>
__global__ void __launch_bounds__(NTH, 1)
    decode_tma_kernel(const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const DecodeArgs a) {
  constexpr int NH = D / 64;                       // slabs a row
  constexpr uint32_t TILE_BYTES = NH * SLAB * sizeof(bf16);
  extern __shared__ uint8_t smem_raw[];
  bf16* const ks = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* const vs = ks + STAGES * NH * SLAB;        // [STAGES][NH][KT][64]
  uint64_t* const full = reinterpret_cast<uint64_t*>(vs + STAGES * NH * SLAB);
  uint64_t* const empty = full + STAGES;
  float* const mrg = reinterpret_cast<float*>(empty + STAGES);

  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int g = a.hq / a.hkv;
  const int start = a.start_ptr != nullptr ? *a.start_ptr : a.start;
  const int qpos = a.qpos_ptr != nullptr ? *a.qpos_ptr : a.qpos;
  // this split's live keys: [k_lo, k_hi) of the shard
  const int k_lo = sp * a.chunk;
  const long long horizon = static_cast<long long>(qpos) - start + 1;
  long long hi = k_lo + a.chunk < a.s_loc ? k_lo + a.chunk : a.s_loc;
  if (horizon < hi) hi = horizon;  // keys at or before q_pos only
  const int k_hi = hi > k_lo ? static_cast<int>(hi) : k_lo;
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
    // producer: K and V tiles into the ring, slab by slab
    if (lane == 0) {
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) s9::mbar_wait(empty + st, ((i / STAGES) & 1) ^ 1);
        s9::mbar_expect_tx(full + st, 2 * TILE_BYTES);
        const int s0 = k_lo + i * KT;
        const int c1 = a.hs ? hk : s0, c2 = a.hs ? s0 : hk;
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          s9::tma_load_4d(ks + (st * NH + h) * SLAB, &tm_k, full + st, 64 * h,
                          c1, c2, b);
          s9::tma_load_4d(vs + (st * NH + h) * SLAB, &tm_v, full + st, 64 * h,
                          c1, c2, b);
        }
      }
    }
    return;
  }

  // consumer warp: query row `row` (a head of the group, rows >= g zero)
  const int row = lane >> 2, cq = 2 * (lane & 3);
  uint32_t qa[D / 16][2];
  {
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        a.q + (static_cast<long>(b) * a.hq + hk * g + row) * D);
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
        // anything; their probabilities are 0)
        bf16* vt = vs + st * NH * SLAB;
        for (int x = lane; x < 16 * NH * 8; x += 32) {
          const int r = x / (NH * 8), c = x % (NH * 8);
          if (kw0 + r >= k_hi)
            *reinterpret_cast<uint4*>(
                reinterpret_cast<uint8_t*>(vt) +
                (tile_addr<D>(0, 16 * warp + r, c))) =
                make_uint4(0u, 0u, 0u, 0u);
        }
        __syncwarp();
      }
      // S = Q K^T over the group's 16 keys: two n-tiles of 8 keys
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t bk[4];
        ldsm_x4(bk, tile_addr<D>(kb, rk, 2 * kk + ck));
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
          sc[nt][u] = valid ? sc[nt][u] * a.scale : td::NEG_INF;
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
        ldsm_x4_t(bv, tile_addr<D>(vb, rv, 2 * j2 + cv));
        mma_bf16(o[2 * j2], pa0, pa2, bv[0], bv[1]);
        mma_bf16(o[2 * j2 + 1], pa0, pa2, bv[2], bv[3]);
      }
    }
    s9::mbar_arrive(empty + st);
  }

  // merge the four warps' (acc, m, l) by exact LSE, warps in order
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
  float* const out = a.part + ((static_cast<long>(sp) * a.b_len + b) * a.hq +
                               hk * g) * (D + 2);
  for (int x = threadIdx.x; x < g * D; x += NCW * 32) {
    const int r = x / D, c = x % D;
    float mx = td::NEG_INF;
#pragma unroll
    for (int w = 0; w < NCW; ++w)
      mx = fmaxf(mx, mrg[(w * MAXG + r) * (D + 2) + D]);
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < NCW; ++w) {
      const float* mw = mrg + (w * MAXG + r) * (D + 2);
      const float sc = expf(mw[D] - mx);
      acc = __fadd_rn(acc, __fmul_rn(mw[c], sc));
      l = __fadd_rn(l, __fmul_rn(mw[D + 1], sc));
    }
    out[r * (D + 2) + c] = acc;
    if (c == 0) {
      out[r * (D + 2) + D] = mx;
      out[r * (D + 2) + D + 1] = l;
    }
  }
}

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
cudaError_t launch(const DecodeArgs& a, const void* k, const void* v,
                   long sb, long sh, long sk, int splits, cudaStream_t st) {
  CUtensorMap tm_k, tm_v;
  if (!shard_map(&tm_k, k, a.b_len, a.s_loc, a.hkv, D, sb, sh, sk, a.hs) ||
      !shard_map(&tm_v, v, a.b_len, a.s_loc, a.hkv, D, sb, sh, sk, a.hs))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<D>();
  // the shared-memory attribute is set once per device (a bit per device)
  static std::atomic<uint64_t> smem_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(smem_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(decode_tma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set.fetch_or(bit, std::memory_order_release);
  }
  decode_tma_kernel<D><<<dim3(splits, a.hkv, a.b_len), NTH, smem, st>>>(
      tm_k, tm_v, a);
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
    const hop::DecodeArgs a{static_cast<const __nv_bfloat16*>(q), pp, b, hq,
                            hkv, s_loc, sp, start, qp, qpos, chunk, scale,
                            sh <= sk ? 1 : 0};
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
