// B1: causal GQA flash attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/flash_attention.py::_prefill_kernel of the
// JAX package (launched by flash_prefill and flash_fold_partial through
// _flash_launch) in all three of its forms:
//  * prefill: the normalized output over a cache, queries at offset + i
//    (the prefill, a prefill chunk's continuation, and the dense decode
//    step at T = 1);
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
// the bound is bytes. At the dense decode step (T = 1) it is bytes: each
// (batch, kv head) streams its live keys and values once. At the
// sequence-parallel fold (2,048 queries against a 2,048-key chunk at
// Qwen3-32B's 64 heads) it is operations: ~137 GFLOP for the full chunk,
// ~0.14 ms.
//
// Two bodies, by dtype:
//
// bf16 (every serving path): the Hopper kernel in namespace hop, built
// from attn_tile_sm90.cuh.
//  * GQA-packed rows. A block's 64 or 128 rows are (query, head) pairs of
//    ONE kv head: row r is query q0 + r / hpt and q head hk * g + h0 +
//    r % hpt, hpt = g (or the rows, when g exceeds them). Each K/V tile is
//    read once for all g heads that share it, and at T = 1 a block holds g
//    live rows. The packing (queries a tile, heads a tile, the grid) is
//    flash_attention.py's flash_plan, passed in by the launch; the grid is
//    (query tiles x head tiles, Hkv, B) and depends only on T and g.
//  * Tensor cores for both products, 128 keys a step: QK^T is wgmma
//    m64n128k16 bf16 -> f32 with Q and K from shared memory (K-major);
//    P.V is wgmma m64n64k16 per 64-column slab of V, with P from
//    registers (the QK^T accumulator rounded to bf16 in place) and V read
//    MN-major (transposed) from shared memory. Every form uses wgmma, the
//    T = 1 form included: there one consumer warpgroup of 64 rows holds
//    the g live rows, and the ring below keeps its bytes in flight.
//    (128-key steps ran faster here than 64-key steps; a software
//    pipeline of QK^T of step i + 1 beside P.V of step i, FA3's, ran
//    slower with two warpgroups a block.)
//  * Asynchronous K/V: one producer warp keeps 2 (3 at T = 1) stages of
//    128-key K and V tiles in flight by TMA (a 4-D tensor map of the
//    (B, S, Hkv, D) layout, 128-byte swizzle matching the descriptors;
//    keys past S arrive as zeros), each stage guarded by full / empty
//    mbarriers. Tiles stay bf16 in shared memory: at D = 128 a 128-row Q
//    tile and two stages take 160 KB.
//  * The softmax in registers: row max and row sum from the accumulator
//    fragment by quad shuffles; masking only on the key steps that need
//    it (the causal diagonal or a chunk partly in the future, the s_len
//    tail, a segment boundary), as a compare against each row's window
//    [segment start, min(position, S - 1)]; O's rescale skipped where
//    the rows' maxima did not move.
//  * Positions are read on the device (q_start_ptr, k_start_ptr, cu):
//    a captured CUDA graph stays right as they advance. Key steps run
//    [kb_lo, nk): nk is the reference's block_live bound with the key
//    start at the tile's last query; in varlen, steps wholly before the
//    tile's first segment are skipped (all masked, they change nothing).
//  * The reference's numerics: a finite NEG_INF for m; probabilities
//    exp(s - m) (as exp2 of the scaled log2 argument), 0 where masked;
//    l summed from the f32 probabilities before P is rounded to bf16 for
//    P.V; the normalized form divides by max(l, 1e-30); the fold form
//    stores acc, m and l unnormalized in f32, (0, NEG_INF, 0) for a row
//    with no live key.
//
// f32 (the gates that need f32 exactness: 1e-4 against the plain version
// and the continuation's off-by-one check; TF32 would miss them, and no
// serving path runs B1 in f32): the FMA body below, one block per
// (64-query tile, q head, batch row):
//  * the TPU grid's sequential key-block axis becomes a loop inside the
//    block, bounded by the causal diagonal exactly like the reference's
//    block_live test (with the key start: k_start + kb * BK <= the tile's
//    last query), so key blocks above the diagonal are never loaded;
//  * q head h reads kv head h / (Hq/Hkv) (GQA) straight from the
//    (B, S, Hkv, D) layout through strides: no head-major copies in HBM;
//  * tiles are staged through 16-byte loads, several in flight per
//    thread; loads past T and S are masked (zero-filled) and stores past
//    T are skipped, so nothing is read or written out of bounds (the TPU
//    kernel reads padded tails and zeroes V's tail rows instead; the
//    in-chunk mask k < k_start + S of its fold form is this bound);
//  * online softmax with the running (m, l) of each row in shared memory,
//    the reference's numerics kept as above;
//  * segment ids of the tile's queries are computed once, those of each
//    key step beside its tile, from the boundaries in device memory;
//  * each thread holds a 4 x (D/16) register tile of scores and outputs
//    (rows rg + 16i, columns cg + 16j), so shared-memory reads stay
//    conflict-free (rows padded to D+1 floats).

#include <atomic>

#include "attn_tile_sm90.cuh"
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

// -- bf16: the Hopper kernel -------------------------------------------------

namespace hop {

using bf16 = __nv_bfloat16;
namespace s9 = td::sm90;

constexpr int KEYS = 128;         // keys per step (one n128 QK^T product)
constexpr int KSLAB = KEYS * 64;  // elements of a K or V slab
constexpr int NO_SEG = -(1 << 30);
constexpr float LOG2E = 1.4426950408889634f;

// Keys and values in flight: 3 stages for the one-warpgroup (T=1) form,
// which is bound by the bytes it streams, 2 for the two-warpgroup form
// (what fits in shared memory beside its 128-row Q tile).
template <int NWG>
__host__ __device__ constexpr int stages() {
  return NWG == 1 ? 3 : 2;
}

template <int D, int NWG>
__host__ __device__ constexpr size_t smem_bytes() {
  // 1 KB of slack to align the slabs to 1024 bytes, Q, the K and V ring,
  // three barriers a stage
  return 1024 + sizeof(bf16) * (size_t)(D / 64) *
                    (NWG * 64 * 64 + 2 * stages<NWG>() * KSLAB) +
         3 * stages<NWG>() * sizeof(uint64_t);
}

// One launch: the shapes, positions and outputs (as Args) and the packing
// that flash_attention.py's flash_plan computed.
struct Plan {
  const bf16* q;
  bf16* o;
  float* acc;
  float* m_out;
  float* l_out;
  int t_len, s_len, hq, hkv;
  const int* q_start_ptr;
  int q_start;
  const int* k_start_ptr;
  int k_start;
  const int* cu;
  int n_seq;
  float scale;
  int q_per_tile;  // queries of a tile
  int h_per_tile;  // heads of the kv head's group in a tile
  int h_tiles;     // tiles across the group (1 unless g > rows)
};

// The start of pos's segment: the largest boundary cu[1..n_seq] at or
// below it, NO_SEG if none. A key at or before pos shares its segment iff
// it is at or after this start.
__device__ __forceinline__ int segment_start(const int* __restrict__ cu,
                                             int n_seq, int pos) {
  int lo = NO_SEG;
  for (int j = 1; j <= n_seq; ++j) {
    const int c = __ldg(cu + j);
    if (c <= pos) lo = max(lo, c);
  }
  return lo;
}

// Block = (tile of packed rows, kv head, batch row). Warps 0 .. 4 NWG - 1
// are NWG consumer warpgroups of 64 rows each; warp 4 NWG is the producer,
// one thread of which streams K and V through the ring by TMA. The
// producer is one warp, not a warpgroup: 160 or 288 threads leave each
// consumer thread 255 or 224 registers without setmaxnreg.
template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
    attn_kernel(const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const Plan a) {
  constexpr int M = NWG * 64;  // packed rows of the block
  constexpr int NH = D / 64;   // 64-column slabs of a row
  constexpr int ST = stages<NWG>();
  constexpr uint32_t TILE_BYTES = NH * KSLAB * sizeof(bf16);
  extern __shared__ uint8_t smem_raw[];
  bf16* const qs = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* const ks = qs + NH * M * 64;      // [ST][NH][KEYS][64]
  bf16* const vs = ks + ST * NH * KSLAB;  // [ST][NH][KEYS][64]
  uint64_t* const full_k = reinterpret_cast<uint64_t*>(vs + ST * NH * KSLAB);
  uint64_t* const full_v = full_k + ST;
  uint64_t* const empty = full_v + ST;

  const int offset = a.q_start_ptr != nullptr ? *a.q_start_ptr : a.q_start;
  const int k_base = a.k_start_ptr != nullptr ? *a.k_start_ptr : a.k_start;
  const int t_len = a.t_len, s_len = a.s_len;
  const int g = a.hq / a.hkv;
  const int hpt = a.h_per_tile;
  const int q0 = (blockIdx.x / a.h_tiles) * a.q_per_tile;
  const int h0 = (blockIdx.x % a.h_tiles) * hpt;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;

  // live key steps: [kb_lo, nk). The causal bound is the reference's
  // block_live with the key start, taken at the tile's last real query;
  // in varlen, steps wholly before the first query's segment are skipped
  // (every row of the tile masks them).
  const int q_last = min(q0 + a.q_per_tile - 1, t_len - 1);
  const int last_pos = offset + q_last;
  const int nk = last_pos < k_base
                     ? 0
                     : min((s_len + KEYS - 1) / KEYS,
                           (last_pos - k_base) / KEYS + 1);
  int kb_lo = 0, lo_last = NO_SEG;
  if (a.cu != nullptr) {
    const int lo_first = segment_start(a.cu, a.n_seq, offset + q0);
    if (lo_first > k_base) kb_lo = min((lo_first - k_base) / KEYS, nk);
    lo_last = segment_start(a.cu, a.n_seq, last_pos);
  }

  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      s9::mbar_init(full_k + s, 1);
      s9::mbar_init(full_v + s, 1);
      s9::mbar_init(empty + s, NWG * 128);
    }
    s9::mbar_init_fence();
  }
  __syncthreads();

  if (warp == NWG * 4) {
    // producer: the ring's K and V tiles, slab by slab
    if ((threadIdx.x & 31) == 0) {
      for (int kb = kb_lo, i = 0; kb < nk; ++kb, ++i) {
        const int st = i % ST;
        if (i >= ST) s9::mbar_wait(empty + st, ((i / ST) & 1) ^ 1);
        s9::mbar_expect_tx(full_k + st, TILE_BYTES);
#pragma unroll
        for (int h = 0; h < NH; ++h)
          s9::tma_load_4d(ks + (st * NH + h) * KSLAB, &tm_k, full_k + st,
                          64 * h, hk, kb * KEYS, b);
        s9::mbar_expect_tx(full_v + st, TILE_BYTES);
#pragma unroll
        for (int h = 0; h < NH; ++h)
          s9::tma_load_4d(vs + (st * NH + h) * KSLAB, &tm_v, full_v + st,
                          64 * h, hk, kb * KEYS, b);
      }
    }
    return;
  }

  // consumer warpgroup wg: packed rows [64 wg, 64 wg + 64)
  const int wg = warp >> 2;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int rows_live = a.q_per_tile * hpt;

  // row R of the tile is (query q0 + R / hpt, head h0 + R % hpt); rows
  // past the tile's pairs, past T or past the group are zeros and never
  // stored
  auto row_pair = [&](int r, int& q, int& h) {
    q = q0 + r / hpt;
    h = h0 + r % hpt;
    return r < rows_live && q < t_len && h < g;
  };

  // Q: this warpgroup's 64 rows into the swizzled slabs, every load
  // issued before the first store (a store between them would wait out
  // each load's latency in turn)
  constexpr int QV = 64 * D / 8 / 128;  // 16-byte chunks a thread moves
  uint4 qv[QV];
#pragma unroll
  for (int u = 0; u < QV; ++u) {
    const int idx = tid + 128 * u;
    int q, h;
    qv[u] = make_uint4(0u, 0u, 0u, 0u);
    if (row_pair(wg * 64 + idx / (D / 8), q, h))
      qv[u] = __ldg(reinterpret_cast<const uint4*>(
                        a.q + (((long)b * t_len + q) * a.hq + hk * g + h) *
                                  D) +
                    idx % (D / 8));
  }
#pragma unroll
  for (int u = 0; u < QV; ++u) {
    const int idx = tid + 128 * u;
    const int r = wg * 64 + idx / (D / 8);
    const int c = idx % (D / 8);  // 16-byte chunk of the row
    *reinterpret_cast<uint4*>(qs + (c >> 3) * M * 64 + r * 64 +
                              (((c & 7) ^ (r & 7)) << 3)) = qv[u];
  }
  s9::fence_proxy_async();
  s9::named_sync(1 + wg, 128);

  // this thread's two rows: ra and ra + 8 of the warpgroup
  const int ra = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  int qa, ha, qb, hb;
  const bool live_a = row_pair(ra, qa, ha);
  const bool live_b = row_pair(ra + 8, qb, hb);
  const int pos_a = offset + qa, pos_b = offset + qb;
  const int lo_a = a.cu != nullptr ? segment_start(a.cu, a.n_seq, pos_a)
                                   : NO_SEG;
  const int lo_b = a.cu != nullptr ? segment_start(a.cu, a.n_seq, pos_b)
                                   : NO_SEG;

  const float sl2 = a.scale * LOG2E;
  float m_a = td::NEG_INF, m_b = td::NEG_INF, l_a = 0.f, l_b = 0.f;
  float o[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[h][i] = 0.f;

  const uint32_t q_addr = s9::smem_addr(qs) + wg * 64 * 128;
  const uint32_t k_addr = s9::smem_addr(ks);
  const uint32_t v_addr = s9::smem_addr(vs);
  const int col0 = 2 * (lane & 3);

  for (int kb = kb_lo, i = 0; kb < nk; ++kb, ++i) {
    const int st = i % ST;
    const uint32_t par = (i / ST) & 1;
    const int k0 = kb * KEYS;
    const int kp0 = k_base + k0;

    // S = Q K^T on the tensor cores
    float s[KEYS / 2];
    s9::mbar_wait(full_k + st, par);
    s9::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      s9::wgmma_ss(
          s,
          s9::desc_sw128(q_addr + (kk >> 2) * M * 128 + (kk & 3) * 32, 16,
                         1024),
          s9::desc_sw128(k_addr + (st * NH + (kk >> 2)) * KSLAB * 2 +
                             (kk & 3) * 32,
                         16, 1024),
          kk > 0);
    s9::wgmma_commit();
    s9::wgmma_wait<0>();
    s9::fence_regs(s);

    // masks only where a tile needs them: the causal diagonal (or a
    // chunk partly in the future), the s_len tail, a segment boundary
    const bool masked = kp0 + KEYS - 1 > offset + q0 || k0 + KEYS > s_len ||
                        kp0 < lo_last;
    if (masked) {
      const int hi_a = min(pos_a - kp0, s_len - k0 - 1);
      const int hi_b = min(pos_b - kp0, s_len - k0 - 1);
      const int lo_ca = lo_a - kp0, lo_cb = lo_b - kp0;
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + col0 + e;
          if (c > hi_a || c < lo_ca) s[4 * j + e] = -INFINITY;
          if (c > hi_b || c < lo_cb) s[4 * j + 2 + e] = -INFINITY;
        }
    }

    // online softmax in registers: the rows' maxima by quad shuffles
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    // max(scale * s) = scale * max(s): rounding is monotonic
    const float mn_a = fmaxf(m_a, s9::quad_max(mx_a) * a.scale);
    const float mn_b = fmaxf(m_b, s9::quad_max(mx_b) * a.scale);
    const float al_a = exp2f((m_a - mn_a) * LOG2E);
    const float al_b = exp2f((m_b - mn_b) * LOG2E);
    m_a = mn_a;
    m_b = mn_b;
    const float nm_a = -mn_a * LOG2E;
    const float nm_b = -mn_b * LOG2E;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      // a masked score is -inf: its probability is exactly 0
      s[4 * j] = exp2f(fmaf(s[4 * j], sl2, nm_a));
      s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], sl2, nm_a));
      s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], sl2, nm_b));
      s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], sl2, nm_b));
      ps_a += s[4 * j] + s[4 * j + 1];
      ps_b += s[4 * j + 2] + s[4 * j + 3];
    }
    // l from the f32 probabilities (a thread's share of its rows; the
    // quad's shares are summed once at the end)
    l_a = l_a * al_a + ps_a;
    l_b = l_b * al_b + ps_b;
    // once the rows' maxima settle, alpha is 1 and the rescale is skipped
    // (multiplying by 1 changes nothing)
    if (al_a != 1.f || al_b != 1.f) {
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[h][4 * j] *= al_a;
          o[h][4 * j + 1] *= al_a;
          o[h][4 * j + 2] *= al_b;
          o[h][4 * j + 3] *= al_b;
        }
    }
    uint32_t pa[KEYS / 16][4];  // P rounded to bf16, as P.V's A fragments
    s9::p_fragments<KEYS>(s, pa);

    // O += P V on the tensor cores
    s9::mbar_wait(full_v + st, par);
    s9::wgmma_fence();
#pragma unroll
    for (int h = 0; h < NH; ++h)
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
        s9::wgmma_rs_tb(o[h], pa[kk],
                        s9::desc_sw128(v_addr + (st * NH + h) * KSLAB * 2 +
                                           kk * 16 * 128,
                                       KEYS * 128, 1024));
    s9::wgmma_commit();
    s9::wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NH; ++h) s9::fence_regs(o[h]);
    s9::mbar_arrive(empty + st);
  }

  l_a = s9::quad_sum(l_a);
  l_b = s9::quad_sum(l_b);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bool live = half == 0 ? live_a : live_b;
    if (!live) continue;
    const int q = half == 0 ? qa : qb;
    const int h = half == 0 ? ha : hb;
    const float l = half == 0 ? l_a : l_b;
    const long row = ((long)b * t_len + q) * a.hq + hk * g + h;
    if (a.acc != nullptr) {
#pragma unroll
      for (int sl = 0; sl < NH; ++sl)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(a.acc + row * D + 64 * sl + 8 * j +
                                     col0) =
              make_float2(o[sl][4 * j + 2 * half],
                          o[sl][4 * j + 2 * half + 1]);
      if ((lane & 3) == 0) {
        a.m_out[row] = half == 0 ? m_a : m_b;
        a.l_out[row] = l;
      }
    } else {
      const float den = fmaxf(l, 1e-30f);
#pragma unroll
      for (int sl = 0; sl < NH; ++sl)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(a.o + row * D + 64 * sl +
                                             8 * j + col0) =
              __floats2bfloat162_rn(o[sl][4 * j + 2 * half] / den,
                                    o[sl][4 * j + 2 * half + 1] / den);
    }
  }
}

template <int D, int NWG>
cudaError_t launch(const Plan& a, const void* k, const void* v, int b,
                   cudaStream_t stream) {
  CUtensorMap tm_k, tm_v;
  if (!s9::bshd_map(&tm_k, k, b, a.s_len, a.hkv, D, KEYS) ||
      !s9::bshd_map(&tm_v, v, b, a.s_len, a.hkv, D, KEYS))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<D, NWG>();
  // the shared-memory attribute is set once per device for this instance
  // (a bit per device), not on every launch
  static std::atomic<uint64_t> smem_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(smem_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(attn_kernel<D, NWG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set.fetch_or(bit, std::memory_order_release);
  }
  const int q_tiles = (a.t_len + a.q_per_tile - 1) / a.q_per_tile;
  const dim3 grid(q_tiles * a.h_tiles, a.hkv, b);
  attn_kernel<D, NWG><<<grid, NWG * 128 + 32, smem, stream>>>(tm_k, tm_v, a);
  return cudaGetLastError();
}

}  // namespace hop
}  // namespace

// q: (B, T, Hq, D); k, v: (B, S, Hkv, D); all contiguous, one dtype
// (td::F32 or td::BF16), D in {64, 128}. Query i sits at position
// q_start + i and attends the keys j (at position k_start + j) at or before
// it, of its own segment when cu (n_seq + 1 int32 boundaries in device
// memory) is not null. q_start / k_start are read from device memory (one
// int32 each) when their pointers are not null, else the values passed.
// Exactly one output form: o (B, T, Hq, D) of the dtype, normalized; or
// acc (B, T, Hq, D), m, l (B, T, Hq) f32, unnormalized. The bf16 kernel's
// packing (flash_attention.py's flash_plan): rows a block (64 or 128),
// queries a tile, heads of the group a tile, tiles across the group; the
// f32 body ignores it. Returns a cudaError_t.
extern "C" int td_flash_attn(const void* q, const void* k, const void* v,
                             void* o, void* acc, void* m_out, void* l_out,
                             int b, int t_len, int s_len, int hq, int hkv,
                             int d, const void* q_start_ptr, int q_start,
                             const void* k_start_ptr, int k_start,
                             const void* cu, int n_seq, float scale,
                             int dtype, int rows, int q_per_tile,
                             int h_per_tile, int h_tiles, void* stream) {
  if (b <= 0 || t_len <= 0 || s_len <= 0 || hkv <= 0 || hq % hkv != 0 ||
      (o == nullptr) == (acc == nullptr) ||
      (acc != nullptr && (m_out == nullptr || l_out == nullptr)) ||
      (cu != nullptr && n_seq <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == td::BF16) {
    // the plan must cover every (query, head) pair of a kv head's group
    const int g = hq / hkv;
    if ((rows != 64 && rows != 128) || q_per_tile <= 0 || h_per_tile <= 0 ||
        h_tiles <= 0 || q_per_tile * h_per_tile > rows ||
        h_per_tile * h_tiles < g || (h_per_tile < g && q_per_tile != 1) ||
        (h_per_tile > g))
      return static_cast<int>(cudaErrorInvalidValue);
    const hop::Plan a{static_cast<const __nv_bfloat16*>(q),
                      static_cast<__nv_bfloat16*>(o),
                      static_cast<float*>(acc),
                      static_cast<float*>(m_out),
                      static_cast<float*>(l_out),
                      t_len, s_len, hq, hkv,
                      static_cast<const int*>(q_start_ptr), q_start,
                      static_cast<const int*>(k_start_ptr), k_start,
                      static_cast<const int*>(cu), n_seq, scale,
                      q_per_tile, h_per_tile, h_tiles};
#define TD_HOP(DIM, NWG)                                                     \
  if (d == DIM && rows == 64 * NWG)                                          \
    return static_cast<int>(hop::launch<DIM, NWG>(a, k, v, b, st));
    TD_HOP(64, 1)
    TD_HOP(64, 2)
    TD_HOP(128, 1)
    TD_HOP(128, 2)
#undef TD_HOP
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
#undef TD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
