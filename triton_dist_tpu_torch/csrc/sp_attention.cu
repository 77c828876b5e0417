// B21: fused causal GQA ring attention over sequence-sharded q / k / v,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/sp_ag_attention.py::_ring_attn_kernel of
// the JAX package (launched by _pallas_ring_attn_per_device, the PALLAS
// tier of sp_attention). Rank r holds q, k, v (B, T_loc, H, D) of global
// positions [r T_loc, (r + 1) T_loc) and returns its rows of causal GQA
// attention over the whole sequence, (B, T_loc, Hq, D).
//
// What it computes: the reference's XLA_BLOCK tier (its bit-exactness twin
// of the TPU kernel) up to rounding. Step s folds the shard of rank
// (me - s) mod n, its comm_blocks row blocks in ascending order; a block
// wholly after the tile's last query is skipped (its fold is the
// identity). The reference rescales once a comm block; the bf16 body
// folds 128-key steps with one rescale each (B1's online softmax), the
// f32 body one rescale a comm block, scoring each block's keys twice (its
// max, then its probabilities). Either way the sums run in another order
// than the reference's matmul, so the floats differ by rounding only.
//
// What bounds it on this card. Qwen3-32B at T = 32,768 over four cards
// (8,192 a rank, Hq 64, Hkv 8, D 128, bf16): the last rank folds ~7.7e12
// causal FLOP, ~7.8 ms at the 989 TFLOP/s bf16 peak; its 128 MB of q and
// 32 MB of k / v are far below that, so operations bound it.
//
// The transport (both bodies): NVSwitch joins the cards all to all, so
// each rank pushes its own k and v shard into slot `rank` of every peer's
// landing buffer (16-byte stores over NVLink) instead of forwarding a
// ring: comm block by comm block, every block of the grid a share of each;
// the last grid block to finish a comm block raises one epoch flag per
// (sender, comm block) on each peer. The fold waits only for the flags of
// blocks it folds. The transport does not depend on any fold, so the
// causal skip changes nothing a peer waits for; before its kernel ends a
// rank waits for every flag of the call all the same, so that its next
// call's pushes cannot overtake a peer still reading the slots. The
// landing slots are double-buffered by the epoch's parity and no barrier
// opens a call (as B17 and B20); flags carry the epoch, waits are bounded
// and trap. A persistent grid of occupancy x SMs (/ ranks sharing the
// card) walks the work items, the query tiles with the most live keys
// first; every block of every rank is resident at once, so the pushes of
// every rank run while the folds wait.
//
// bf16 (the PALLAS tier's path): B1's Hopper tiles (flash_prefill.cu's
// namespace hop) on attn_tile_sm90.cuh, in a persistent kernel of its own.
//  * A work item is a tile of 128 GQA-packed rows of one kv head and batch
//    row (sp_ag_attention.py's ring_plan, as B1's flash_plan: 16 queries
//    x 8 heads at Qwen3-32B), so each K/V tile is read once for all g
//    heads.
//  * One producer warpgroup, one thread of which keeps 2 stages of 128-key
//    K and V tiles in flight by TMA; its three other warps push the
//    block's share of the shard while the consumers fold (over NVLink
//    with a card a rank, within the card's memory in a one-card world:
//    one transport for both). Where a step's keys come from: the
//    local k / v for s = 0, else landing slot par + src, each through a
//    5-D map (d, h, block row, block, slab), so rows past a comm block's
//    end arrive as zeros and a step never reads the next block's rows,
//    landed or not. Before the first TMA of a landed block the producer
//    waits for its flag (acquire at system scope), then fences the
//    generic proxy, which peers' stores wrote through, against the async
//    proxy TMA reads by.
//  * Two consumer warpgroups run QK^T on wgmma m64n128k16 (Q and K from
//    shared memory) and P.V on m64n64k16 (P in registers, V transposed),
//    the online softmax in registers with one rescale a 128-key step and
//    B1's numerics (a finite NEG_INF for m, l summed from the f32
//    probabilities before P is rounded to bf16, the division by
//    max(l, 1e-30)); masks only on a step that crosses the causal
//    diagonal or a comm block's end (a short last step of a block whose
//    rows are no multiple of 128). A value row that is not live is a
//    zero row or a landed row, never garbage: a landing slot not yet
//    landed, or the first call's uninitialized memory, may hold NaN, and
//    0 x NaN would poison O.
//  * 384 threads, registers split by setmaxnreg: the producer warpgroup
//    40 a thread, the consumers 232 (at 288 threads, B1's block, an SM
//    sub-partition holding three warps caps every thread at 168, and this
//    kernel's longer loop state spilled).
//  * Its own kernel, not B1's through a shared header: B1's key step,
//    called from a header shared by both, cost B1's fold and varlen forms
//    3.8% / 4.1% on an H100 (168 registers and a spill where B1 had
//    none).
//  * No printf and no wait that calls one: a function call in a wgmma
//    kernel makes ptxas serialize every wgmma.
//
// f32 (the gates that need f32 exactness: 1e-4 against the plain
// version): the FMA body, a work item (batch, q head, 64-query tile), the
// rows padded to D+1 floats in shared memory.

#include <string.h>

#include "attn_tile_sm90.cuh"
#include "td_common.cuh"
#include "td_dist.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;

constexpr int kMaxBlocks = 64;   // comm blocks a call at most

// Pointers and shapes every body takes.
template <typename T>
struct Shards {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  Team team;
  u64* ctl;
  long land_v;     // byte offset of the V landing slots (K's are at 0)
  long flag_off;   // byte offset of the flags (world, nblk) u64
  int b_len, t_loc, hq, hkv, nblk;
  float scale;
};

// 1. push: comm block by comm block, this grid block's share of every
//    batch row's block rows of k and v into slot `me` (parity par) of
//    every peer; the last grid block done with a comm block raises its
//    flag on each peer. Called by the nth threads tid = 0 .. nth - 1 of
//    the block that push, sync() a barrier of exactly them.
template <typename T, int D, class Sync>
__device__ __forceinline__ void push_shard(const Shards<T>& a, u64 e,
                                           long par, int tid, int nth,
                                           Sync&& sync) {
  constexpr int VEC = td::kVec<T>;
  const Team& t = a.team;
  const int me = t.rank, world = t.world;
  const int tl = a.t_loc, nblk = a.nblk, bb = tl / nblk;
  const long row_el = static_cast<long>(a.hkv) * D;   // a k / v token row
  const long shard_el = static_cast<long>(a.b_len) * tl * row_el;
  const long seg_v = static_cast<long>(bb) * row_el / VEC;  // vectors
  const long total = a.b_len * seg_v;
  const long lo = total * blockIdx.x / gridDim.x;
  const long hi = total * (blockIdx.x + 1) / gridDim.x;
  for (int blk = 0; blk < nblk; ++blk) {
    for (int i = 1; i < world; ++i) {
      const int p = (me + i) % world;
      T* lk = reinterpret_cast<T*>(t.peer(p)) + (par + me) * shard_el;
      T* lv = reinterpret_cast<T*>(t.peer(p) + a.land_v) +
              (par + me) * shard_el;
      for (long x = lo + tid; x < hi; x += nth) {
        const long bi = x / seg_v, xi = x % seg_v;
        const long off = (bi * tl + static_cast<long>(blk) * bb) * row_el +
                         xi * VEC;
        *reinterpret_cast<uint4*>(lk + off) =
            *reinterpret_cast<const uint4*>(a.k + off);
        *reinterpret_cast<uint4*>(lv + off) =
            *reinterpret_cast<const uint4*>(a.v + off);
      }
    }
    __threadfence_system();
    sync();
    if (tid == 0 && world > 1 &&
        atomicAdd(a.ctl + td::dist::kCtlHeader + blk, 1ull) ==
            gridDim.x - 1) {
      a.ctl[td::dist::kCtlHeader + blk] = 0;
      __threadfence_system();
      for (int i = 1; i < world; ++i) {
        const int p = (me + i) % world;
        td::dist::notify(reinterpret_cast<u64*>(t.peer(p) + a.flag_off) +
                             static_cast<long>(me) * nblk + blk,
                         e);
      }
    }
  }
}

// -- f32: the FMA body --------------------------------------------------------

constexpr int BQ = 64;   // queries a work item
constexpr int BK = 64;   // keys a step
constexpr int NT = 256;  // 16 row groups x 16 column groups

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 4 * BQ);
}

// One key tile's scores against the query tile: sc[i][j] for rows
// rg + 16i, keys cg + 16j, from the f32 tiles in shared memory.
template <int D>
__device__ __forceinline__ void tile_scores(const float* qs, const float* ks,
                                            int rg, int cg, float sc[4][4]) {
  constexpr int LD = D + 1;
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
}

template <int D>
__global__ void __launch_bounds__(NT) ring_attn_kernel(
    const Shards<float> a) {
  using T = float;
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int CPT = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;            // [BQ][LD] query tile, pre-scaled
  float* ks = qs + BQ * LD;    // [BK][LD] key tile
  float* vs = ks + BK * LD;    // [BK][LD] value tile
  float* ps = vs + BK * LD;    // [BQ][LP] scores, then probabilities
  float* m_s = ps + BQ * LP;   // [BQ] running max
  float* l_s = m_s + BQ;       // [BQ] running sum
  float* a_s = l_s + BQ;       // [BQ] the block's rescale factor
  float* mb_s = a_s + BQ;      // [BQ] the block's row max

  const Team& t = a.team;
  const int me = t.rank, world = t.world, tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int tl = a.t_loc, nblk = a.nblk, bb = tl / nblk;
  const long row_el = static_cast<long>(a.hkv) * D;   // a k / v token row
  const long shard_el = static_cast<long>(a.b_len) * tl * row_el;
  const u64 e = td::dist::begin_call(a.ctl);
  const long par = static_cast<long>(e & 1) * world;

  push_shard<T, D>(a, e, par, tid, NT, [] { __syncthreads(); });
  const u64* flags = reinterpret_cast<const u64*>(t.peer(me) + a.flag_off);

  // 2. fold: persistent walk over (batch, q head, query tile) items, the
  //    last tiles (the most keys) first
  const int ntile = (tl + BQ - 1) / BQ;
  const int bh = a.b_len * a.hq;
  const int g = a.hq / a.hkv;
  const long q_row = static_cast<long>(a.hq) * D;
  for (int item = blockIdx.x; item < bh * ntile; item += gridDim.x) {
    const int q0 = (ntile - 1 - item / bh) * BQ;
    const int b = (item % bh) / a.hq, h = item % a.hq, hk = h / g;
    const T* qp = a.q + (static_cast<long>(b) * tl * a.hq + h) * D;
    __syncthreads();  // the previous item's readers are done
    td::load_rows<T, D, NT, 4>(qp + q0 * q_row, q_row, BQ, tl - q0, qs, LD);
    for (int r = tid; r < BQ; r += NT) {
      m_s[r] = td::NEG_INF;
      l_s[r] = 0.f;
    }
    __syncthreads();
    for (int x = tid; x < BQ * D; x += NT)
      qs[(x / D) * LD + x % D] *= a.scale;
    float acc[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
    const int q_first = me * tl + q0;                    // global positions
    const int q_hi = me * tl + min(q0 + BQ, tl) - 1;     // tile's last query

    for (int s = 0; s < world; ++s) {
      const int src = (me - s + world) % world;
      const T* kp;
      const T* vp;
      if (s == 0) {
        kp = a.k;
        vp = a.v;
      } else {
        kp = reinterpret_cast<const T*>(t.peer(me)) + (par + src) * shard_el;
        vp = reinterpret_cast<const T*>(t.peer(me) + a.land_v) +
             (par + src) * shard_el;
      }
      kp += static_cast<long>(b) * tl * row_el + hk * D;
      vp += static_cast<long>(b) * tl * row_el + hk * D;
      for (int blk = 0; blk < nblk; ++blk) {
        const int first = src * tl + blk * bb;   // the block's first key
        if (first > q_hi) continue;              // wholly in the future
        if (s > 0) {
          if (tid == 0)
            td::dist::wait(flags + static_cast<long>(src) * nblk + blk, e,
                           "B21 ring attention block", src);
          __syncthreads();
        }
        // live key tiles of the block: [blk*bb, k_end) of the shard
        const int k_end = min(blk * bb + bb, q_hi - src * tl + 1);
        for (int pass = 0; pass < 2; ++pass) {
          for (int r = tid; r < BQ; r += NT) mb_s[r] = td::NEG_INF;
          for (int k0 = blk * bb; k0 < k_end; k0 += BK) {
            const int nk = min(BK, blk * bb + bb - k0);
            __syncthreads();  // the previous tile's readers are done
            if (s == 0) {
              td::load_rows<T, D, NT, 4>(kp + k0 * row_el, row_el, BK, nk, ks,
                                         LD);
              if (pass == 1)
                td::load_rows<T, D, NT, 4>(vp + k0 * row_el, row_el, BK, nk,
                                           vs, LD);
            } else {
              td::load_rows<T, D, NT, 4, true>(kp + k0 * row_el, row_el, BK,
                                               nk, ks, LD);
              if (pass == 1)
                td::load_rows<T, D, NT, 4, true>(vp + k0 * row_el, row_el, BK,
                                                 nk, vs, LD);
            }
            __syncthreads();
            float sc[4][4];
            tile_scores<D>(qs, ks, rg, cg, sc);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int r = rg + 16 * i, c = cg + 16 * j;
                const bool valid =
                    c < nk && src * tl + k0 + c <= q_first + r;
                ps[r * LP + c] = valid ? sc[i][j] : td::NEG_INF;
              }
            __syncthreads();
            // rows: warp w owns 8 rows, each lane two keys
            const int warp = tid >> 5, lane = tid & 31;
            for (int rr = 0; rr < BQ / (NT / 32); ++rr) {
              const int r = warp * (BQ / (NT / 32)) + rr;
              const float s0 = ps[r * LP + lane];
              const float s1 = ps[r * LP + lane + 32];
              if (pass == 0) {
                const float mx = td::warp_max(fmaxf(s0, s1));
                if (lane == 0) mb_s[r] = fmaxf(mb_s[r], mx);
              } else {
                const int kq = q_first + r - src * tl - k0;  // last live key
                const float p0 = lane < nk && lane <= kq
                                     ? expf(s0 - m_s[r]) : 0.f;
                const float p1 = lane + 32 < nk && lane + 32 <= kq
                                     ? expf(s1 - m_s[r]) : 0.f;
                const float sum = td::warp_sum(p0 + p1);
                ps[r * LP + lane] = p0;
                ps[r * LP + lane + 32] = p1;
                if (lane == 0) l_s[r] += sum;
              }
            }
            if (pass == 1) {
              __syncthreads();
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
                  for (int j = 0; j < CPT; ++j)
                    acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
              }
            }
          }
          if (pass == 0) {
            // the block's one rescale
            __syncthreads();
            for (int r = tid; r < BQ; r += NT) {
              const float m_new = fmaxf(m_s[r], mb_s[r]);
              const float alpha = expf(m_s[r] - m_new);
              a_s[r] = alpha;
              l_s[r] *= alpha;
              m_s[r] = m_new;
            }
            __syncthreads();
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float al = a_s[rg + 16 * i];
#pragma unroll
              for (int j = 0; j < CPT; ++j) acc[i][j] *= al;
            }
          }
        }
      }
    }
    __syncthreads();
    T* op = a.o + (static_cast<long>(b) * tl * a.hq + h) * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
      if (q0 + r >= tl) continue;
      const float den = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        op[(q0 + r) * q_row + cg + 16 * j] = td::from_f<T>(acc[i][j] / den);
    }
  }

  // 3. every flag of the call, folded or not, before the kernel ends
  if (blockIdx.x == 0 && tid == 0)
    for (int s = 0; s < world; ++s)
      if (s != me)
        for (int blk = 0; blk < nblk; ++blk)
          td::dist::wait(flags + static_cast<long>(s) * nblk + blk, e,
                         "B21 ring attention block (drain)", s);
  td::dist::end_call(a.ctl, e);
}

// Occupancy (blocks per SM) and SMs of the current device, queried once a
// device and instantiation (never under a CUDA-graph capture: the first
// call comes before any); the query also loads the kernel and sets its
// shared-memory limit. The kernels of both head dims have one type, so
// the cache is a template of D as well: one per kernel.
struct Occupancy {
  int occ, sms;
};

template <int D, class K>
cudaError_t occupancy(K kernel, int threads, size_t smem, Occupancy* out) {
  static Occupancy cache[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev].sms == 0) {
    Occupancy o{};
    err = cudaDeviceGetAttribute(&o.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.occ, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    cache[dev] = o;
  }
  *out = cache[dev];
  return cudaSuccess;
}

template <int D>
cudaError_t launch_f32(const Shards<float>& a, int ranks_per_device,
                       cudaStream_t st) {
  Occupancy o{};
  cudaError_t err = occupancy<D>(ring_attn_kernel<D>, NT, smem_bytes<D>(), &o);
  if (err != cudaSuccess) return err;
  const long items = static_cast<long>(a.b_len) * a.hq *
                     ((a.t_loc + BQ - 1) / BQ);
  long grid = static_cast<long>(o.occ) * o.sms / ranks_per_device;
  if (grid > items) grid = items;
  if (grid < 1) return cudaErrorInvalidConfiguration;
  ring_attn_kernel<D><<<static_cast<unsigned>(grid), NT, smem_bytes<D>(),
                        st>>>(a);
  return cudaGetLastError();
}

// -- bf16: the Hopper body ----------------------------------------------------

namespace hop {

namespace s9 = td::sm90;
using bf16 = __nv_bfloat16;

constexpr int NWG = 2;                 // consumer warpgroups: 128 rows
constexpr int M = NWG * 64;            // packed rows of a tile
constexpr int NTH = (NWG + 1) * 128;   // and one producer warpgroup
constexpr int KEYS = 128;              // keys a step (one n128 QK^T)
constexpr int KSLAB = KEYS * 64;       // elements of a K or V slab
constexpr int ST = 2;                  // K/V stages in flight
constexpr int PRODUCER_REGS = 40;      // setmaxnreg: 40 + 2 x 232 a
constexpr int CONSUMER_REGS = 232;     // warp of each SM sub-partition
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t smem_bytes() {
  // 1 KB of slack to align the slabs to 1024 bytes, Q, the K and V ring,
  // three barriers a stage
  return 1024 + sizeof(bf16) * (size_t)(D / 64) * (M * 64 + 2 * ST * KSLAB) +
         3 * ST * sizeof(uint64_t);
}

// The ring in dynamic shared memory: Q [NH][M][64], K and V [ST][NH][KEYS]
// [64], each slab 1024-byte aligned in attn_tile_sm90.cuh's 128-byte
// swizzle; full_k / full_v complete on a stage's TMA bytes, empty on
// every consumer thread's arrival.
template <int D>
struct Ring {
  static constexpr int NH = D / 64;   // 64-column slabs of a row
  static constexpr uint32_t TILE_BYTES = NH * KSLAB * sizeof(bf16);
  bf16* qs;
  bf16* ks;
  bf16* vs;
  uint64_t* full_k;
  uint64_t* full_v;
  uint64_t* empty;

  __device__ __forceinline__ explicit Ring(uint8_t* smem_raw) {
    qs = reinterpret_cast<bf16*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    ks = qs + NH * M * 64;
    vs = ks + ST * NH * KSLAB;
    full_k = reinterpret_cast<uint64_t*>(vs + ST * NH * KSLAB);
    full_v = full_k + ST;
    empty = full_v + ST;
  }

  // thread 0 initializes the barriers; a block barrier follows
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < ST; ++s) {
      s9::mbar_init(full_k + s, 1);
      s9::mbar_init(full_v + s, 1);
      s9::mbar_init(empty + s, NWG * 128);
    }
    s9::mbar_init_fence();
  }
};

// A work item: a tile of M GQA-packed rows (ring_plan, as B1's
// flash_plan): row R is query q0 + R / hpt and head h0 + R % hpt of kv
// head hk's group, batch row b; rows past the tile's pairs, past T_loc or
// past the group are zeros and never stored.
struct Tile {
  int q0, h0, hk, b;
};

struct Pack {
  int q_per_tile, h_per_tile, h_tiles;
};

// Work item i (heaviest first: the last query tiles, whose rows see the
// most keys, then the others in descending order): per = B x Hkv x
// h_tiles items a query tile; qt = q_tiles - 1 - i / per; within it the
// head tile fastest, then the kv head, then the batch row.
__device__ __forceinline__ Tile item_tile(const Shards<bf16>& a,
                                          const Pack& p, int item,
                                          int q_tiles) {
  const int per = a.b_len * a.hkv * p.h_tiles;
  const int r = item % per;
  return Tile{(q_tiles - 1 - item / per) * p.q_per_tile,
              (r % p.h_tiles) * p.h_per_tile, (r / p.h_tiles) % a.hkv,
              r / (p.h_tiles * a.hkv)};
}

__device__ __forceinline__ bool tile_row(const Shards<bf16>& a,
                                         const Pack& p, const Tile& t,
                                         int r, int& qi, int& h) {
  qi = t.q0 + r / p.h_per_tile;
  h = t.h0 + r % p.h_per_tile;
  return r < p.q_per_tile * p.h_per_tile && qi < a.t_loc &&
         h < a.hq / a.hkv;
}

// (b, q, head) of a tile's row: its offset in rows of D
__device__ __forceinline__ long row_off(const Shards<bf16>& a, const Tile& t,
                                        int qi, int h) {
  return ((long)t.b * a.t_loc + qi) * a.hq + t.hk * (a.hq / a.hkv) + h;
}

// Every live key step of a tile whose last query sits at global position
// q_hi, in the reference's order: step s folds src = (me - s) mod n, its
// comm blocks ascending, a block from its first row in 128-key steps up to
// its end or the causal limit; blocks wholly after q_hi are skipped.
// f(s, src, blk, k0 (shard row), blk_end (shard row)).
template <class F>
__device__ __forceinline__ void for_each_step(int me, int world, int tl,
                                              int nblk, int q_hi, F&& f) {
  const int bb = tl / nblk;
  for (int s = 0; s < world; ++s) {
    const int src = (me - s + world) % world;
    for (int blk = 0; blk < nblk; ++blk) {
      if (src * tl + blk * bb > q_hi) break;   // this and later blocks
      const int blk_end = blk * bb + bb;
      const int k_end = min(blk_end, q_hi - src * tl + 1);
      for (int k0 = blk * bb; k0 < k_end; k0 += KEYS)
        f(s, src, blk, k0, blk_end);
    }
  }
}

// A flag's bounded wait, one thread, no printf (see the note above).
__device__ __forceinline__ void wait_flag(const u64* flag, u64 e) {
  long long polls = 0;
  while (td::dist::ld_acquire(flag) < e) {
    if (++polls > td::dist::kMaxPolls) __trap();
    __nanosleep(128);
  }
}

// tm_k / tm_v: the local shards, slabs = B; tm_lk / tm_lv: the landing
// slots, slabs = 2 x world x B (slot par + src, batch row b at slab
// (par + src) B + b). Both as (d, h, block row, block, slab).
template <int D>
__global__ void __launch_bounds__(NTH, 1)
    ring_kernel(const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_lk,
                const __grid_constant__ CUtensorMap tm_lv,
                const Shards<bf16> a, const Pack p) {
  constexpr int NH = D / 64;
  extern __shared__ uint8_t smem_raw[];
  const Ring<D> ring(smem_raw);
  const Team& t = a.team;
  const int me = t.rank, world = t.world;
  const int tl = a.t_loc, nblk = a.nblk, bb = tl / nblk;
  const u64 e = td::dist::begin_call(a.ctl);
  const long par = static_cast<long>(e & 1) * world;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();
  const u64* flags = reinterpret_cast<const u64*>(t.peer(me) + a.flag_off);

  const int q_tiles = (tl + p.q_per_tile - 1) / p.q_per_tile;
  const int items = q_tiles * p.h_tiles * a.hkv * a.b_len;
  const int warp = threadIdx.x >> 5;
  if (warp >= NWG * 4) {
    // producer warpgroup: warps 1-3 push this block's share of the shard
    // while the fold runs (the fold waits on no push of its own block:
    // a block's pushes depend on nothing), one thread of warp 0 issues
    // every item's key steps through the ring, slab by slab
    s9::regs_dec<PRODUCER_REGS>();
    if (warp > NWG * 4) {
      push_shard<bf16, D>(a, e, par, threadIdx.x - (NWG * 128 + 32), 96,
                          [] { s9::named_sync(3, 96); });
    } else if (threadIdx.x == NWG * 128) {
      const CUtensorMap* const own[2] = {&tm_k, &tm_v};
      const CUtensorMap* const landed[2] = {&tm_lk, &tm_lv};
      int i = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const Tile tile = item_tile(a, p, item, q_tiles);
        const int q_hi = me * tl + min(tile.q0 + p.q_per_tile, tl) - 1;
        for_each_step(me, world, tl, nblk, q_hi,
                      [&](int s, int src, int blk, int k0, int) {
          if (s > 0 && k0 == blk * bb) {
            // the block landed: peers' generic stores, then TMA's reads
            wait_flag(flags + static_cast<long>(src) * nblk + blk, e);
            s9::fence_proxy_async_global();
          }
          const CUtensorMap* mk = s == 0 ? own[0] : landed[0];
          const CUtensorMap* mv = s == 0 ? own[1] : landed[1];
          const int slab = s == 0 ? tile.b
                                  : static_cast<int>((par + src) * a.b_len) +
                                        tile.b;
          const int st = i % ST;
          if (i >= ST) s9::mbar_wait(ring.empty + st, ((i / ST) & 1) ^ 1);
          ++i;
          s9::mbar_expect_tx(ring.full_k + st, ring.TILE_BYTES);
#pragma unroll
          for (int h = 0; h < NH; ++h)
            s9::tma_load_5d(ring.ks + (st * NH + h) * KSLAB, mk,
                            ring.full_k + st, 64 * h, tile.hk, k0 - blk * bb,
                            blk, slab);
          s9::mbar_expect_tx(ring.full_v + st, ring.TILE_BYTES);
#pragma unroll
          for (int h = 0; h < NH; ++h)
            s9::tma_load_5d(ring.vs + (st * NH + h) * KSLAB, mv,
                            ring.full_v + st, 64 * h, tile.hk, k0 - blk * bb,
                            blk, slab);
        });
      }
    }
  } else {
    // consumer warpgroup wg: packed rows [64 wg, 64 wg + 64) of each tile
    s9::regs_inc<CONSUMER_REGS>();
    const int wg = warp >> 2;
    const int tid = threadIdx.x & 127;
    const int lane = threadIdx.x & 31;
    const int col0 = 2 * (lane & 3);
    const int ra = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const uint32_t q_addr = s9::smem_addr(ring.qs) + wg * 64 * 128;
    const uint32_t k_addr = s9::smem_addr(ring.ks);
    const uint32_t v_addr = s9::smem_addr(ring.vs);
    const float sl2 = a.scale * LOG2E;
    int i = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Tile tile = item_tile(a, p, item, q_tiles);
      // Q: this warpgroup's 64 rows into the swizzled slabs, every load
      // issued before the first store, once the last item's readers of Q
      // are done
      constexpr int QV = 64 * D / 8 / 128;  // 16-byte chunks a thread moves
      uint4 qv[QV];
#pragma unroll
      for (int u = 0; u < QV; ++u) {
        const int idx = tid + 128 * u;
        int qi, h;
        qv[u] = make_uint4(0u, 0u, 0u, 0u);
        if (tile_row(a, p, tile, wg * 64 + idx / (D / 8), qi, h))
          qv[u] = __ldg(reinterpret_cast<const uint4*>(
                            a.q + row_off(a, tile, qi, h) * D) +
                        idx % (D / 8));
      }
      s9::named_sync(1 + wg, 128);
#pragma unroll
      for (int u = 0; u < QV; ++u) {
        const int idx = tid + 128 * u;
        const int r = wg * 64 + idx / (D / 8);
        const int c = idx % (D / 8);  // 16-byte chunk of the row
        *reinterpret_cast<uint4*>(ring.qs + (c >> 3) * M * 64 + r * 64 +
                                  (((c & 7) ^ (r & 7)) << 3)) = qv[u];
      }
      s9::fence_proxy_async();
      s9::named_sync(1 + wg, 128);

      // this thread's two rows: ra and ra + 8 of the warpgroup
      int qa, ha, qb, hb;
      const bool live_a = tile_row(a, p, tile, ra, qa, ha);
      const bool live_b = tile_row(a, p, tile, ra + 8, qb, hb);
      const int pos_a = me * tl + qa, pos_b = me * tl + qb;
      const int q_first = me * tl + tile.q0;
      const int q_hi = me * tl + min(tile.q0 + p.q_per_tile, tl) - 1;
      float m_a = td::NEG_INF, m_b = td::NEG_INF, l_a = 0.f, l_b = 0.f;
      float o[NH][32];
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int j = 0; j < 32; ++j) o[h][j] = 0.f;

      for_each_step(me, world, tl, nblk, q_hi,
                    [&](int, int src, int, int k0, int blk_end) {
        const int st = i % ST;
        const uint32_t ph = (i / ST) & 1;
        ++i;
        // S = Q K^T on the tensor cores
        float s[KEYS / 2];
        s9::mbar_wait(ring.full_k + st, ph);
        s9::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          s9::wgmma_ss(
              s,
              s9::desc_sw128(q_addr + (kk >> 2) * M * 128 + (kk & 3) * 32,
                             16, 1024),
              s9::desc_sw128(k_addr + (st * NH + (kk >> 2)) * KSLAB * 2 +
                                 (kk & 3) * 32,
                             16, 1024),
              kk > 0);
        s9::wgmma_commit();
        s9::wgmma_wait<0>();
        s9::fence_regs(s);

        // masks where the step crosses the causal diagonal or the comm
        // block's end (the keys past it arrived as zeros)
        const int kp0 = src * tl + k0;   // the step's first key position
        if (kp0 + KEYS - 1 > q_first || k0 + KEYS > blk_end) {
          const int hi_a = min(pos_a - kp0, blk_end - k0 - 1);
          const int hi_b = min(pos_b - kp0, blk_end - k0 - 1);
#pragma unroll
          for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
            for (int c2 = 0; c2 < 2; ++c2) {
              const int c = 8 * j + col0 + c2;
              if (c > hi_a) s[4 * j + c2] = -INFINITY;
              if (c > hi_b) s[4 * j + 2 + c2] = -INFINITY;
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
        // once the rows' maxima settle, alpha is 1 and the rescale is
        // skipped (multiplying by 1 changes nothing)
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
        uint32_t pa[KEYS / 16][4];  // P rounded to bf16, P.V's A fragments
        s9::p_fragments<KEYS>(s, pa);

        // O += P V on the tensor cores
        s9::mbar_wait(ring.full_v + st, ph);
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
        s9::mbar_arrive(ring.empty + st);
      });

      l_a = s9::quad_sum(l_a);
      l_b = s9::quad_sum(l_b);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (!(half == 0 ? live_a : live_b)) continue;
        const long row = half == 0 ? row_off(a, tile, qa, ha)
                                   : row_off(a, tile, qb, hb);
        const float den = fmaxf(half == 0 ? l_a : l_b, 1e-30f);
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
  __syncthreads();

  // 3. every flag of the call, folded or not, before the kernel ends
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int s = 0; s < world; ++s)
      if (s != me)
        for (int blk = 0; blk < nblk; ++blk)
          wait_flag(flags + static_cast<long>(s) * nblk + blk, e);
  td::dist::end_call(a.ctl, e);
}

// The landing slots' maps (K's at land, V's at land + land_v): slabs
// 2 x world x B.
inline bool land_maps(CUtensorMap* maps, const char* land, long land_v,
                      int b, int t_loc, int hkv, int d, int nblk,
                      int world) {
  const long slabs = 2L * world * b;
  const int bb = t_loc / nblk;
  return s9::block_rows_map(maps, land, slabs, nblk, bb, hkv, d, KEYS) &&
         s9::block_rows_map(maps + 1, land + land_v, slabs, nblk, bb, hkv,
                            d, KEYS);
}

// grid: ring_plan's; it must leave every block of every rank sharing the
// card resident (the folds spin on flags that other blocks raise).
template <int D>
cudaError_t launch(const Shards<bf16>& a, const Pack& p, int grid,
                   const CUtensorMap* land, int ranks_per_device,
                   cudaStream_t st) {
  const size_t smem = smem_bytes<D>();
  Occupancy o{};
  cudaError_t err = occupancy<D>(ring_kernel<D>, NTH, smem, &o);
  if (err != cudaSuccess) return err;
  if (grid < 1 || static_cast<long>(grid) * ranks_per_device >
                      static_cast<long>(o.occ) * o.sms)
    return cudaErrorInvalidConfiguration;
  CUtensorMap tm_k, tm_v;
  const int bb = a.t_loc / a.nblk;
  if (!s9::block_rows_map(&tm_k, a.k, a.b_len, a.nblk, bb, a.hkv, D, KEYS) ||
      !s9::block_rows_map(&tm_v, a.v, a.b_len, a.nblk, bb, a.hkv, D, KEYS))
    return cudaErrorInvalidValue;
  ring_kernel<D><<<static_cast<unsigned>(grid), NTH, smem, st>>>(
      tm_k, tm_v, land[0], land[1], a, p);
  return cudaGetLastError();
}

}  // namespace hop
}  // namespace

// The two tensor maps of B21's bf16 landing slots (K's, then V's) into
// `out` (2 x 128 bytes, host memory, 64-byte aligned): the launcher
// encodes them once a workspace, outside any capture. land: this rank's
// landing buffer (K slots (2, world, B, T_loc, Hkv, D) at byte 0, V's at
// land_v). Returns a cudaError_t.
extern "C" int td_ring_attn_land_maps(void* out, const void* land,
                                      long long land_v, int b, int t_loc,
                                      int hkv, int d, int nblk, int world) {
  if (b <= 0 || t_loc <= 0 || hkv <= 0 || nblk <= 0 || t_loc % nblk != 0 ||
      (d != 64 && d != 128) || world < 1 ||
      reinterpret_cast<uintptr_t>(out) % 64 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return hop::land_maps(static_cast<CUtensorMap*>(out),
                        static_cast<const char*>(land),
                        static_cast<long>(land_v), b, t_loc, hkv, d, nblk,
                        world)
             ? 0
             : static_cast<int>(cudaErrorInvalidValue);
}

// B21. q, o: (B, T_loc, Hq, D); k, v: (B, T_loc, Hkv, D); contiguous, one
// dtype (td::F32 or td::BF16), D in {64, 128}; T_loc a multiple of nblk
// (the comm blocks, at most 64). base: device table of every rank's
// symmetric buffer: K landing slots (2, world, B, T_loc, Hkv, D) at byte 0,
// V's at land_v, flags (world, nblk) u64 at flag_off (zeroed once); ctl:
// this rank's control block (4 + nblk u64, zeroed once); ranks_per_device:
// ranks sharing this card. bf16 only: the packing (q_per_tile, h_per_tile,
// h_tiles) and grid of ring_plan, and land_maps (td_ring_attn_land_maps'
// two maps, host memory); f32 sizes its own grid. Returns a cudaError_t.
extern "C" int td_ring_attn(const void* q, const void* k, const void* v,
                            void* o, int b, int t_loc, int hq, int hkv, int d,
                            int nblk, int rank, int world, const void* base,
                            void* ctl, long long land_v, long long flag_off,
                            float scale, int ranks_per_device, int dtype,
                            int q_per_tile, int h_per_tile, int h_tiles,
                            int grid, const void* land_maps, void* stream) {
  if (b <= 0 || t_loc <= 0 || hkv <= 0 || hq % hkv != 0 || nblk <= 0 ||
      nblk > kMaxBlocks || t_loc % nblk != 0 || world < 1 ||
      world > td::dist::kMaxWorld || rank < 0 || rank >= world ||
      ranks_per_device < 1 || (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == td::BF16) {
    const int g = hq / hkv;
    // the packing must cover every (query, head) pair of a group
    if (q_per_tile <= 0 || h_per_tile <= 0 || h_tiles <= 0 ||
        q_per_tile * h_per_tile > hop::NWG * 64 ||
        h_per_tile * h_tiles < g || (h_per_tile < g && q_per_tile != 1) ||
        h_per_tile > g || land_maps == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap land[2];
    memcpy(land, land_maps, sizeof(land));
    using bf = __nv_bfloat16;
    const Shards<bf> a{static_cast<const bf*>(q), static_cast<const bf*>(k),
                       static_cast<const bf*>(v), static_cast<bf*>(o),
                       team, static_cast<u64*>(ctl),
                       static_cast<long>(land_v),
                       static_cast<long>(flag_off),
                       b, t_loc, hq, hkv, nblk, scale};
    const hop::Pack p{q_per_tile, h_per_tile, h_tiles};
    return static_cast<int>(
        d == 64 ? hop::launch<64>(a, p, grid, land, ranks_per_device, st)
                : hop::launch<128>(a, p, grid, land, ranks_per_device, st));
  }
  if (dtype != td::F32) return static_cast<int>(cudaErrorInvalidValue);
  const Shards<float> a{static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v),
                        static_cast<float*>(o),
                        team,
                        static_cast<u64*>(ctl),
                        static_cast<long>(land_v),
                        static_cast<long>(flag_off),
                        b, t_loc, hq, hkv, nblk, scale};
  return static_cast<int>(d == 64 ? launch_f32<64>(a, ranks_per_device, st)
                                  : launch_f32<128>(a, ranks_per_device, st));
}
