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
// of the TPU kernel). Step s folds the shard of rank (me - s) mod n, its
// comm_blocks row blocks in ascending order, each block with ONE online-
// softmax rescale: m' = max(m, max of the block's masked scores), acc and l
// rescaled by e^(m - m'), then the block's e^(s - m') summed into l and
// multiplied into acc, with q pre-scaled by D^-1/2 in f32 and P.V in f32.
// A block wholly after this rank's last query is skipped: its fold is the
// identity. Within a block this kernel scores the keys twice (the block's
// row max first, then the probabilities), because a block of thousands of
// keys does not fit in shared memory; the sums over a block's keys run in
// another order than the reference's matmul, so the floats differ from
// XLA_BLOCK's by rounding only.
//
// What bounds it on this card. Qwen3-32B at T = 32,768 over four cards
// (8,192 a rank, Hq 64, Hkv 8, D 128, bf16): the last rank folds ~7.7e12
// causal FLOP, ~8 ms at the 989 TFLOP/s bf16 peak; its 128 MB of q and
// 32 MB of k / v are far below that, so operations bound it. This kernel
// computes with FP32 FMAs out of shared memory, no tensor cores, and
// scores each key twice, so it runs far above that bound; wgmma tiles and
// TMA are the later step.
//
// Design:
//  * transport: NVSwitch joins the cards all to all, so each rank pushes
//    its own k and v shard into slot `rank` of every peer's landing buffer
//    (16-byte stores over NVLink) instead of forwarding a ring: comm block
//    by comm block, every block of the grid a share of each; the last grid
//    block to finish a comm block raises one epoch flag per (sender, comm
//    block) on each peer. The fold waits only for the flags of blocks it
//    folds. The transport does not depend on any fold, so the causal skip
//    changes nothing a peer waits for; before its kernel ends a rank
//    waits for every flag of the call all the same, so that its next
//    call's pushes cannot overtake a peer still reading the slots;
//  * the landing slots are double-buffered by the epoch's parity and no
//    barrier opens a call (as B17 and B20); flags carry the epoch, waits
//    are bounded and trap naming the flag;
//  * the TPU's design point keeps q and the whole (m, l, acc) state in VMEM
//    with T_loc up to ~2k. Here q is tiled: a work item is (batch, q head,
//    64-query tile), its (m, l) in shared memory and acc in registers, so
//    T_loc = 8,192 at 64 heads runs. A persistent grid of occupancy x SMs
//    (/ ranks sharing the card) walks the items, the tiles with the most
//    work first; every block of every rank is resident at once, so the
//    pushes of every rank run while the folds wait;
//  * the tile machinery is B1's (csrc/flash_prefill.cu): 16-byte staged
//    loads, a 4 x (D/16) register tile a thread, rows padded to D+1
//    floats; landed rows are read through L2 only.

#include "td_common.cuh"
#include "td_dist.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;

constexpr int BQ = 64;   // queries a work item
constexpr int BK = 64;   // keys a step
constexpr int NT = 256;  // 16 row groups x 16 column groups
constexpr int kMaxBlocks = 64;   // comm blocks a call at most

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 4 * BQ);
}

template <typename T>
struct Args {
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

template <typename T, int D>
__global__ void __launch_bounds__(NT) ring_attn_kernel(const Args<T> a) {
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int CPT = D / 16;
  constexpr int VEC = td::kVec<T>;
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

  // 1. push: comm block by comm block, this grid block's share of every
  //    batch row's block rows of k and v into slot `me` of every peer
  {
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
        for (long x = lo + tid; x < hi; x += NT) {
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
      __syncthreads();
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

// Occupancy (blocks per SM) of one instantiation and the card's SMs,
// queried once (the first call; never under a CUDA-graph capture). The
// query also loads the kernel.
template <typename T, int D>
cudaError_t launch_info(int* occ, int* sms) {
  static int occ_c = 0, sms_c = 0;
  if (occ_c == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms_c, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ring_attn_kernel<T, D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem_bytes<D>()));
    int q = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &q, ring_attn_kernel<T, D>, NT, smem_bytes<D>());
    if (err != cudaSuccess) return err;
    occ_c = q;
  }
  *occ = occ_c;
  *sms = sms_c;
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch(const Args<T>& a, int ranks_per_device, cudaStream_t st) {
  int occ = 0, sms = 0;
  cudaError_t err = launch_info<T, D>(&occ, &sms);
  if (err != cudaSuccess) return err;
  const long items = static_cast<long>(a.b_len) * a.hq *
                     ((a.t_loc + BQ - 1) / BQ);
  long grid = static_cast<long>(occ) * sms / ranks_per_device;
  if (grid > items) grid = items;
  if (grid < 1) return cudaErrorInvalidConfiguration;
  ring_attn_kernel<T, D><<<static_cast<unsigned>(grid), NT, smem_bytes<D>(),
                           st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// B21. q, o: (B, T_loc, Hq, D); k, v: (B, T_loc, Hkv, D); contiguous, one
// dtype (td::F32 or td::BF16), D in {64, 128}; T_loc a multiple of nblk
// (the comm blocks, at most 64). base: device table of every rank's
// symmetric buffer: K landing slots (2, world, B, T_loc, Hkv, D) at byte 0,
// V's at land_v, flags (world, nblk) u64 at flag_off (zeroed once); ctl:
// this rank's control block (4 + nblk u64, zeroed once); ranks_per_device:
// ranks sharing this card. Returns a cudaError_t.
extern "C" int td_ring_attn(const void* q, const void* k, const void* v,
                            void* o, int b, int t_loc, int hq, int hkv, int d,
                            int nblk, int rank, int world, const void* base,
                            void* ctl, long long land_v, long long flag_off,
                            float scale, int ranks_per_device, int dtype,
                            void* stream) {
  if (b <= 0 || t_loc <= 0 || hkv <= 0 || hq % hkv != 0 || nblk <= 0 ||
      nblk > kMaxBlocks || t_loc % nblk != 0 || world < 1 ||
      world > td::dist::kMaxWorld || rank < 0 || rank >= world ||
      ranks_per_device < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TD_CASE(CODE, TYPE, DIM)                                             \
  if (dtype == CODE && d == DIM) {                                           \
    const Args<TYPE> a{static_cast<const TYPE*>(q),                          \
                       static_cast<const TYPE*>(k),                          \
                       static_cast<const TYPE*>(v),                          \
                       static_cast<TYPE*>(o),                                \
                       team,                                                 \
                       static_cast<u64*>(ctl),                               \
                       static_cast<long>(land_v),                            \
                       static_cast<long>(flag_off),                          \
                       b, t_loc, hq, hkv, nblk, scale};                      \
    return static_cast<int>(launch<TYPE, DIM>(a, ranks_per_device, st));     \
  }
  TD_CASE(td::F32, float, 64)
  TD_CASE(td::F32, float, 128)
  TD_CASE(td::BF16, __nv_bfloat16, 64)
  TD_CASE(td::BF16, __nv_bfloat16, 128)
#undef TD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
