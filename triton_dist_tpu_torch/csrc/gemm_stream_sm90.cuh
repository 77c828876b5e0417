// The bf16 decode GEMM of B4's world-1 body (gemm_ar.cu) and B12
// (matmul.cu), hand-written for Hopper (sm_90a): out = cast(A @ W), A
// (M, K), W (K, N), f32 accumulation of the exact bf16 products, one cast.
// The f32 forms keep the FMA body of gemm_splitk.cuh.
//
// What bounds it on this card. On the decode path M is the batch (4 on
// the static Engine, 8 on the ContinuousEngine): the product does about M
// operations a byte of weights against the ~295 at which the tensor cores,
// and not the memory, become the limit. So bytes bound it: Qwen3-8B's o
// (K = N = 4096, 33.5 MB) at 10.0 us, down (K = 12288, N = 4096, 100.7
// MB) at 30.0 us at 3.35 TB/s. Every SM has to keep tens of KB of weight
// loads in flight, all the time, and spend few issue slots on the math.
//
// Design:
//  * swapped operands: out^T = W^T A^T on mma.sync m16n8k16. Sixteen
//    columns of W are the MMA's 16 rows (ldmatrix.trans from the W tile),
//    the batch rows its n side: MG = 8 rows (one n8 tile) up to M = 8, 16
//    (two) above; larger M runs M groups of 16 rows, each group a pass
//    over W (the later passes read it through L2). Nothing is padded to
//    64 rows, and the tensor cores take the FMAs' issue slots off the SM;
//  * W in tiles of 128 columns x 128 K rows (32 KB: two TMA boxes of 64
//    columns side by side, so each K row is read as 256 contiguous
//    bytes; a 2-D map in the 128-byte swizzle, encoded once per (W, K, N)
//    and cached), through a ring of STAGES tiles that one producer warp
//    keeps full: 160 KB of weights in flight on every SM. The producer
//    copies A's MG rows of the same 128 K rows into the stage beside the
//    tile (cp.async, or 2-byte loads where K or A's address does not keep
//    rows 16-byte aligned), after the tile's TMA is issued: no block
//    waits for A before its first weight load;
//  * a persistent grid of at most one block an SM. The units (M group,
//    column tile, 128-row K tile), in that order, are cut evenly over the
//    blocks (stream-K): block b takes units [b U / G, (b + 1) U / G). A
//    block walks its run as items (one column tile's run of K tiles), the
//    ring running on from one item into the next without draining; four
//    consumer warps own 32 columns of a tile each;
//  * the split-K fold in the same launch: an item that holds all of its
//    tile's K tiles is cast and stored by its warps; else each warp
//    stores its f32 partial into its block's slot of the workspace, a
//    ticket per (tile, warp) counts the arrivals (acq_rel), and the last
//    to arrive folds the slices in block order (K order: the same sum
//    whatever order they arrive in), casts, stores, and resets the
//    ticket to 0. One launch a call, the same bytes every call, and no
//    memset between calls (a captured graph replays it as it is).
//
// Workspace (the launcher's): f32 slots [2 G][4 warps][NS][MG / 8][32
// lanes] of float4: slot 2 b holds block b's first item, 2 b + 1 its last
// (only those two can share a tile with another block). Tickets: int
// [G][4], zero before the first call; the tile whose last K tile lies in
// block b (and not its first) counts at b's row, so no two tiles of a
// call share a ticket.
#pragma once

#include <atomic>
#include <mutex>
#include <unordered_map>

#include "attn_tile_sm90.cuh"
#include "td_common.cuh"

// Internal linkage: each source that includes this header (gemm_ar.cu,
// matmul.cu: two libraries in one process) keeps its own kernel, map cache
// and shared-memory flag. Static locals of an inline function with
// external linkage are one object across every loaded library (the
// dynamic linker unifies them), so the second library found the first
// one's flag set and launched without its shared-memory attribute.
namespace {
namespace td_stream {

namespace s9 = td::sm90;
using bf16 = __nv_bfloat16;

constexpr int BOX = 64;           // columns a TMA box: one 128-byte row
constexpr int NBX = 2;            // boxes side by side in a tile
constexpr int BN = NBX * BOX;     // columns of W a tile
constexpr int BK = 128;           // K rows a tile (the boxes' outer side)
constexpr int STAGES = 5;         // tiles in the ring
constexpr int NCW = 4;            // consumer warps
constexpr int NS = BN / 16 / NCW; // 16-column MMA rows a consumer warp owns
constexpr int NTH = (NCW + 1) * 32;
constexpr int A_LD = BK + 8;      // A's row stride in a stage (elements):
                                  // 8 rows on 8 distinct bank groups
constexpr uint32_t BOX_BYTES = BK * BOX * sizeof(bf16);
constexpr uint32_t W_BYTES = NBX * BOX_BYTES;

template <int MG>
constexpr size_t smem_bytes() {
  return 1024 + size_t(STAGES) * W_BYTES +
         size_t(STAGES) * MG * A_LD * sizeof(bf16) +
         2 * STAGES * sizeof(uint64_t);
}

// The launch's shape and cut; the launcher's stream_plan computes the same.
struct Plan {
  int m, k, n;
  int n_tiles;      // ceil(N / BN)
  int n_kt;         // ceil(K / BK)
  long long units;  // M groups x n_tiles x n_kt
  int grid;         // blocks, <= units
  int a_vec;        // A's rows 16-byte aligned: cp.async
};

// first unit of block b
__device__ __forceinline__ long long unit0(const Plan& p, int b) {
  return static_cast<long long>(b) * p.units / p.grid;
}

// the block whose run holds unit u
__device__ __forceinline__ int owner(const Plan& p, long long u) {
  return static_cast<int>(((u + 1) * p.grid - 1) / p.units);
}

// f(t, kt0, kt1) for each item of block b: tile t (M group t / n_tiles,
// column tile t % n_tiles), K tiles [kt0, kt1)
template <typename F>
__device__ __forceinline__ void for_items(const Plan& p, int b, F&& f) {
  const long long end = unit0(p, b + 1);
  for (long long u = unit0(p, b); u < end;) {
    const long long t = u / p.n_kt;
    const int kt0 = static_cast<int>(u - t * p.n_kt);
    const long long left = end - u;
    const int kt1 = left < p.n_kt - kt0 ? kt0 + static_cast<int>(left)
                                        : p.n_kt;
    f(t, kt0, kt1);
    u += kt1 - kt0;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   s9::smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// one arrival on bar once this thread's earlier cp.async copies landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   s9::smem_addr(bar))
               : "memory");
}

// A's rows [m0, m0 + MG) x K rows [k0, k0 + BK) into a stage (rows of
// A_LD elements), zeros outside A; by the producer warp's 32 lanes
template <int MG>
__device__ __forceinline__ void stage_a(const bf16* __restrict__ a,
                                        const Plan& p, bf16* dst, int m0,
                                        int k0, int lane) {
  if (p.a_vec) {
    constexpr int VPR = BK / 8;  // 16-byte vectors a row
#pragma unroll
    for (int v = lane; v < MG * VPR; v += 32) {
      const int r = v / VPR, c = v % VPR;
      const bool ok = m0 + r < p.m && k0 + 8 * c < p.k;  // K % 8 == 0
      const bf16* src =
          ok ? a + static_cast<long long>(m0 + r) * p.k + k0 + 8 * c : a;
      cp_async16(dst + r * A_LD + 8 * c, src, ok ? 16 : 0);
    }
  } else {
    for (int v = lane; v < MG * BK; v += 32) {
      const int r = v / BK, c = v % BK;
      dst[r * A_LD + c] =
          m0 + r < p.m && k0 + c < p.k
              ? a[static_cast<long long>(m0 + r) * p.k + k0 + c]
              : __float2bfloat16(0.f);
    }
  }
}

// A warp's (16 columns x MG rows) sums: lane l holds columns n0 and n0 + 8
// (n0 = its 16 + l / 4) of rows m0, m0 + 1 (m0 = 2 (l % 4)) of each n8
// tile j, as the MMA's accumulator fragment
template <int MG>
__device__ __forceinline__ void store_out(const Plan& p, bf16* out,
                                          const float (&acc)[MG / 8][4],
                                          int n0, int m0) {
#pragma unroll
  for (int j = 0; j < MG / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int n = n0 + 8 * (r >> 1), m = m0 + 8 * j + (r & 1);
      if (n < p.n && m < p.m)
        out[static_cast<long long>(m) * p.n + n] = __float2bfloat16(acc[j][r]);
    }
}

template <int MG>
__global__ void __launch_bounds__(NTH, 1)
    stream_kernel(const __grid_constant__ CUtensorMap tm_w,
                  const bf16* __restrict__ a, bf16* __restrict__ out,
                  float4* __restrict__ ws, int* __restrict__ tickets,
                  const Plan p) {
  extern __shared__ uint8_t smem_raw[];
  bf16* const wt = reinterpret_cast<bf16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* const at = wt + STAGES * BK * BN;   // [STAGES][MG][A_LD]
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(at + STAGES * MG * A_LD);
  uint64_t* const empty = full + STAGES;

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == NCW && lane == 0)  // the map's descriptor, ahead of its use
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&tm_w))
                 : "memory");
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      // the TMA's expect_tx arrival and one per producer lane (its A copy)
      s9::mbar_init(full + st, 1 + 32);
      s9::mbar_init(empty + st, NCW * 32);
    }
    s9::mbar_init_fence();
  }
  __syncthreads();

  if (warp == NCW) {
    // producer: each unit's W tile by TMA, then A's rows beside it
    int it = 0;
    for_items(p, b, [&](long long t, int kt0, int kt1) {
      const int mg = static_cast<int>(t / p.n_tiles);
      const int ct = static_cast<int>(t % p.n_tiles);
      for (int kt = kt0; kt < kt1; ++kt, ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) s9::mbar_wait(empty + st, ((it / STAGES) & 1) ^ 1);
        if (lane == 0) {
          s9::mbar_expect_tx(full + st, W_BYTES);
#pragma unroll
          for (int x = 0; x < NBX; ++x)
            s9::tma_load_2d(wt + (st * NBX + x) * BK * BOX, &tm_w, full + st,
                            ct * BN + x * BOX, kt * BK);
        }
        stage_a<MG>(a, p, at + st * MG * A_LD, mg * MG, kt * BK, lane);
        if (p.a_vec)
          cp_async_arrive(full + st);
        else
          s9::mbar_arrive(full + st);
      }
    });
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // consumer warp: the NS 16-column groups g = NS warp + s of each tile
  // (box g / 4, 16-byte chunks 2 (g % 4) and 2 (g % 4) + 1 of its rows)
  const uint32_t wt_base = s9::smem_addr(wt), at_base = s9::smem_addr(at);
  int it = 0;
  for_items(p, b, [&](long long t, int kt0, int kt1) {
    float acc[NS][MG / 8][4];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int j = 0; j < MG / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[s][j][r] = 0.f;
    for (int kt = kt0; kt < kt1; ++kt, ++it) {
      const int st = it % STAGES;
      s9::mbar_wait(full + st, (it / STAGES) & 1);
      const uint32_t wb = wt_base + st * W_BYTES;
      const uint32_t ab = at_base + st * MG * A_LD * sizeof(bf16);
#pragma unroll
      for (int k2 = 0; k2 < BK / 32; ++k2) {
        // A^T's fragments of two 16-deep steps: rows 8j + l % 8, K from
        // 32 k2 + 8 (l / 8)
        uint32_t bf[MG / 8][4];
#pragma unroll
        for (int j = 0; j < MG / 8; ++j)
          s9::ldsm_x4(bf[j], ab + ((8 * j + (lane & 7)) * A_LD + 32 * k2 +
                                   8 * (lane >> 3)) * sizeof(bf16));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // W^T's 16 x 16 fragment of group g: matrix q = l / 8 is K rows
          // 8 (q / 2) .. + 7 of chunk 2 (g % 4) + q % 2, transposed
          const int kr = 32 * k2 + 16 * h + (lane & 7) + 8 * (lane >> 4);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int g = NS * warp + s;
            const int ch = 2 * (g % 4) + ((lane >> 3) & 1);
            uint32_t wa[4];
            s9::ldsm_x4_t(wa, wb + (g / 4) * BOX_BYTES + kr * 128 +
                                  ((ch ^ (kr & 7)) << 4));
#pragma unroll
            for (int j = 0; j < MG / 8; ++j)
              s9::mma_m16n8k16(acc[s][j], wa, bf[j][2 * h],
                               bf[j][2 * h + 1]);
          }
        }
      }
      s9::mbar_arrive(empty + st);
    }

    // the item's sums: stored, or folded with the tile's other slices
    const long long t0 = t * p.n_kt;  // the tile's first unit
    const int b_first = owner(p, t0), b_last = owner(p, t0 + p.n_kt - 1);
    const int n0 = static_cast<int>(t % p.n_tiles) * BN + 16 * NS * warp +
                   (lane >> 2);
    const int m0 = static_cast<int>(t / p.n_tiles) * MG + 2 * (lane & 3);
    if (b_first == b_last) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
        store_out<MG>(p, out, acc[s], n0 + 16 * s, m0);
      return;
    }
    const auto slot = [&](int bb) {
      return ws + ((2 * bb + (t0 > unit0(p, bb) ? 1 : 0)) * NCW + warp) *
                      NS * (MG / 8) * 32 + lane;
    };
    float4* const mine = slot(b);
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int j = 0; j < MG / 8; ++j)
        mine[32 * (s * (MG / 8) + j)] = make_float4(
            acc[s][j][0], acc[s][j][1], acc[s][j][2], acc[s][j][3]);
    // the warp's stores, then one acq_rel arrival (release: the stores
    // before it; acquire: the other slices' stores, for the last)
    __syncwarp();
    int* const ticket = tickets + b_last * NCW + warp;
    int arrived = 0;
    if (lane == 0)
      asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                   : "=r"(arrived)
                   : "l"(ticket)
                   : "memory");
    arrived = __shfl_sync(0xffffffffu, arrived, 0);
    if (arrived != b_last - b_first) return;
    __syncwarp();
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int j = 0; j < MG / 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[s][j][r] = 0.f;
    for (int bb = b_first; bb <= b_last; ++bb) {
      const float4* src = slot(bb);
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int j = 0; j < MG / 8; ++j) {
          const float4 v = __ldcg(src + 32 * (s * (MG / 8) + j));
          acc[s][j][0] += v.x;
          acc[s][j][1] += v.y;
          acc[s][j][2] += v.z;
          acc[s][j][3] += v.w;
        }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) store_out<MG>(p, out, acc[s], n0 + 16 * s, m0);
    if (lane == 0) *ticket = 0;
  });
}

// The map of W (K, N) bf16, row-major: boxes of BN columns x BK rows in
// the 128-byte swizzle, made once per (W, K, N, device) and cached (a
// weight keeps its address; the map holds only address, shape and
// layout). False if the CUDA driver refuses it.
inline bool weight_map(CUtensorMap* map, const void* w, int k, int n,
                       int dev) {
  struct Key {
    const void* w;
    int k, n, dev;
    bool operator==(const Key& o) const {
      return w == o.w && k == o.k && n == o.n && dev == o.dev;
    }
  };
  struct Hash {
    size_t operator()(const Key& x) const {
      return std::hash<const void*>()(x.w) ^
             (static_cast<size_t>(x.k) * 0x9E3779B97F4A7C15ull) ^
             (static_cast<size_t>(x.n) << 20) ^ static_cast<size_t>(x.dev);
    }
  };
  static std::mutex mu;
  static std::unordered_map<Key, CUtensorMap, Hash> cache;
  const Key key{w, k, n, dev};
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return true;
  }
  const s9::EncodeTiledFn fn = s9::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)k};
  const cuuint64_t strides[1] = {(cuuint64_t)n * sizeof(bf16)};
  const cuuint32_t box[2] = {BOX, BK};
  const cuuint32_t elem[2] = {1, 1};
  if (fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(w),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

template <int MG>
cudaError_t launch(const CUtensorMap& map, const bf16* a, bf16* out,
                   float* ws, int* tickets, const Plan& p, int dev,
                   cudaStream_t st) {
  constexpr size_t smem = smem_bytes<MG>();
  // the shared-memory attribute is set once per device (a bit per device)
  static std::atomic<uint64_t> smem_set{0};
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(smem_set.load(std::memory_order_acquire) & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        stream_kernel<MG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set.fetch_or(bit, std::memory_order_release);
  }
  stream_kernel<MG><<<p.grid, NTH, smem, st>>>(
      map, a, out, reinterpret_cast<float4*>(ws), tickets, p);
  return cudaGetLastError();
}

}  // namespace td_stream

// out (M, N) = cast(a (M, K) @ w (K, N)), bf16, contiguous; w 16-byte
// aligned and N a multiple of 8 (the map's row stride, 16-byte units);
// any M and K. grid blocks (1 <= grid <= the plan's units); ws the f32
// workspace of 2 grid x BN x MG floats (MG = 8 up to M = 8, else 16);
// tickets 4 grid ints, zero before the first call and left zero. Returns
// a cudaError_t.
int td_gemm_stream(const void* a, const void* w, void* ws, int* tickets,
                   void* out, int m_rows, int k_dim, int n_cols, int grid,
                   void* stream) {
  using namespace td_stream;
  if (m_rows <= 0 || k_dim <= 0 || n_cols <= 0 || n_cols % 8 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || ws == nullptr ||
      tickets == nullptr || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mg = m_rows <= 8 ? 8 : 16;
  Plan p;
  p.m = m_rows;
  p.k = k_dim;
  p.n = n_cols;
  p.n_tiles = (n_cols + BN - 1) / BN;
  p.n_kt = (k_dim + BK - 1) / BK;
  p.units = static_cast<long long>((m_rows + mg - 1) / mg) * p.n_tiles *
            p.n_kt;
  p.grid = grid;
  p.a_vec = k_dim % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  if (grid > p.units) return static_cast<int>(cudaErrorInvalidConfiguration);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map;
  if (!weight_map(&map, w, k_dim, n_cols, dev))
    return static_cast<int>(cudaErrorNotSupported);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* ap = static_cast<const bf16*>(a);
  bf16* op = static_cast<bf16*>(out);
  float* wsp = static_cast<float*>(ws);
  err = mg == 8 ? td_stream::launch<8>(map, ap, op, wsp, tickets, p, dev, st)
                : td_stream::launch<16>(map, ap, op, wsp, tickets, p, dev, st);
  return static_cast<int>(err);
}

}  // namespace
