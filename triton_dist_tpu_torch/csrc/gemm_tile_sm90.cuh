// The port's tile GEMM for Hopper (sm_90a), first used by B10 and B11 at
// prefill (ag_gemm.cu): out = cast(A @ W), A (M, K) bf16 row-major read by
// TMA through a 2-D map, W (K, N) bf16 row-major, f32 accumulation on the
// tensor cores, one cast. B12, B13a, B13b and B4 at prefill shapes may take
// it later (ROADMAP).
//
// What bounds it on this card. At prefill M is thousands of rows: the
// product does ~M / 2 operations a weight byte, far above the ~295 at which
// the tensor cores, and not HBM, become the limit (QKV of Qwen3-32B at TP=4,
// 8,192 gathered rows: 215 GFLOP, 0.217 ms at 989 TFLOP/s). So the tensor
// cores have to be kept busy: wgmma, not mma.sync or FMAs, and every
// operand in shared memory before the instruction that reads it.
//
// Design (the shape of CUTLASS's warp-specialised persistent kernels, on
// attn_tile_sm90.cuh's TMA maps, mbarrier ring and wgmma descriptors):
//  * output tiles of BM x BN = 128 x 256; K in steps of BK = 64 (one
//    128-byte swizzled row of A, one 64-row box of W);
//  * one block an SM, in clusters of two: the two blocks of a cluster
//    take two row tiles of one column tile at a time, and each W stage is
//    loaded once for both by TMA multicast (each block issues two of its
//    four boxes into both blocks' shared memory). A 128 x 256 tile reads
//    48 KB a 64-deep step for 4.2 MFLOP: without the multicast the
//    card's L2 cannot feed its tensor cores (gate/up of 8,192 rows on one
//    rank: 1.74 ms, against 1.58 with it and cuBLAS's 1.38); with it a
//    block reads 32 KB a step;
//  * persistent: cluster c takes pair tiles c, c + G / 2, ... of an order
//    the source gives (Src::row_tile: block r of the cluster takes row
//    position 2 q + r of the pair's q; an odd last position leaves the
//    second block a pair without rows, which loads W for its partner and
//    stores nothing): row pairs in groups of GM / 2, and inside a group
//    the column tiles in groups of GN, each column group swept by every
//    row pair of the group before the next, so a strip of W stays in L2
//    while the row tiles read it;
//  * one producer thread keeps STAGES stages of A (128 x 64, one box) and
//    W (64 x 256, four 64-column boxes) in flight by TMA in the 128-byte
//    swizzle, through a ring of full / empty mbarriers (a stage's empty
//    barrier counts the consumer warps of both blocks: its W lands in
//    both); before a tile's first A load it asks the source whether the
//    rows are there and from which of three maps (Src::a_tile: ag_gemm.cu
//    reads the own shard's rows straight from the caller's tensor, and
//    the others from the landing buffer once it acquired their flags and
//    fenced the async proxy);
//  * two consumer warpgroups, 64 rows each, issue wgmma m64n256k16 with A
//    K-major from shared memory and W as the transposed (MN-major) B
//    operand (bf16 allows it): four 64-column slabs of the stage, slab
//    stride (LBO) one box, 8-row groups (SBO) 1,024 bytes apart; one
//    product in flight while the next stage's is issued; the whole K of a
//    tile in one accumulator and one cast in the epilogue, so a tile's
//    bits depend on nothing but its inputs;
//  * setmaxnreg: 88 registers for the producer warpgroup (its side work
//    keeps eight 16-byte vectors a thread in flight), 208 for the
//    consumers; the producer warpgroup's three other warps run the
//    source's side work (Src::side: ag_gemm.cu's push of the own shard),
//    which takes no consumer's issue slot.
#pragma once

#include <atomic>

#include "attn_tile_sm90.cuh"

// Internal linkage, as gemm_stream_sm90.cuh: each library keeps its own
// kernels and shared-memory flags. Its maps come from
// gemm_stream_sm90.cuh's rows_map (boxes of 64 columns x BK rows for W,
// x BM rows for A).
namespace {
namespace td_tile {

namespace s9 = td::sm90;
using bf16 = __nv_bfloat16;

constexpr int BM = 128;           // rows a tile (two warpgroups of 64)
constexpr int BN = 256;           // columns a tile: one n256 product
constexpr int BK = 64;            // K a stage: one 128-byte swizzled row
constexpr int WBOX = 64;          // columns a W box
constexpr int NWB = BN / WBOX;    // W boxes a stage
constexpr int STAGES = 4;
constexpr int GM = 16;            // row tiles a group
constexpr int GN = 4;             // column tiles a column group
constexpr int NWG = 2;            // consumer warpgroups
constexpr int CLUSTER = 2;        // blocks a cluster: W multicast to both
constexpr int NTH = (NWG + 1) * 128;
constexpr int PRODUCER_REGS = 88;    // the side work's copies in flight
constexpr int CONSUMER_REGS = 208;   // 2 x 208 + 88 = the 504 of 3 x 168
constexpr uint32_t A_BYTES = BM * BK * sizeof(bf16);      // 16 KB
constexpr uint32_t WBOX_BYTES = BK * WBOX * sizeof(bf16);  // 8 KB
constexpr uint32_t W_BYTES = NWB * WBOX_BYTES;             // 32 KB
constexpr uint32_t STAGE_BYTES = A_BYTES + W_BYTES;
// alignment slack, the stages, the full and empty barriers
constexpr size_t SMEM_BYTES =
    1024 + size_t(STAGES) * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
static_assert(SMEM_BYTES <= 232448, "over a block's shared memory");

// The launch's shape and cut; ag_gemm.py's ag_plan computes the same.
struct Plan {
  int m, k, n;
  int row_tiles;    // ceil(M / BM)
  int row_pairs;    // ceil(row_tiles / CLUSTER)
  int col_tiles;    // ceil(N / BN)
  int n_kt;         // ceil(K / BK)
  int tiles;        // pair tiles: row_pairs x col_tiles
};

// The i-th pair tile of the order: row pair q (row positions 2 q and 2 q
// + 1 of the source's order) and column tile ct. Groups of GM / CLUSTER
// row pairs; in a group, column groups of GN column tiles, each swept pair
// by pair.
__device__ __forceinline__ void tile_at(const Plan& p, int i, int& q,
                                        int& ct) {
  constexpr int GP = GM / CLUSTER;
  const int per_group = GP * p.col_tiles;
  const int g = i / per_group;
  const int rows_g = min(GP, p.row_pairs - g * GP);
  int j = i - g * per_group;
  const int cg = j / (rows_g * GN);
  const int cw = min(GN, p.col_tiles - cg * GN);
  j -= cg * rows_g * GN;
  q = g * GP + j / cw;
  ct = cg * GN + j % cw;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of both blocks: what either wrote to the other's shared
// memory (barrier inits, arrivals, multicast) ordered around it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// One arrival on the mbarrier at bar's offset in block `cta` of the
// cluster, with the default (CTA-scope) release: the arriving warp's reads
// of the stage are complete (wgmma_wait), so no ordering wider than its
// own block is needed; a cluster-scope release made the kernel 1.4x
// slower on one rank and 1.9x in the one-card world (PERF.md §6, PR 21).
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(s9::smem_addr(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// A 2-D box into dst (and the same offset) of every block in `mask`,
// completing on the mbarrier at bar's offset in each of them.
__device__ __forceinline__ void tma_load_2d_mc(void* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int c0, int c1,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(
          s9::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(s9::smem_addr(bar)), "r"(c0),
      "r"(c1), "h"(mask)
      : "memory");
}

// D (64 x 256 f32) (+)= A (64 x 16, K-major in shared memory) x B (16 x
// 256, MN-major in shared memory, read transposed); accumulate = 0
// overwrites D.
__device__ __forceinline__ void wgmma_n256_tb(float (&d)[128], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
      "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
      "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
      "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
      "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
      "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
      "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The source's interface (ag_gemm.cu's GatherTiles):
//   begin()                      every thread, before the first barrier;
//   side(tid, nth)               the producer warpgroup's warps 1-3;
//   row_tile(q)                  the row tile at position q of the order;
//   a_tile(r0, r1, row, maps)    the producer thread, before a tile's
//                                first A load of rows [r0, r1): the map
//                                (one of the kernel's three) and the row
//                                of r0 in it, once the rows are there;
//   staged(p, r0, ct, kt, a, t)  each consumer thread t of a warpgroup
//                                once its stage landed: a is the
//                                warpgroup's 64 rows from row r0.
template <typename Src>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NTH, 1)
    tile_kernel(const __grid_constant__ CUtensorMap tm_w,
                const __grid_constant__ CUtensorMap tm_a0,
                const __grid_constant__ CUtensorMap tm_a1,
                const __grid_constant__ CUtensorMap tm_a2, const Src src_in,
                bf16* __restrict__ out, const Plan p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // stage st: A at st * STAGE_BYTES, its W boxes after it
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(base + STAGES * STAGE_BYTES);
  uint64_t* const empty = full + STAGES;
  Src src = src_in;
  src.begin();
  const uint32_t crank = cluster_rank();
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      s9::mbar_init(full + st, 1);
      // a consumer warp of either block, once it read the stage
      s9::mbar_init(empty + st, CLUSTER * NWG * 4);
    }
    s9::mbar_init_fence();
  }
  __syncthreads();
  cluster_sync();   // the partner's barriers exist before any multicast

  const int warp = threadIdx.x >> 5;
  const int cid = blockIdx.x / CLUSTER, ncl = gridDim.x / CLUSTER;
  if (warp >= NWG * 4) {
    s9::regs_dec<PRODUCER_REGS>();
    if (warp > NWG * 4) {
      src.side(threadIdx.x - (NWG * 128 + 32), 96);
    } else if (threadIdx.x == NWG * 128) {
      const CUtensorMap* const maps[3] = {&tm_a0, &tm_a1, &tm_a2};
      int it = 0;
      for (int i = cid; i < p.tiles; i += ncl) {
        int q, ct, row = 0;
        tile_at(p, i, q, ct);
        const int pos = CLUSTER * q + static_cast<int>(crank);
        const CUtensorMap* ma = nullptr;
        if (pos < p.row_tiles) {
          const int rt = src.row_tile(pos);
          ma = src.a_tile(rt * BM, min(p.m, rt * BM + BM), row, maps);
        }
        for (int kt = 0; kt < p.n_kt; ++kt, ++it) {
          const int st = it % STAGES;
          if (it >= STAGES) s9::mbar_wait(empty + st, ((it / STAGES) & 1) ^ 1);
          uint8_t* const sa = base + st * STAGE_BYTES;
          s9::mbar_expect_tx(full + st, ma ? STAGE_BYTES : W_BYTES);
          if (ma) s9::tma_load_2d(sa, ma, full + st, kt * BK, row);
#pragma unroll
          for (int x = crank * (NWB / CLUSTER);
               x < (crank + 1) * (NWB / CLUSTER); ++x)
            tma_load_2d_mc(sa + A_BYTES + x * WBOX_BYTES, &tm_w, full + st,
                           ct * BN + x * WBOX, kt * BK,
                           (1u << CLUSTER) - 1);
        }
      }
    }
  } else {
    // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of each tile
    s9::regs_inc<CONSUMER_REGS>();
    const int wg = warp >> 2, tid = threadIdx.x & 127, lane = threadIdx.x & 31;
    const uint32_t sbase = s9::smem_addr(base);
    // this warp's arrival on a stage's empty barrier in both blocks
    const auto release = [&](int st) {
      if (lane == 0)
        for (uint32_t c = 0; c < CLUSTER; ++c) mbar_arrive_at(empty + st, c);
    };
    int it = 0;
    for (int i = cid; i < p.tiles; i += ncl) {
      int q, ct;
      tile_at(p, i, q, ct);
      const int pos = CLUSTER * q + static_cast<int>(crank);
      const bool live = pos < p.row_tiles;
      const int rt = live ? src.row_tile(pos) : 0;
      float acc[128];
      for (int kt = 0; kt < p.n_kt; ++kt, ++it) {
        const int st = it % STAGES;
        s9::mbar_wait(full + st, (it / STAGES) & 1);
        const uint32_t sa = sbase + st * STAGE_BYTES;
        if (live)
          src.staged(p, rt * BM + wg * 64, ct, kt,
                     reinterpret_cast<const bf16*>(base + st * STAGE_BYTES +
                                                   wg * 64 * 128),
                     tid);
        s9::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_n256_tb(acc, s9::desc_sw128(sa + wg * 64 * 128 + kk * 32, 16,
                                            1024),
                        s9::desc_sw128(sa + A_BYTES + kk * 16 * 128,
                                       WBOX_BYTES, 1024),
                        kt > 0 || kk > 0);
        s9::wgmma_commit();
        s9::wgmma_wait<1>();
        fence_acc(acc);
        if (kt > 0) release((it - 1) % STAGES);
      }
      s9::wgmma_wait<0>();
      fence_acc(acc);
      release((it - 1) % STAGES);
      if (!live) continue;

      // epilogue: rows r and r + 8 of the warp's 16, columns 8 j + 2 (l % 4)
      const int r = rt * BM + wg * 64 + (warp & 3) * 16 + (lane >> 2);
      const int c0 = ct * BN + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = c0 + 8 * j;
        if (col >= p.n) continue;
        if (r < p.m)
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<long long>(r) * p.n + col) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        if (r + 8 < p.m)
          *reinterpret_cast<__nv_bfloat162*>(
              out + static_cast<long long>(r + 8) * p.n + col) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
  // no block leaves while its partner may still arrive on its barriers
  cluster_sync();
}

// The plan of M x K x N (the launcher's ag_plan gives the grid).
inline Plan plan_of(int m, int k, int n) {
  Plan p;
  p.m = m;
  p.k = k;
  p.n = n;
  p.row_tiles = (m + BM - 1) / BM;
  p.row_pairs = (p.row_tiles + CLUSTER - 1) / CLUSTER;
  p.col_tiles = (n + BN - 1) / BN;
  p.n_kt = (k + BK - 1) / BK;
  p.tiles = p.row_pairs * p.col_tiles;
  return p;
}

// Sets the kernel's shared-memory attribute once per device and returns
// the clusters the card holds at once (for the launcher's residency
// check).
template <typename Src>
cudaError_t prepare(int dev, int* clusters) {
  // clusters resident on a card at once, asked once per device (0: not
  // yet; the attribute is set before the question)
  static std::atomic<int> seen[64];
  int c = dev < 64 ? seen[dev].load(std::memory_order_acquire) : 0;
  if (c == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CLUSTER);
    cfg.blockDim = dim3(NTH);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    err = cudaOccupancyMaxActiveClusters(&c, tile_kernel<Src>, &cfg);
    if (err != cudaSuccess) return err;
    if (dev < 64) seen[dev].store(c, std::memory_order_release);
  }
  *clusters = c;
  return cudaSuccess;
}

// One launch on `grid` blocks: W's map (boxes of 64 columns x BK rows),
// A's three maps (boxes of 64 x BM; the source picks one a tile).
template <typename Src>
cudaError_t launch(const CUtensorMap& w, const CUtensorMap (&a)[3],
                   const Src& src, bf16* out, const Plan& p, int grid,
                   cudaStream_t st) {
  tile_kernel<Src><<<grid, NTH, SMEM_BYTES, st>>>(w, a[0], a[1], a[2], src,
                                                  out, p);
  return cudaGetLastError();
}

}  // namespace td_tile
}  // namespace
