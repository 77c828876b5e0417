// Device code of the port's one-hop collectives on an NVSwitch full mesh
// (B9 and B7 in ring_collectives.cu, B5 and B6 in allreduce.cu; the LL
// lines and flags also carry B17 / B18 in ep_a2a.cu and the landing of
// B13b and B4 across ranks in gemm_land_stream.cuh): a block's column
// slice, 16-byte adds in a dtype, the two signalling protocols (LL lines
// that carry the epoch, or flags raised after one fence a publishing
// thread), the bounded waits that trap, a block's epoch word and the
// residency check of a spinning grid.
//
// Slots (kernels/reduce_scatter.py::ring_layout): a rank receives n - 1
// slots of slot_bytes from every call, double-buffered by the epoch's
// parity (slot j of parity P at byte (P (n - 1) + j) slot_bytes of the
// region). Rank r stores its rows for rank p into p's slot (r - p - 1) mod
// n, so slot s of rank p holds rank p + 1 + s's rows. Block b owns the
// 16-byte column vectors [b kv / G, (b + 1) kv / G) of every row and
// exchanges data and signals only with block b of its peers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdio.h>

#include "td_common.cuh"
#include "td_dist.cuh"

namespace td {
namespace oneshot {

using td::dist::Team;
using td::dist::u64;

constexpr int NT = 256;                        // threads a block
constexpr int kPeers = td::dist::kMaxWorld - 1;

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

// a + b elementwise, each sum rounded to T
template <typename T>
__device__ __forceinline__ uint4 add_vec(const uint4& a, const uint4& b) {
  constexpr int VEC = td::kVec<T>;
  float fa[VEC], fb[VEC];
  td::unpack(a, fa, static_cast<const T*>(nullptr));
  td::unpack(b, fb, static_cast<const T*>(nullptr));
#pragma unroll
  for (int i = 0; i < VEC; ++i) fa[i] = fa[i] + fb[i];
  return pack(fa, static_cast<const T*>(nullptr));
}

// This block's columns: vectors [c0, c0 + cw) of every row of kv vectors.
struct Cols {
  int c0, cw;
  __device__ Cols(int kv) {
    c0 = static_cast<int>(static_cast<long>(blockIdx.x) * kv / gridDim.x);
    cw = static_cast<int>(static_cast<long>(blockIdx.x + 1) * kv /
                          gridDim.x) - c0;
  }
  // index of item i of a chunk whose first row is r0
  __device__ __forceinline__ long at(long i, long r0, int kv) const {
    return (r0 + i / cw) * kv + c0 + i % cw;
  }
};

__device__ __forceinline__ uint4* buf(const Team& t, int p, long off) {
  return reinterpret_cast<uint4*>(t.peer(p) + off);
}
__device__ __forceinline__ u64* flags(const Team& t, int p, long off) {
  return reinterpret_cast<u64*>(t.peer(p) + off);
}

// -- signalling -------------------------------------------------------------

constexpr long long kSpinPolls = 1 << 12;     // polls before any sleep
constexpr long long kPollLimit = 1LL << 25;   // then >= 2 s of 64 ns sleeps

__device__ __noinline__ void lost(const char* what, int from,
                                  unsigned long long have,
                                  unsigned long long want) {
  printf("td_dist: lost signal: %s from rank %d (flag %llu, want %llu)\n",
         what, from, have, want);
  __trap();
}

// one poll done: spin tightly first, then back off; bounded
__device__ __forceinline__ void backoff(long long& polls, const char* what,
                                        int from, unsigned long long have,
                                        unsigned long long want) {
  if (++polls > kSpinPolls) {
    if (polls > kPollLimit) lost(what, from, have, want);
    __nanosleep(64);
  }
}

// Wait (one thread) until *flag >= e.
__device__ __forceinline__ void await_flag(const u64* flag, u64 e,
                                           const char* what, int from) {
  long long polls = 0;
  u64 v;
  while ((v = td::dist::ld_acquire(flag)) < e) backoff(polls, what, from, v, e);
}

// LL lines: {lo, f, hi, f}, written and read whole (volatile: relaxed at
// system scope); each 8-byte half holds a data word and the epoch.
__device__ __forceinline__ void st_line(uint4* p, unsigned lo, unsigned hi,
                                        unsigned f) {
  asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(lo), "r"(f), "r"(hi), "r"(f) : "memory");
}
__device__ __forceinline__ uint4 ld_line(const uint4* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p) : "memory");
  return v;
}

// One 16-byte vector as the two LL lines at `lines`, tagged f.
__device__ __forceinline__ void send_ll(uint4* lines, const uint4& v,
                                        unsigned f) {
  st_line(lines, v.x, v.y, f);
  st_line(lines + 1, v.z, v.w, f);
}

// The 16-byte vector of the two LL lines at `lines` once both carry f.
__device__ __forceinline__ uint4 recv_ll(const uint4* lines, unsigned f,
                                         const char* what, int from) {
  long long polls = 0;
  for (;;) {
    const uint4 a = ld_line(lines), b = ld_line(lines + 1);
    if (a.y == f && a.w == f && b.y == f && b.w == f)
      return make_uint4(a.x, a.z, b.x, b.z);
    backoff(polls, what, from, a.y, f);
  }
}

// Flags protocol, after this block's stores: threads 0..n-2 each raise
// the flag (b, slot) of the peer they stored into (the peer at distance
// t + 1 takes slot n - 2 - t) after a system fence, then wait for this
// rank's flag (b, t); the block goes on when all n - 1 are up.
__device__ __forceinline__ void exchange_flags(const Team& team,
                                               long flag_off, u64 e,
                                               const char* what) {
  const int me = team.rank, n = team.world, t = threadIdx.x;
  const long row = static_cast<long>(blockIdx.x) * (n - 1);
  __syncthreads();
  if (t < n - 1) {
    __threadfence_system();
    td::dist::notify(flags(team, (me + 1 + t) % n, flag_off) + row + n - 2 - t,
                     e);
    await_flag(flags(team, me, flag_off) + row + t, e, what, (me + 1 + t) % n);
  }
  __syncthreads();
}

// This block's epoch: its own word of the control block.
struct Epoch {
  u64* word;
  u64 e;
  __device__ explicit Epoch(u64* ctl)
      : word(ctl + td::dist::kCtlHeader + blockIdx.x), e(__ldcg(word) + 1) {}
  __device__ void close() const {
    __syncthreads();
    if (threadIdx.x == 0) *word = e;
  }
};

// One 16-byte vector into item v of a peer's slot at `slot`: plain, or as
// two LL lines tagged f.
template <bool LL>
__device__ __forceinline__ void put_vec(char* slot, long v, const uint4& val,
                                        unsigned f) {
  uint4* dst = reinterpret_cast<uint4*>(slot);
  if (LL)
    send_ll(dst + 2 * v, val, f);
  else
    dst[v] = val;
}

// Item v of this rank's slot at `slot`, which rank `from` stores: waits
// for its LL lines, or reads it after the flags.
template <bool LL>
__device__ __forceinline__ uint4 get_vec(const char* slot, long v, unsigned f,
                                         const char* what, int from) {
  const uint4* src = reinterpret_cast<const uint4*>(slot);
  return LL ? recv_ll(src + 2 * v, f, what, from) : __ldcg(src + v);
}

// -- the two legs ------------------------------------------------------------

// Scatter leg (B9, B6's two-shot regime): this block's columns of row
// chunk p (m rows at row p m of x) into owner p's slot for this rank, for
// every peer p; `land` is the byte offset of this call's parity in the
// slot region. A thread loads an item's n - 1 chunks before it stores any,
// so their latencies overlap.
template <bool LL>
__device__ __forceinline__ void scatter_chunks(const uint4* __restrict__ x,
                                               const Team& team,
                                               const Cols& cols, int m,
                                               int kv, long land,
                                               long slot_bytes, unsigned f) {
  const int me = team.rank, n = team.world;
  const long items = static_cast<long>(m) * cols.cw;
  for (long j = threadIdx.x; j < items; j += NT) {
    const long v = cols.at(j, 0, kv);
    uint4 val[kPeers];
#pragma unroll
    for (int i = 0; i < kPeers; ++i)
      if (i < n - 1)
        val[i] = x[cols.at(j, static_cast<long>((me + 1 + i) % n) * m, kv)];
#pragma unroll
    for (int i = 0; i < kPeers; ++i)
      if (i < n - 1)
        put_vec<LL>(team.peer((me + 1 + i) % n) + land +
                        (n - 2 - i) * slot_bytes, v, val[i], f);
  }
}

// Gather leg (B7, B6's two-shot regime): slot s of this rank (at byte
// `land`, rank me + 1 + s's m rows) copied into rows (me + 1 + s) m of out,
// this block's columns, as its LL lines land or once the flags are up.
// Under flags a thread loads kBatch items before it stores any, so their
// latencies overlap; under LL (a few items a block: the plan keeps LL
// blocks small) one at a time measured faster on the card.
constexpr int kBatch = 4;

template <bool LL>
__device__ __forceinline__ void gather_slots(uint4* __restrict__ out,
                                             const Team& team,
                                             const Cols& cols, int m, int kv,
                                             long land, long slot_bytes,
                                             unsigned f, const char* what) {
  const int me = team.rank, n = team.world;
  const long items = static_cast<long>(m) * cols.cw;
  constexpr int kB = LL ? 1 : kBatch;
  uint4 val[kBatch];
  for (int s = 0; s < n - 1; ++s) {
    const int from = (me + 1 + s) % n;
    const char* slot = team.peer(me) + land + s * slot_bytes;
    for (long j0 = threadIdx.x; j0 < items; j0 += kB * NT) {
#pragma unroll
      for (int u = 0; u < kB; ++u)
        if (j0 + u * NT < items)
          val[u] = get_vec<LL>(slot, cols.at(j0 + u * NT, 0, kv), f, what,
                               from);
#pragma unroll
      for (int u = 0; u < kB; ++u)
        if (j0 + u * NT < items)
          out[cols.at(j0 + u * NT, static_cast<long>(from) * m, kv)] = val[u];
    }
  }
}

// -- host --------------------------------------------------------------------

// Checks that `grid` blocks of kernel fn fit on the card at once with the
// other ranks that share it (queried once per kernel: never under a CUDA
// graph capture, callers warm up first; the query also loads the kernel
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

}  // namespace oneshot
}  // namespace td
