// Device side of the port's distributed language (the reference's
// language/__init__.py): rank, num_ranks, notify, wait, put and the
// barriers, over symmetric buffers whose base addresses every rank holds
// in a device table.
//
// A symmetric allocation is `bytes` of data followed, at byte offset
// `sig_off`, by a signal pad of 64-bit flags (kPadWords of them). A Team
// names the calling rank, the world and the table of every rank's base
// address. The same code serves n ranks on n cards (the table holds CUDA
// IPC mappings of the peers' allocations) and n logical ranks on one card
// (the table holds n separate allocations of that card).
//
// Flags carry a per-call epoch. Each op keeps a small local control block
// (ctl, 64-bit words): the epoch of its last finished call, and counters
// that name the last block of a grid. Every block reads the epoch at its
// start and uses e = epoch + 1 for this call; the last block to finish
// stores e. Flags are SET to e, and a wait is for a flag >= e, so a flag
// left from an earlier call never satisfies this call's wait, and the
// epoch advances on the device, under a CUDA graph replay too. Every rank
// makes the same sequence of calls on an op, so epochs agree.
//
// Memory order: data is published with __threadfence_system() by every
// writing thread, then a block barrier, then a release store (or release
// add) at system scope of the flag; a waiter reads the flag with an
// acquire load at system scope, then a block barrier, and reads the data
// with L1-bypassing loads (__ldcg). Every spin-wait is bounded: after
// kMaxPolls polls it prints which flag it waited on and traps, so a lost
// signal fails the launch instead of hanging it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace td {
namespace dist {

using u64 = unsigned long long;

constexpr int kMaxWorld = 8;
constexpr int kPadWords = 64;           // flags per signal pad
constexpr long kPadBytes = kPadWords * 8;
// signal pad layout (u64 words)
constexpr int kArrive = 0;              // [kArrive + s]: rank s began call e
constexpr int kData = kMaxWorld;        // [kData + s]: rank s's data landed
constexpr int kUser = 2 * kMaxWorld;    // free for ops with one flag
// control block layout (u64 words, local to a rank)
constexpr int kEpoch = 0;               // epoch of the last finished call
constexpr int kDone = 1;                // blocks finished in this call
constexpr int kPushed = 2;              // blocks (or tiles) whose puts are done
constexpr int kCtlHeader = 4;           // op-specific counters follow

constexpr long long kMaxPolls = 1LL << 25;   // >= 4 s of 128 ns sleeps

struct Team {
  int rank;                 // this rank
  int world;                // number of ranks
  const long long* base;    // device array: every rank's allocation base
  long long sig_off;        // byte offset of the signal pad

  __device__ __forceinline__ char* peer(int p) const {
    return reinterpret_cast<char*>(base[p]);
  }
  __device__ __forceinline__ u64* pad(int p) const {
    return reinterpret_cast<u64*>(base[p] + sig_off);
  }
};

__device__ __forceinline__ int rank(const Team& t) { return t.rank; }
__device__ __forceinline__ int num_ranks(const Team& t) { return t.world; }

__device__ __forceinline__ u64 ld_acquire(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void add_release(u64* p, u64 v) {
  asm volatile("red.release.sys.global.add.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// notify: raise a flag on any rank's pad (a release store of `value`, or a
// release add of it). Called by one thread.
__device__ __forceinline__ void notify(u64* flag, u64 value,
                                       bool add = false) {
  if (add)
    add_release(flag, value);
  else
    st_release(flag, value);
}

// wait: spin (acquire) until *flag >= target; bounded, then trap naming
// the flag. Called by one thread; the caller's block barrier follows.
__device__ __noinline__ void wait(const u64* flag, u64 target,
                                  const char* what, int from) {
  long long polls = 0;
  u64 v;
  while ((v = ld_acquire(flag)) < target) {
    if (++polls > kMaxPolls) {
      printf("td_dist: lost signal: %s from rank %d (flag %llu, want "
             ">= %llu)\n", what, from, v, target);
      __trap();
    }
    __nanosleep(128);
  }
}

// put: this block copies `bytes` from src to dst (any rank's memory) with
// 16-byte stores; both 16-byte aligned and bytes a multiple of 16.
__device__ __forceinline__ void put(void* dst, const void* src, long bytes) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* s = reinterpret_cast<const uint4*>(src);
  for (long i = threadIdx.x; i < bytes / 16; i += blockDim.x)
    d[i] = __ldcg(s + i);
}

// push_all: this block's share of `bytes` of src (the grid splits them in
// 16-byte units), stored at byte `off` of every rank's allocation, the
// next rank first and this rank's own last: the full-mesh gather leg of
// B8 and B10. Call from all threads of the block.
__device__ __forceinline__ void push_all(const Team& t, long off,
                                         const void* src, long bytes) {
  const long per = ((bytes / 16 + gridDim.x - 1) / gridDim.x) * 16;
  const long lo = per * blockIdx.x < bytes ? per * blockIdx.x : bytes;
  const long hi = lo + per < bytes ? lo + per : bytes;
  for (int i = 1; i <= t.world; ++i) {
    const int p = (t.rank + i) % t.world;
    put(t.peer(p) + off + lo, static_cast<const char*>(src) + lo, hi - lo);
  }
}

// The epoch of this call (every block of the grid reads the same one).
__device__ __forceinline__ u64 begin_call(const u64* ctl) {
  __shared__ u64 epoch;
  if (threadIdx.x == 0)
    epoch = *reinterpret_cast<const volatile u64*>(ctl + kEpoch) + 1;
  __syncthreads();
  return epoch;
}

// The last block of the grid to get here stores the epoch e.
__device__ __forceinline__ void end_call(u64* ctl, u64 e) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(ctl + kDone, 1ull) == gridDim.x - 1) {
      ctl[kDone] = 0;
      ctl[kEpoch] = e;
      __threadfence();
    }
  }
}

// Barrier, first half: one block tells every rank that this rank began
// call e (threads 0..world-1 each raise one flag).
__device__ __forceinline__ void arrive_all(const Team& t, u64 e) {
  if (threadIdx.x < t.world) notify(t.pad(threadIdx.x) + kArrive + t.rank, e);
}

// Barrier, second half: wait until every rank began call e. After it no
// rank still reads the landing buffers of call e - 1.
__device__ __forceinline__ void wait_all_arrived(const Team& t, u64 e,
                                                 const char* what) {
  if (threadIdx.x == 0)
    for (int p = 0; p < t.world; ++p) wait(t.pad(t.rank) + kArrive + p, e,
                                           what, p);
  __syncthreads();
}

// barrier_all: arrive + wait, inside one block.
__device__ __forceinline__ void barrier_all(const Team& t, u64 e,
                                            const char* what) {
  arrive_all(t, e);
  wait_all_arrived(t, e, what);
}

// barrier_neighbors: the ring neighbours only (left and right).
__device__ __forceinline__ void barrier_neighbors(const Team& t, u64 e,
                                                  const char* what) {
  const int left = (t.rank + t.world - 1) % t.world;
  const int right = (t.rank + 1) % t.world;
  if (threadIdx.x == 0) {
    notify(t.pad(left) + kArrive + t.rank, e);
    notify(t.pad(right) + kArrive + t.rank, e);
    wait(t.pad(t.rank) + kArrive + left, e, what, left);
    wait(t.pad(t.rank) + kArrive + right, e, what, right);
  }
  __syncthreads();
}

// Publish this block's puts of call e. Every thread fences its own
// stores; the last of `count` publishers (counted in ctl[kPushed]) raises
// flag [kData + rank] = e on every rank. Returns nothing; call from all
// threads of the block.
__device__ __forceinline__ void publish(const Team& t, u64* ctl, u64 e,
                                        unsigned count) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(ctl + kPushed, 1ull) == count - 1) {
    ctl[kPushed] = 0;
    __threadfence_system();
    for (int p = 0; p < t.world; ++p) notify(t.pad(p) + kData + t.rank, e);
  }
}

}  // namespace dist
}  // namespace td
