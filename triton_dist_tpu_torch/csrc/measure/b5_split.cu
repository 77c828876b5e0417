// A measurement copy of B5's one-launch kernel as it stood before B5 moved
// onto td_oneshot.cuh's one-shot regime (allreduce.cu's one_shot_kernel:
// x stored into slot `rank` of every peer's landing buffer, one flag a
// (block, sender) raised after a system fence, thread 0's wait for each
// peer's flag in turn, the fold, begin_call / end_call's shared epoch),
// with each block's phases stamped: %globaltimer at its start and end,
// clock64 at each phase boundary. chip_compare.py --ar --split builds it
// with nvcc (not part of the port's kernels: build.all_sources() does not
// list it) and splits a call's time between the launch gap, begin_call,
// the per-peer store loop, the serial wait, the fold and end_call.
#include "../td_common.cuh"
#include "../td_dist.cuh"
#include "../td_oneshot.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;
using namespace td::oneshot;

__device__ __forceinline__ u64 global_ns() {
  u64 t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// stamps: this call's (grid, 8) u64: global ns at the start, clock64
// after each of entry, begin_call, the stores, the wait, the fold and
// end_call, global ns at the end.
__global__ void __launch_bounds__(NT)
    one_shot_stamped(const uint4* __restrict__ x, uint4* __restrict__ out,
                     Team team, u64* ctl, int m, int kv, long land_off,
                     long flag_off, u64* stamps) {
  u64* st = stamps + 8 * blockIdx.x;
  if (threadIdx.x == 0) {
    st[0] = global_ns();
    st[1] = clock64();
  }
  const int me = team.rank, world = team.world, b = blockIdx.x;
  const u64 e = td::dist::begin_call(ctl);
  if (threadIdx.x == 0) st[2] = clock64();
  const Cols cols(kv);
  const long items = static_cast<long>(m) * cols.cw;
  const long slot = static_cast<long>(m) * kv;
  const long parity = static_cast<long>(e & 1) * world;

  for (int i = 1; i < world; ++i) {
    const int p = (me + i) % world;
    uint4* dst = buf(team, p, land_off) + (parity + me) * slot;
    for (long j = threadIdx.x; j < items; j += NT) {
      const long v = cols.at(j, 0, kv);
      dst[v] = x[v];
    }
  }
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) st[3] = clock64();
  if (threadIdx.x < world && threadIdx.x != me)
    td::dist::notify(flags(team, threadIdx.x, flag_off) + b * world + me, e);
  if (threadIdx.x == 0)
    for (int s = 0; s < world; ++s)
      if (s != me)
        td::dist::wait(flags(team, me, flag_off) + b * world + s, e,
                       "B5 one-shot data", s);
  __syncthreads();
  if (threadIdx.x == 0) st[4] = clock64();
  const uint4* land = buf(team, me, land_off) + parity * slot;
  for (long j = threadIdx.x; j < items; j += NT) {
    const long v = cols.at(j, 0, kv);
    uint4 acc = x[v];
    for (int s = 0; s < world; ++s)
      if (s != me)
        acc = add_vec<__nv_bfloat16>(acc, __ldcg(land + s * slot + v));
    out[v] = acc;
  }
  __syncthreads();
  if (threadIdx.x == 0) st[5] = clock64();
  td::dist::end_call(ctl, e);
  if (threadIdx.x == 0) {
    st[6] = clock64();
    st[7] = global_ns();
  }
}

}  // namespace

// x, out: (m, K) bf16, kv = K / 8 vectors a row; base: every rank's
// symmetric buffer (landing slots (2, world, m, K) at land_off, flags
// (grid, world) u64 at flag_off, zeroed once); ctl: 4 u64, zeroed once;
// stamps: (grid, 8) u64 for this call. Returns a cudaError_t.
extern "C" int td_b5_split(const void* x, void* out, int rank, int world,
                           const void* base, void* ctl, int m, int kv,
                           long long land_off, long long flag_off, int grid,
                           void* stamps, void* stream) {
  const Team team{rank, world, static_cast<const long long*>(base), 0};
  one_shot_stamped<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), team,
      static_cast<u64*>(ctl), m, kv, land_off, flag_off,
      static_cast<u64*>(stamps));
  return static_cast<int>(cudaGetLastError());
}
