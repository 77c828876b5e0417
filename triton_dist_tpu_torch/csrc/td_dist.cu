// The port's symmetric-memory library and its notify/wait demonstration.
//
// Host side: device allocations that every rank can address. td_malloc
// allocates (cudaMalloc, zero-filled) so that the pointer is the base of
// its own allocation; td_ipc_handle / td_ipc_open exchange it between
// processes as a CUDA IPC handle (the process group carries the 64 bytes),
// and the opened mapping is a peer pointer that kernels load and store
// through NVLink. The one-card world uses td_malloc alone: its logical
// ranks are separate allocations of one card.
//
// Device side: td_notify_wait is tutorials/01-distributed-notify-wait.py
// (the reference's tutorial of notify / wait): after a barrier, rank 0
// puts its buffer into every rank's symmetric buffer and notifies a flag
// on each; every other rank waits on its flag, then copies what landed
// into its output. One block per rank. It is no TPU kernel's port: it
// holds the language helpers of td_dist.cuh on the card.

#include <string.h>

#include "td_dist.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;

__global__ void notify_wait_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, Team team,
                                   u64* ctl, long bytes) {
  const u64 e = td::dist::begin_call(ctl);
  td::dist::barrier_all(team, e, "notify_wait arrival");
  u64* flag = team.pad(team.rank) + td::dist::kUser;
  if (td::dist::rank(team) == 0) {
    for (int p = 0; p < td::dist::num_ranks(team); ++p)
      td::dist::put(team.peer(p), x, bytes);
    __threadfence_system();
    __syncthreads();
    if (threadIdx.x < team.world)
      td::dist::notify(team.pad(threadIdx.x) + td::dist::kUser, e);
  }
  if (threadIdx.x == 0) td::dist::wait(flag, e, "notify_wait data", 0);
  __syncthreads();
  td::dist::put(out, team.peer(team.rank), bytes);
  td::dist::end_call(ctl, e);
}

}  // namespace

extern "C" {

// cudaMalloc'd, zero-filled `bytes` on the current device.
int td_malloc(long bytes, void** out) {
  cudaError_t err = cudaMalloc(out, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*out, 0, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceSynchronize());
}

int td_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

// The 64-byte IPC handle of a td_malloc allocation.
int td_ipc_handle(void* ptr, void* handle64) {
  return static_cast<int>(
      cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle64), ptr));
}

// Map another process's allocation; *out is its base on this device.
int td_ipc_open(const void* handle64, void** out) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle64, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess));
}

int td_ipc_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// The tutorial: x (bytes, 16-byte multiple) of rank 0 lands in `out` of
// every rank. base: device table of the ranks' symmetric buffers (each at
// least `bytes` of data, signal pad at sig_off); ctl: this rank's control
// block. Returns a cudaError_t.
int td_notify_wait(const void* x, void* out, int rank, int world,
                   const void* base, long long sig_off, void* ctl,
                   long bytes, void* stream) {
  if (world < 1 || world > td::dist::kMaxWorld || rank < 0 ||
      rank >= world || bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), sig_off};
  notify_wait_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), team,
      static_cast<u64*>(ctl), bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
