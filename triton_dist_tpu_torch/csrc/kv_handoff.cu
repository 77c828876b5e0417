// B29 (the KV page handoff) and B30 (its fan-out to several ranks) across
// ranks, hand-written for Hopper (sm_90a).
//
// Replace the TPU kernels of the JAX package
// kernels/kv_handoff.py::_kv_handoff_kernel (B29) and
// ::_kv_handoff_fanout_kernel (B30). Every rank holds a shard x of `shard`
// bytes (any dtype, any shape: the kernels move bytes), cut into cb
// comm blocks of shard / cb bytes (the wrapper's legalized row blocks):
//  * B29: an opening barrier; then dst's output is src's shard and every
//    other rank's output its own shard (dst takes no passthrough copy);
//  * B30: the same from one src to each rank of a set of destinations;
//    every rank outside the set passes its shard through.
// The data is moved, never computed on: the outputs are bit-exact.
//
// What bounds them on this card. The staged pages of one 2,048-token
// request held by one rank of Qwen3-32B at TP=4 are 128 MiB: B29 moves
// them once over NVLink (~0.30 ms at 450 GB/s each way), B30 once to each
// of ndst destinations from the one source (ndst x the bytes of src's
// egress, ~0.89 ms for three). One decode-size move (a layer's four page
// planes, 128 KiB) is bound by the barrier's and one flag's round trips.
//
// Design (B24's, csrc/ll_collectives.cu, with comm blocks):
//  * each comm block is cut into ppb pieces of rb 16-byte units (the last
//    may be short); block g of a rank's grid owns the pieces j = g, g + G,
//    ... of the cb x ppb; every piece has its own epoch-valued flag in each
//    destination's symmetric buffer (set to e, waited for >= e), so each
//    destination's flags are its own and a slow receiver completes nothing
//    for another;
//  * src stores a piece into the landing slot of every destination,
//    fences it at system scope and raises that piece's flag there; a
//    destination waits for every flag of the comm block that holds its
//    piece (the block is the unit that lands) and copies its piece out;
//    the other ranks copy their own pieces through;
//  * one landing slot (round16(shard) bytes) per rank: the opening barrier
//    (td_dist.cuh's arrival flags) orders a call's stores after every
//    rank began the call, so after every destination copied out the last
//    call's slot;
//  * copies use the widest word both addresses allow (a shard of any size
//    and alignment travels); the grid is small enough that every block of
//    every rank sharing the card is resident at once.

#include "td_dist.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;

constexpr int NT = 256;

template <typename W>
__device__ __forceinline__ long copy_words(char* dst, const char* src,
                                           long bytes) {
  const long n = bytes / static_cast<long>(sizeof(W));
  W* d = reinterpret_cast<W*>(dst);
  const W* s = reinterpret_cast<const W*>(src);
  for (long i = threadIdx.x; i < n; i += NT) d[i] = __ldcg(s + i);
  return n * static_cast<long>(sizeof(W));
}

// This block copies `bytes` from src to dst (either on any rank) in the
// widest words (16, 8, 4, 2 bytes) both addresses allow, the tail byte by
// byte; reads go through L2 only.
__device__ __forceinline__ void copy_bytes(char* dst, const char* src,
                                           long bytes) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(dst) |
                               reinterpret_cast<unsigned long long>(src);
  long done = 0;
  if ((a & 15) == 0)
    done = copy_words<uint4>(dst, src, bytes);
  else if ((a & 7) == 0)
    done = copy_words<uint2>(dst, src, bytes);
  else if ((a & 3) == 0)
    done = copy_words<unsigned>(dst, src, bytes);
  else if ((a & 1) == 0)
    done = copy_words<unsigned short>(dst, src, bytes);
  for (long i = done + threadIdx.x; i < bytes; i += NT)
    dst[i] = __ldcg(src + i);
}

// The pieces: comm block c (cbytes bytes) holds pieces c * ppb .. c * ppb
// + ppb - 1 of rb 16-byte units each.
struct Pieces {
  long cbytes;
  int cb, ppb, rb;
  __device__ __forceinline__ int total() const { return cb * ppb; }
  __device__ __forceinline__ long lo(int j) const {
    return static_cast<long>(j / ppb) * cbytes +
           static_cast<long>(j % ppb) * rb * 16;
  }
  __device__ __forceinline__ long len(int j) const {
    const long in = static_cast<long>(j % ppb) * rb * 16;
    const long full = static_cast<long>(rb) * 16;
    return cbytes - in < full ? cbytes - in : full;
  }
};

// B29 / B30 on this rank: src's shard to the ranks of dst_mask. Symmetric
// buffer: the landing slot from byte 0, flags (cb * ppb) u64 at flag_off,
// the arrival flags in the signal pad.
__device__ __forceinline__ void handoff(const char* __restrict__ x,
                                        char* __restrict__ out,
                                        const Team& team, u64* ctl,
                                        const Pieces& pc, long flag_off,
                                        int src, unsigned dst_mask,
                                        const char* what) {
  const int me = team.rank;
  const u64 e = td::dist::begin_call(ctl);
  if (blockIdx.x == 0) td::dist::arrive_all(team, e);
  td::dist::wait_all_arrived(team, e, what);
  const bool is_dst = (dst_mask >> me) & 1u;
  for (int j = blockIdx.x; j < pc.total(); j += gridDim.x) {
    if (!is_dst) copy_bytes(out + pc.lo(j), x + pc.lo(j), pc.len(j));
    if (me == src) {
      for (int d = 0; d < team.world; ++d)
        if ((dst_mask >> d) & 1u)
          copy_bytes(team.peer(d) + pc.lo(j), x + pc.lo(j), pc.len(j));
      __threadfence_system();
      __syncthreads();
      if (threadIdx.x < team.world && ((dst_mask >> threadIdx.x) & 1u))
        td::dist::notify(
            reinterpret_cast<u64*>(team.peer(threadIdx.x) + flag_off) + j, e);
    }
  }
  if (!is_dst) {
    td::dist::end_call(ctl, e);
    return;
  }
  const u64* flags = reinterpret_cast<const u64*>(team.peer(me) + flag_off);
  for (int j = blockIdx.x; j < pc.total(); j += gridDim.x) {
    if (threadIdx.x == 0) {
      const int c0 = j / pc.ppb * pc.ppb;
      for (int p = 0; p < pc.ppb; ++p)
        td::dist::wait(flags + c0 + p, e, what, src);
    }
    __syncthreads();
    copy_bytes(out + pc.lo(j), team.peer(me) + pc.lo(j), pc.len(j));
  }
  td::dist::end_call(ctl, e);
}

__global__ void __launch_bounds__(NT)
    kv_handoff_kernel(const char* __restrict__ x, char* __restrict__ out,
                      Team team, u64* ctl, Pieces pc, long flag_off, int src,
                      int dst) {
  handoff(x, out, team, ctl, pc, flag_off, src, 1u << dst,
          "B29 KV page block");
}

__global__ void __launch_bounds__(NT)
    kv_fanout_kernel(const char* __restrict__ x, char* __restrict__ out,
                     Team team, u64* ctl, Pieces pc, long flag_off, int src,
                     unsigned dst_mask) {
  handoff(x, out, team, ctl, pc, flag_off, src, dst_mask,
          "B30 KV page block (fan-out)");
}

// Checks that `grid` blocks of kernel fn fit on the card at once with the
// other ranks that share it (queried once per kernel, never under a CUDA
// graph capture; the query also loads the kernel before any spinning
// launch).
template <typename K>
cudaError_t resident(K fn, int* occ, int grid, int ranks_per_device) {
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

}  // namespace

extern "C" {

// B29 (fanout 0: dst = the one set bit of dst_mask) or B30 (fanout 1).
// x, out: the shard, shard = cb * cbytes bytes (> 0); base: device table
// of every rank's symmetric buffer (landing slot round16(shard) bytes at
// byte 0, flags (cb * ppb) u64 at flag_off, zeroed once; its signal pad at
// sig_off); ctl: this rank's control block (4 u64, zeroed once); rb:
// 16-byte units a piece, ppb = ceil(ceil(cbytes / 16) / rb) pieces a comm
// block; src: the source rank; dst_mask: the destinations (bit d for rank
// d; src not among them); grid: blocks, the same on every rank;
// ranks_per_device: ranks that share this card. Returns a cudaError_t.
int td_kv_handoff(int fanout, const void* x, void* out, int rank, int world,
                  const void* base, long long sig_off, void* ctl,
                  long long cbytes, int cb, int rb, int ppb,
                  long long flag_off, int src, unsigned dst_mask, int grid,
                  int ranks_per_device, void* stream) {
  const long units = (cbytes + 15) / 16;
  if (world < 1 || world > td::dist::kMaxWorld || rank < 0 ||
      rank >= world || cbytes <= 0 || cb < 1 || rb < 1 ||
      ppb != (units + rb - 1) / rb || grid < 1 || ranks_per_device < 1 ||
      src < 0 || src >= world || dst_mask == 0 ||
      (dst_mask >> world) != 0 || ((dst_mask >> src) & 1u))
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), sig_off};
  const Pieces pc{static_cast<long>(cbytes), cb, ppb, rb};
  const char* xs = static_cast<const char*>(x);
  char* o = static_cast<char*>(out);
  u64* c = static_cast<u64*>(ctl);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (fanout) {
    static int occ = 0;
    err = resident(kv_fanout_kernel, &occ, grid, ranks_per_device);
    if (err == cudaSuccess)
      kv_fanout_kernel<<<grid, NT, 0, st>>>(xs, o, team, c, pc, flag_off, src,
                                            dst_mask);
  } else {
    if (dst_mask & (dst_mask - 1))
      return static_cast<int>(cudaErrorInvalidValue);
    int dst = 0;
    while (!((dst_mask >> dst) & 1u)) ++dst;
    static int occ = 0;
    err = resident(kv_handoff_kernel, &occ, grid, ranks_per_device);
    if (err == cudaSuccess)
      kv_handoff_kernel<<<grid, NT, 0, st>>>(xs, o, team, c, pc, flag_off,
                                             src, dst);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
