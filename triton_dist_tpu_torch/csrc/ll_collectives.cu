// B22 (bidirectional-ring all-gather), B23 (2-D factored ring
// all-gather), B24 (point-to-point put), B25 (device barrier) and B26
// (ring shift) across ranks, hand-written for Hopper (sm_90a).
//
// Replace the TPU kernels of the JAX package
// kernels/low_latency_allgather.py::_bidir_ring_ag_kernel (B22) and
// ::_ring2d_ag_kernel (B23), kernels/p2p.py::_p2p_kernel (B24) and
// kernels/common_ops.py::_barrier_kernel (B25) and ::_ring_shift_kernel
// (B26). Every rank holds a shard x of `shard` bytes (any dtype, any
// shape: the kernels move bytes):
//  * B22: every rank returns the n shards in rank order (n * shard bytes).
//    Both ring directions at once: at round s chunk (me - s) travels right
//    (kr = n / 2 rounds) and chunk (me + s) left (kl = (n - 1) / 2);
//  * B23: the same result over n = nx * ny ranks from the linear rank: a
//    ring over the nx shards of each row, then a ring of the completed
//    rows (nx shards) down each column; nx + ny - 2 hops, the 1-D ring's
//    bytes;
//  * B24: an opening barrier, then dst's output is src's shard and every
//    other rank's output its own shard (dst takes no passthrough copy);
//  * B25: a barrier across the ranks, then x copied to the output, so the
//    output depends on every rank having arrived;
//  * B26: out = the shard of rank (me - shift) mod n: one put of the own
//    shard `shift` hops right, no barrier.
//
// What bounds them on this card. At the decode shapes (1-16 rows of
// Qwen3-32B's 5,120-wide hidden, bf16: 10-160 KiB a shard) every one of
// them is bound by flag latency: a round trip over NVLink per hop (B22
// and B23 make two hops at n = 4, B24-B26 one), not by bytes. At a
// prefill chunk (2,048 rows, 20 MiB a shard) B22 / B23 receive 3 x 20
// MiB a rank, ~140 us at NVLink's 450 GB/s each way.
//
// Design:
//  * a shard travels in pieces of rb 16-byte units (the last may be
//    short), block b of a rank owning the pieces j = b, b + G, ...; each
//    (chunk, piece) has its own flag per rank (epoch-valued: set to e,
//    waited for >= e, td_dist.cuh), raised by whoever stored it, so block
//    b waits only for block b of another rank;
//  * the ring kernels keep their slots n x round16(shard) bytes in the
//    symmetric buffer (td_ring.cuh's row blocks with 16-byte rows) and
//    forward with 16-byte stores; each rank first copies its own shard
//    into its own slot, so a shard of any size and alignment travels (a
//    bf16 row of 5 values is 10 bytes); copies into and out of the slots
//    use the widest word both pointers' alignment allows;
//  * B22's forwarding leg is B11's (td_ring.cuh bidir_ring_forward);
//  * landing slots are double-buffered by the epoch's parity. B22 and
//    B23 need no opening barrier: a rank that finished call e + 1 holds
//    every rank's shard of call e + 1, so every rank had begun call e + 1
//    and finished call e before any rank writes the slots of call e + 2.
//    B26's receiver acknowledges each piece once it copied it out, and a
//    sender waits for the acknowledgement of call e - 2 before it writes
//    that half again (a ring shift does not make every rank wait for
//    every other; the wrapper keeps a workspace per shift, so the rank
//    that acknowledges is the rank written to). B24's and B25's
//    barrier is td_dist.cuh's arrival flags (block 0 raises them, every
//    block waits for all of them);
//  * the grid is small enough that every block of every rank that shares
//    the card is resident at once (G <= occupancy x SMs / ranks per
//    card).

#include "td_dist.cuh"
#include "td_ring.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;
using td::ring::RowBlocks;

constexpr int NT = 256;

enum Op { kBidir = 0, kRing2d = 1, kP2p = 2, kBarrier = 3, kShift = 4 };

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

// Piece j of a shard: bytes [lo, lo + len).
struct Pieces {
  long shard;
  int rb, mb;
  __device__ __forceinline__ long lo(int j) const {
    return static_cast<long>(j) * rb * 16;
  }
  __device__ __forceinline__ long len(int j) const {
    const long left = shard - lo(j), full = static_cast<long>(rb) * 16;
    return left < full ? left : full;
  }
};

// `chunks` slots of round16(shard) bytes in every rank's symmetric buffer
// (the half of this call's parity when double-buffered), each piece its
// own flag.
__device__ __forceinline__ RowBlocks slots(const Team& team, const Pieces& pc,
                                           int chunks, bool parity, u64 e,
                                           long flag_off) {
  const int units = static_cast<int>((pc.shard + 15) / 16);
  const long half = static_cast<long>(chunks) * units * 16;
  return RowBlocks{team, parity ? static_cast<long>(e & 1) * half : 0,
                   flag_off, 16, units, pc.rb, pc.mb};
}

// The own shard into the own slot, this block's pieces.
__device__ __forceinline__ void stage_own(const RowBlocks& rbk,
                                          const Pieces& pc, const char* x) {
  const int me = rbk.team.rank;
  for (int j = blockIdx.x; j < pc.mb; j += gridDim.x)
    copy_bytes(rbk.at(me, me, j), x + pc.lo(j), pc.len(j));
  __syncthreads();
}

// Every chunk of this block's pieces, once landed, out of the slots into
// out (chunk c at byte c * shard).
__device__ __forceinline__ void gather_out(const RowBlocks& rbk,
                                           const Pieces& pc, char* out,
                                           u64 e, const char* what) {
  const int me = rbk.team.rank, n = rbk.team.world;
  for (int j = blockIdx.x; j < pc.mb; j += gridDim.x)
    for (int c = 0; c < n; ++c) {
      if (c != me) td::ring::wait_row_block(rbk, c, j, e, c, what);
      copy_bytes(out + c * pc.shard + pc.lo(j), rbk.at(me, c, j),
                 pc.len(j));
    }
}

// B22. Symmetric buffer: slots (2, n, round16(shard)) from byte 0, flags
// (n, mb) u64 at flag_off.
__global__ void __launch_bounds__(NT)
    bidir_ring_ag_kernel(const char* __restrict__ x, char* __restrict__ out,
                         Team team, u64* ctl, Pieces pc, long flag_off) {
  const int me = team.rank, n = team.world;
  const u64 e = td::dist::begin_call(ctl);
  const RowBlocks rbk = slots(team, pc, n, true, e, flag_off);
  stage_own(rbk, pc, x);
  const int round0[2] = {(me + 1) % n, (me + n - 1) % n};
  td::ring::bidir_ring_forward(rbk, rbk.at(me, me, 0), round0,
                               (n - 1) / 2 > 0 ? 2 : 1, e,
                               "B22 bidirectional ring shard");
  gather_out(rbk, pc, out, e, "B22 bidirectional ring shard");
  td::dist::end_call(ctl, e);
}

// B23. Symmetric buffer as B22's; rank me is (row me / nx, column
// me % nx).
__global__ void __launch_bounds__(NT)
    ring2d_ag_kernel(const char* __restrict__ x, char* __restrict__ out,
                     Team team, u64* ctl, Pieces pc, long flag_off, int nx) {
  const int me = team.rank, n = team.world, ny = n / nx;
  const int cx = me % nx, cy = me / nx;
  const int right = cy * nx + (cx + 1) % nx;
  const int left = cy * nx + (cx + nx - 1) % nx;
  const int down = (cy + 1) % ny * nx + cx, up = (cy + ny - 1) % ny * nx + cx;
  const u64 e = td::dist::begin_call(ctl);
  const RowBlocks rbk = slots(team, pc, n, true, e, flag_off);
  stage_own(rbk, pc, x);
  // stage 1: a ring over the nx shards of this row
  for (int s = 0; s < nx - 1; ++s) {
    const int c = cy * nx + (cx + nx - s) % nx;
    for (int j = blockIdx.x; j < pc.mb; j += gridDim.x) {
      if (s > 0)
        td::ring::wait_row_block(rbk, c, j, e, left, "B23 row ring shard");
      td::ring::store_row_block(rbk, rbk.at(me, c, j), c, j, &right, 1, e);
    }
  }
  // stage 2: a ring of the completed rows down each column; a row's piece
  // goes on once all its nx shards' pieces have landed here
  for (int s = 0; s < ny - 1; ++s) {
    const int ry = (cy + ny - s) % ny;
    for (int j = blockIdx.x; j < pc.mb; j += gridDim.x)
      for (int q = 0; q < nx; ++q) {
        const int c = ry * nx + q;
        if (c != me)
          td::ring::wait_row_block(rbk, c, j, e, s == 0 ? left : up,
                                   "B23 ring shard");
        td::ring::store_row_block(rbk, rbk.at(me, c, j), c, j, &down, 1, e);
      }
  }
  gather_out(rbk, pc, out, e, "B23 ring shard");
  td::dist::end_call(ctl, e);
}

// B24. Symmetric buffer: the landing slot (round16(shard)) from byte 0,
// flags (mb) u64 at flag_off, the arrival flags in the signal pad.
__global__ void __launch_bounds__(NT)
    p2p_kernel(const char* __restrict__ x, char* __restrict__ out, Team team,
               u64* ctl, Pieces pc, long flag_off, int src, int dst) {
  const int me = team.rank;
  const u64 e = td::dist::begin_call(ctl);
  if (blockIdx.x == 0) td::dist::arrive_all(team, e);
  td::dist::wait_all_arrived(team, e, "B24 p2p opening barrier");
  const RowBlocks land = slots(team, pc, 1, false, e, flag_off);
  for (int j = blockIdx.x; j < pc.mb; j += gridDim.x) {
    if (me != dst) copy_bytes(out + pc.lo(j), x + pc.lo(j), pc.len(j));
    if (me == src) {
      copy_bytes(land.at(dst, 0, j), x + pc.lo(j), pc.len(j));
      __threadfence_system();
      __syncthreads();
      if (threadIdx.x == 0) td::dist::notify(land.flag(dst, 0, j), e);
    }
    if (me == dst) {
      td::ring::wait_row_block(land, 0, j, e, src, "B24 p2p shard");
      copy_bytes(out + pc.lo(j), land.at(me, 0, j), pc.len(j));
    }
  }
  td::dist::end_call(ctl, e);
}

// B25. Symmetric buffer: only its signal pad's arrival flags.
__global__ void __launch_bounds__(NT)
    barrier_kernel(const char* __restrict__ x, char* __restrict__ out,
                   Team team, u64* ctl, Pieces pc) {
  const u64 e = td::dist::begin_call(ctl);
  if (blockIdx.x == 0) td::dist::arrive_all(team, e);
  td::dist::wait_all_arrived(team, e, "B25 barrier");
  for (int j = blockIdx.x; j < pc.mb; j += gridDim.x)
    copy_bytes(out + pc.lo(j), x + pc.lo(j), pc.len(j));
  td::dist::end_call(ctl, e);
}

// B26. Symmetric buffer: landing slots (2, round16(shard)) from byte 0,
// data flags (mb) u64 at flag_off (raised by the rank `shift` to the
// left), acknowledgements (mb) u64 at ack_off (raised by the rank `shift`
// to the right once it copied a piece out).
__global__ void __launch_bounds__(NT)
    ring_shift_kernel(const char* __restrict__ x, char* __restrict__ out,
                      Team team, u64* ctl, Pieces pc, long flag_off,
                      long ack_off, int shift) {
  const int me = team.rank, n = team.world;
  const int dst = (me + shift) % n, src = (me + n - shift) % n;
  const u64 e = td::dist::begin_call(ctl);
  const RowBlocks land = slots(team, pc, 1, true, e, flag_off);
  const u64* acked = reinterpret_cast<const u64*>(team.peer(me) + ack_off);
  for (int j = blockIdx.x; j < pc.mb; j += gridDim.x) {
    // dst read this half of its landing slot in call e - 2
    if (threadIdx.x == 0 && e > 2)
      td::dist::wait(acked + j, e - 2, "B26 landing slot freed", dst);
    __syncthreads();
    copy_bytes(land.at(dst, 0, j), x + pc.lo(j), pc.len(j));
    __threadfence_system();
    __syncthreads();
    if (threadIdx.x == 0) td::dist::notify(land.flag(dst, 0, j), e);
  }
  for (int j = blockIdx.x; j < pc.mb; j += gridDim.x) {
    td::ring::wait_row_block(land, 0, j, e, src, "B26 ring shift shard");
    copy_bytes(out + pc.lo(j), land.at(me, 0, j), pc.len(j));
    __syncthreads();
    if (threadIdx.x == 0)
      td::dist::notify(reinterpret_cast<u64*>(team.peer(src) + ack_off) + j,
                       e);
  }
  td::dist::end_call(ctl, e);
}

// Checks that `grid` blocks of kernel fn fit on the card at once with the
// other ranks that share it (queried once per kernel, never under a CUDA
// graph capture: callers warm up first; the query also loads the kernel
// before any spinning launch).
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

// One entry for the five kernels. op: 0 B22, 1 B23 (a = nx, a divisor of
// world), 2 B24 (a = src, b = dst), 3 B25, 4 B26 (a = shift, in
// [0, world)). x: the shard, `shard` bytes (> 0); out: world * shard
// bytes (B22, B23) or shard bytes; base: device table of every rank's
// symmetric buffer (its signal pad at sig_off), the layout of each
// kernel above, zeroed once; ctl: this rank's control block (4 u64,
// zeroed once); rb: 16-byte units a piece; grid: blocks, the number of
// pieces, the same on every rank; ranks_per_device: ranks that share
// this card. Returns a cudaError_t.
int td_ll_collective(int op, const void* x, void* out, int rank, int world,
                     const void* base, long long sig_off, void* ctl,
                     long long shard, int rb, long long flag_off,
                     long long ack_off, int a, int b, int grid,
                     int ranks_per_device, void* stream) {
  const long units = (shard + 15) / 16;
  if (world < 1 || world > td::dist::kMaxWorld || rank < 0 ||
      rank >= world || shard <= 0 || rb < 1 || grid < 1 ||
      grid != (units + rb - 1) / rb || ranks_per_device < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), sig_off};
  const Pieces pc{static_cast<long>(shard), rb, grid};
  const char* xs = static_cast<const char*>(x);
  char* o = static_cast<char*>(out);
  u64* c = static_cast<u64*>(ctl);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  switch (op) {
    case kBidir: {
      static int occ = 0;
      err = resident(bidir_ring_ag_kernel, &occ, grid, ranks_per_device);
      if (err == cudaSuccess)
        bidir_ring_ag_kernel<<<grid, NT, 0, st>>>(xs, o, team, c, pc,
                                                  flag_off);
      break;
    }
    case kRing2d: {
      if (a < 1 || world % a) return static_cast<int>(cudaErrorInvalidValue);
      static int occ = 0;
      err = resident(ring2d_ag_kernel, &occ, grid, ranks_per_device);
      if (err == cudaSuccess)
        ring2d_ag_kernel<<<grid, NT, 0, st>>>(xs, o, team, c, pc, flag_off,
                                              a);
      break;
    }
    case kP2p: {
      if (a < 0 || a >= world || b < 0 || b >= world)
        return static_cast<int>(cudaErrorInvalidValue);
      static int occ = 0;
      err = resident(p2p_kernel, &occ, grid, ranks_per_device);
      if (err == cudaSuccess)
        p2p_kernel<<<grid, NT, 0, st>>>(xs, o, team, c, pc, flag_off, a, b);
      break;
    }
    case kBarrier: {
      static int occ = 0;
      err = resident(barrier_kernel, &occ, grid, ranks_per_device);
      if (err == cudaSuccess)
        barrier_kernel<<<grid, NT, 0, st>>>(xs, o, team, c, pc);
      break;
    }
    case kShift: {
      if (a < 0 || a >= world) return static_cast<int>(cudaErrorInvalidValue);
      static int occ = 0;
      err = resident(ring_shift_kernel, &occ, grid, ranks_per_device);
      if (err == cudaSuccess)
        ring_shift_kernel<<<grid, NT, 0, st>>>(xs, o, team, c, pc, flag_off,
                                               ack_off, a);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
