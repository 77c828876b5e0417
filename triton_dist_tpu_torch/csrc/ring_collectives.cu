// B9 (ring reduce-scatter), B7 (ring all-gather) and B8 (full-mesh
// all-gather) across ranks, hand-written for Hopper (sm_90a).
//
// Replace the TPU kernels kernels/reduce_scatter.py::_ring_rs_kernel,
// kernels/allgather.py::_ring_ag_kernel and ::_full_mesh_ag_kernel of the
// JAX package (methods RING_1D of reduce_scatter_per_device /
// all_gather_per_device, together all_reduce_per_device's TWO_SHOT; and
// all_gather_per_device's FULL_MESH).
//  * B9: every rank holds x (n*m, K); rank r returns row chunk r of the
//    sum over ranks, (m, K). At step 0 rank r sends its raw chunk r-1 to
//    its right neighbour; at step s >= 1 it receives the partial of chunk
//    c = r-1-s (mod n) from its left, adds its own rows of c
//    (acc = incoming + local, rounded to x's dtype) and forwards it, or,
//    at the last step (c = r), stores it as the output. So chunk c is
//    folded x_{c+1} + x_{c+2} + ... + x_c (ranks mod n), the same bytes
//    on whichever rank computes it, as the TPU kernel's order.
//  * B7: every rank holds x (m, K); every rank returns the (n*m, K) rows
//    of all ranks in rank order. At step s rank r forwards chunk r-s
//    (mod n) to its right neighbour (its own rows at step 0, after that
//    the chunk that landed from its left at step s-1, which it waits
//    for first).
//  * B8: every rank holds x (m, K); every rank returns the (n*m, K) rows
//    of all ranks in rank order, each rank's shard pushed straight into
//    slot `rank` of every rank's buffer (one hop on NVSwitch).
//
// What bounds them on this card. On the TWO_SHOT prefill path (Qwen3-32B
// at TP=4, one 512-token chunk) x is (512, 5120) bf16, 5.2 MB: B9 sends
// 3 x 1.3 MB per rank and reads/writes ~2.6 MB of HBM per step, B7 the
// same; ~9 us of NVLink time at 450 GB/s each way. At the decode shape
// (16, 5120) the kernels are bound by latency: n - 1 flag hops in
// sequence, each after the previous one landed. B8 moves the same bytes
// in one hop: every rank stores its shard into n - 1 peers at once, so at
// (128, 5120) bf16 a rank sends 3 x 1.3 MB (~9 us at 450 GB/s) and at the
// decode shape it is bound by one flag round trip.
//
// Design:
//  * the grid is G blocks (the wrapper's choice, the same on every rank),
//    and block b owns a fixed slice of the columns (16-byte vectors) of
//    every row, in every step; block b of a rank talks only to block b of
//    its left and right neighbours, so no block waits for another block
//    of its own rank, and each (block, step) has its own flag in the
//    symmetric buffer (epoch-valued: set to e, waited for >= e);
//  * a sender publishes with __threadfence_system() by every storing
//    thread, a block barrier, then a release store of the flag at system
//    scope; a receiver acquires the flag and reads what landed with
//    L1-bypassing loads; every wait is bounded and traps naming the flag;
//  * one landing region per ring step (n - 1 of them), so a fast sender
//    never overwrites a partial (B9) or a chunk (B7) not yet consumed,
//    and every region is double-buffered by the epoch's parity, with no
//    opening barrier: rank r writes its right neighbour's regions of
//    call e + 2 only after it finished call e + 1, whose last step needed
//    data that left the right neighbour at step 0 of call e + 1 (around
//    the ring through every rank), which the right neighbour sent only
//    after its call e kernel had ended;
//  * B7's gathered rows are written by the left neighbour, so they live
//    in the symmetric buffer and are copied out to the caller's fresh
//    tensor at the end (the own rows straight from x);
//  * B8 shares B10's gather leg (td_dist.cuh push_all): the grid splits
//    the shard's bytes, each block stores its share into slot `rank` of
//    every rank's gathered rows, and the last block of the grid to finish
//    raises this rank's data flag (epoch-valued) on every rank; every
//    block waits for the n flags and copies its share of the gathered rows
//    out. The gathered rows are double-buffered by the epoch's parity,
//    with no opening barrier: rank r writes a peer's rows of call e + 2
//    only after call e + 1, which waited for every peer's flag of call
//    e + 1, raised only after that peer's call e kernel had ended;
//  * the grid is small enough that every block of every rank that shares
//    the card is resident at once (G <= occupancy x SMs / ranks per card).

#include "td_common.cuh"
#include "td_dist.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;

constexpr int NT = 256;

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

// Fence this block's stores at system scope, then raise `flag` = e.
__device__ __forceinline__ void publish_to(u64* flag, u64 e) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0) td::dist::notify(flag, e);
}

// Wait (thread 0) until `flag` >= e, then let the whole block on.
__device__ __forceinline__ void wait_for(const u64* flag, u64 e,
                                         const char* what, int from) {
  if (threadIdx.x == 0) td::dist::wait(flag, e, what, from);
  __syncthreads();
}

// B9. Symmetric buffer: landing (2, n-1, m, kv) vectors at land_off,
// flags (G, n-1) at flag_off (raised by the left neighbour).
template <typename T>
__global__ void __launch_bounds__(NT)
    ring_rs_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                   Team team, u64* ctl, int m, int kv, long land_off,
                   long flag_off) {
  const int me = team.rank, n = team.world, b = blockIdx.x;
  const int right = (me + 1) % n, left = (me + n - 1) % n;
  const u64 e = td::dist::begin_call(ctl);
  const Cols cols(kv);
  const long items = static_cast<long>(m) * cols.cw;
  const long slot = static_cast<long>(m) * kv;
  const long parity = static_cast<long>(e & 1) * (n - 1);
  const uint4* land = buf(team, me, land_off);
  uint4* dst = buf(team, right, land_off);
  u64* my_flags = flags(team, me, flag_off) + static_cast<long>(b) * (n - 1);
  u64* right_flags =
      flags(team, right, flag_off) + static_cast<long>(b) * (n - 1);

  // step 0: the raw chunk me - 1 to the right neighbour's slot 0
  long c = (me + n - 1) % n;
  for (long j = threadIdx.x; j < items; j += NT) {
    const long v = cols.at(j, c * m, kv);
    dst[parity * slot + cols.at(j, 0, kv)] = x[v];
  }
  publish_to(right_flags, e);
  for (int s = 1; s < n; ++s) {
    c = (me + 2 * n - 1 - s) % n;
    wait_for(my_flags + s - 1, e, "B9 ring reduce-scatter partial", left);
    const uint4* in = land + (parity + s - 1) * slot;
    for (long j = threadIdx.x; j < items; j += NT) {
      const long v = cols.at(j, 0, kv);
      const uint4 acc = add_vec<T>(__ldcg(in + v),
                                   x[cols.at(j, c * m, kv)]);
      if (s < n - 1)
        dst[(parity + s) * slot + v] = acc;
      else
        out[v] = acc;
    }
    if (s < n - 1) publish_to(right_flags + s, e);
  }
  td::dist::end_call(ctl, e);
}

// B7. Symmetric buffer: gathered rows (2, n*m, kv) vectors at rows_off,
// flags (G, n-1) at flag_off (raised by the left neighbour).
template <typename T>
__global__ void __launch_bounds__(NT)
    ring_ag_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                   Team team, u64* ctl, int m, int kv, long rows_off,
                   long flag_off) {
  const int me = team.rank, n = team.world, b = blockIdx.x;
  const int right = (me + 1) % n, left = (me + n - 1) % n;
  const u64 e = td::dist::begin_call(ctl);
  const Cols cols(kv);
  const long items = static_cast<long>(m) * cols.cw;
  const long half = static_cast<long>(n) * m * kv;
  const uint4* rows = buf(team, me, rows_off) + (e & 1) * half;
  uint4* dst = buf(team, right, rows_off) + (e & 1) * half;
  u64* my_flags = flags(team, me, flag_off) + static_cast<long>(b) * (n - 1);
  u64* right_flags =
      flags(team, right, flag_off) + static_cast<long>(b) * (n - 1);

  for (int s = 0; s < n - 1; ++s) {
    const long c = (me + n - s) % n;
    if (s > 0)
      wait_for(my_flags + s - 1, e, "B7 ring all-gather chunk", left);
    for (long j = threadIdx.x; j < items; j += NT) {
      const long v = cols.at(j, c * m, kv);
      dst[v] = s == 0 ? x[cols.at(j, 0, kv)] : __ldcg(rows + v);
    }
    publish_to(right_flags + s, e);
  }
  wait_for(my_flags + n - 2, e, "B7 ring all-gather chunk", left);
  for (int c = 0; c < n; ++c)
    for (long j = threadIdx.x; j < items; j += NT) {
      const long v = cols.at(j, static_cast<long>(c) * m, kv);
      out[v] = c == me ? x[cols.at(j, 0, kv)] : __ldcg(rows + v);
    }
  td::dist::end_call(ctl, e);
}

// B8. Symmetric buffer: the gathered rows (2, n, shard bytes) from byte
// 0, halves by the epoch's parity; the data flags in the signal pad.
__global__ void __launch_bounds__(NT)
    full_mesh_ag_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                        Team team, u64* ctl, long shard) {
  const int n = team.world;
  const u64 e = td::dist::begin_call(ctl);
  const long half = n * shard;
  const long par = static_cast<long>(e & 1) * half;
  td::dist::push_all(team, par + team.rank * shard, x, shard);
  td::dist::publish(team, ctl, e, gridDim.x);
  if (threadIdx.x == 0)
    for (int p = 0; p < n; ++p)
      td::dist::wait(team.pad(team.rank) + td::dist::kData + p, e,
                     "B8 full-mesh shard", p);
  __syncthreads();
  const uint4* rows = buf(team, team.rank, par);
  const long vecs = half / 16;
  for (long i = static_cast<long>(blockIdx.x) * NT + threadIdx.x; i < vecs;
       i += static_cast<long>(gridDim.x) * NT)
    out[i] = __ldcg(rows + i);
  td::dist::end_call(ctl, e);
}

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

// Both kernels of a dtype are queried (and so loaded) at the first call
// of either: TWO_SHOT launches B7 right after B9, and a lazy load behind a
// spinning B9 could wait for ranks not yet launched on a shared card.
template <typename T>
cudaError_t resident(bool ag, int grid, int rpd) {
  static int occ_rs = 0, occ_ag = 0;
  cudaError_t err = check_resident(ring_rs_kernel<T>, &occ_rs,
                                   ag ? 1 : grid, rpd);
  if (err == cudaSuccess)
    err = check_resident(ring_ag_kernel<T>, &occ_ag, ag ? grid : 1, rpd);
  return err;
}

template <typename T>
cudaError_t launch_rs(const void* x, void* out, const Team& team, u64* ctl,
                      int m, int kv, long land_off, long flag_off, int grid,
                      int rpd, cudaStream_t st) {
  cudaError_t err = resident<T>(false, grid, rpd);
  if (err != cudaSuccess) return err;
  ring_rs_kernel<T><<<grid, NT, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), team, ctl, m,
      kv, land_off, flag_off);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ag(const void* x, void* out, const Team& team, u64* ctl,
                      int m, int kv, long rows_off, long flag_off, int grid,
                      int rpd, cudaStream_t st) {
  cudaError_t err = resident<T>(true, grid, rpd);
  if (err != cudaSuccess) return err;
  ring_ag_kernel<T><<<grid, NT, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), team, ctl, m,
      kv, rows_off, flag_off);
  return cudaGetLastError();
}

cudaError_t launch_full_mesh(const void* x, void* out, const Team& team,
                             u64* ctl, long shard, int grid, int rpd,
                             cudaStream_t st) {
  static int occ = 0;
  cudaError_t err = check_resident(full_mesh_ag_kernel, &occ, grid, rpd);
  if (err != cudaSuccess) return err;
  full_mesh_ag_kernel<<<grid, NT, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), team, ctl,
      shard);
  return cudaGetLastError();
}

bool valid(int rank, int world, int m, int kv, int grid, int rpd) {
  return world >= 2 && world <= td::dist::kMaxWorld && rank >= 0 &&
         rank < world && m > 0 && kv > 0 && grid >= 1 && grid <= kv &&
         rpd >= 1;
}

}  // namespace

extern "C" {

// B9. x: (world * m, K), out: (m, K), one dtype (td::F32 or td::BF16),
// contiguous, 16-byte aligned, kv = K * itemsize / 16 vectors per row;
// base: device table of every rank's symmetric buffer (landing slots
// (2, world - 1, m, K) at byte land_off, flags (grid, world - 1) u64 at
// flag_off, zeroed once); ctl: this rank's control block (4 u64, zeroed
// once); grid: blocks, the same on every rank; ranks_per_device: ranks
// that share this card. Returns a cudaError_t.
int td_ring_rs(const void* x, void* out, int rank, int world,
               const void* base, void* ctl, int m, int kv,
               long long land_off, long long flag_off, int grid,
               int ranks_per_device, int dtype, void* stream) {
  if (!valid(rank, world, m, kv, grid, ranks_per_device))
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* c = static_cast<u64*>(ctl);
  if (dtype == td::F32)
    return static_cast<int>(launch_rs<float>(
        x, out, team, c, m, kv, land_off, flag_off, grid, ranks_per_device,
        st));
  if (dtype == td::BF16)
    return static_cast<int>(launch_rs<__nv_bfloat16>(
        x, out, team, c, m, kv, land_off, flag_off, grid, ranks_per_device,
        st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// B7. x: (m, K), out: (world * m, K); as td_ring_rs, with the gathered
// rows (2, world * m, K) at byte rows_off of the symmetric buffer and the
// flags (grid, world - 1) u64 at flag_off. Returns a cudaError_t.
int td_ring_ag(const void* x, void* out, int rank, int world,
               const void* base, void* ctl, int m, int kv,
               long long rows_off, long long flag_off, int grid,
               int ranks_per_device, int dtype, void* stream) {
  if (!valid(rank, world, m, kv, grid, ranks_per_device))
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* c = static_cast<u64*>(ctl);
  if (dtype == td::F32)
    return static_cast<int>(launch_ag<float>(
        x, out, team, c, m, kv, rows_off, flag_off, grid, ranks_per_device,
        st));
  if (dtype == td::BF16)
    return static_cast<int>(launch_ag<__nv_bfloat16>(
        x, out, team, c, m, kv, rows_off, flag_off, grid, ranks_per_device,
        st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// B8. x: (m, K), out: (world * m, K), any dtype, contiguous, 16-byte
// aligned, kv = K * itemsize / 16 vectors per row; base: device table of
// every rank's symmetric buffer (the gathered rows (2, world * m, K) from
// byte 0, the signal pad at sig_off, zeroed once); ctl: this rank's
// control block (4 u64, zeroed once); grid: blocks, the same on every
// rank; ranks_per_device: ranks that share this card. Returns a
// cudaError_t.
int td_full_mesh_ag(const void* x, void* out, int rank, int world,
                    const void* base, long long sig_off, void* ctl, int m,
                    int kv, int grid, int ranks_per_device, void* stream) {
  if (!valid(rank, world, m, kv, grid, ranks_per_device))
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), sig_off};
  return static_cast<int>(launch_full_mesh(
      x, out, team, static_cast<u64*>(ctl), static_cast<long>(m) * kv * 16,
      grid, ranks_per_device, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
