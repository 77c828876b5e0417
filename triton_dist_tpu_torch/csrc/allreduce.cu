// B5 (one-shot) and B6 (recursive halving-doubling) all-reduce across
// ranks, hand-written for Hopper (sm_90a).
//
// Replace the TPU kernels kernels/allreduce.py::_one_shot_kernel and
// ::_rhd_kernel of the JAX package (all_reduce_per_device, methods
// ONE_SHOT and RHD): every rank holds x (M, K) and returns the sum over
// ranks, accumulated in x's dtype (each add rounded to it, as the TPU
// kernels' `acc[:] + term[:]` on bf16 rounds), into a fresh tensor.
//  * B5: every rank stores its x into slot `rank` of every peer's landing
//    buffer; then acc = own, and for i ascending, skipping `rank`, acc =
//    acc + slot i. The order depends on the rank (kept exactly: results
//    may differ from rank to rank in the last bit).
//  * B6: log2(n) halving steps (step s: partner rank ^ (n >> (s+1)); send
//    the half of the live rows the partner keeps into the partner's
//    landing strip, then keep = keep + term), then log2(n) doubling steps
//    with the same partners in reverse, each writing its owned rows
//    straight into the partner's output rows. a + b == b + a in float, so
//    every owned shard has one value and every rank ends with the same
//    bytes. Power-of-two n, M a multiple of n (the wrapper checks).
//
// What bounds them on this card. On the decode path (Qwen3-32B at TP=4,
// batch 16) x is (16, 5120) bf16, 160 KB: B5 sends 3 x 160 KB per rank,
// B6 2 x (80 + 40) KB, about a microsecond of NVLink time at 450 GB/s;
// the kernels are bound by latency (flag round trips, launch), not bytes.
//
// Design:
//  * the grid is G blocks (the wrapper's choice, the same on every rank),
//    and block b owns a fixed slice of the columns (16-byte vectors) of
//    every row, in every step. Block b of a rank exchanges data and flags
//    only with block b of its peers, so no block waits for another block
//    of its own rank, and each (block, sender, step) has its own flag in
//    the symmetric buffer (epoch-valued: set to e, waited for >= e);
//  * a sender publishes with __threadfence_system() by every storing
//    thread, a block barrier, then a release store of the flag at system
//    scope; a receiver acquires the flag and reads what landed with
//    L1-bypassing loads;
//  * no barrier opens a call. B5 double-buffers its landing slots by the
//    epoch's parity: a rank in call e + 2 reuses the slots of call e only
//    after it finished call e + 1, which needed every peer's data of call
//    e + 1, which every peer sends only once it finished call e. B6's
//    landing strip has a disjoint region per step (a fast pair's step s+1
//    never lands on a slow pair's step s), and a rank writes a peer's
//    strip or output in call e + 1 only after that peer's data of call
//    e + 1 reached it, so the peer finished call e;
//  * B6's working rows and output live in the symmetric buffer (peers
//    write into them); the last step copies them out to the caller's
//    fresh tensor;
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
  // index of item i of `rows` rows starting at row r0
  __device__ __forceinline__ long at(long i, int r0, int kv) const {
    return static_cast<long>(r0 + i / cw) * kv + c0 + i % cw;
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

// B5. Symmetric buffer: landing (2, world, m, kv) vectors at land_off,
// flags (G, world) at flag_off.
template <typename T>
__global__ void __launch_bounds__(NT)
    one_shot_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                    Team team, u64* ctl, int m, int kv, long land_off,
                    long flag_off) {
  const int me = team.rank, world = team.world, b = blockIdx.x;
  const u64 e = td::dist::begin_call(ctl);
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
  if (threadIdx.x < world && threadIdx.x != me)
    td::dist::notify(flags(team, threadIdx.x, flag_off) + b * world + me, e);
  if (threadIdx.x == 0)
    for (int s = 0; s < world; ++s)
      if (s != me)
        td::dist::wait(flags(team, me, flag_off) + b * world + s, e,
                       "B5 one-shot data", s);
  __syncthreads();
  const uint4* land = buf(team, me, land_off) + parity * slot;
  for (long j = threadIdx.x; j < items; j += NT) {
    const long v = cols.at(j, 0, kv);
    uint4 acc = x[v];
    for (int s = 0; s < world; ++s)
      if (s != me) acc = add_vec<T>(acc, __ldcg(land + s * slot + v));
    out[v] = acc;
  }
  td::dist::end_call(ctl, e);
}

// B6. Symmetric buffer: working rows / output (m, kv) vectors at out_off,
// landing strip (m - m/world rows, per-step disjoint regions) at
// land_off, flags (G, 2, logn) at flag_off.
template <typename T>
__global__ void __launch_bounds__(NT)
    rhd_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
               Team team, u64* ctl, int m, int kv, long out_off,
               long land_off, long flag_off) {
  const int me = team.rank, world = team.world, b = blockIdx.x;
  const u64 e = td::dist::begin_call(ctl);
  const Cols cols(kv);
  int logn = 0;
  while ((1 << logn) < world) ++logn;
  uint4* own = buf(team, me, out_off);
  const uint4* land = buf(team, me, land_off);
  u64* my_flags = flags(team, me, flag_off) + static_cast<long>(b) * 2 * logn;

  int base = 0, land_row = 0;
  for (int s = 0; s < logn; ++s) {          // phase 1: halving
    const int half = m >> (s + 1);
    const int partner = me ^ (world >> (s + 1));
    const int bit = (me >> (logn - 1 - s)) & 1;
    const int keep_base = base + bit * half;
    const int send_base = base + (1 - bit) * half;
    const long items = static_cast<long>(half) * cols.cw;
    uint4* dst = buf(team, partner, land_off);
    for (long j = threadIdx.x; j < items; j += NT) {
      const long v = cols.at(j, send_base, kv);
      dst[cols.at(j, land_row, kv)] = s == 0 ? x[v] : __ldcg(own + v);
    }
    publish_to(flags(team, partner, flag_off) +
                   static_cast<long>(b) * 2 * logn + s, e);
    if (threadIdx.x == 0)
      td::dist::wait(my_flags + s, e, "B6 halving data", partner);
    __syncthreads();
    for (long j = threadIdx.x; j < items; j += NT) {
      const long v = cols.at(j, keep_base, kv);
      const uint4 keep = s == 0 ? x[v] : __ldcg(own + v);
      own[v] = add_vec<T>(keep, __ldcg(land + cols.at(j, land_row, kv)));
    }
    __threadfence();
    __syncthreads();
    base = keep_base;
    land_row += half;
  }
  for (int s = logn - 1; s >= 0; --s) {     // phase 2: doubling
    const int cur = m >> (s + 1);
    const int partner = me ^ (world >> (s + 1));
    const int bit = (me >> (logn - 1 - s)) & 1;
    const long items = static_cast<long>(cur) * cols.cw;
    uint4* dst = buf(team, partner, out_off);
    for (long j = threadIdx.x; j < items; j += NT) {
      const long v = cols.at(j, base, kv);
      dst[v] = __ldcg(own + v);
    }
    publish_to(flags(team, partner, flag_off) +
                   static_cast<long>(b) * 2 * logn + logn + s, e);
    if (threadIdx.x == 0)
      td::dist::wait(my_flags + logn + s, e, "B6 doubling data", partner);
    __syncthreads();
    base -= bit * cur;
  }
  const long items = static_cast<long>(m) * cols.cw;
  for (long j = threadIdx.x; j < items; j += NT) {
    const long v = cols.at(j, 0, kv);
    out[v] = logn == 0 ? x[v] : __ldcg(own + v);
  }
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

template <typename T>
cudaError_t launch_one_shot(const void* x, void* out, const Team& team,
                            u64* ctl, int m, int kv, long land_off,
                            long flag_off, int grid, int rpd,
                            cudaStream_t st) {
  static int occ = 0;
  cudaError_t err = check_resident(one_shot_kernel<T>, &occ, grid, rpd);
  if (err != cudaSuccess) return err;
  one_shot_kernel<T><<<grid, NT, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), team, ctl, m,
      kv, land_off, flag_off);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_rhd(const void* x, void* out, const Team& team, u64* ctl,
                       int m, int kv, long out_off, long land_off,
                       long flag_off, int grid, int rpd, cudaStream_t st) {
  static int occ = 0;
  cudaError_t err = check_resident(rhd_kernel<T>, &occ, grid, rpd);
  if (err != cudaSuccess) return err;
  rhd_kernel<T><<<grid, NT, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), team, ctl, m,
      kv, out_off, land_off, flag_off);
  return cudaGetLastError();
}

bool valid(int rank, int world, int m, int kv, int grid, int rpd) {
  return world >= 1 && world <= td::dist::kMaxWorld && rank >= 0 &&
         rank < world && m > 0 && kv > 0 && grid >= 1 && grid <= kv &&
         rpd >= 1;
}

}  // namespace

extern "C" {

// B5. x, out: (m, K) of one dtype (td::F32 or td::BF16), contiguous,
// 16-byte aligned, kv = K * itemsize / 16 vectors per row; base: device
// table of every rank's symmetric buffer (landing slots (2, world, m, K)
// at byte land_off, flags (grid, world) u64 at flag_off, zeroed once);
// ctl: this rank's control block (4 u64, zeroed once); grid: blocks, the
// same on every rank; ranks_per_device: ranks that share this card.
// Returns a cudaError_t.
int td_one_shot(const void* x, void* out, int rank, int world,
                const void* base, void* ctl, int m, int kv, long long land_off,
                long long flag_off, int grid, int ranks_per_device, int dtype,
                void* stream) {
  if (!valid(rank, world, m, kv, grid, ranks_per_device))
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* c = static_cast<u64*>(ctl);
  if (dtype == td::F32)
    return static_cast<int>(launch_one_shot<float>(
        x, out, team, c, m, kv, land_off, flag_off, grid, ranks_per_device,
        st));
  if (dtype == td::BF16)
    return static_cast<int>(launch_one_shot<__nv_bfloat16>(
        x, out, team, c, m, kv, land_off, flag_off, grid, ranks_per_device,
        st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// B6. As td_one_shot, with world a power of two and m a multiple of it;
// the symmetric buffer holds the working rows (m, K) at out_off, the
// landing strip (m - m/world, K) at land_off and the flags (grid, 2,
// log2 world) u64 at flag_off. Returns a cudaError_t.
int td_rhd(const void* x, void* out, int rank, int world, const void* base,
           void* ctl, int m, int kv, long long out_off, long long land_off,
           long long flag_off, int grid, int ranks_per_device, int dtype,
           void* stream) {
  if (!valid(rank, world, m, kv, grid, ranks_per_device) ||
      (world & (world - 1)) != 0 || m % world != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* c = static_cast<u64*>(ctl);
  if (dtype == td::F32)
    return static_cast<int>(launch_rhd<float>(
        x, out, team, c, m, kv, out_off, land_off, flag_off, grid,
        ranks_per_device, st));
  if (dtype == td::BF16)
    return static_cast<int>(launch_rhd<__nv_bfloat16>(
        x, out, team, c, m, kv, out_off, land_off, flag_off, grid,
        ranks_per_device, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
