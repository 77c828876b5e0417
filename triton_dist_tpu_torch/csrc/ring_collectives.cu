// B9 (reduce-scatter), B7 (all-gather) and B8 (full-mesh all-gather)
// across ranks, hand-written for Hopper (sm_90a).
//
// Replace the TPU kernels kernels/reduce_scatter.py::_ring_rs_kernel,
// kernels/allgather.py::_ring_ag_kernel and ::_full_mesh_ag_kernel of the
// JAX package (methods RING_1D of reduce_scatter_per_device /
// all_gather_per_device, together all_reduce_per_device's TWO_SHOT; and
// all_gather_per_device's FULL_MESH).
//  * B9: every rank holds x (n*m, K); rank p returns row chunk p of the
//    sum over ranks, (m, K), folded in the reference ring's order:
//    x_{p+1} + x_{p+2} + ... + x_p (ranks mod n), each add rounded to x's
//    dtype, so every chunk has one value. The TPU's ring suits a torus of
//    neighbour links; an H100 host is an NVSwitch full mesh, so the ring's
//    n - 1 dependent hops become one: rank r stores its raw chunk p
//    straight into owner p's landing slot j = (r - p - 1) mod n, so slot j
//    holds the (j+1)-th term of p's fold, and the owner folds slot 0, 1,
//    ..., n - 2, then its own rows. The NVLink bytes a rank sends are the
//    ring's, (n - 1) m K, sent at once instead of in sequence; the adds are
//    the ring's too.
//  * B7: every rank holds x (m, K); every rank returns the (n*m, K) rows
//    of all ranks in rank order. Rank r stores its shard into slot
//    (r - p - 1) mod n of every peer p and its own rows straight into out;
//    each block copies its column slice of each slot out as it lands.
//  * B8: every rank holds x (m, K); every rank returns the (n*m, K) rows
//    of all ranks in rank order, each rank's shard pushed straight into
//    slot `rank` of every rank's buffer (one hop on NVSwitch).
//
// What bounds them on this card. At the decode shape of the TWO_SHOT path
// (Qwen3-32B at TP=4, x (16, 5120) bf16) a rank sends 3 x 40 KB: under a
// microsecond of NVLink time at 450 GB/s, so B9 and B7 are bound by
// latency (the launch, one store across the switch, its signal). On a
// 512-token prefill chunk x is 5.2 MB: B9 sends 3 x 1.3 MB per rank, ~9 us
// of NVLink time, B7 the same. B8 moves B7's bytes in one hop with a flag
// per rank.
//
// Design of B9 and B7 (their legs, protocols and epochs live in
// td_oneshot.cuh, shared with B6 in allreduce.cu):
//  * a plan (kernels/reduce_scatter.py::ring_plan, the same on every rank)
//    fixes the grid G, the landing slots (2 parities x n - 1 slots of
//    slot_bytes from byte 0 of the symmetric buffer: slot j of parity P
//    at (P (n - 1) + j) slot_bytes) and the flags (u64 [b (n - 1) + j]
//    from byte flag_off). Block b owns the 16-byte column vectors
//    [b kv / G, (b + 1) kv / G) of every row and exchanges data and
//    signals only with block b of its peers, so no block waits for
//    another block of its own rank;
//  * two protocols, fixed by the plan from the bytes of a slot
//    (reduce_scatter.py LL_MAX_SLOT_BYTES, from a chip sweep):
//    - LL (small blocks): the signal rides in the data, as in NCCL's LL
//      protocol. Each 16-byte vector travels as two 16-byte lines
//      {4 data bytes, epoch, 4 data bytes, epoch} (volatile stores, no
//      fence, no flag); the receiver polls its lines until both epoch
//      words of each equal this call's. Twice the bytes on the wire, no
//      round trip for a fence;
//    - flags (large blocks): plain 16-byte stores; then a block barrier,
//      and threads 0..n-2 each raise one peer's flag (b, slot) to the
//      epoch with a system fence and a release store; on the receiving
//      side thread s polls flag (b, s) (acquire, a tight spin before any
//      sleep), and after a block barrier the block reads its slots with
//      L1-bypassing loads (the n - 1 waits in parallel: waiting slot by
//      slot measured ~2 us slower for B7 at every size);
//  * a B9 thread loads all of an item's n - 1 terms before it stores or
//    adds any, a B7 thread four items under flags, so memory latencies
//    overlap (at 512 rows a thread has ~10 items a slot on one card);
//  * each block keeps its own epoch in the rank's control block (word
//    kCtlHeader + b): read at the start, e = epoch + 1, stored at the end.
//    No atomics: the next launch on the stream begins after this one
//    ended. Flags are set to e and waited for >= e; LL lines must equal
//    e (32 bits). So the epoch advances on the device, under a CUDA graph
//    replay too, and every rank makes the same sequence of calls;
//  * the slots are double-buffered by the epoch's parity, with no opening
//    barrier. Rank r writes peer p's slots of parity P in call e + 2 only
//    after it finished call e + 1. In call e + 1 every rank receives a
//    slot from every peer, so r waited there for p's data of call e + 1,
//    which p sent only after its call e kernel (the last to read those
//    slots of parity P) had ended;
//  * the grid is small enough that every block of every rank that shares
//    the card is resident at once (G <= SMs / ranks per card, checked
//    against the kernel's occupancy).
//
// B8 shares B10's gather leg (td_dist.cuh push_all): the grid splits the
// shard's bytes, each block stores its share into slot `rank` of every
// rank's gathered rows, and the last block of the grid to finish raises
// this rank's data flag (epoch-valued) on every rank; every block waits
// for the n flags and copies its share of the gathered rows out. The
// gathered rows are double-buffered by the epoch's parity, with no
// opening barrier: rank r writes a peer's rows of call e + 2 only after
// call e + 1, which waited for every peer's flag of call e + 1, raised
// only after that peer's call e kernel had ended.

#include "td_common.cuh"
#include "td_dist.cuh"
#include "td_oneshot.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;
using namespace td::oneshot;

// B9. The peer at distance i + 1 (owner me + 1 + i) takes this rank's
// rows in its slot n - 2 - i; slot s of this rank holds the rows of rank
// me + 1 + s. A thread loads an item's n - 1 terms before it stores or
// adds any, so their latencies overlap.
template <typename T, bool LL>
__global__ void __launch_bounds__(NT)
    ring_rs_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                   Team team, u64* ctl, int m, int kv, long slot_bytes,
                   long flag_off) {
  const int me = team.rank, n = team.world;
  const Epoch ep(ctl);
  const unsigned f = static_cast<unsigned>(ep.e);
  const Cols cols(kv);
  const long items = static_cast<long>(m) * cols.cw;
  const long par = static_cast<long>(ep.e & 1) * (n - 1) * slot_bytes;
  scatter_chunks<LL>(x, team, cols, m, kv, par, slot_bytes, f);
  if (!LL) exchange_flags(team, flag_off, ep.e, "B9 reduce-scatter slot");
  const char* land = team.peer(me) + par;
  for (long j = threadIdx.x; j < items; j += NT) {
    const long v = cols.at(j, 0, kv);
    uint4 term[kPeers];
#pragma unroll
    for (int s = 0; s < kPeers; ++s)
      if (s < n - 1)
        term[s] = get_vec<LL>(land + s * slot_bytes, v, f,
                              "B9 reduce-scatter line", (me + 1 + s) % n);
    const uint4 own = x[cols.at(j, static_cast<long>(me) * m, kv)];
    uint4 acc = term[0];
#pragma unroll
    for (int s = 1; s < kPeers; ++s)
      if (s < n - 1) acc = add_vec<T>(acc, term[s]);
    out[v] = add_vec<T>(acc, own);
  }
  ep.close();
}

// B7. As B9's slots: this rank's shard goes to slot n - 2 - i of the
// peer at distance i + 1, slot s of this rank holds rank me + 1 + s's
// rows, copied out as its lines land (LL) or once the block's flags are
// up (gather_slots). Under flags a thread loads kBatch items before it
// stores any, so their latencies overlap; under LL (a few items a block:
// the plan keeps LL blocks small) one at a time measured faster on the
// card.
template <bool LL>
__global__ void __launch_bounds__(NT)
    ring_ag_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                   Team team, u64* ctl, int m, int kv, long slot_bytes,
                   long flag_off) {
  const int me = team.rank, n = team.world;
  const Epoch ep(ctl);
  const unsigned f = static_cast<unsigned>(ep.e);
  const Cols cols(kv);
  const long items = static_cast<long>(m) * cols.cw;
  const long par = static_cast<long>(ep.e & 1) * (n - 1) * slot_bytes;
  constexpr int kB = LL ? 1 : kBatch;
  uint4 val[kBatch];
  for (long j0 = threadIdx.x; j0 < items; j0 += kB * NT) {
#pragma unroll
    for (int u = 0; u < kB; ++u)
      if (j0 + u * NT < items) val[u] = x[cols.at(j0 + u * NT, 0, kv)];
#pragma unroll
    for (int u = 0; u < kB; ++u) {
      const long j = j0 + u * NT;
      if (j >= items) break;
      const long v = cols.at(j, 0, kv);
#pragma unroll
      for (int i = 0; i < kPeers; ++i)
        if (i < n - 1)
          put_vec<LL>(team.peer((me + 1 + i) % n) + par +
                          (n - 2 - i) * slot_bytes, v, val[u], f);
      out[cols.at(j, static_cast<long>(me) * m, kv)] = val[u];
    }
  }
  if (!LL) exchange_flags(team, flag_off, ep.e, "B7 all-gather slot");
  gather_slots<LL>(out, team, cols, m, kv, par, slot_bytes, f,
                   "B7 all-gather line");
  ep.close();
}

// The latency floor of a one-hop kernel: ranks 0 and 1 bounce one flag
// kRoundTrips times (0 raises 1's flag to k, 1 waits for k and raises 0's
// flag to k, 0 waits for it); the other ranks return at once. Flags: the
// u64 at byte 0 of each rank's buffer; ctl[kCtlHeader]: the last k, which
// both ranks advance by kRoundTrips a call, so they start every call from
// the same base.
constexpr int kRoundTrips = 2000;

__global__ void pingpong_kernel(Team team, u64* ctl) {
  const int me = team.rank;
  if (threadIdx.x != 0 || me > 1) return;
  u64* last = ctl + td::dist::kCtlHeader;
  const u64 base = *last;
  u64* mine = flags(team, me, 0);
  u64* theirs = flags(team, 1 - me, 0);
  for (int k = 1; k <= kRoundTrips; ++k) {
    if (me == 0) td::dist::notify(theirs, base + k);
    await_flag(mine, base + k, "ping-pong flag", 1 - me);
    if (me == 1) td::dist::notify(theirs, base + k);
  }
  *last = base + kRoundTrips;
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

template <typename T, bool LL>
int occ_rs = 0;
template <bool LL>
int occ_ag = 0;

// Every B9 / B7 kernel is queried (and so loaded) at the first call of
// any: TWO_SHOT launches B7 right after B9, and a lazy load behind a
// spinning kernel could wait for ranks not yet launched on a shared card.
cudaError_t load_ring_kernels() {
  cudaError_t err =
      check_resident(ring_rs_kernel<float, false>, &occ_rs<float, false>, 1, 1);
  if (err == cudaSuccess)
    err = check_resident(ring_rs_kernel<float, true>, &occ_rs<float, true>, 1,
                         1);
  if (err == cudaSuccess)
    err = check_resident(ring_rs_kernel<__nv_bfloat16, false>,
                         &occ_rs<__nv_bfloat16, false>, 1, 1);
  if (err == cudaSuccess)
    err = check_resident(ring_rs_kernel<__nv_bfloat16, true>,
                         &occ_rs<__nv_bfloat16, true>, 1, 1);
  if (err == cudaSuccess)
    err = check_resident(ring_ag_kernel<false>, &occ_ag<false>, 1, 1);
  if (err == cudaSuccess)
    err = check_resident(ring_ag_kernel<true>, &occ_ag<true>, 1, 1);
  return err;
}

struct RingArgs {
  const uint4* x;
  uint4* out;
  Team team;
  u64* ctl;
  int m, kv;
  long slot_bytes, flag_off;
  int grid, rpd;
};

template <typename T, bool LL>
cudaError_t launch_rs(const RingArgs& a, cudaStream_t st) {
  cudaError_t err = load_ring_kernels();
  if (err == cudaSuccess)
    err = check_resident(ring_rs_kernel<T, LL>, &occ_rs<T, LL>, a.grid, a.rpd);
  if (err != cudaSuccess) return err;
  ring_rs_kernel<T, LL><<<a.grid, NT, 0, st>>>(
      a.x, a.out, a.team, a.ctl, a.m, a.kv, a.slot_bytes, a.flag_off);
  return cudaGetLastError();
}

template <bool LL>
cudaError_t launch_ag(const RingArgs& a, cudaStream_t st) {
  cudaError_t err = load_ring_kernels();
  if (err == cudaSuccess)
    err = check_resident(ring_ag_kernel<LL>, &occ_ag<LL>, a.grid, a.rpd);
  if (err != cudaSuccess) return err;
  ring_ag_kernel<LL><<<a.grid, NT, 0, st>>>(
      a.x, a.out, a.team, a.ctl, a.m, a.kv, a.slot_bytes, a.flag_off);
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

// B9 / B7's checks and arguments; false if the call is not taken.
bool ring_args(RingArgs* a, const void* x, void* out, int rank, int world,
               const void* base, void* ctl, int m, int kv,
               long long slot_bytes, long long flag_off, int grid, int ll,
               int rpd) {
  if (!valid(rank, world, m, kv, grid, rpd) || (ll != 0 && ll != 1) ||
      slot_bytes % 16 || flag_off % 8 ||
      slot_bytes < static_cast<long long>(m) * kv * 16 * (ll ? 2 : 1))
    return false;
  *a = RingArgs{static_cast<const uint4*>(x), static_cast<uint4*>(out),
                Team{rank, world, static_cast<const long long*>(base), 0},
                static_cast<u64*>(ctl), m, kv, static_cast<long>(slot_bytes),
                static_cast<long>(flag_off), grid, rpd};
  return true;
}

}  // namespace

extern "C" {

// B9. x: (world * m, K), out: (m, K), one dtype (td::F32 or td::BF16),
// contiguous, 16-byte aligned, kv = K * itemsize / 16 vectors per row;
// base: device table of every rank's symmetric buffer, laid out by the
// plan (kernels/reduce_scatter.py::ring_plan): landing slots (2, world -
// 1) of slot_bytes from byte 0, LL lines if ll else plain vectors,
// flags (grid, world - 1) u64 at flag_off (unused under LL), zeroed once;
// ctl: this rank's control block (kCtlHeader + grid u64, zeroed once);
// grid: blocks, the same on every rank; ranks_per_device: ranks that share
// this card. Returns a cudaError_t.
int td_ring_rs(const void* x, void* out, int rank, int world,
               const void* base, void* ctl, int m, int kv,
               long long slot_bytes, long long flag_off, int grid, int ll,
               int ranks_per_device, int dtype, void* stream) {
  RingArgs a;
  if (!ring_args(&a, x, out, rank, world, base, ctl, m, kv, slot_bytes,
                 flag_off, grid, ll, ranks_per_device))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == td::F32)
    return static_cast<int>(ll ? launch_rs<float, true>(a, st)
                               : launch_rs<float, false>(a, st));
  if (dtype == td::BF16)
    return static_cast<int>(ll ? launch_rs<__nv_bfloat16, true>(a, st)
                               : launch_rs<__nv_bfloat16, false>(a, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// B7. x: (m, K), out: (world * m, K), any dtype, contiguous, 16-byte
// aligned; the rest as td_ring_rs. Returns a cudaError_t.
int td_ring_ag(const void* x, void* out, int rank, int world,
               const void* base, void* ctl, int m, int kv,
               long long slot_bytes, long long flag_off, int grid, int ll,
               int ranks_per_device, void* stream) {
  RingArgs a;
  if (!ring_args(&a, x, out, rank, world, base, ctl, m, kv, slot_bytes,
                 flag_off, grid, ll, ranks_per_device))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(ll ? launch_ag<true>(a, st)
                             : launch_ag<false>(a, st));
}

// The flag ping-pong between ranks 0 and 1: kRoundTrips round trips, one
// block of one warp; base: every rank's symmetric buffer (a u64 flag at
// byte 0, zeroed once); ctl: this rank's control block (kCtlHeader + 1
// u64, zeroed once). Every rank of the world calls it. Returns a
// cudaError_t.
int td_ring_pingpong(int rank, int world, const void* base, void* ctl,
                     void* stream) {
  if (world < 2 || world > td::dist::kMaxWorld || rank < 0 || rank >= world)
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), 0};
  pingpong_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      team, static_cast<u64*>(ctl));
  return static_cast<int>(cudaGetLastError());
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
