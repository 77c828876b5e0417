// B5 (one-shot) and B6 (the halving tree's all-reduce) across ranks,
// hand-written for Hopper (sm_90a).
//
// Replace the TPU kernels kernels/allreduce.py::_one_shot_kernel and
// ::_rhd_kernel of the JAX package (all_reduce_per_device, methods
// ONE_SHOT and RHD): every rank holds x (M, K) and returns the sum over
// ranks, accumulated in x's dtype (each add rounded to it, as the TPU
// kernels' `acc[:] + term[:]` on bf16 rounds), into a fresh tensor.
//  * B5: every rank's x reaches every peer; then acc = own, and for i
//    ascending, skipping `rank`, acc = acc + term i. The order depends on
//    the rank (kept exactly: results may differ from rank to rank in the
//    last bit).
//  * B6: the reference's recursive halving-doubling, whose value is the
//    halving tree's fold of the n terms (pairs at distance n/2, then n/4,
//    ..., 1: at n = 4, (x0 + x2) + (x1 + x3); kernels/plain.py rhd_fold),
//    the same for every row and every rank because a + b == b + a in
//    float. The TPU's log2(n) halving and log2(n) doubling steps suit a
//    torus; an H100 host is an NVSwitch full mesh, so the dependent chain
//    of 2 log2(n) flag round trips becomes one hop (or two): the tree is
//    folded wherever all n terms land. Power-of-two n, M a multiple of n
//    (the wrapper checks). Every rank returns the same bytes.
//
// What bounds them on this card. On the decode path (Qwen3-32B at TP=4,
// batch 16) x is (16, 5120) bf16, 160 KB: B5 sends 3 x 160 KB per rank,
// about a microsecond of NVLink time at 450 GB/s; the kernels are bound
// by latency (a flag's trip across the switch, the launch), not bytes. A
// 512-token prefill chunk is 5.2 MB: there bytes count.
//
// Design (td_oneshot.cuh: B9 / B7's slots, protocols and epochs; one
// kernel template for both, all_reduce_kernel; kernels/allreduce.py's
// rhd_plan and one_shot_plan fix everything below from the bytes of x,
// the same on every rank), one launch a call. B6 has two regimes, B5 the
// first:
//  * one-shot (B5 always; B6 at small x, decode): every rank stores its
//    whole x into its slot of every peer (sender-indexed: slot (r - p - 1)
//    mod n of rank p holds rank r's x), then folds the n terms locally, B6
//    by the halving tree, B5 own first, then ascending. One hop: one
//    signal latency;
//  * two-shot (large x, prefill chunks): B9's scatter leg (row chunk p of
//    every rank into owner p's slots), owner p folds chunk p's n terms by
//    the halving tree and stores the folded rows into its out and into
//    its slot of every peer's second region, then B7's gather leg copies
//    the n - 1 other folded chunks out. 2 (n - 1) / n of x on the wire
//    instead of (n - 1) x, for one more signal latency;
//  * either regime under LL lines (the epoch in every 16-byte line, no
//    fence, twice the bytes) or flags (one fence a publishing thread), by
//    the bytes of a slot (B6: reduce_scatter.py LL_MAX_SLOT_BYTES; B5:
//    allreduce.py ONE_SHOT_LL_MAX_SLOT_BYTES, from a four-card sweep);
//    block b owns a column slice of every row, a vector a thread; each
//    block keeps its own epoch word; slots double-buffered by the epoch's
//    parity, with no opening barrier (every rank receives from every peer
//    in each region of each call, so finishing call e + 1 proves each
//    peer ended call e);
//  * a thread loads an item's n terms before it adds any (their latencies
//    overlap), then adds them in the fold's order, each add rounded to T;
//  * every B5 / B6 kernel is loaded at the first call of any, and the grid
//    leaves every block of every rank that shares the card resident (at
//    most one block an SM a rank).

#include "td_common.cuh"
#include "td_dist.cuh"
#include "td_oneshot.cuh"

namespace {

using td::dist::Team;
using td::dist::u64;
using namespace td::oneshot;

// The fold of the n terms: B6's halving tree, or B5's own term first,
// then the others in ascending rank.
enum Fold { kTree, kOwnFirst };

// B5 (F = kOwnFirst, one-shot) and B6 (F = kTree). The slots of the first
// region (one-shot: x's m rows; two-shot: a row chunk of m rows) from
// byte 0, their flags (G, n - 1) at flag_off; two-shot: the second
// region's slots (the folded chunks) from byte ag_off, flags at
// ag_flag_off. This rank's term of an item is x's (own rows); rank r's is
// slot (r - me - 1) mod n.
template <typename T, bool LL, bool TWO, Fold F>
__global__ void __launch_bounds__(NT)
    all_reduce_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                      Team team, u64* ctl, int m, int kv, long slot_bytes,
                      long flag_off, long ag_off, long ag_flag_off) {
  static_assert(F == kTree || !TWO, "B5 is one-shot");
  const int me = team.rank, n = team.world;
  const Epoch ep(ctl);
  const unsigned f = static_cast<unsigned>(ep.e);
  const Cols cols(kv);
  const long items = static_cast<long>(m) * cols.cw;
  const long par = static_cast<long>(ep.e & 1) * (n - 1) * slot_bytes;
  const long own0 = TWO ? static_cast<long>(me) * m : 0;  // own rows
  if (TWO) {
    scatter_chunks<LL>(x, team, cols, m, kv, par, slot_bytes, f);
  } else {
    for (long j = threadIdx.x; j < items; j += NT) {
      const long v = cols.at(j, 0, kv);
      const uint4 val = x[v];
#pragma unroll
      for (int i = 0; i < kPeers; ++i)
        if (i < n - 1)
          put_vec<LL>(team.peer((me + 1 + i) % n) + par +
                          (n - 2 - i) * slot_bytes, v, val, f);
    }
  }
  if (!LL)
    exchange_flags(team, flag_off, ep.e,
                   F == kTree ? "B6 reduce slot" : "B5 slot");
  const char* land = team.peer(me) + par;
  for (long j = threadIdx.x; j < items; j += NT) {
    const long v = cols.at(j, 0, kv);
    const uint4 own = x[cols.at(j, own0, kv)];
    uint4 t[td::dist::kMaxWorld];
#pragma unroll
    for (int r = 0; r < td::dist::kMaxWorld; ++r)
      if (r < n)
        t[r] = r == me ? own
                       : get_vec<LL>(land + ((r - me - 1 + n) % n) *
                                                slot_bytes,
                                     v, f,
                                     F == kTree ? "B6 reduce line"
                                                : "B5 line", r);
    if (F == kTree) {
      // the halving tree: pairs at distance n/2, then n/4, ..., 1
#pragma unroll
      for (int d = td::dist::kMaxWorld / 2; d >= 1; d /= 2)
        if (d < n) {
#pragma unroll
          for (int i = 0; i < d; ++i) t[i] = add_vec<T>(t[i], t[i + d]);
        }
    } else {
      // own first, then ascending rank (me's own term skipped)
      t[0] = me == 0 ? own : add_vec<T>(own, t[0]);
#pragma unroll
      for (int r = 1; r < td::dist::kMaxWorld; ++r)
        if (r < n && r != me) t[0] = add_vec<T>(t[0], t[r]);
    }
    out[cols.at(j, own0, kv)] = t[0];
    if (TWO) {
#pragma unroll
      for (int i = 0; i < kPeers; ++i)
        if (i < n - 1)
          put_vec<LL>(team.peer((me + 1 + i) % n) + ag_off + par +
                          (n - 2 - i) * slot_bytes, v, t[0], f);
    }
  }
  if (TWO) {
    if (!LL) exchange_flags(team, ag_flag_off, ep.e, "B6 gather slot");
    gather_slots<LL>(out, team, cols, m, kv, ag_off + par, slot_bytes, f,
                     "B6 gather line");
  }
  ep.close();
}

template <typename T, bool LL, bool TWO, Fold F>
int occ = 0;

// Every B5 / B6 kernel is queried (and so loaded) at the first call of
// any: a lazy load behind a spinning kernel could wait for ranks not yet
// launched on a shared card.
cudaError_t load_kernels() {
  static bool done = false;
  if (done) return cudaSuccess;
  cudaError_t err = cudaSuccess;
#define TD_LOAD(TYPE, LL, TWO, F)                                        \
  if (err == cudaSuccess)                                                \
    err = check_resident(all_reduce_kernel<TYPE, LL, TWO, F>,            \
                         &occ<TYPE, LL, TWO, F>, 1, 1);
#define TD_LOAD_TYPE(TYPE)                   \
  TD_LOAD(TYPE, false, false, kTree)         \
  TD_LOAD(TYPE, false, true, kTree)          \
  TD_LOAD(TYPE, true, false, kTree)          \
  TD_LOAD(TYPE, true, true, kTree)           \
  TD_LOAD(TYPE, false, false, kOwnFirst)     \
  TD_LOAD(TYPE, true, false, kOwnFirst)
  TD_LOAD_TYPE(float)
  TD_LOAD_TYPE(__nv_bfloat16)
#undef TD_LOAD_TYPE
#undef TD_LOAD
  done = err == cudaSuccess;
  return err;
}

struct Args {
  const uint4* x;
  uint4* out;
  Team team;
  u64* ctl;
  int m, kv;
  long slot_bytes, flag_off, ag_off, ag_flag_off;
  int grid, rpd;
};

template <typename T, bool LL, bool TWO, Fold F>
cudaError_t launch(const Args& a, cudaStream_t st) {
  cudaError_t err = load_kernels();
  if (err == cudaSuccess)
    err = check_resident(all_reduce_kernel<T, LL, TWO, F>,
                         &occ<T, LL, TWO, F>, a.grid, a.rpd);
  if (err != cudaSuccess) return err;
  all_reduce_kernel<T, LL, TWO, F><<<a.grid, NT, 0, st>>>(
      a.x, a.out, a.team, a.ctl, a.m, a.kv, a.slot_bytes, a.flag_off,
      a.ag_off, a.ag_flag_off);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, bool ll, bool two, bool tree,
                     cudaStream_t st) {
  if (!tree)
    return ll ? launch<T, true, false, kOwnFirst>(a, st)
              : launch<T, false, false, kOwnFirst>(a, st);
  if (ll)
    return two ? launch<T, true, true, kTree>(a, st)
               : launch<T, true, false, kTree>(a, st);
  return two ? launch<T, false, true, kTree>(a, st)
             : launch<T, false, false, kTree>(a, st);
}

bool valid(int rank, int world, int m, int kv, int grid, int rpd) {
  return world >= 1 && world <= td::dist::kMaxWorld && rank >= 0 &&
         rank < world && m > 0 && kv > 0 && grid >= 1 && grid <= kv &&
         rpd >= 1;
}

}  // namespace

extern "C" {

// B5 and B6. x, out: (M, K) of one dtype (td::F32 or td::BF16),
// contiguous, 16-byte aligned, kv = K * itemsize / 16 vectors per row.
// tree: B6 (world a power of two) or B5 (one-shot, any world). The plan
// (kernels/allreduce.py's rhd_plan / one_shot_plan, the same on every
// rank): two_shot (m = M / world rows a slot) or one-shot (m = M); ll:
// the LL protocol (slots of LL lines) or flags; grid: blocks. base: device
// table of every rank's symmetric buffer: the first region's slots (2,
// world - 1) of slot_bytes from byte 0 and their flags (grid, world - 1)
// u64 at flag_off (unused under LL); two-shot: the second region's slots
// from byte ag_off, flags at ag_flag_off; zeroed once. ctl: this rank's
// control block (kCtlHeader + grid u64, zeroed once); ranks_per_device:
// ranks that share this card. Returns a cudaError_t.
int td_all_reduce(const void* x, void* out, int rank, int world,
                  const void* base, void* ctl, int m, int kv,
                  long long slot_bytes, long long flag_off, long long ag_off,
                  long long ag_flag_off, int grid, int ll, int two_shot,
                  int tree, int ranks_per_device, int dtype, void* stream) {
  if (!valid(rank, world, m, kv, grid, ranks_per_device) ||
      (tree != 0 && tree != 1) || (tree && (world & (world - 1)) != 0) ||
      (!tree && two_shot != 0) || (ll != 0 && ll != 1) ||
      (two_shot != 0 && two_shot != 1) || slot_bytes % 16 || flag_off % 8 ||
      ag_off % 16 || ag_flag_off % 8 ||
      slot_bytes < static_cast<long long>(m) * kv * 16 * (ll ? 2 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const uint4*>(x),
               static_cast<uint4*>(out),
               Team{rank, world, static_cast<const long long*>(base), 0},
               static_cast<u64*>(ctl),
               m,
               kv,
               static_cast<long>(slot_bytes),
               static_cast<long>(flag_off),
               static_cast<long>(ag_off),
               static_cast<long>(ag_flag_off),
               grid,
               ranks_per_device};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == td::F32)
    return static_cast<int>(dispatch<float>(a, ll, two_shot, tree, st));
  if (dtype == td::BF16)
    return static_cast<int>(
        dispatch<__nv_bfloat16>(a, ll, two_shot, tree, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
