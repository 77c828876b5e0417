// B13a and B13b: the overlapped GEMM + ReduceScatter across ranks,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/gemm_reduce_scatter.py::_gemm_rs_kernel
// (the fused ring kernel that _pallas_gemm_rs_per_device launches for
// gemm_rs_per_device at n > 1, method PALLAS): every rank holds A (n*m,
// K_loc) and a (K_loc, N) row shard of W; rank d returns rows [d*m,
// (d+1)*m) of sum over ranks of A @ W, (m, N), from f32 partials with one
// cast.
//
// What bounds it on this card, and the design: gemm_land.cuh (the device
// code B4 across ranks shares), with kAll = false: each row lands only in
// the slot of the rank that keeps it. The JAX ring kernel adds in a
// rank-dependent ring order, this one in ascending sender rank, so the
// two agree to f32 rounding, not bit for bit.
//
// B13b replaces kernels/gemm_reduce_scatter.py::_gemm_rs_bidir_kernel
// (method PALLAS_BIDIR at n >= 3): the same function, the partials
// reduce-scattered over both ring directions in ceil((n - 1) / 2) rounds,
// each chunk's sum travelling to its owner along the shorter arc. With kr
// = n / 2 and kl = (n - 1) / 2, at round s the right chain computes the
// f32 partial of chunk (me + kr - s), the left chain that of chunk
// (me - kl + s); a rank adds its own product to what landed from the
// round before (own + arrival) and stores the sum into its neighbour's
// landing slot of this round; the last round folds the own chunk as own
// product + right arrival + left arrival, in that order, and casts once:
// the TPU kernel's fold (_make_rs_block_runner), kept here where B13a
// keeps its own order. Design:
//  * work items (phase, row tile, K slice, column tile) over the split-K
//    GEMM tile of gemm_splitk.cuh, phases in round order (right chain,
//    then left chain of each round, then the final fold), so an item only
//    ever waits for a phase before its own on a neighbour; every item
//    stores its K slice's f32 partial locally, and the last slice of a
//    tile to finish (a per-(phase, tile) counter) sums the slices in
//    slice order, waits (acquire) for the tile's arrival(s), adds them,
//    and stores the tile into the neighbour's landing slot and raises its
//    flag there (release, epoch-valued), or, in the final phase, casts it
//    into the output;
//  * one landing slot per (chain, round) and one flag per (chain, round,
//    tile), so a slot is written once a call; the slots are double-
//    buffered by the epoch's parity, with no opening barrier: a rank
//    writes a neighbour's slots of call e + 2 only after call e + 1, whose
//    final fold waited for both neighbours' sums of call e + 1, stored
//    after their call e kernels had ended;
//  * the grid is persistent and small enough that every block of every
//    rank that shares the card is resident at once.

#include "gemm_land.cuh"

namespace {

template <typename T, int MT, int U>
__global__ void __launch_bounds__(NT, 2)
    gemm_rs_bidir_kernel(const T* __restrict__ a, const T* __restrict__ w,
                         float* __restrict__ part, T* __restrict__ out,
                         Team team, u64* ctl, int m, int k_dim, int n_cols,
                         int k_chunk, int splits, long flag_off) {
  constexpr int BN = 32 * td::kVec<T>;
  const int me = team.rank, world = team.world, tid = threadIdx.x;
  const int right = (me + 1) % world, left = (me + world - 1) % world;
  const int kr = world / 2, kl = (world - 1) / 2;
  const int chains = kr + kl;   // landing slots: right rounds, left rounds
  const u64 e = td::dist::begin_call(ctl);
  const int m_tiles = (m + MT - 1) / MT;
  const int n_tiles = (n_cols + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles;
  const long per_phase = static_cast<long>(tiles) * splits;
  const long items = per_phase * (chains + 1);
  const long slot = static_cast<long>(m) * n_cols;      // floats
  const long par = static_cast<long>(e & 1) * chains * slot;
  u64* tile_done = ctl + td::dist::kCtlHeader;
  const auto flag = [&](int p, int sl, int tile) {
    return reinterpret_cast<u64*>(team.peer(p) + flag_off) +
           static_cast<long>(sl) * tiles + tile;
  };
  __shared__ bool last_slice;
  for (long it = blockIdx.x; it < items; it += gridDim.x) {
    const int ph = static_cast<int>(it / per_phase);
    const long rem = it % per_phase;
    const int mt = static_cast<int>(rem % m_tiles);
    const long rest = rem / m_tiles;
    const int ks = static_cast<int>(rest % splits);
    const int nt = static_cast<int>(rest / splits);
    // phase ph: round ph / 2 of the right (even) or left (odd) chain while
    // both chains run, then the right chain's last round when kr > kl,
    // then the final fold. c: the chunk; dst: where its sum goes (-1: the
    // output); in0 / in1: the landing slots it adds.
    int c, dst = -1, out_slot = -1, in0 = -1, in1 = -1;
    if (ph < chains) {
      const bool to_left = ph < 2 * kl && (ph & 1);
      const int s = ph < 2 * kl ? ph / 2 : kr - 1;
      if (to_left) {
        c = (me - kl + s + world) % world;
        dst = left;
        out_slot = kr + s;
        in0 = s > 0 ? kr + s - 1 : -1;
      } else {
        c = (me + kr - s) % world;
        dst = right;
        out_slot = s;
        in0 = s > 0 ? s - 1 : -1;
      }
    } else {
      c = me;
      in0 = kr - 1;
      in1 = kr + kl - 1;
    }
    gemm_tile<T, MT, U, false>(
        a + static_cast<long>(c) * m * k_dim, w, m, k_dim, n_cols, k_chunk,
        nt, ks, mt, [&](int row, int col, float sum) {
          part[((static_cast<long>(ph) * splits + ks) * m + row) * n_cols +
               col] = sum;
        });
    // the last K slice of this tile to finish folds and ships it
    __threadfence();
    __syncthreads();
    const int tile = nt * m_tiles + mt;
    u64* done = tile_done + static_cast<long>(ph) * tiles + tile;
    if (tid == 0) last_slice = atomicAdd(done, 1ull) == splits - 1;
    __syncthreads();
    if (!last_slice) continue;
    __threadfence();
    if (tid == 0) {
      if (in0 >= 0)
        td::dist::wait(flag(me, in0, tile), e, "B13b partial",
                       in0 < kr ? left : right);
      if (in1 >= 0)
        td::dist::wait(flag(me, in1, tile), e, "B13b partial", right);
    }
    __syncthreads();
    const float* land = reinterpret_cast<const float*>(team.peer(me)) + par;
    const int col = nt * BN + tid;
    if (tid < BN && col < n_cols) {
      for (int r = 0; r < MT; ++r) {
        const int row = mt * MT + r;
        if (row >= m) break;
        const long at = static_cast<long>(row) * n_cols + col;
        float sum = 0.f;
        for (int q = 0; q < splits; ++q)
          sum += __ldcg(part + (static_cast<long>(ph) * splits + q) * slot +
                        at);
        if (in0 >= 0) sum = sum + __ldcg(land + in0 * slot + at);
        if (in1 >= 0) sum = sum + __ldcg(land + in1 * slot + at);
        if (dst >= 0)
          reinterpret_cast<float*>(team.peer(dst))[par + out_slot * slot +
                                                   at] = sum;
        else
          out[at] = td::from_f<T>(sum);
      }
    }
    if (dst >= 0) {
      __threadfence_system();
      __syncthreads();
      if (tid == 0) td::dist::notify(flag(dst, out_slot, tile), e);
    }
    if (tid == 0) *done = 0;
  }
  td::dist::end_call(ctl, e);
}

template <typename T, int MT, int U>
cudaError_t launch_bidir(const void* a, const void* w, void* part, void* out,
                         const Team& team, u64* ctl, int m, int k_dim,
                         int n_cols, int k_chunk, int splits, int rpd,
                         long flag_off, cudaStream_t stream) {
  constexpr int BN = 32 * td::kVec<T>;
  // queried once per instantiation (the first call, never under a CUDA
  // graph capture: callers warm up first)
  static int sms = 0, occ = 0;
  cudaError_t err = cudaSuccess;
  if (occ == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, gemm_rs_bidir_kernel<T, MT, U>, NT, 0);
    if (err != cudaSuccess) {
      occ = 0;
      return err;
    }
  }
  const int chains = team.world / 2 + (team.world - 1) / 2;
  const long items = static_cast<long>((m + MT - 1) / MT) * splits *
                     ((n_cols + BN - 1) / BN) * (chains + 1);
  const long resident = static_cast<long>(occ) * sms / rpd;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const unsigned grid = static_cast<unsigned>(items < resident ? items
                                                               : resident);
  gemm_rs_bidir_kernel<T, MT, U><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(w),
      static_cast<float*>(part), static_cast<T*>(out), team, ctl, m, k_dim,
      n_cols, k_chunk, splits, flag_off);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bidir(const void* a, const void* w, void* part,
                           void* out, const Team& team, u64* ctl, int m,
                           int k_dim, int n_cols, int k_chunk, int splits,
                           int rpd, long flag_off, cudaStream_t st) {
  if (m == 1)
    return launch_bidir<T, 1, 8>(a, w, part, out, team, ctl, m, k_dim,
                                 n_cols, k_chunk, splits, rpd, flag_off, st);
  if (m == 2)
    return launch_bidir<T, 2, 8>(a, w, part, out, team, ctl, m, k_dim,
                                 n_cols, k_chunk, splits, rpd, flag_off, st);
  if (m <= 4)
    return launch_bidir<T, 4, 8>(a, w, part, out, team, ctl, m, k_dim,
                                 n_cols, k_chunk, splits, rpd, flag_off, st);
  return launch_bidir<T, 8, 4>(a, w, part, out, team, ctl, m, k_dim, n_cols,
                               k_chunk, splits, rpd, flag_off, st);
}

}  // namespace

// a: (world*m, K) rows of every destination; the rest as td_gemm_land
// (gemm_land.cuh). Returns a cudaError_t.
extern "C" int td_gemm_rs(const void* a, const void* w, void* part,
                          void* out, int rank, int world, const void* base,
                          long long sig_off, void* ctl, int m, int k_dim,
                          int n_cols, int k_chunk, int splits,
                          int ranks_per_device, int dtype, void* stream) {
  return td_gemm_land<false>(a, w, part, out, rank, world, base, sig_off,
                             ctl, m, k_dim, n_cols, k_chunk, splits,
                             ranks_per_device, dtype, stream);
}

// B13b, world >= 3. a: (world*m, K) rows of every destination; w: (K, N)
// weight shard; out: this rank's (m, N) rows; part: f32 (world / 2 +
// (world - 1) / 2 + 1, splits, m, N) workspace; base: device table of
// every rank's symmetric buffer (landing slots (2, world / 2 + (world -
// 1) / 2, m, N) f32 from byte 0, halves by the epoch's parity; the flags,
// one u64 per (slot, row tile, column tile), zeroed once, at byte
// flag_off); ctl: this rank's control block, zeroed once: 4 u64, then a
// counter per (phase, row tile, column tile) ((slots + 1) * m *
// ceil(N / BN) words cover any row tile); ranks_per_device: ranks that
// share this card. One dtype (td::F32 or td::BF16); N a multiple of the
// 16-byte vector; 16-byte aligned pointers. Returns a cudaError_t.
extern "C" int td_gemm_rs_bidir(const void* a, const void* w, void* part,
                                void* out, int rank, int world,
                                const void* base, long long flag_off,
                                void* ctl, int m, int k_dim, int n_cols,
                                int k_chunk, int splits,
                                int ranks_per_device, int dtype,
                                void* stream) {
  if (world < 3 || world > td::dist::kMaxWorld || rank < 0 ||
      rank >= world || m <= 0 || k_dim <= 0 || n_cols <= 0 ||
      k_chunk <= 0 || splits <= 0 || ranks_per_device < 1 ||
      static_cast<long>(k_chunk) * splits < k_dim || part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Team team{rank, world, static_cast<const long long*>(base), 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  u64* c = static_cast<u64*>(ctl);
  if (dtype == td::F32 && n_cols % td::kVec<float> == 0)
    return static_cast<int>(dispatch_bidir<float>(
        a, w, part, out, team, c, m, k_dim, n_cols, k_chunk, splits,
        ranks_per_device, flag_off, st));
  if (dtype == td::BF16 && n_cols % td::kVec<__nv_bfloat16> == 0)
    return static_cast<int>(dispatch_bidir<__nv_bfloat16>(
        a, w, part, out, team, c, m, k_dim, n_cols, k_chunk, splits,
        ranks_per_device, flag_off, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
