// The bidirectional ring's forwarding leg, shared by B11 (ag_gemm.cu) and
// B22 / B23 (ll_collectives.cu): a shard travels in row blocks of rb rows,
// each with its own epoch-valued flag per rank, raised by whoever stored
// it. Block b of a rank owns the row blocks j = b, b + G, ... of every
// chunk and talks only to block b of its neighbours, so no block waits for
// another block of its own rank.
#pragma once

#include "td_dist.cuh"

namespace td {
namespace ring {

using dist::Team;
using dist::u64;

// Row block j (rb rows; the last may be short) of chunk c, at the same
// place in every rank's gathered rows (this call's parity half, at byte
// par), and its flag there (flags (chunks, mb) u64 at byte flag_off).
struct RowBlocks {
  Team team;
  long par, flag_off, row_bytes;
  int m, rb, mb;
  __device__ __forceinline__ char* at(int p, int c, int j) const {
    return team.peer(p) + par +
           (static_cast<long>(c) * m + static_cast<long>(j) * rb) * row_bytes;
  }
  __device__ __forceinline__ long bytes(int j) const {
    return static_cast<long>(min(rb, m - j * rb)) * row_bytes;
  }
  __device__ __forceinline__ u64* flag(int p, int c, int j) const {
    return reinterpret_cast<u64*>(team.peer(p) + flag_off) +
           static_cast<long>(c) * mb + j;
  }
};

// This block stores row block j of chunk c (from src) into the ranks
// dst[0..nd), then raises its flag on each of them.
__device__ __forceinline__ void store_row_block(const RowBlocks& rbk,
                                                const char* src, int c, int j,
                                                const int* dst, int nd,
                                                u64 e) {
  for (int d = 0; d < nd; ++d)
    dist::put(rbk.at(dst[d], c, j), src, rbk.bytes(j));
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0)
    for (int d = 0; d < nd; ++d) dist::notify(rbk.flag(dst[d], c, j), e);
}

// Wait (thread 0) for row block j of chunk c on this rank, then let the
// block on.
__device__ __forceinline__ void wait_row_block(const RowBlocks& rbk, int c,
                                               int j, u64 e, int from,
                                               const char* what) {
  if (threadIdx.x == 0)
    dist::wait(rbk.flag(rbk.team.rank, c, j), e, what, from);
  __syncthreads();
}

// Both ring directions at once: round 0 stores the own shard's row blocks
// (from own, rb rows apart) into the ranks round0[0..n0); at round s >= 1
// chunk (me - s) has landed from the left and chunk (me + s) from the
// right, and each travels on in its direction while s < kr = n / 2 (or
// s < kl = (n - 1) / 2). The received chunks {me - 1 .. me - kr} and
// {me + 1 .. me + kl} are the n - 1 others.
__device__ __forceinline__ void bidir_ring_forward(const RowBlocks& rbk,
                                                   const char* own,
                                                   const int* round0, int n0,
                                                   u64 e, const char* what) {
  const int me = rbk.team.rank, world = rbk.team.world;
  const int right = (me + 1) % world, left = (me + world - 1) % world;
  const int kr = world / 2, kl = (world - 1) / 2;
  for (int j = blockIdx.x; j < rbk.mb; j += gridDim.x)
    store_row_block(rbk, own + static_cast<long>(j) * rbk.rb * rbk.row_bytes,
                    me, j, round0, n0, e);
  for (int s = 1; s < kr; ++s) {
    const int cr = (me - s + world) % world, cl = (me + s) % world;
    for (int j = blockIdx.x; j < rbk.mb; j += gridDim.x) {
      wait_row_block(rbk, cr, j, e, left, what);
      store_row_block(rbk, rbk.at(me, cr, j), cr, j, &right, 1, e);
      if (s < kl) {
        wait_row_block(rbk, cl, j, e, right, what);
        store_row_block(rbk, rbk.at(me, cl, j), cl, j, &left, 1, e);
      }
    }
  }
}

}  // namespace ring
}  // namespace td
