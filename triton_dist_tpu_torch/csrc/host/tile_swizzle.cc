// The AllGather + MoE tile schedule on the host, behind the native schedule
// provider (kernels/moe_utils.py, make_chunk_schedule(provider="native")):
// given per-(rank, expert) token counts, emit the (stage, expert, tile)
// consumption order for the overlapped AllGather + grouped GEMM: tiles of
// the shard arriving at ring stage s become runnable at stage s, and each
// rank starts at its own shard (rank-rotated), so no tile ever waits on a
// shard that has not landed. Built with g++, loaded with ctypes
// (runtime/native.py).
//
// C ABI: td_ag_moe_tile_schedule fills three parallel arrays
// (stage, expert, tile_row_offset) of length td_ag_moe_tile_count.

#include <cstdint>
#include <vector>

extern "C" {

// Number of (block-aligned) tiles the schedule will emit.
//   counts: n_ranks x num_experts row-major token counts
// Tiles per (rank, expert) = ceil(count / block_m).
int64_t td_ag_moe_tile_count(const int32_t* counts, int32_t n_ranks,
                             int32_t num_experts, int32_t block_m) {
  if (!counts || n_ranks <= 0 || num_experts <= 0 || block_m <= 0) return -1;
  int64_t total = 0;
  for (int64_t i = 0; i < int64_t(n_ranks) * num_experts; ++i)
    total += (int64_t(counts[i]) + block_m - 1) / block_m;
  return total;
}

// Emit the schedule for `rank`. Arrival order of shards is the ring
// schedule: stage s delivers shard (rank - s) mod n_ranks (own shard at
// stage 0). Within a stage, tiles are ordered expert-major so consecutive
// tiles share expert weights.
//
//   stage_out / expert_out / row_off_out: capacity td_ag_moe_tile_count
//   row offsets are LOCAL to the (rank, expert) segment, in rows.
// Returns number of tiles written, or -1 on bad args.
int64_t td_ag_moe_tile_schedule(const int32_t* counts, int32_t n_ranks,
                                int32_t num_experts, int32_t block_m,
                                int32_t rank, int32_t* stage_out,
                                int32_t* expert_out, int32_t* row_off_out) {
  if (!counts || !stage_out || !expert_out || !row_off_out || n_ranks <= 0 ||
      num_experts <= 0 || block_m <= 0 || rank < 0 || rank >= n_ranks)
    return -1;
  int64_t w = 0;
  for (int32_t s = 0; s < n_ranks; ++s) {
    int32_t src = (rank - s % n_ranks + n_ranks) % n_ranks;
    for (int32_t e = 0; e < num_experts; ++e) {
      int32_t cnt = counts[int64_t(src) * num_experts + e];
      for (int32_t off = 0; off < cnt; off += block_m) {
        stage_out[w] = s;
        expert_out[w] = e;
        row_off_out[w] = off;
        ++w;
      }
    }
  }
  return w;
}

}  // extern "C"
