// MoE routing utilities on the host: the block-aligned stable expert sort
// behind the native schedule provider (kernels/moe_utils.py,
// make_chunk_schedule(provider="native")), so that every grouped-GEMM tile
// of B14 / B15 touches exactly one expert. Plain C++ over int32 arrays,
// built with g++ and loaded with ctypes (runtime/native.py).
//
// C ABI:
//   td_expert_histogram      — per-expert counts
//   td_moe_align_block_size  — stable expert sort with per-expert padding to
//                              a block multiple; emits sorted token ids
//                              (pad = sentinel M*topk), per-block expert ids,
//                              and the padded total.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// counts[e] = |{i : expert_ids[i] == e}|; ids outside [0, num_experts) are
// ignored. Returns 0 on success.
int td_expert_histogram(const int32_t* expert_ids, int64_t n,
                        int32_t num_experts, int32_t* counts) {
  if (!expert_ids || !counts || num_experts <= 0) return -1;
  std::fill(counts, counts + num_experts, 0);
  for (int64_t i = 0; i < n; ++i) {
    int32_t e = expert_ids[i];
    if (e >= 0 && e < num_experts) counts[e]++;
  }
  return 0;
}

// Stable-sort flat (token, choice) rows by expert, padding each expert's
// segment to a multiple of `block`.
//
//   topk_ids        : n = M*topk flat expert ids
//   sorted_token_ids: capacity >= n + num_experts*(block-1); row i holds the
//                     flat source row occupying sorted slot i, or `n` (the
//                     pad sentinel)
//   expert_ids_out  : capacity >= capacity/block entries; expert of each
//                     output block
//   num_tokens_post_pad: the padded total (single int32)
//
// Returns 0 on success, -1 on bad args.
int td_moe_align_block_size(const int32_t* topk_ids, int64_t n,
                            int32_t num_experts, int32_t block,
                            int32_t* sorted_token_ids,
                            int32_t* expert_ids_out,
                            int32_t* num_tokens_post_pad) {
  if (!topk_ids || !sorted_token_ids || !expert_ids_out ||
      !num_tokens_post_pad || num_experts <= 0 || block <= 0)
    return -1;

  std::vector<int32_t> counts(num_experts, 0);
  for (int64_t i = 0; i < n; ++i) {
    int32_t e = topk_ids[i];
    if (e < 0 || e >= num_experts) return -1;
    counts[e]++;
  }

  std::vector<int64_t> starts(num_experts + 1, 0);  // padded segment starts
  for (int32_t e = 0; e < num_experts; ++e) {
    int64_t padded = (int64_t(counts[e]) + block - 1) / block * block;
    starts[e + 1] = starts[e] + padded;
  }
  int64_t total = starts[num_experts];
  *num_tokens_post_pad = static_cast<int32_t>(total);

  std::fill(sorted_token_ids, sorted_token_ids + total,
            static_cast<int32_t>(n));  // pad sentinel
  std::vector<int64_t> cursor(starts.begin(), starts.end() - 1);
  for (int64_t i = 0; i < n; ++i)  // forward pass => stable within expert
    sorted_token_ids[cursor[topk_ids[i]]++] = static_cast<int32_t>(i);

  for (int32_t e = 0; e < num_experts; ++e)
    for (int64_t b = starts[e] / block; b < starts[e + 1] / block; ++b)
      expert_ids_out[b] = e;
  return 0;
}

}  // extern "C"
