// B4: the fused GEMM + allreduce, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/gemm_allreduce.py::_gemm_ar_kernel of the
// JAX package (launched by gemm_ar_per_device, method PALLAS): every rank
// holds A (M, K_loc) and a (K_loc, N) row shard of W, and every rank
// returns out = cast(sum over ranks r of A_r @ W_r) from f32 partials.
//
// World 1 (td_gemm_ar): the TPU kernel's sum over the sender slots is its
// own partial, so the body is the GEMM, the f32 accumulator and the cast
// epilogue, the function B12 computes too (matmul.cu): in bf16 the Hopper
// kernel of gemm_stream_sm90.cuh (TMA weight tiles into mma.sync, a
// persistent stream-K grid, the split-K fold in the same launch), in f32
// the FMA body of gemm_splitk.cuh; the bound and the designs are described
// there.
//
// World n > 1 (td_gemm_ar_tp): the TPU kernel pushes each partial block to
// every peer's sender-indexed slot and folds slot 0 + slot 1 + ... + slot
// n-1 (its reduce_chunk order; slot `me` holds the own partial), the same
// on every rank, so every rank returns the same bytes. On the decode path
// of Qwen3-32B at TP=4 (M = 16, bf16) the product streams 21 MB (o) and
// 65.5 MB (down) of weights per rank: bound by HBM bytes, 6.3 us and 19.6
// us at 3.35 TB/s; its 320 KB f32 partial goes to 3 peers (2 us of
// NVLink at 450 GB/s, 4 as LL lines), at the end of the pass, when the
// stream-K tiles finish. The design is
// gemm_land_stream.cuh's with kAll = true (B13b's one-hop landing): one
// launch, one pass over the weight shard on gemm_stream_sm90.cuh in bf16
// (gemm_splitk.cuh's FMA item in f32), each finished tile's f32 rows
// stored by its warp into this rank's slot on every rank, its own
// included, while the rest of the weights stream; LL lines or flags by
// the bytes of a slot (kernels/gemm_allreduce.py AR_LL_MAX_SLOT_BYTES,
// from a four-card sweep); after its items every consumer warp folds a
// share of the (m, N) rows, slot 0 + ... + slot n-1 in f32, one cast; an
// epoch word a block and the slots double-buffered by its parity, with no
// opening barrier.

#include "gemm_land_stream.cuh"

// a: (M, K); w: (K, N); out: (M, N); all contiguous, one dtype (td::F32 or
// td::BF16), w 16-byte aligned, N a multiple of the 16-byte vector. out =
// cast(a @ w) with f32 accumulation. bf16: part is the f32 workspace and
// tickets the zeroed ticket words of td_gemm_stream, over `grid` blocks.
// f32: the K rows are cut into `splits` slices of k_chunk rows (k_chunk *
// splits >= K); with splits > 1, part is an f32 (splits, M, N) workspace.
// Returns a cudaError_t.
extern "C" int td_gemm_ar(const void* a, const void* w, void* part,
                          int* tickets, void* out, int m_rows, int k_dim,
                          int n_cols, int k_chunk, int splits, int grid,
                          int dtype, void* stream) {
  if (dtype == td::BF16)
    return td_gemm_stream(a, w, part, tickets, out, m_rows, k_dim, n_cols,
                          grid, stream);
  if (dtype != td::F32) return static_cast<int>(cudaErrorInvalidValue);
  return td_gemm_splitk_f32(a, w, part, out, m_rows, k_dim, n_cols, k_chunk,
                            splits, stream);
}

// Under kernels/gemm_allreduce.py::ar_plan: a (m, K) this rank's rows;
// out (m, N), the sum over ranks; the rest as land::land_gemm
// (gemm_land_stream.cuh), with rows = m. Returns a cudaError_t.
extern "C" int td_gemm_ar_tp(const void* a, const void* w, void* part,
                             void* out, int rank, int world,
                             const void* base, void* ctl, int m, int k_dim,
                             int n_cols, int rg, int ll,
                             long long slot_bytes, long long flag_off,
                             int grid, int k_chunk, int splits,
                             int ranks_per_device, int dtype, void* stream) {
  return land::land_gemm<true>(a, w, part, out, rank, world, base, ctl, m,
                               k_dim, n_cols, rg, ll, slot_bytes, flag_off,
                               grid, k_chunk, splits, ranks_per_device, dtype,
                               stream);
}
