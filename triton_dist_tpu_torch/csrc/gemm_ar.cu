// B4: the fused GEMM + allreduce, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/gemm_allreduce.py::_gemm_ar_kernel of the
// JAX package (launched by gemm_ar_per_device, method PALLAS): every rank
// holds A (M, K_loc) and a (K_loc, N) row shard of W, and every rank
// returns out = cast(sum over ranks r of A_r @ W_r) from f32 partials.
//
// World 1 (td_gemm_ar): the TPU kernel's sum over the sender slots is its
// own partial, so the body is the GEMM, the f32 accumulator and the cast
// epilogue: the split-K GEMM of gemm_splitk.cuh (the device code B12
// shares), where the bound and the design are described.
//
// World n > 1 (td_gemm_ar_tp): the device code of gemm_land.cuh (shared
// with B13a) with kAll = true. Each tile's f32 partial is stored into
// slot `rank` of every rank's (n, M, N) f32 landing buffer (the TPU
// kernel's push of each partial block to every peer's sender-indexed
// slot), and every rank folds slot 0 + slot 1 + ... + slot n-1 in f32 and
// casts once: the TPU kernel's reduce_chunk order (slot `me` holds the
// own partial there too), the same on every rank, so every rank returns
// the same bytes. On the decode path of Qwen3-32B at TP=4 (M = 16, bf16)
// the product streams 21 MB (o) and 65.5 MB (down) of weights per rank:
// bound by HBM bytes, 6.3 us and 19.6 us at 3.35 TB/s; the 320 KB f32
// partial crosses NVLink to 3 peers.

#include "gemm_land.cuh"

// a: (M, K); w: (K, N); out: (M, N); all contiguous, one dtype (td::F32 or
// td::BF16), w and out 16-byte aligned, N a multiple of the 16-byte vector.
// The K rows are cut into `splits` slices of k_chunk rows (k_chunk * splits
// >= K); with splits > 1, part is an f32 (splits, M, N) workspace. out =
// cast(a @ w) with f32 accumulation. Returns a cudaError_t.
extern "C" int td_gemm_ar(const void* a, const void* w, void* part,
                          void* out, int m_rows, int k_dim, int n_cols,
                          int k_chunk, int splits, int dtype, void* stream) {
  return td_gemm_splitk(a, w, part, out, m_rows, k_dim, n_cols, k_chunk,
                        splits, dtype, stream);
}

// a: (m, K) this rank's rows; w: (K, N) its weight shard; out: (m, N), the
// sum over ranks; the rest as td_gemm_land (gemm_land.cuh), with landing
// slots (world, m, N) f32. Returns a cudaError_t.
extern "C" int td_gemm_ar_tp(const void* a, const void* w, void* part,
                             void* out, int rank, int world,
                             const void* base, long long sig_off, void* ctl,
                             int m, int k_dim, int n_cols, int k_chunk,
                             int splits, int ranks_per_device, int dtype,
                             void* stream) {
  return td_gemm_land<true>(a, w, part, out, rank, world, base, sig_off, ctl,
                            m, k_dim, n_cols, k_chunk, splits,
                            ranks_per_device, dtype, stream);
}
