// B4 at world 1: the GEMM body of the fused GEMM + allreduce, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/gemm_allreduce.py::_gemm_ar_kernel of the
// JAX package (launched by gemm_ar_per_device, method PALLAS) in its world-1
// form: out = cast(A @ W) with f32 accumulation, A (M, K), W (K, N). At
// n = 1 the TPU kernel's sum over the sender slots is its own partial, so
// the body is the GEMM, the f32 accumulator and the cast epilogue. The push
// of each partial block to the peers and the landing-slot reduction wait for
// tensor parallelism (ROADMAP A5).
//
// What bounds it on this card, and the design: gemm_splitk.cuh (the device
// code B12 shares).

#include "gemm_splitk.cuh"

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
