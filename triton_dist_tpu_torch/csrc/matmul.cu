// B12: the tiled local GEMM of the fused AllGather + GEMM and GEMM +
// ReduceScatter at world 1, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/allgather_gemm.py::_matmul_kernel (the
// K-split tile pipeline that _pallas_matmul launches: ag_gemm_per_device
// and gemm_rs_per_device at n = 1, method PALLAS): out = cast(A @ W) with
// a K-split f32 accumulator and one cast, A (M, K), W (K, N). That is the
// function of B4's world-1 body, so this source shares its device code
// (gemm_splitk.cuh) and adds its own C entry point.
//
// What bounds it on this card: on the triton_dist decode path M is the
// batch and the QKV / o projections stream their weights (Qwen3-30B-A3B:
// 21 MB and 17 MB of bf16 per layer), so it is bound by bytes; the design
// notes are in gemm_splitk.cuh. Any M is taken (the M tiles of 8 rows run
// in the grid and re-read W through L2), correct but slow at prefill sizes.

#include "gemm_splitk.cuh"

// The interface of td_gemm_ar (gemm_ar.cu): a (M, K), w (K, N), out
// (M, N), one dtype, optional f32 (splits, M, N) workspace. Returns a
// cudaError_t.
extern "C" int td_matmul(const void* a, const void* w, void* part, void* out,
                         int m_rows, int k_dim, int n_cols, int k_chunk,
                         int splits, int dtype, void* stream) {
  return td_gemm_splitk(a, w, part, out, m_rows, k_dim, n_cols, k_chunk,
                        splits, dtype, stream);
}
