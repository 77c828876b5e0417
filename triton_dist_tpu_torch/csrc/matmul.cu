// B12: the tiled local GEMM of the fused AllGather + GEMM and GEMM +
// ReduceScatter at world 1, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel kernels/allgather_gemm.py::_matmul_kernel (the
// K-split tile pipeline that _pallas_matmul launches: ag_gemm_per_device
// and gemm_rs_per_device at n = 1, method PALLAS): out = cast(A @ W) with
// a K-split f32 accumulator and one cast, A (M, K), W (K, N). That is the
// function of B4's world-1 body, so this source shares its device code
// (bf16: the Hopper kernel of gemm_stream_sm90.cuh; f32: the FMA body of
// gemm_splitk.cuh) and adds its own C entry point.
//
// What bounds it on this card: on the triton_dist decode path M is the
// batch and the projections stream their weights (Qwen3-8B: QKV 50 MB, o
// 34 MB, gate_up 201 MB, down 101 MB of bf16 a layer), so it is bound by
// bytes; the design notes are in gemm_stream_sm90.cuh. Any M is taken (M
// groups of 16 rows, each a pass over W), correct but slow at prefill
// sizes.

#include "gemm_splitk.cuh"
#include "gemm_stream_sm90.cuh"

// The interface of td_gemm_ar (gemm_ar.cu). Returns a cudaError_t.
extern "C" int td_matmul(const void* a, const void* w, void* part,
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
