// B13a: the overlapped GEMM + ReduceScatter across ranks, hand-written for
// Hopper (sm_90a).
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

#include "gemm_land.cuh"

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
