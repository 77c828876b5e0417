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
// What bounds it on this card, and the design: gemm_land.cuh. Each row
// lands only in the slot of the rank that keeps it. The JAX ring kernel
// adds in a rank-dependent ring order, this one in ascending sender rank,
// so the two agree to f32 rounding, not bit for bit.
//
// B13b replaces kernels/gemm_reduce_scatter.py::_gemm_rs_bidir_kernel
// (method PALLAS_BIDIR at n >= 3): the same function, the partials
// reduce-scattered over both ring directions, each chunk's sum travelling
// to its owner along the shorter arc: with kr = n / 2 and kl = (n - 1) /
// 2, the right chain starts at rank me - kr and each hop adds its own
// partial to the arrival (own + arrival) up to rank me - 1, the left chain
// the same from rank me + kl down to me + 1, and the owner adds own +
// right + left, in that order, and casts once (the TPU kernel's fold,
// _make_rs_block_runner; kernels/plain.py::bidir_rs_fold).
//
// What bounds it on this card. On the decode path (Qwen3-32B at TP=4,
// B=16: n m = 16 rows, 4 a rank) the product streams the weight shard once
// (o 2,048 x 5,120 bf16, 21 MB; down 6,400 x 5,120, 65.5 MB): bound by HBM
// bytes, 6.3 us and 19.6 us at 3.35 TB/s. The TPU's ring suits a torus of
// neighbour links; an H100 host is an NVSwitch full mesh, so the arcs'
// hops become one, and the product of every chunk is one pass over W
// (the ring computed one chunk's product a phase, a pass over W each).
// Design: gemm_land_stream.cuh with kAll = false (shared with B4 across
// ranks): one pass over W for every chunk's rows on gemm_stream_sm90.cuh
// (bf16; at prefill, many M groups, whole tiles column-tile major, so each
// column strip of W is read from HBM about once and from L2 by every M
// group) or gemm_splitk.cuh's FMA item (f32), each finished f32 row stored
// into its owner's slot for this sender (one NVLink hop), LL lines or
// flags by the bytes of a slot (kernels/gemm_reduce_scatter.py
// RS_LL_MAX_SLOT_BYTES, from a four-card sweep), and the owner's fold of
// its n slots in bidir_rs_fold's order, in f32, with one cast: given the
// same partials the output is bidir_rs_fold's bytes.

#include "gemm_land.cuh"
#include "gemm_land_stream.cuh"

// a: (world*m, K) rows of every destination; the rest as td_gemm_land
// (gemm_land.cuh). Returns a cudaError_t.
extern "C" int td_gemm_rs(const void* a, const void* w, void* part,
                          void* out, int rank, int world, const void* base,
                          long long sig_off, void* ctl, int m, int k_dim,
                          int n_cols, int k_chunk, int splits,
                          int ranks_per_device, int dtype, void* stream) {
  return td_gemm_land(a, w, part, out, rank, world, base, sig_off, ctl, m,
                      k_dim, n_cols, k_chunk, splits, ranks_per_device,
                      dtype, stream);
}

// B13b, world >= 3, under kernels/gemm_reduce_scatter.py::bidir_plan: a
// (world*m, K) rows of every destination, out this rank's (m, N) rows; the
// rest as land::land_gemm (gemm_land_stream.cuh). Returns a cudaError_t.
extern "C" int td_gemm_rs_bidir(const void* a, const void* w, void* part,
                                void* out, int rank, int world,
                                const void* base, void* ctl, int m,
                                int k_dim, int n_cols, int rg, int ll,
                                long long slot_bytes, long long flag_off,
                                int grid, int k_chunk, int splits,
                                int ranks_per_device, int dtype,
                                void* stream) {
  if (world < 3) return static_cast<int>(cudaErrorInvalidValue);
  return land::land_gemm<false>(a, w, part, out, rank, world, base, ctl, m,
                                k_dim, n_cols, rg, ll, slot_bytes, flag_off,
                                grid, k_chunk, splits, ranks_per_device,
                                dtype, stream);
}
