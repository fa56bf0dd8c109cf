// Exact masked top-k over the probed blocks of an IVF index, for Hopper
// (sm_90a): one entry per storage tier.
//
// Replaces the TPU kernels of youtu_rag_tpu/ops/ivf.py:
//   ivf_topk_bf16  <- pallas_ivf_topk_dma       (pallas_call at :461, _ivf_dma_kernel_bf16)
//   ivf_topk_int8  <- pallas_ivf_topk_int8_dma  (pallas_call at :527, _ivf_dma_kernel)
//   ivf_topk_int4  <- pallas_ivf_topk_int4_dma  (pallas_call at :596, _ivf_dma_kernel packed)
// Same contract: the exact top k (score desc, row asc) over the rows of
// blocks ids[0 .. n_valid) only, block b covering stored rows
// [b * block_rows, (b + 1) * block_rows); entries of ids past n_valid are
// never read; slots no live row fills come back as (NEG_INF, row 0). The
// scores are the brute kernels' (topk_pruned.cu, topk_int8_pruned.cu,
// topk_int4_pruned.cu): bf16 f32(q)·f32(x) + bias, int8/int4 the exact
// integer dot with the op-by-op f32 epilogue.
//
// Design. The TPU kernel is one program that walks the block list in
// order with double-buffered DMA and one running top-k. Here the scan of
// topk_select.cuh runs with its IVF row source: n_valid is read on the
// device (no host sync between plan and scan), the probed rows split
// evenly over all CTAs in 128-row tiles, a 4-row scoring group (bf16,
// int8) reads contiguous rows of one block, int4's 16-row warp tile maps
// each of its rows on its own, and the lists keep stored rows, so the
// merge's (score desc, row asc) order equals the plain version's sort.
// The grid is sized on the host from the plan's static length max_blocks.
//
// Bound: like the brute scans, HBM reads: n_valid * block_rows rows
// (2d, d or d/2 bytes each, plus 4 or 8 bytes of bias and scale), read once
// per 8-query tile.

#include "topk_scorers.cuh"

// <name>_launch(queries, qscale, x, xscale, bias, ids int32 [max_blocks],
//               n_valid int32 [1], cand_s, cand_i, out_s, out_i,
//               q, n, d, k, max_blocks, block_rows, n_cta, stream)
IVF_C_INTERFACE(ivf_topk_bf16, Bf16Scorer)
IVF_C_INTERFACE(ivf_topk_int8, Int8Scorer)
IVF_C_INTERFACE(ivf_topk_int4, Int4Scorer)

extern "C" const char* ivf_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
