// Exact masked top-k over the probed blocks of an IVF index, for Hopper
// (sm_90a): one entry per storage tier.
//
// Replaces the TPU kernels of youtu_rag_tpu/ops/ivf.py:
//   ivf_topk_bf16    <- pallas_ivf_topk_dma       (pallas_call at :461, _ivf_dma_kernel_bf16)
//   ivf_topk_int8    <- pallas_ivf_topk_int8_dma  (pallas_call at :527, _ivf_dma_kernel)
//   ivf_topk_int4    <- pallas_ivf_topk_int4_dma  (pallas_call at :596, _ivf_dma_kernel packed)
//   ivf_blocks_bf16  <- pallas_ivf_topk           (pallas_call at :103, _ivf_kernel, with its
//                                                  lax.top_k merge at :110-114)
//   ivf_blocks_int8  <- pallas_ivf_topk_int8      (pallas_call at :188, _ivf_kernel_int8, merge
//                                                  at :192-196)
// The ivf_blocks entries keep the per-block contract (probe-order ties, the
// per-block fill in the slots no live row fills; see ivf_scan_tma.cuh) and compute the merged result in the same one launch;
// topk_blocks.cu keeps the unmerged candidates. The DMA entries' contract:
// the exact top k (score desc, row asc) over the rows of
// blocks ids[0 .. n_valid) only, block b covering stored rows
// [b * block_rows, (b + 1) * block_rows); entries of ids past n_valid are
// never read; slots no live row fills come back as (NEG_INF, row 0). Every
// entry takes what JAX does: any block_rows that divides n, any d % 128 ==
// 0 (int4 d % 256 == 0: its packed width a multiple of 128) and any k,
// bias and scales at any 4-byte alignment. The scores are the brute
// kernels' (topk_pruned.cu, topk_int8_pruned.cu, topk_int4_pruned.cu):
// bf16 f32(q)·f32(x) + bias, int8/int4 the exact integer dot with the
// op-by-op f32 epilogue.
//
// Design. The TPU kernel is one program that walks the block list in
// order with double-buffered DMA and one running top-k; the port does not
// copy that. Every entry runs ivf_scan_tma.cuh: one launch per 64 queries
// that prepares its queries (the bf16 cast; int8 and int4 the
// quantize_rows_int8 rounding, int4 also each query's byte sum for its
// biased nibbles), splits the virtual rows of the plan (n_valid read on the
// device, no host sync between plan and scan) evenly over one wave of
// CTAs, streams each CTA's share through a ring of bulk asynchronous copies
// (cp.async.bulk on mbarriers), scores it on the tensor cores (int4: the
// packed bytes unpacked to biased u8 nibbles in registers, mma.sync u8 x
// s8), selects per query as topk_select.cuh's scan does, and merges the
// CTAs' lists in the last CTA of each query tile to finish. The DMA
// entries' lists keep stored rows, so their result is ordered (score desc,
// stored row asc) whatever the order of the ids; the ivf_blocks entries'
// lists keep the virtual row, so theirs is in probe order.
//
// Bound: like the brute scans, HBM reads: n_valid * block_rows rows
// (2d, d or d/2 bytes each, plus 4 or 8 bytes of bias and scale), read once
// per 8-query tile.

#include "ivf_scan_tma.cuh"

// <name>_launch(queries f32 (bf16 also: queries_bf16 = 1), queries_bf16,
//               x (int4: packed [n, d/2]), xscale, bias, ids int32 [max_blocks],
//               n_valid int32 [1],
//               cand_s, cand_i [tiles, n_cta, 8, k_pad4], counter int32 [2 + 16, tiles],
//               out_s, out_i, q, n, d (the unpacked width), k, max_blocks, block_rows,
//               n_cta, stream);
// <name>_plan(d, k, out int32 [4]): rows, stages, lists in device memory, wide
// (a wide plan takes bf16 queries)
IVF_TMA_C_INTERFACE(ivf_topk_bf16, ivf_tma::Bf16, false)
IVF_TMA_C_INTERFACE(ivf_topk_int8, ivf_tma::Int8, false)
IVF_TMA_C_INTERFACE(ivf_topk_int4, ivf_tma::Int4, false)
// (the DMA entries use the counters' first [2, tiles])
IVF_TMA_C_INTERFACE(ivf_blocks_bf16, ivf_tma::Bf16, true)
IVF_TMA_C_INTERFACE(ivf_blocks_int8, ivf_tma::Int8, true)

extern "C" const char* ivf_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
