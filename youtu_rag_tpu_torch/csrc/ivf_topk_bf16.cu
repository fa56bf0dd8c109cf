// Exact masked top-k over the probed blocks of an index, or over all of its
// rows, for Hopper (sm_90a): the bf16 entries of the ring
// (ivf_scan_tma.cuh). ivf_topk_int8.cu and ivf_topk_int4.cu hold the int8
// and int4 tiers' entries, one source per tier so that the three builds
// run in parallel.
//
// Replaces the TPU kernels:
//   ivf_topk_bf16    <- youtu_rag_tpu/ops/ivf.py::pallas_ivf_topk_dma   (pallas_call at :461,
//                                                  _ivf_dma_kernel_bf16)
//   ivf_blocks_bf16  <- youtu_rag_tpu/ops/ivf.py::pallas_ivf_topk       (pallas_call at :103,
//                                                  _ivf_kernel, with its lax.top_k merge at
//                                                  :110-114)
//   topk_merged_bf16 <- youtu_rag_tpu/ops/topk.py::pallas_topk          (pallas_call at :174,
//                                                  _topk_kernel, with its lax.top_k merge at
//                                                  :184-189)
//   topk_pruned_bf16 <- youtu_rag_tpu/ops/topk.py::pallas_topk_pruned   (pallas_call at :299,
//                                                  _topk_kernel_pruned)
// Four contracts on two kernel sets:
//  - ivf_topk_<tier> (the DMA contract): the exact top k (score desc, probe
//    position asc, row in block asc) over the rows of blocks ids[0 ..
//    n_valid) only, block b covering stored rows [b * block_rows, (b + 1) *
//    block_rows); entries of ids past n_valid are never read; slots no live
//    row fills come back as the TPU kernels leave them, (NEG_INF, the best
//    live row before the last block with one; 0 if none);
//  - ivf_blocks_<tier> (kProbe): the per-block contract, merged: probe-order
//    ties, and the per-block fill in the slots no live row fills;
//  - topk_merged_<tier>: the kProbe kernels over the identity plan (block i
//    at position i, every block valid, no plan read): the brute per-block
//    contract merged, ties in row order and merge_blocks' tail
//    (topk_blocks.cu keeps the unmerged candidates);
//  - topk_pruned_<tier>: the DMA kernels over the identity plan with one
//    block of all n rows (any n): the brute pruned scan, ties in row order,
//    the slots no live row fills (NEG_INF, 0) as the TPU kernels' running
//    top-k leaves them.
// Every entry takes what JAX does: any block_rows that divides n, any
// d % 128 == 0 (int4 d % 256 == 0: its packed width a multiple of 128) and
// any k, bias and scales at any 4-byte alignment. The scores: bf16
// f32(bf16 q) . f32(x) + bias, summed in f32 on the tensor cores (in
// another order than the plain version's matmul); int8 and int4 the exact
// integer dot with the op-by-op f32 epilogue.
//
// Design. The TPU kernels walk their blocks in order with double-buffered
// DMA and carry one running top-k; the port does not copy that. Every entry
// runs ivf_scan_tma.cuh: one launch per 64 queries that prepares its
// queries (the bf16 cast; int8 and int4 the quantize_rows_int8 rounding,
// int4 also each query's byte sum for its biased nibbles), splits the
// virtual rows of the plan (n_valid read on the device, no host sync
// between plan and scan) over one wave of CTAs, streams each CTA's share
// through a ring of bulk asynchronous copies (cp.async.bulk on mbarriers),
// scores it on the tensor cores, selects per query into sorted lists, and
// merges the CTAs' lists in the last CTA of each query tile to finish.
// Every entry's lists keep the virtual row, so ties come in probe order.
//
// Bound: HBM reads: n_valid * block_rows rows (2d, d or d/2 bytes each,
// plus 4 or 8 bytes of bias and scale; the identity-plan entries every
// row), read once per 8-query tile.

#include "ivf_scan_tma.cuh"

// <name>_launch(queries f32 (bf16 also: queries_bf16 = 1), queries_bf16,
//               x (int4: packed [n, d/2]), xscale, bias, ids int32 [max_blocks],
//               n_valid int32 [1] (identity-plan entries: both ignored,
//               max_blocks = n / block_rows),
//               cand_s, cand_i [tiles, n_cta, 8, k_pad4], counter int32 [2 + 16, tiles],
//               out_s, out_i, q, n, d (the unpacked width), k, max_blocks, block_rows,
//               n_cta, stream);
// <name>_ctas_per_sm(d, k): CTAs one SM holds (0: none fits; < 0: a CUDA error);
// <name>_plan(d, k, out int32 [4]): rows, stages, lists in device memory, wide
// (a wide plan takes bf16 queries)
IVF_TMA_C_INTERFACE(ivf_topk_bf16, ivf_tma::Bf16, false, false)
// (the DMA entries use one int of each tile's kFirstCols: the last live row)
IVF_TMA_C_INTERFACE(ivf_blocks_bf16, ivf_tma::Bf16, true, false)
IVF_TMA_C_INTERFACE(topk_merged_bf16, ivf_tma::Bf16, true, true)
// the DMA kernels of ivf_topk_bf16 over the identity plan (no new instance)
IVF_TMA_C_INTERFACE(topk_pruned_bf16, ivf_tma::Bf16, false, true)

extern "C" const char* ivf_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
