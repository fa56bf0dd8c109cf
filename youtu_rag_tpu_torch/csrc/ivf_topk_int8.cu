// The int8 entries of the ring (ivf_scan_tma.cuh's Int8 tier), for Hopper
// (sm_90a); ivf_topk_bf16.cu and ivf_topk_int4.cu hold the other tiers, one
// source each so that their builds run in parallel.
//
// Replaces the TPU kernels:
//   ivf_topk_int8    <- youtu_rag_tpu/ops/ivf.py::pallas_ivf_topk_int8_dma (pallas_call at :527,
//                                                  _ivf_dma_kernel)
//   ivf_blocks_int8  <- youtu_rag_tpu/ops/ivf.py::pallas_ivf_topk_int8  (pallas_call at :188,
//                                                  _ivf_kernel_int8, merge at :192-196)
//   topk_merged_int8 <- youtu_rag_tpu/ops/topk.py::pallas_topk_int8     (pallas_call at :407,
//                                                  _topk_kernel_int8, merge at :411-415)
//   topk_pruned_int8 <- youtu_rag_tpu/ops/topk.py::pallas_topk_int8_pruned (pallas_call at :494,
//                                                  _topk_kernel_int8_pruned)
// The contracts, the design and the bound are ivf_topk_bf16.cu's and
// ivf_scan_tma.cuh's: the queries come as f32 and the kernel quantizes them
// as quantize_rows_int8 does; the scores are the exact integer dot, then
// f32(acc) * (qs * xs) + bias rounded op by op.

#include "ivf_scan_tma.cuh"

// the launch, ctas_per_sm and plan entries: ivf_topk_bf16.cu
IVF_TMA_C_INTERFACE(ivf_topk_int8, ivf_tma::Int8, false, false)
IVF_TMA_C_INTERFACE(ivf_blocks_int8, ivf_tma::Int8, true, false)
IVF_TMA_C_INTERFACE(topk_merged_int8, ivf_tma::Int8, true, true)
// the DMA kernels of ivf_topk_int8 over the identity plan (no new instance)
IVF_TMA_C_INTERFACE(topk_pruned_int8, ivf_tma::Int8, false, true)

extern "C" const char* ivf_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
