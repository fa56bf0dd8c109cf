// The int4 entries of the ring (ivf_scan_tma.cuh's Int4 tier: packed
// nibbles), for Hopper (sm_90a); ivf_topk_bf16.cu and ivf_topk_int8.cu hold
// the other tiers, one source each so that their builds run in parallel.
//
// Replaces the TPU kernels:
//   ivf_topk_int4    <- youtu_rag_tpu/ops/ivf.py::pallas_ivf_topk_int4_dma (pallas_call at :596,
//                                                  _ivf_dma_kernel packed)
//   topk_pruned_int4 <- youtu_rag_tpu/ops/topk.py::pallas_topk_int4_pruned (pallas_call at :665,
//                                                  _topk_kernel_int4_pruned)
// The contracts, the design and the bound are ivf_topk_bf16.cu's and
// ivf_scan_tma.cuh's: rows packed [n, d/2] as quantize_rows_int4 packs them
// (d % 256 == 0), the queries f32, quantized in the kernel as
// quantize_rows_int8 does; the scores the exact integer dot with the
// nibbles, then f32(acc) * (qs * xs) + bias rounded op by op.

#include "ivf_scan_tma.cuh"

// the launch, ctas_per_sm and plan entries: ivf_topk_bf16.cu
IVF_TMA_C_INTERFACE(ivf_topk_int4, ivf_tma::Int4, false, false)
// the DMA kernels of ivf_topk_int4 over the identity plan (no new instance)
IVF_TMA_C_INTERFACE(topk_pruned_int4, ivf_tma::Int4, false, true)

extern "C" const char* ivf_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
