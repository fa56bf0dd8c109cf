// Exact masked top-k over a bf16 vector index, for Hopper (sm_90a).
//
// Replaces the TPU kernel youtu_rag_tpu/ops/topk.py::pallas_topk_pruned
// (kernel body _topk_kernel_pruned). Same contract:
//   score[q, row] = sum_d f32(bf16 Q[q, d]) * f32(bf16 X[row, d])  (f32 sums)
//                   + bias[row]
//   result        = the k best (score desc, row asc) per query, 1 <= k <= 1024.
// The selection, the k classes and the merge are in topk_select.cuh.
//
// Bound: the kernel must read the whole index once, N*d*2 bytes (plus
// N*4 bytes of bias); at q <= 64 queries it does 2*q*N*d flops, far below
// the card's FMA rate per byte, so it is bound by HBM reads.
//
// Scoring: Bf16Scorer in topk_scorers.cuh.

#include "topk_scorers.cuh"

// topk_pruned_launch(queries bf16 [q, d], qscale = NULL, x bf16 [n, d],
//                    xscale = NULL, bias, ...)
TOPK_C_INTERFACE(topk_pruned, Bf16Scorer)
