// Exact masked top-k over an int8 vector index, for Hopper (sm_90a).
//
// Replaces the TPU kernel youtu_rag_tpu/ops/topk.py::pallas_topk_int8_pruned
// (pallas_call at :494, kernel body _topk_kernel_int8_pruned). Same contract:
//   acc[q, row]   = sum_d Q[q, d] * X[row, d]            (int8 x int8, exact int32)
//   score[q, row] = f32(acc) * (qs[q] * xs[row]) + bias[row]
//                   (each product and the sum rounded on its own, as XLA
//                   computes the TPU kernel's epilogue: __fmul_rn/__fadd_rn,
//                   never an FMA)
//   result        = the k best (score desc, row asc) per query, 1 <= k <= 1024.
// Queries arrive quantized per row (the wrapper does it, as the JAX wrapper
// leaves it to XLA outside the pallas_call). f32(acc) is exact while
// |acc| < 2^24, which holds for d <= 1024 (d * 127^2 < 2^24).
// The selection, the k classes and the merge are in topk_select.cuh.
//
// Bound: the kernel must read N*d bytes of vectors and 8N bytes of scales
// and bias. It does 2*q*N*d integer operations; at q = 8 that is 16 per
// byte read, and __dp4a (4 products and a sum per instruction) on the
// CUDA cores keeps it below the HBM time, so it is bound by HBM reads.
//
// Scoring: Int8Scorer in topk_scorers.cuh (bit-equal to the plain version).

#include "topk_scorers.cuh"

// topk_int8_pruned_launch(queries int8 [q, d], qscale f32 [q], x int8 [n, d],
//                         xscale f32 [n], bias f32 [n], ...)
TOPK_C_INTERFACE(topk_int8_pruned, Int8Scorer)
