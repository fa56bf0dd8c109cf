// Exact masked top-k over an int4-packed vector index, for Hopper (sm_90a).
//
// Replaces the TPU kernel youtu_rag_tpu/ops/topk.py::pallas_topk_int4_pruned
// (pallas_call at :665, kernel body _topk_kernel_int4_pruned). Same contract:
//   X is packed [N, d/2] int8: byte j holds column j in its low nibble and
//   column j + d/2 in its high nibble, each a 4-bit two's-complement value
//   in [-7, 7] (ops/topk.py::quantize_rows_int4);
//   acc[q, row]   = dot(Q[q, :d/2], lo(X[row])) + dot(Q[q, d/2:], hi(X[row]))
//                   (int8 queries, exact int32)
//   score[q, row] = f32(acc) * (qs[q] * xs[row]) + bias[row]
//                   (__fmul_rn/__fadd_rn, never an FMA)
//   result        = the k best (score desc, row asc) per query, 1 <= k <= 1024.
// f32(acc) is exact at any d the index takes (d * 127 * 7 < 2^24 up to
// d = 18,870). The selection, the k classes and the merge are in
// topk_select.cuh.
//
// Bound: the kernel must read N*d/2 bytes of packed vectors and 8N bytes of
// scales and bias. It does the same 2*q*N*d integer operations as the int8
// kernel on half the bytes (32 per byte at q = 8), plus the unpack: on the
// CUDA cores (__dp4a, 4 products an instruction, a 31-shuffle butterfly per
// 4 rows) that work took as long as the int8 scan of twice the bytes.
//
// Scoring: Int4Scorer in topk_scorers.cuh puts the products on the tensor
// cores: mma.sync m16n8k32 over the biased nibbles (u8) of a warp's 16 rows
// and the tile's 8 int8 queries, the columns ordered so that each lane
// fills its fragments from 16-byte loads of packed bytes; no butterfly.
// Bit-equal to the plain version (exact integer sums).

#include "topk_scorers.cuh"

// topk_int4_pruned_launch(queries int8 [q, d], qscale f32 [q],
//                         x packed int8 [n, d/2], xscale f32 [n], bias f32 [n],
//                         ..., d = the unpacked width, ...)
TOPK_C_INTERFACE(topk_int4_pruned, Int4Scorer)
