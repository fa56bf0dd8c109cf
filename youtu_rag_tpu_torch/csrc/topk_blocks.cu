// Per-block top-k candidates over a bf16 or int8 index, for Hopper
// (sm_90a): every block of block_rows rows writes its own top k, padded to
// k_pad = round_up(k, 128); the caller merges the [n_blocks, q, k_pad]
// candidates (ops/topk.py::merge_blocks, a stable sort over positions).
// The IVF entries serve ops/ivf.py's candidates=True only: the merged IVF
// call runs ivf_topk.cu's ivf_blocks_* entries (ivf_scan_tma.cuh), one
// launch with the merge inside.
//
// Replaces the TPU kernels:
//   topk_blocks_bf16      <- youtu_rag_tpu/ops/topk.py::pallas_topk          (pallas_call :174, _topk_kernel)
//   topk_blocks_int8      <- youtu_rag_tpu/ops/topk.py::pallas_topk_int8     (pallas_call :407, _topk_kernel_int8)
//   ivf_topk_blocks_bf16  <- youtu_rag_tpu/ops/ivf.py::pallas_ivf_topk       (pallas_call :103, _ivf_kernel)
//   ivf_topk_blocks_int8  <- youtu_rag_tpu/ops/ivf.py::pallas_ivf_topk_int8  (pallas_call :188, _ivf_kernel_int8)
// Same contract. Block i covers stored rows [i * block_rows, (i + 1) *
// block_rows) (brute) or [ids[i] * block_rows, ...) (IVF, i < n_valid; a
// block at i >= n_valid is not read and scores NEG_INF throughout). Its
// list holds, per query:
//   - its live rows (score > NEG_INF), best k, in (score desc, row asc);
//   - then, up to k, what _select_topk (topk.py:77-94) picks once they run
//     out: (NEG_INF, base + c0) for the block's lowest column c0 scoring
//     >= NEG_INF, or, when every row scores -inf, (-inf, base) first and
//     (NEG_INF, base) after, base being the block's first stored row;
//   - then (NEG_INF, 0) up to k_pad.
// Scores are the brute kernels': bf16 f32(q)·f32(x) + bias; int8 the exact
// integer dot, then f32(acc) * (qs[q] * xs[row]) + bias[row] rounded op by
// op.
//
// Design. The TPU grid walks the blocks in order and selects each block
// with k passes of max / first-argmax over a [q_pad, block_rows] score
// tile in VMEM. Here the scan kernel of topk_select.cuh runs with its
// kBlocks flag: one CTA per (block, 8-query tile), the 128-row score tile,
// warp j keeping query j's sorted list in shared memory (the two k
// classes), with no threshold shared across blocks; the epilogue writes
// the fill and the pad. The merge stays outside, as the JAX package leaves
// it to XLA: it must order ties by candidate position, which for the IVF
// entries is probe order, not row order.
//
// Bound: HBM bytes. The kernel reads each scanned row once (2d or d bytes,
// plus 4 or 8 bytes of bias and scale) per 8-query tile, and writes
// n_blocks x q x k_pad x 8 bytes of candidates (8.4 MB at 1,048,576 rows,
// block_rows 1024, q = 8, k <= 128).
//
// Scoring: Bf16Scorer and Int8Scorer in topk_scorers.cuh.

#include "topk_scorers.cuh"

// <name>_launch(queries, qscale, x, xscale, bias, ids int32 [n_blocks] (IVF),
//               n_valid int32 [1] (IVF), cand_s f32 [n_blocks, q, k_pad],
//               cand_i int32 [n_blocks, q, k_pad], q, n, d, k, k_pad,
//               n_blocks, block_rows, stream)
BLOCKS_C_INTERFACE(topk_blocks_bf16, Bf16Scorer, false)
BLOCKS_C_INTERFACE(topk_blocks_int8, Int8Scorer, false)
BLOCKS_C_INTERFACE(ivf_topk_blocks_bf16, Bf16Scorer, true)
BLOCKS_C_INTERFACE(ivf_topk_blocks_int8, Int8Scorer, true)

extern "C" const char* topk_blocks_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
