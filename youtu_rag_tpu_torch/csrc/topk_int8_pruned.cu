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
// Scoring: the query tile sits in shared memory as int8 [8, d]; each lane
// reads 16-byte chunks (16 int8) of its warp's 4 rows and takes 4 __dp4a
// per (row, query) pair. Integer sums are exact, so the butterfly's order
// does not matter and the kernel's scores equal the plain version's bit
// for bit.

#include "topk_select.cuh"

namespace {

struct Int8Scorer {
  static constexpr bool kScaled = true;

  static __host__ __device__ bool width_ok(int d) { return d % 128 == 0; }

  // the query tile as int8 [kQT, d]
  static __host__ __device__ size_t q_bytes(int d) { return (size_t)kQT * d; }

  static __device__ void load_queries(unsigned char* qt, const void* queries, int q0,
                                      int q_valid, int d) {
    const int8_t* qq = static_cast<const int8_t*>(queries);
    const int words = d / 16;  // 16-byte words per query row
    for (int e = threadIdx.x; e < kQT * words; e += blockDim.x) {
      const int j = e / words;
      reinterpret_cast<int4*>(qt)[e] =
          j < q_valid ? reinterpret_cast<const int4*>(qq + (size_t)(q0 + j) * d)[e % words]
                      : make_int4(0, 0, 0, 0);
    }
  }

  static __device__ __forceinline__ float group(const unsigned char* qt, const void* xp,
                                                int row0, int row_end, int d, int lane) {
    const int8_t* x = static_cast<const int8_t*>(xp);
    const int n_chunks = d / 16;  // 16-byte chunks per row
    int acc[kR * kQT];
#pragma unroll
    for (int v = 0; v < kR * kQT; ++v) acc[v] = 0;

    // one pointer walks the group's first row, as in topk_pruned.cu
    const int4* xw = reinterpret_cast<const int4*>(x + (size_t)row0 * d) + lane;
    for (int c = lane; c < n_chunks && row0 < row_end; c += 32, xw += 32) {
      int4 xv[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r)
        xv[r] = row0 + r < row_end ? __ldg(xw + r * n_chunks) : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < kQT; ++j) {
        const int4 qv = reinterpret_cast<const int4*>(qt + j * d)[c];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          int t = acc[r * kQT + j];
          t = __dp4a(qv.x, xv[r].x, t);
          t = __dp4a(qv.y, xv[r].y, t);
          t = __dp4a(qv.z, xv[r].z, t);
          t = __dp4a(qv.w, xv[r].w, t);
          acc[r * kQT + j] = t;
        }
      }
    }
    butterfly(acc, lane);
    return __int2float_rn(acc[0]);
  }
};

}  // namespace

// topk_int8_pruned_launch(queries int8 [q, d], qscale f32 [q], x int8 [n, d],
//                         xscale f32 [n], bias f32 [n], ...)
TOPK_C_INTERFACE(topk_int8_pruned, Int8Scorer)
