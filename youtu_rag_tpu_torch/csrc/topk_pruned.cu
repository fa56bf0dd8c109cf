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
// Scoring: the query tile sits in shared memory as f32; each lane reads
// 16-byte chunks (8 bf16) of its warp's 4 rows and accumulates with
// CUDA-core FMAs, which keep up with HBM at these query counts.

#include <cuda_bf16.h>

#include "topk_select.cuh"

namespace {

__device__ __forceinline__ void bf16x2_to_f32(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

struct Bf16Scorer {
  static constexpr bool kScaled = false;

  static __host__ __device__ bool width_ok(int d) { return d % 128 == 0; }

  // the query tile as f32 [kQT, d]
  static __host__ __device__ size_t q_bytes(int d) { return sizeof(float) * kQT * d; }

  static __device__ void load_queries(unsigned char* qt, const void* queries, int q0,
                                      int q_valid, int d) {
    float* qs = reinterpret_cast<float*>(qt);
    const __nv_bfloat16* qq = static_cast<const __nv_bfloat16*>(queries);
    // rows past q are zero
    for (int e = threadIdx.x; e < kQT * d; e += blockDim.x) {
      int j = e / d;
      qs[e] = j < q_valid ? __bfloat162float(qq[(size_t)(q0 + j) * d + e % d]) : 0.f;
    }
  }

  static __device__ __forceinline__ float group(const unsigned char* qt, const void* xp,
                                                int row0, int row_end, int d, int lane) {
    const float* qs = reinterpret_cast<const float*>(qt);
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(xp);
    const int n_chunks = d / 8;  // 16-byte chunks per row
    float acc[kR * kQT];
#pragma unroll
    for (int v = 0; v < kR * kQT; ++v) acc[v] = 0.f;

    // one 64-bit pointer walks the group's first row and the other rows
    // sit 32-bit multiples of the row stride from it: four row pointers
    // held across the loop would push the kernel past 128 registers
    const uint4* xw = reinterpret_cast<const uint4*>(x + (size_t)row0 * d) + lane;
    for (int c = lane; c < n_chunks && row0 < row_end; c += 32, xw += 32) {
      uint4 xv[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r)
        xv[r] = row0 + r < row_end ? __ldg(xw + r * n_chunks) : make_uint4(0, 0, 0, 0);
      float xf[kR][8];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        bf16x2_to_f32(xv[r].x, xf[r][0], xf[r][1]);
        bf16x2_to_f32(xv[r].y, xf[r][2], xf[r][3]);
        bf16x2_to_f32(xv[r].z, xf[r][4], xf[r][5]);
        bf16x2_to_f32(xv[r].w, xf[r][6], xf[r][7]);
      }
#pragma unroll
      for (int j = 0; j < kQT; ++j) {
        const float4* qp = reinterpret_cast<const float4*>(qs + j * d + c * 8);
        float4 a = qp[0], b = qp[1];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          float t = acc[r * kQT + j];
          t = fmaf(a.x, xf[r][0], t);
          t = fmaf(a.y, xf[r][1], t);
          t = fmaf(a.z, xf[r][2], t);
          t = fmaf(a.w, xf[r][3], t);
          t = fmaf(b.x, xf[r][4], t);
          t = fmaf(b.y, xf[r][5], t);
          t = fmaf(b.z, xf[r][6], t);
          t = fmaf(b.w, xf[r][7], t);
          acc[r * kQT + j] = t;
        }
      }
    }
    butterfly(acc, lane);
    return acc[0];
  }
};

}  // namespace

// topk_pruned_launch(queries bf16 [q, d], qscale = NULL, x bf16 [n, d],
//                    xscale = NULL, bias, ...)
TOPK_C_INTERFACE(topk_pruned, Bf16Scorer)
