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
// kernel on half the bytes (32 per byte at q = 8), plus the unpack, so on
// the CUDA cores it may meet its compute time before its HBM time.
//
// Design: no sign extension per nibble. A nibble x in [-8, 7] stored as
// 4 bits becomes u = x + 8 in [0, 15] by flipping its bit 3, so one XOR
// with 0x88888888, one shift and two masks turn a 32-bit word into the
// biased low and high nibbles of its 4 bytes, each a non-negative int8
// that __dp4a takes as it is. Then
//   dot(q, x) = dot(q, u) - 8 * sum(q),
// and sum(q) over all d columns is one integer per query, computed once per
// CTA. All sums are exact integers, so the order of the butterfly does not
// matter and the scores equal the plain version's bit for bit.

#include "topk_select.cuh"

namespace {

struct Int4Scorer {
  static constexpr bool kScaled = true;

  // the packed width d/2 must be a multiple of 128, as the TPU kernel asserts
  static __host__ __device__ bool width_ok(int d) { return d % 256 == 0; }

  // the query tile as int8 [kQT, d], then 8 * sum(q) per query as int32
  static __host__ __device__ size_t q_bytes(int d) {
    return (size_t)kQT * d + 16 * ((kQT * sizeof(int) + 15) / 16);
  }

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
    // warp j sums query j (kWarps == kQT)
    int* qcorr = reinterpret_cast<int*>(qt + (size_t)kQT * d);
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    int s = 0;
    if (warp < q_valid)
      for (int e = lane; e < d; e += 32) s += qq[(size_t)(q0 + warp) * d + e];
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) qcorr[warp] = 8 * s;
  }

  static __device__ __forceinline__ float group(const unsigned char* qt, const void* xp,
                                                int row0, int row_end, int d, int lane) {
    const int8_t* x = static_cast<const int8_t*>(xp);
    const int half = d / 2;          // packed bytes per row
    const int n_chunks = half / 16;  // 16-byte chunks per packed row
    int acc[kR * kQT];
#pragma unroll
    for (int v = 0; v < kR * kQT; ++v) acc[v] = 0;

    // one pointer walks the group's first row, as in topk_pruned.cu
    const uint4* xw = reinterpret_cast<const uint4*>(x + (size_t)row0 * half) + lane;
    for (int c = lane; c < n_chunks && row0 < row_end; c += 32, xw += 32) {
      uint4 xv[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r)
        xv[r] = row0 + r < row_end ? __ldg(xw + r * n_chunks) : make_uint4(0, 0, 0, 0);
      // biased nibbles: lo[r][w] holds columns c*16 + 4w .. +3, hi[r][w]
      // the same columns + d/2
      int lo[kR][4], hi[kR][4];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const uint32_t w[4] = {xv[r].x ^ 0x88888888u, xv[r].y ^ 0x88888888u,
                               xv[r].z ^ 0x88888888u, xv[r].w ^ 0x88888888u};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          lo[r][t] = (int)(w[t] & 0x0f0f0f0fu);
          hi[r][t] = (int)((w[t] >> 4) & 0x0f0f0f0fu);
        }
      }
#pragma unroll
      for (int j = 0; j < kQT; ++j) {
        const int4 ql = reinterpret_cast<const int4*>(qt + j * d)[c];
        const int4 qh = reinterpret_cast<const int4*>(qt + j * d + half)[c];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          int t = acc[r * kQT + j];
          t = __dp4a(ql.x, lo[r][0], t);
          t = __dp4a(ql.y, lo[r][1], t);
          t = __dp4a(ql.z, lo[r][2], t);
          t = __dp4a(ql.w, lo[r][3], t);
          t = __dp4a(qh.x, hi[r][0], t);
          t = __dp4a(qh.y, hi[r][1], t);
          t = __dp4a(qh.z, hi[r][2], t);
          t = __dp4a(qh.w, hi[r][3], t);
          acc[r * kQT + j] = t;
        }
      }
    }
    butterfly(acc, lane);
    const int* qcorr = reinterpret_cast<const int*>(qt + (size_t)kQT * d);
    return __int2float_rn(acc[0] - qcorr[lane % kQT]);
  }
};

}  // namespace

// topk_int4_pruned_launch(queries int8 [q, d], qscale f32 [q],
//                         x packed int8 [n, d/2], xscale f32 [n], bias f32 [n],
//                         ..., d = the unpacked width, ...)
TOPK_C_INTERFACE(topk_int4_pruned, Int4Scorer)
