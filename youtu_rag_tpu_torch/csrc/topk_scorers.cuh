// The three scorers of the port's scan kernels (see topk_select.cuh for
// the Scorer contract): bf16 rows (Bf16Scorer), int8 rows (Int8Scorer) and
// int4-packed rows (Int4Scorer). Shared by the brute sources
// (topk_pruned.cu, topk_int8_pruned.cu, topk_int4_pruned.cu) and the IVF
// source (ivf_topk.cu), which differ only in where a CTA's rows come from.

#pragma once

#include <cuda_bf16.h>

#include "topk_select.cuh"

namespace {

__device__ __forceinline__ void bf16x2_to_f32(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// bf16: the query tile sits in shared memory as f32; each lane reads
// 16-byte chunks (8 bf16) of its warp's 4 rows and accumulates with
// CUDA-core FMAs, which keep up with HBM at these query counts.
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

// int8: the query tile sits in shared memory as int8 [8, d]; each lane
// reads 16-byte chunks (16 int8) of its warp's 4 rows and takes 4 __dp4a
// per (row, query) pair. Integer sums are exact, so the butterfly's order
// does not matter and the scores equal the plain version's bit for bit.
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

    // one pointer walks the group's first row, as in Bf16Scorer
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

// int4: no sign extension per nibble. A nibble x in [-8, 7] stored as 4
// bits becomes u = x + 8 in [0, 15] by flipping its bit 3, so one XOR with
// 0x88888888, one shift and two masks turn a 32-bit word into the biased
// low and high nibbles of its 4 bytes, each a non-negative int8 that
// __dp4a takes as it is. Then
//   dot(q, x) = dot(q, u) - 8 * sum(q),
// and sum(q) over all d columns is one integer per query, computed once per
// CTA. All sums are exact integers, so the order of the butterfly does not
// matter and the scores equal the plain version's bit for bit.
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

    // one pointer walks the group's first row, as in Bf16Scorer
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
