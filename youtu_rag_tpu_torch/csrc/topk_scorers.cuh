// The three scorers of the port's scan kernels (see topk_select.cuh for
// the Scorer contract): bf16 rows (Bf16Scorer) and int8 rows (Int8Scorer)
// score a 4-row group per warp step on the CUDA cores; int4-packed rows
// (Int4Scorer) score a warp's 16 rows at once on the tensor cores. Shared
// by the brute sources (topk_pruned.cu, topk_int8_pruned.cu,
// topk_int4_pruned.cu) and the per-block candidates (topk_blocks.cu). The
// IVF scans (ivf_scan_tma.cuh) score on their own ring with mma_u8s8 and
// Int4Scorer's nibble arithmetic.

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
  static constexpr int kWarpRows = kR;  // group(): 4 rows per warp step

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
  static constexpr int kWarpRows = kR;  // group(): 4 rows per warp step

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

// d = A . B + d over one k32 step: A 16 x 32 u8 (row major), B 32 x 8 s8
// (column major), d 16 x 8 s32, exact
__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// int4 on the tensor cores. No sign extension per nibble: a nibble x in
// [-8, 7] stored as 4 bits becomes u = x + 8 in [0, 15] by flipping its
// bit 3, so one XOR with 0x88888888, one shift and two masks turn a 32-bit
// word of packed bytes into the biased low and high nibbles of its 4
// bytes, four u8 values each. Then
//   dot(q, x) = dot(q, u) - 8 * sum(q),
// and sum(q) over all d columns is one integer per query, computed once per
// CTA. dot(q, u) is mma.sync m16n8k32 (u8 rows x s8 queries, s32 sums):
// A = the biased nibbles of the warp's 16 rows, B = the tile's 8 queries
// (kQT), so one warp scores its share of the 128-row tile (8 warps x 16)
// with no shuffle. All sums are exact integers, so the order of the k
// columns does not matter and the scores equal the plain version's bit for
// bit.
//
// Column order. A k32 step takes, for lane (g, t) = (lane / 4, lane % 4),
// A's k columns 4t..4t+3 and 16+4t..16+4t+3 of rows g and g + 8, and B's
// same k columns of query g. The scorer maps them onto stored columns so
// that each lane fills its fragments from 16-byte loads: lane (g, t) reads
// packed chunk ch = t, t + 4, ... (16 bytes, packed columns 16ch..16ch+15)
// of rows g and g + 8, and word w of the chunk gives k step (ch, w): the
// low nibbles (columns 16ch + 4w..+3) as k 4t..4t+3, the high nibbles
// (columns d/2 + 16ch + 4w..+3) as k 16+4t... B's registers are then
// plain words of the query row, read as 16-byte chunks ch of its low and
// high halves from the query tile in shared memory (rows padded by kQPad
// bytes, so that the 8 lanes of a quarter-warp hit distinct banks), once
// per chunk and warp (at d = 768, 12 loads a lane per 128-row tile).
struct Int4Scorer {
  static constexpr bool kScaled = true;
  static constexpr int kWarpRows = 16;  // warp_tile(): a warp's 16 rows at once
  static constexpr int kQPad = 64;      // bytes of padding per query row in shared memory

  // the packed width d/2 must be a multiple of 128, as the TPU kernel asserts
  // (so the 16-byte chunks of a packed row come in whole rounds of 8)
  static __host__ __device__ bool width_ok(int d) { return d % 256 == 0; }

  // the query tile as int8 [kQT, d + kQPad], then 8 * sum(q) per query as int32
  static __host__ __device__ size_t q_bytes(int d) {
    return (size_t)kQT * (d + kQPad) + 16 * ((kQT * sizeof(int) + 15) / 16);
  }

  static __device__ void load_queries(unsigned char* qt, const void* queries, int q0,
                                      int q_valid, int d) {
    const int8_t* qq = static_cast<const int8_t*>(queries);
    const int words = d / 16;                // 16-byte words per query row
    const int stride = (d + kQPad) / 16;     // the same, padded, in shared memory
    for (int e = threadIdx.x; e < kQT * words; e += blockDim.x) {
      const int j = e / words, w = e % words;
      reinterpret_cast<int4*>(qt)[j * stride + w] =
          j < q_valid ? reinterpret_cast<const int4*>(qq + (size_t)(q0 + j) * d)[w]
                      : make_int4(0, 0, 0, 0);
    }
    // warp j sums query j (kWarps == kQT)
    int* qcorr = reinterpret_cast<int*>(qt + (size_t)kQT * (d + kQPad));
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    int s = 0;
    if (warp < q_valid)
      for (int e = lane; e < d; e += 32) s += qq[(size_t)(q0 + warp) * d + e];
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) qcorr[warp] = 8 * s;
  }

  // The warp's 16 rows against the tile's 8 queries. Lane (g, t) is given
  // the stored rows ra (row g of the 16) and rb (row g + 8), -1 for a row
  // past the range (it reads nothing and its scores are not used), and
  // returns out[e] = the dot of row (e < 2 ? ra : rb) with query 2t + (e & 1),
  // as f32, before the scales and the bias.
  static __device__ __forceinline__ void warp_tile(const unsigned char* qt, const void* xp, int ra,
                                                   int rb, int d, int lane, float (&out)[4]) {
    const int half = d / 2;          // packed bytes per row
    const int n_chunks = half / 16;  // 16-byte chunks per packed row, a multiple of 8
    const int g = lane >> 2, t = lane & 3;
    int acc[4] = {0, 0, 0, 0};
    if (__any_sync(kFull, ra >= 0)) {  // rb >= 0 only where ra >= 0
      const int8_t* x = static_cast<const int8_t*>(xp);
      const uint4* pa = reinterpret_cast<const uint4*>(x + (size_t)max(ra, 0) * half);
      const uint4* pb = reinterpret_cast<const uint4*>(x + (size_t)max(rb, 0) * half);
      const unsigned char* qrow = qt + g * (d + kQPad);
      const uint4* ql = reinterpret_cast<const uint4*>(qrow);         // query g's low half
      const uint4* qh = reinterpret_cast<const uint4*>(qrow + half);  // and its high half
      const uint4 zero = make_uint4(0, 0, 0, 0);
      // two chunks per row in flight, and the next two loading while these
      // are scored (n_chunks / 4 chunks per lane, an even count)
      uint4 xa[2], xb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xa[i] = ra >= 0 ? __ldg(pa + t + 4 * i) : zero;
        xb[i] = rb >= 0 ? __ldg(pb + t + 4 * i) : zero;
      }
      for (int ch = t; ch < n_chunks; ch += 8) {
        uint4 na[2], nb[2];
        const bool more = ch + 8 < n_chunks;  // warp-uniform: n_chunks % 8 == 0
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          na[i] = more && ra >= 0 ? __ldg(pa + ch + 8 + 4 * i) : zero;
          nb[i] = more && rb >= 0 ? __ldg(pb + ch + 8 + 4 * i) : zero;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint4 bl = ql[ch + 4 * i], bh = qh[ch + 4 * i];
          const uint32_t wa[4] = {xa[i].x, xa[i].y, xa[i].z, xa[i].w};
          const uint32_t wb[4] = {xb[i].x, xb[i].y, xb[i].z, xb[i].w};
          const uint32_t lo[4] = {bl.x, bl.y, bl.z, bl.w};
          const uint32_t hi[4] = {bh.x, bh.y, bh.z, bh.w};
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const uint32_t ua = wa[w] ^ 0x88888888u, ub = wb[w] ^ 0x88888888u;
            const uint32_t a[4] = {ua & 0x0f0f0f0fu, ub & 0x0f0f0f0fu, (ua >> 4) & 0x0f0f0f0fu,
                                   (ub >> 4) & 0x0f0f0f0fu};
            const uint32_t b[2] = {lo[w], hi[w]};
            mma_u8s8(acc, a, b);
          }
          xa[i] = na[i];
          xb[i] = nb[i];
        }
      }
    }
    const int* qcorr = reinterpret_cast<const int*>(qt + (size_t)kQT * (d + kQPad));
    const int c0 = qcorr[2 * t], c1 = qcorr[2 * t + 1];
    out[0] = __int2float_rn(acc[0] - c0);
    out[1] = __int2float_rn(acc[1] - c1);
    out[2] = __int2float_rn(acc[2] - c0);
    out[3] = __int2float_rn(acc[3] - c1);
  }
};

}  // namespace
