// Blockwise and flash attention for the encoder, for Hopper (sm_90a).
//
// Replaces three TPU kernels of youtu_rag_tpu/ops/attention.py:
//   blockwise_attention_launch     -> blockwise_attention   (kernel _attn_kernel)
//   flash_attention_launch         -> flash_attention       (kernel _flash_kernel)
//   flash_attention_stats_launch   -> flash_attention_stats (kernel _flash_stats_kernel)
// Same contract, for q [B, H, T, hd], k, v [B, H, T_kv, hd] (T_kv == T but
// for the stats entry) and a key bias [B, T_kv] already clamped to -1e30 by
// the wrapper:
//   s = sum_d f32(q) * f32(k)  (f32 sums), then s * scale + bias (two roundings)
//   blockwise: p = cast(exp(s - max) / sum) to v's type, out = cast(p . v)
//   flash:     online softmax, running max from -1e30; the unnormalized
//              exp(s - m) is cast to v's type for p . v, out = cast(acc / l)
//   stats:     the flash entry's one pass over a K/V span of T_kv keys (the
//              inner step of ring attention, one hop), ending without the
//              divide: acc = sum exp(s - m) . cast(v) f32 [B, H, T, hd], and
//              the running max m and denominator l f32 [B, H, T]. Its key
//              tiles (128 keys in bf16, 64 in f32) are not JAX's 1024-key
//              blocks: m is the same maximum; l and acc agree within f32
//              summation order and the bf16 rounding of p, as the flash
//              entry's output does.
// exp is the ex2-based __expf and blockwise divides by a product with the
// f32 reciprocal of the sum: each within a few f32 ulps of the plain
// version's exp and division, far inside the one-bf16-ulp tolerance that
// covers where the casts fall.
//
// Bound: 4*B*H*T^2*hd flops (q.k and p.v) against 4*B*H*T*hd elements
// read and written, i.e. T/2 flops per byte in bf16 against the card's
// ~295: at the encoder's T = 512 the bytes bound it, barely (0.120 ms a
// layer at B = 128, H = 12, hd = 64, against 0.104 ms of products), and
// the products from T ~ 600 up (flash at T = 8192: 0.417 ms at B = 2).
// Stats: 4*B*H*T*T_kv*hd operations at 989 TFLOP/s against the bytes of q,
// k, v, the bias, acc, m and l: the operations from T_kv ~ 600 up (one hop
// of sp 4 over T = 32,768, [2, 12, 8192, 64] against 8192 keys: 0.417 ms).
//
// Design. Every bf16 call of the three entries, hd 64 and 128, runs the
// Hopper kernels of attention_wgmma.cuh: a warp-specialized CTA (a TMA
// producer warpgroup, two consumer warpgroups of 64 query rows taking
// turns at the tensor cores), K/V tiles of 128 keys in an mbarrier ring,
// both products on wgmma, one persistent CTA per SM; the stats entry is
// its third entry (K/V maps of T_kv rows, an f32 epilogue without the
// divide). The header says why and what bounds it. The kernel below is the
// first, simple design, and serves the f32 calls: one CTA per (batch x
// head, query tile), each warp 16 query rows (blockwise 64-row tiles, 4
// warps; flash and stats 128-row tiles, 8 warps), K and V streamed through
// shared memory in 64-key tiles double-buffered with cp.async, both
// products on mma.sync m16n8k16 (bf16 terms, f32 sums). Blockwise keeps
// the JAX rounding points with two passes over K: the first finds each
// row's max and denominator, the second forms cast(exp(s - m) / l) and
// p . v (1.5x the products of one pass). Flash is the one-pass online
// softmax; stats is flash under a template flag, with its own key length
// and another epilogue. f32 inputs split each operand into three bf16
// terms (hi + mid + lo, exact) and sum the six products that matter, so
// the f32 path keeps near-f32 products on the same code path (wgmma's
// tf32 would not be exact).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_wgmma.cuh"

namespace {

constexpr int kBK = 64;  // keys per shared-memory tile
constexpr int kPad = 8;  // elements of padding per shared row: spreads banks, keeps 16-byte rows
constexpr float kClamp = -1e30f;

template <bool kFlash>
struct Shape {
  static constexpr int kBQ = kFlash ? 128 : 64;  // query rows per CTA, 16 per warp
  static constexpr int kThreads = kBQ / 16 * 32;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// An operand type's fragment registers: two neighbouring elements of a
// row per 32-bit register, as kTerms bf16 terms. Only f32 reaches this
// template (bf16 runs attention_wgmma.cuh).
template <typename T>
struct Operand;

template <>
struct Operand<float> {
  static constexpr int kTerms = 3;
  // x = hi + mid + lo exactly: 8 + 8 + 8 significant bits of f32's 24
  static __device__ __forceinline__ void pack(float a, float b, uint32_t (&r)[3]) {
    __nv_bfloat16 ah = __float2bfloat16_rn(a), bh = __float2bfloat16_rn(b);
    float ar = a - __bfloat162float(ah), br = b - __bfloat162float(bh);
    __nv_bfloat16 am = __float2bfloat16_rn(ar), bm = __float2bfloat16_rn(br);
    r[0] = pack_bf16(__bfloat162float(ah), __bfloat162float(bh));
    r[1] = pack_bf16(__bfloat162float(am), __bfloat162float(bm));
    r[2] = pack_bf16(ar - __bfloat162float(am), br - __bfloat162float(bm));
  }
  static __device__ __forceinline__ void load(const float* p, uint32_t (&r)[3]) {
    float2 f = *reinterpret_cast<const float2*>(p);
    pack(f.x, f.y, r);
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b over N-term operands: the products of terms i and j with
// i + j < N, the smallest first
template <int N>
__device__ __forceinline__ void mma_terms(float (&c)[4], const uint32_t (&a)[N][4],
                                          const uint32_t (&b)[N][2]) {
#pragma unroll
  for (int s = N - 1; s >= 0; --s)
#pragma unroll
    for (int i = 0; i <= s; ++i) mma_bf16(c, a[i], b[s - i]);
}

// A fragment (16 x 16, row major) of rows r0.. and columns k0.. of a
// shared tile with row stride ld
template <typename T>
__device__ __forceinline__ void load_a(const T* tile, int ld, int r0, int k0, int lane,
                                       uint32_t (&a)[Operand<T>::kTerms][4]) {
  constexpr int N = Operand<T>::kTerms;
  const T* p = tile + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  const int off[4] = {0, 8 * ld, 8, 8 * ld + 8};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t r[N];
    Operand<T>::load(p + off[i], r);
#pragma unroll
    for (int s = 0; s < N; ++s) a[s][i] = r[s];
  }
}

// B fragment (16 x 8, k x n) from a shared tile stored n-major: rows n0..
// of the tile, columns k0.. (K for q . k)
template <typename T>
__device__ __forceinline__ void load_b(const T* tile, int ld, int n0, int k0, int lane,
                                       uint32_t (&b)[Operand<T>::kTerms][2]) {
  constexpr int N = Operand<T>::kTerms;
  const T* p = tile + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t r[N];
    Operand<T>::load(p + 8 * i, r);
#pragma unroll
    for (int s = 0; s < N; ++s) b[s][i] = r[s];
  }
}

// B fragments of two neighbouring n8 column blocks (n0 and n0 + 8) from a
// shared tile stored k-major, rows k0..k0+15 (V for p . v): element loads,
// split into terms.
template <typename T>
__device__ __forceinline__ void load_b_kmajor(const T* tile, int ld, int k0, int n0, int lane,
                                              uint32_t (&b0)[Operand<T>::kTerms][2],
                                              uint32_t (&b1)[Operand<T>::kTerms][2]) {
  constexpr int N = Operand<T>::kTerms;
  const T* p = tile + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const T* q = p + half * 8 + i * 8 * ld;
      uint32_t r[N];
      Operand<T>::pack(q[0], q[ld], r);
#pragma unroll
      for (int s = 0; s < N; ++s) (half ? b1 : b0)[s][i] = r[s];
    }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [0, rows) of src (row stride rs elements) into a shared tile, async
template <typename T, int HD, int kThreads>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src, long long rs, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int e = threadIdx.x; e < rows * kPerRow; e += kThreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * kVec;
    cp_async16(dst + r * ld + c, src + r * rs + c);
  }
}

__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;  // [B, T], clamped
  void* out;          // [B, H, T, hd], contiguous (stats: acc, f32)
  int h, t;
  long long qs[3], ks[3], vs[3];  // element strides of batch, head and row
  float scale;
};

// The stats entry's arguments: the span's own key count, bias [B, T_kv],
// and the outputs m and l [B, H, T] f32, contiguous. A struct of its own,
// so that the blockwise and flash entries keep their code.
struct StatsArgs : Args {
  float* m;
  float* l;
  int t_kv;
};

template <bool kStats>
using ArgsOf = typename std::conditional<kStats, StatsArgs, Args>::type;

__device__ __forceinline__ int keys_of(const Args& a) { return a.t; }
__device__ __forceinline__ int keys_of(const StatsArgs& a) { return a.t_kv; }

// shared memory: the query tile, two K and two V tiles, two bias tiles
template <typename T, int HD, bool kFlash>
constexpr size_t smem_bytes() {
  return sizeof(T) * (Shape<kFlash>::kBQ + 4 * kBK) * (HD + kPad) + sizeof(float) * 2 * kBK;
}

// The warp's 16 x 64 scores of one key tile: s = dot * scale + bias, in
// the mma C layout (tile j, element e: row g + 8 * (e >> 1), key
// j * 8 + 2 * t + (e & 1)).
template <typename T, int HD>
__device__ __forceinline__ void score_tile(const T* qs, const T* ks, const float* bs, int r0,
                                           int lane, float scale, float (&s)[kBK / 8][4]) {
  constexpr int N = Operand<T>::kTerms;
  constexpr int kLd = HD + kPad;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < HD; k0 += 16) {
    uint32_t a[N][4];
    load_a<T>(qs, kLd, r0, k0, lane, a);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      uint32_t b[N][2];
      load_b<T>(ks, kLd, j * 8, k0, lane, b);
      mma_terms<N>(s[j], a, b);
    }
  }
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = __fadd_rn(__fmul_rn(s[j][e], scale), bs[j * 8 + 2 * t + (e & 1)]);
}

// o += p . V over one key tile; p is cast (bf16) or split (f32) here
template <typename T, int HD>
__device__ __forceinline__ void pv_tile(const T* vs, int lane, const float (&p)[kBK / 8][4],
                                        float (&o)[HD / 8][4]) {
  constexpr int N = Operand<T>::kTerms;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t a[N][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // A registers: row g then g + 8 of key block 2kk, then of 2kk + 1
      const float* pj = p[2 * kk + (i >> 1)];
      uint32_t r[N];
      Operand<T>::pack(pj[2 * (i & 1)], pj[2 * (i & 1) + 1], r);
#pragma unroll
      for (int s = 0; s < N; ++s) a[s][i] = r[s];
    }
#pragma unroll
    for (int n = 0; n < HD / 8; n += 2) {
      uint32_t b0[N][2], b1[N][2];
      load_b_kmajor<T>(vs, HD + kPad, kk * 16, n * 8, lane, b0, b1);
      mma_terms<N>(o[n], a, b0);
      mma_terms<N>(o[n + 1], a, b1);
    }
  }
}

// Start the async copy of key tile kt (K, V when with_v, the bias) into
// buffer buf, as one commit group.
template <typename T, int HD, int kThreads>
__device__ __forceinline__ void stage_tile(T* ks, T* vs, float* bs, const T* kg, const T* vg,
                                           const float* bias, const Args& args, int kt, int buf,
                                           bool with_v) {
  constexpr int kTile = kBK * (HD + kPad);
  copy_rows<T, HD, kThreads>(ks + buf * kTile, HD + kPad, kg + kt * kBK * args.ks[2],
                             args.ks[2], kBK);
  if (with_v)
    copy_rows<T, HD, kThreads>(vs + buf * kTile, HD + kPad, vg + kt * kBK * args.vs[2],
                               args.vs[2], kBK);
  if (threadIdx.x < kBK / 4)
    cp_async16(bs + buf * kBK + 4 * threadIdx.x, bias + kt * kBK + 4 * threadIdx.x);
  cp_async_commit();
}

template <typename T, int HD, bool kFlash, bool kStats = false>
__global__ void __launch_bounds__(Shape<kFlash>::kThreads) attention_kernel(ArgsOf<kStats> args) {
  static_assert(kFlash || !kStats, "stats is the flash kernel's epilogue");
  constexpr int kBQ = Shape<kFlash>::kBQ, kThreads = Shape<kFlash>::kThreads;
  constexpr int kLd = HD + kPad, kTile = kBK * kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = qs + kBQ * kLd;  // two K tiles
  T* vs = ks + 2 * kTile;  // two V tiles, row-major
  float* bs = reinterpret_cast<float*>(vs + 2 * kTile);  // two bias tiles

  const int bh = blockIdx.y, b = bh / args.h, h = bh % args.h;
  const int q0 = blockIdx.x * kBQ;
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 16;
  const T* qg = static_cast<const T*>(args.q) + b * args.qs[0] + h * args.qs[1];
  const T* kg = static_cast<const T*>(args.k) + b * args.ks[0] + h * args.ks[1];
  const T* vg = static_cast<const T*>(args.v) + b * args.vs[0] + h * args.vs[1];
  const float* bias = args.bias + (size_t)b * keys_of(args);
  const int n_tiles = keys_of(args) / kBK;

  // the query tile joins the first tile's commit group
  copy_rows<T, HD, kThreads>(qs, kLd, qg + q0 * args.qs[2], args.qs[2], kBQ);

  float m[2], l[2];  // rows g and g + 8; l is this thread's part of the sum
  float s[kBK / 8][4];
  if (!kFlash) {
    // pass 1: each row's max and softmax denominator over all keys
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
    stage_tile<T, HD, kThreads>(ks, vs, bs, kg, vg, bias, args, 0, 0, false);
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int buf = kt & 1;
      if (kt + 1 < n_tiles) {
        stage_tile<T, HD, kThreads>(ks, vs, bs, kg, vg, bias, args, kt + 1, buf ^ 1, false);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      score_tile<T, HD>(qs, ks + buf * kTile, bs + buf * kBK, r0, lane, args.scale, s);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = m[r];
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) mt = fmaxf(mt, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mt = group_max(mt);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
          sum += __expf(s[j][2 * r] - mt) + __expf(s[j][2 * r + 1] - mt);
        l[r] = l[r] * __expf(m[r] - mt) + sum;
        m[r] = mt;
      }
      __syncthreads();  // the buffer is free before the next copy into it
    }
    // the normalization's reciprocal: p / l as p * (1 / l)
    l[0] = 1.f / group_sum(l[0]);
    l[1] = 1.f / group_sum(l[1]);
  } else {
    m[0] = m[1] = kClamp;  // finite: -inf would NaN the rescale
    l[0] = l[1] = 0.f;
  }

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  stage_tile<T, HD, kThreads>(ks, vs, bs, kg, vg, bias, args, 0, 0, true);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      stage_tile<T, HD, kThreads>(ks, vs, bs, kg, vg, bias, args, kt + 1, buf ^ 1, true);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    score_tile<T, HD>(qs, ks + buf * kTile, bs + buf * kBK, r0, lane, args.scale, s);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!kFlash) {
        // normalized in f32 before the cast, as the blockwise kernel does
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) s[j][2 * r + c] = __expf(s[j][2 * r + c] - m[r]) * l[r];
      } else {
        float mt = m[r];
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) mt = fmaxf(mt, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mt = group_max(mt);
        const float alpha = __expf(m[r] - mt);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            s[j][2 * r + c] = __expf(s[j][2 * r + c] - mt);
            sum += s[j][2 * r + c];
          }
        l[r] = alpha * l[r] + sum;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
        }
        m[r] = mt;
      }
    }
    pv_tile<T, HD>(vs + buf * kTile, lane, s, o);
    __syncthreads();  // the buffer is free before the next copy into it
  }

  if (kFlash) {
    l[0] = group_sum(l[0]);
    l[1] = group_sum(l[1]);
  }
  if constexpr (kStats) {
    // no divide: acc, and the rows' running max and denominator
    const size_t row = (size_t)bh * args.t + q0 + r0 + (lane >> 2);
    float* ag = static_cast<float*>(args.out) + row * HD + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(ag + r * 8 * HD + n * 8) =
            make_float2(o[n][2 * r], o[n][2 * r + 1]);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        args.m[row + 8 * r] = m[r];
        args.l[row + 8 * r] = l[r];
      }
    }
    return;
  }
  T* og = static_cast<T*>(args.out) + ((size_t)bh * args.t + q0 + r0 + (lane >> 2)) * HD +
          2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = o[n][2 * r], y = o[n][2 * r + 1];
      if (kFlash) {
        x /= l[r];
        y /= l[r];
      }
      Operand<T>::store2(og + r * 8 * HD + n * 8, x, y);
    }
}

template <typename T, int HD, bool kFlash, bool kStats>
int launch_one(const ArgsOf<kStats>& a, int bh, cudaStream_t st) {
  auto kern = attention_kernel<T, HD, kFlash, kStats>;
  constexpr size_t smem = smem_bytes<T, HD, kFlash>();
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(a.t / Shape<kFlash>::kBQ, bh), Shape<kFlash>::kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool kFlash, bool kStats = false>
int launch(int is_f32, const void* q, const void* k, const void* v, const void* bias, void* out,
           float* m, float* l, int b, int h, int t, int t_kv, int hd, const long long* strides,
           float scale, void* stream) {
  // T and T_kv multiples of the Hopper kernels' 128-row and 128-key tiles
  // (the mma.sync kernel's 64 and 128 divide them); B x H on the grid's y
  if (b <= 0 || h <= 0 || t <= 0 || t_kv <= 0 || t % attention_wgmma::kBM ||
      t_kv % attention_wgmma::kBN || b * h > 65535 || (hd != 64 && hd != 128) ||
      (!kStats && t_kv != t))
    return (int)cudaErrorInvalidValue;
  ArgsOf<kStats> a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.h = h;
  a.t = t;
  if constexpr (kStats) {
    a.m = m;
    a.l = l;
    a.t_kv = t_kv;
  }
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
  }
  a.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32)
    return hd == 64 ? launch_one<float, 64, kFlash, kStats>(a, b * h, st)
                    : launch_one<float, 128, kFlash, kStats>(a, b * h, st);
  // bf16: the Hopper kernels, no other path
  const int entry = kStats ? attention_wgmma::kStats
                           : (kFlash ? attention_wgmma::kFlash : attention_wgmma::kBlockwise);
  return attention_wgmma::launch(entry, q, k, v, a.bias, out, m, l, b, h, t, t_kv, hd, strides,
                                 scale, st);
}

}  // namespace

// <name>_launch(is_f32, q, k, v, bias f32 [B, T] clamped, out [B, H, T, hd],
//               B, H, T, hd, 9 element strides (batch, head, row of q, k, v),
//               scale, stream). Returns cudaGetLastError() (0 = ok),
//               cudaErrorInvalidValue for shapes outside the contract, or
//               (bf16) a tensor-map failure of attention_wgmma.cuh.
extern "C" {
const char* attention_error_string(int err) {
  if (err == attention_wgmma::kErrEntryPoint)
    return "cuTensorMapEncodeTiled was not found in libcuda";
  if (err >= attention_wgmma::kErrEncode)
    return "cuTensorMapEncodeTiled refused a tensor map (CUresult = code - 1000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#define ATTENTION_ENTRY(NAME, FLASH)                                                          \
  int NAME(int is_f32, const void* q, const void* k, const void* v, const void* bias,        \
           void* out, int b, int h, int t, int hd, long long qsb, long long qsh,              \
           long long qst, long long ksb, long long ksh, long long kst, long long vsb,         \
           long long vsh, long long vst, float scale, void* stream) {                         \
    const long long strides[9] = {qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst};               \
    return launch<FLASH>(is_f32, q, k, v, bias, out, nullptr, nullptr, b, h, t, t, hd, strides, \
                         scale, stream);                                                       \
  }

ATTENTION_ENTRY(blockwise_attention_launch, false)
ATTENTION_ENTRY(flash_attention_launch, true)

// flash_attention_stats_launch(is_f32, q, k, v, bias f32 [B, T_kv] clamped,
//     acc f32 [B, H, T, hd], m f32 [B, H, T], l f32 [B, H, T], B, H, T, T_kv,
//     hd, 9 element strides, scale, stream): T and T_kv multiples of 128.
int flash_attention_stats_launch(int is_f32, const void* q, const void* k, const void* v,
                                 const void* bias, void* acc, void* m, void* l, int b, int h,
                                 int t, int t_kv, int hd, long long qsb, long long qsh,
                                 long long qst, long long ksb, long long ksh, long long kst,
                                 long long vsb, long long vsh, long long vst, float scale,
                                 void* stream) {
  const long long strides[9] = {qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst};
  return launch<true, true>(is_f32, q, k, v, bias, acc, static_cast<float*>(m),
                            static_cast<float*>(l), b, h, t, t_kv, hd, strides, scale, stream);
}
}
