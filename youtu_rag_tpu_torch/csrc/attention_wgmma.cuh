// The bf16 entries of attention.cu (blockwise, flash and the ring hop's
// stats entry), designed for Hopper (sm_90a): warp-specialized, fed by
// TMA, both products on wgmma, one persistent CTA per SM. attention.cu
// sends every bf16 call of blockwise_attention_launch, flash_attention_launch
// and flash_attention_stats_launch here, hd 64 and 128; only f32 calls stay
// on its mma.sync template.
//
// The contract is attention.cu's, rounding point for rounding point:
// s = __fadd_rn(__fmul_rn(dot, scale), bias) with the bias clamped to
// -1e30 by the wrapper (at hd 64 the scale is 1/8, dot * scale is exact,
// and one fused multiply-add gives the same value); blockwise: two
// passes, p = exp(s - m) * (1 / l) in f32, then the bf16 cast, out =
// cast(p . v); flash: the online softmax from a running max of -1e30,
// unnormalized bf16 p, out = cast(acc / l); stats: flash's pass over a
// K/V span of its own length T_kv, ending without the divide: acc f32
// [B, H, T, hd], and each row's running max m and denominator l f32
// [B, H, T]. exp is __expf's ex2(x log2 e) with its denormal results
// flushed to 0 (exp_ftz). A fully masked row averages v uniformly.
//
// Bound (at the main path's shapes, H100 SXM at 700 W): blockwise at
// [128, 12, 512, 64] moves 0.120 ms of bytes against 0.104 ms of products
// (one pass's worth; the two passes issue 1.5x that) and needs 805 M exps
// (two per score, ~0.21 ms on the MUFU units); flash at [2, 12, 8192, 64]
// is held by its 0.417 ms of products and 1.61 G exps (~0.41 ms), and so
// is the stats entry at the same shape against 8192 keys (its f32 acc
// doubles the output bytes: 50 MB, 0.015 ms). So the design keeps the
// tensor cores and the exp units busy at the same time:
//
// - CTA of 384 threads. Warpgroup 0 is the producer: setmaxnreg.dec to
//   40 registers, one thread issues every copy. Warpgroups 1 and 2 are
//   consumers (setmaxnreg.inc to 232), each owning 64 query rows of a
//   128-row work item, so a wgmma's B tile serves 64 rows at once.
// - TMA: 4-d tensor maps (hd, T, H, B) over the wrapper's own strides
//   (the encoder's v is a transposed view), encoded on the host through
//   cudaGetDriverEntryPoint (no -lcuda), 128-byte swizzle, boxes
//   of 64 columns (hd 128: two per tile). The Q tile is loaded once per
//   item, into one of two slots, so the next item's Q arrives during this
//   one. K and V tiles of 128 keys and the tile's f32 bias (a plain bulk
//   copy) ride a ring of kStages stages (4 at hd 64, 2 at hd 128 for
//   shared memory), each with a full and an empty mbarrier. The stats
//   entry's K and V maps have T_kv rows, and its bias row T_kv keys.
// - S = Q . K^T is wgmma m64n128k16, both operands from shared memory
//   (K-major). P . V is wgmma m64n{hd}k16 with P in registers: the f32 C
//   layout of two n8 blocks of S, packed to bf16, is the A layout. V is
//   read from shared memory in its natural [keys, hd] layout through the
//   transpose mode (MN-major).
// - Ping-pong: the two consumers take turns at the tensor cores through
//   two named barriers, so that one warpgroup's exps, rescales and packing
//   run while the other's products do. In the P . V loop one turn issues
//   Q . K^T of tile j and P . V of tile j - 1; tile j's softmax then runs
//   while that P . V does (flash and stats rescale o once it has landed).
//   Tile 0 is peeled out of the loop (a branch between a wgmma and its
//   wait makes ptxas serialize the wgmmas); a span of one tile (T_kv = 128)
//   is that peeled tile alone.
// - Persistent grid: min(items, SMs) CTAs walk the (batch x head, q tile)
//   items in order, the four q tiles of a head on neighbouring CTAs. The
//   producer loads the next item's tiles while the consumers finish and
//   store the last one.
// - Blockwise keeps its two passes (pass 1: K and the bias for each row's
//   max and denominator; pass 2: K, V and the bias again). K is streamed
//   twice at every T rather than kept resident for T <= 512: its second
//   read comes from L2 (a head's K is 64 KB at T = 512 and the head's q
//   tiles run together), so residency would save L2 traffic, not HBM
//   bytes, and one ring then serves every T. There is no cut-over.
// - The output is stored from registers: bf16 pairs (blockwise, flash) or
//   f32 pairs of acc and, from one thread of each row's quad, m and l
//   (stats).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing links against libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace attention_wgmma {

constexpr int kBM = 128;        // query rows per work item, 64 per consumer warpgroup
constexpr int kBN = 128;        // keys per ring stage
constexpr int kThreads = 384;   // the producer warpgroup and two consumer warpgroups
constexpr int kRowBytes = 128;  // one swizzled row of a sub-tile: 64 bf16
constexpr int kConsumers = 256;  // consumer threads: each arrives on an empty barrier
constexpr float kClamp = -1e30f;
constexpr int kErrEntryPoint = 999;  // cuTensorMapEncodeTiled was not found
constexpr int kErrEncode = 1000;     // + the CUresult of a failed cuTensorMapEncodeTiled

template <int HD>
struct Plan {
  static constexpr int kSub = HD / 64;  // 64-column sub-tiles of a row, one TMA box each
  static constexpr int kStages = HD == 64 ? 4 : 2;
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kTileBytes = kBN * HD * 2;  // one K or V tile
  static constexpr int kBiasBytes = kBN * 4;
  static constexpr int kStageBytes = 2 * kTileBytes + 1024;  // K, V, the bias; 1024-aligned
  static constexpr int kBarOffset = 2 * kQBytes + kStages * kStageBytes;
  // 1024 bytes to align the base for the swizzle, then the barriers
  static constexpr int kSmem = 1024 + kBarOffset + 8 * (2 * kStages + 4);
};
static_assert(Plan<64>::kSmem <= 232448 && Plan<128>::kSmem <= 232448, "shared memory");

// the three entries; flash and stats share the online softmax
enum Entry { kBlockwise = 0, kFlash = 1, kStats = 2 };

struct Args {
  const float* bias;  // [B, T], clamped
  __nv_bfloat16* out;  // [B, H, T, hd], contiguous
  int h, t, n_items;
  float scale;
};

// The stats entry's arguments: the span's key count (bias [B, T_kv]) and
// the f32 outputs, contiguous. A struct of its own, so that the blockwise
// and flash instantiations keep their parameters and registers.
struct StatsArgs : Args {
  float* acc;  // [B, H, T, hd]
  float* m;    // [B, H, T]
  float* l;    // [B, H, T]
  int t_kv;
};

template <int kEntry>
using ArgsOf = typename std::conditional<kEntry == kStats, StatsArgs, Args>::type;

__device__ __forceinline__ int keys_of(const Args& a) { return a.t; }
__device__ __forceinline__ int keys_of(const StatsArgs& a) { return a.t_kv; }

// shared memory: two Q tiles, the ring's stages, the barriers
template <int HD>
struct Layout {
  using P = Plan<HD>;
  uint32_t base;        // shared address, 1024-aligned
  unsigned char* ptr;   // the same, generic
  __device__ uint32_t q(int slot) const { return base + slot * P::kQBytes; }
  __device__ uint32_t k(int s) const { return base + 2 * P::kQBytes + s * P::kStageBytes; }
  __device__ uint32_t v(int s) const { return k(s) + P::kTileBytes; }
  __device__ uint32_t bias(int s) const { return k(s) + 2 * P::kTileBytes; }
  __device__ const float* bias_ptr(int s) const {
    return reinterpret_cast<const float*>(ptr + (bias(s) - base));
  }
  __device__ uint32_t full(int s) const { return base + P::kBarOffset + 8 * s; }
  __device__ uint32_t empty(int s) const { return full(P::kStages + s); }
  __device__ uint32_t q_full(int slot) const { return full(2 * P::kStages + slot); }
  __device__ uint32_t q_empty(int slot) const { return full(2 * P::kStages + 2 + slot); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` contiguous bytes into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the consumers' turns at the tensor cores: named barriers 1 and 2, each
// completed by one warpgroup's bar.sync and the other's bar.arrive
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of this warpgroup's committed wgmma groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from touching registers a wgmma still reads or writes
// before wgmma_wait: every use of them is ordered after this point
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: the start
// address and the leading and stride byte offsets, in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// d = A . B over one k16 step, A (64 x 16) and B (16 x 128) from shared
// memory, both K-major: the first step of a product, d written only
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]),
        "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
        "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]),
        "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]),
        "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]),
        "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// d += A . B over one k16 step, A (64 x 16) and B (16 x 128) from shared
// memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d += A . B over one k16 step, A (64 x 16 bf16) from registers, B
// (16 x 64) from shared memory, MN-major (the transpose mode)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B over one k16 step, A (64 x 16 bf16) from registers, B
// (16 x 128) from shared memory, MN-major (the transpose mode)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// e^x as __expf computes it, ex2(x * log2 e) on the MUFU unit, but with
// flush-to-zero: a result below 2^-126 (1.2e-38) becomes 0 instead of
// taking three more instructions to be made a denormal. Such a p cannot
// move a bf16 output: every row's max key contributes e^0 = 1.
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S = Q . K^T for this warpgroup's 64 rows and the stage's 128 keys. The
// C layout: element 4c + e is row g + 8 * (e >> 1) of the warp's 16, key
// 8c + 2 * (lane & 3) + (e & 1). A k16 step is 32 bytes into a 128-byte
// swizzled row; hd 128 moves to the second sub-tile after four.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q, uint32_t k) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t qa = q + (kk / 4) * kBM * kRowBytes + (kk % 4) * 32;
    const uint32_t ka = k + (kk / 4) * kBN * kRowBytes + (kk % 4) * 32;
    if (kk == 0)
      wgmma_ss_n128_first(s, desc(qa, 16, 8 * kRowBytes), desc(ka, 16, 8 * kRowBytes));
    else
      wgmma_ss_n128(s, desc(qa, 16, 8 * kRowBytes), desc(ka, 16, 8 * kRowBytes));
  }
  wgmma_commit();
}

// o += P . V over the stage's 128 keys: k16 step kk takes keys 16kk.. of
// V (16 rows of 128 bytes further), 8-key groups 1024 bytes apart, and
// (hd 128) the next 64 columns one sub-tile on
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&p)[8][4],
                                         uint32_t v) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t db = desc(v + kk * 16 * kRowBytes, kBN * kRowBytes, 8 * kRowBytes);
    if constexpr (HD == 64)
      wgmma_rs_n64(o, p[kk], db);
    else
      wgmma_rs_n128(o, p[kk], db);
  }
  wgmma_commit();
}

// s = dot * scale + bias, two roundings, as attention.cu. kFma (hd 64):
// the scale is 1/8, a power of two, so dot * scale is exact and one fused
// multiply-add rounds once to the same value (launch() refuses any other
// scale at hd 64).
template <bool kFma>
__device__ __forceinline__ void scale_bias(float (&s)[64], const float* bias, float scale,
                                           int t4) {
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * c + 2 * t4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float be = e & 1 ? b.y : b.x;
      s[4 * c + e] = kFma ? __fmaf_rn(s[4 * c + e], scale, be)
                          : __fadd_rn(__fmul_rn(s[4 * c + e], scale), be);
    }
  }
}

template <int HD, int kEntry>
__device__ __forceinline__ void produce(const Layout<HD>& L, const CUtensorMap* tq,
                                        const CUtensorMap* tk, const CUtensorMap* tv,
                                        const ArgsOf<kEntry>& a) {
  using P = Plan<HD>;
  const int q_tiles = a.t / kBM, n_tiles = keys_of(a) / kBN;
  int stage = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x, it = 0; item < a.n_items; item += gridDim.x, ++it) {
    const int bh = item / q_tiles, qt = item - bh * q_tiles, b = bh / a.h, h = bh - b * a.h;
    const int slot = it & 1;  // two Q slots: the next item's Q loads during this one
    mbar_wait(L.q_empty(slot), ((it >> 1) & 1) ^ 1);  // the consumers are done with its last Q
    mbar_expect_tx(L.q_full(slot), P::kQBytes);
#pragma unroll
    for (int c = 0; c < P::kSub; ++c)
      tma_load(L.q(slot) + c * kBM * kRowBytes, tq, L.q_full(slot), 64 * c, qt * kBM, h, b);
    const float* bias = a.bias + static_cast<size_t>(b) * keys_of(a);
    // blockwise: pass 0 without V, then pass 1; flash and stats: pass 1 alone
    for (int pass = kEntry == kBlockwise ? 0 : 1; pass < 2; ++pass)
      for (int kt = 0; kt < n_tiles; ++kt) {
        mbar_wait(L.empty(stage), phase ^ 1);
        mbar_expect_tx(L.full(stage), (pass + 1) * P::kTileBytes + P::kBiasBytes);
#pragma unroll
        for (int c = 0; c < P::kSub; ++c) {
          tma_load(L.k(stage) + c * kBN * kRowBytes, tk, L.full(stage), 64 * c, kt * kBN, h, b);
          if (pass == 1)
            tma_load(L.v(stage) + c * kBN * kRowBytes, tv, L.full(stage), 64 * c, kt * kBN, h, b);
        }
        bulk_load(L.bias(stage), bias + kt * kBN, P::kBiasBytes, L.full(stage));
        if (++stage == P::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
  }
}

// Tile j's softmax on S (already scaled and biased), in place: S becomes
// the f32 p of the contract. The online softmax (flash, stats) returns
// each row's rescale of o in alpha (applied once the previous P . V has
// landed); blockwise multiplies by the reciprocal denominator of pass 1
// (held in l).
template <bool kOnline>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (!kOnline) {
      // normalized in f32 before the cast, as the blockwise kernel does
#pragma unroll
      for (int c = 0; c < 16; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          s[4 * c + 2 * r + e] = exp_ftz(s[4 * c + 2 * r + e] - m[r]) * l[r];
    } else {
      float mt = m[r];
#pragma unroll
      for (int c = 0; c < 16; ++c)
        mt = fmaxf(mt, fmaxf(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]));
      mt = quad_max(mt);
      alpha[r] = exp_ftz(m[r] - mt);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * c + 2 * r + e] = exp_ftz(s[4 * c + 2 * r + e] - mt);
          sum += s[4 * c + 2 * r + e];
        }
      l[r] = alpha[r] * l[r] + sum;
      m[r] = mt;
    }
  }
}

// P in the A layout of k16 step kk: n8 blocks 2kk and 2kk + 1 of S, cast
// to bf16
__device__ __forceinline__ void pack_p(uint32_t (&p)[8][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) p[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// A consumer's position in the ring
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  template <int kStages>
  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

template <int HD, int kEntry>
__device__ __forceinline__ void consume(const Layout<HD>& L, const ArgsOf<kEntry>& a, int cw) {
  using P = Plan<HD>;
  constexpr bool kFma = HD == 64, kOnline = kEntry != kBlockwise;
  const int tid = threadIdx.x - 128 * (cw + 1), lane = tid & 31, t4 = lane & 3;
  const int row0 = (tid >> 5) * 16 + (lane >> 2);  // this thread's first row of the 64
  const int q_tiles = a.t / kBM, n_tiles = keys_of(a) / kBN;
  const int mine = 1 + cw, other = 2 - cw;  // the named barriers of the two turns
  Ring ring;
  float s[64];
  if (cw == 1) turn_pass(1);  // consumer 0 takes the first turn

  for (int item = blockIdx.x, it = 0; item < a.n_items; item += gridDim.x, ++it) {
    const int bh = item / q_tiles, qt = item - bh * q_tiles, slot = it & 1;
    const uint32_t q = L.q(slot) + cw * 64 * kRowBytes;
    mbar_wait(L.q_full(slot), (it >> 1) & 1);
    float m[2], l[2], alpha[2];  // rows row0 and row0 + 8; l is this thread's part of the sum
    if constexpr (!kOnline) {
      // pass 1: each row's max and softmax denominator over all keys
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
      for (int kt = 0; kt < n_tiles; ++kt) {
        mbar_wait(L.full(ring.stage), ring.phase);
        turn_wait(mine);
        issue_qk<HD>(s, q, L.k(ring.stage));
        turn_pass(other);
        wgmma_wait<0>();
        hold(s);
        scale_bias<kFma>(s, L.bias_ptr(ring.stage), a.scale, t4);
        mbar_arrive(L.empty(ring.stage));  // S and the bias are in registers: the stage is free
        ring.advance<P::kStages>();
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mt = m[r];
#pragma unroll
          for (int c = 0; c < 16; ++c)
            mt = fmaxf(mt, fmaxf(s[4 * c + 2 * r], s[4 * c + 2 * r + 1]));
          mt = quad_max(mt);
          float sum = 0.f;
#pragma unroll
          for (int c = 0; c < 16; ++c)
            sum += exp_ftz(s[4 * c + 2 * r] - mt) + exp_ftz(s[4 * c + 2 * r + 1] - mt);
          l[r] = l[r] * exp_ftz(m[r] - mt) + sum;
          m[r] = mt;
        }
      }
      // the normalization's reciprocal: p / l as p * (1 / l)
      l[0] = 1.f / quad_sum(l[0]);
      l[1] = 1.f / quad_sum(l[1]);
    } else {
      m[0] = m[1] = kClamp;  // finite: -inf would NaN the rescale
      l[0] = l[1] = 0.f;
    }

    // The P . V loop. One turn issues Q . K^T of tile kt and P . V of tile
    // kt - 1; tile kt's softmax then runs while that P . V (and the other
    // warpgroup's products) do. Tile 0 goes first on its own, so that no
    // branch sits between a wgmma and its wait (ptxas would serialize).
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    uint32_t p[8][4];
    mbar_wait(L.full(ring.stage), ring.phase);
    turn_wait(mine);
    issue_qk<HD>(s, q, L.k(ring.stage));
    turn_pass(other);
    wgmma_wait<0>();
    hold(s);
    if (n_tiles == 1) mbar_arrive(L.q_empty(slot));
    scale_bias<kFma>(s, L.bias_ptr(ring.stage), a.scale, t4);
    softmax_tile<kOnline>(s, m, l, alpha);  // o is 0: no rescale
    pack_p(p, s);
    int prev = ring.stage;  // the stage of the tile whose P is in p
    ring.advance<P::kStages>();
    for (int kt = 1; kt < n_tiles; ++kt) {
      mbar_wait(L.full(ring.stage), ring.phase);
      turn_wait(mine);
      issue_qk<HD>(s, q, L.k(ring.stage));
      issue_pv<HD>(o, p, L.v(prev));
      turn_pass(other);
      wgmma_wait<1>();  // Q . K^T has landed; P . V may still run
      hold(s);
      if (kt == n_tiles - 1) mbar_arrive(L.q_empty(slot));  // the item's last use of Q
      scale_bias<kFma>(s, L.bias_ptr(ring.stage), a.scale, t4);
      softmax_tile<kOnline>(s, m, l, alpha);
      wgmma_wait<0>();
      hold(o);
      hold(p);
      mbar_arrive(L.empty(prev));
      if constexpr (kOnline) {
#pragma unroll
        for (int c = 0; c < HD / 8; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[4 * c + e] *= alpha[e >> 1];
      }
      pack_p(p, s);
      prev = ring.stage;
      ring.advance<P::kStages>();
    }
    turn_wait(mine);
    issue_pv<HD>(o, p, L.v(prev));
    turn_pass(other);
    wgmma_wait<0>();
    hold(o);
    hold(p);
    mbar_arrive(L.empty(prev));

    if constexpr (kOnline) {
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);
    }
    const size_t row = static_cast<size_t>(bh) * a.t + qt * kBM + cw * 64 + row0;
    if constexpr (kEntry == kStats) {
      // no divide: acc as f32 pairs, then each row's m and l from the
      // quad's first thread (the quad holds the row's reduced m and l)
      float* ag = a.acc + row * HD + 2 * t4;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(ag + r * 8 * HD + 8 * c) =
              make_float2(o[4 * c + 2 * r], o[4 * c + 2 * r + 1]);
      if (t4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          a.m[row + 8 * r] = m[r];
          a.l[row + 8 * r] = l[r];
        }
      }
    } else {
      __nv_bfloat16* og = a.out + row * HD + 2 * t4;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = o[4 * c + 2 * r], y = o[4 * c + 2 * r + 1];
          if constexpr (kEntry == kFlash) {
            x /= l[r];
            y /= l[r];
          }
          *reinterpret_cast<uint32_t*>(og + r * 8 * HD + 8 * c) = pack_bf16(x, y);
        }
    }
  }
  if (cw == 0) turn_wait(1);  // consumer 1's last pass of the turn: barriers end balanced
}

template <int HD, int kEntry>
__global__ void __launch_bounds__(kThreads, 1)
    attention_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const ArgsOf<kEntry> a) {
  using P = Plan<HD>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;  // the swizzle wants 1024-byte tiles
  const Layout<HD> L{raw + pad, smem_raw + pad};
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(L.full(s), 1);
      mbar_init(L.empty(s), kConsumers);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(L.q_full(s), 1);
      mbar_init(L.q_empty(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one if-else for the whole kernel: the roles never meet again
  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) produce<HD, kEntry>(L, &tq, &tk, &tv, a);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<HD, kEntry>(L, a, threadIdx.x / 128 - 1);
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime
inline int encode_tiled(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (found == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &status);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (status != cudaDriverEntryPointSuccess || p == nullptr) return kErrEntryPoint;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return 0;
}

// x [B, H, T, hd] bf16 with element strides st (batch, head, row) as a
// 4-d map (hd, T, H, B): boxes of 64 columns by `rows` rows, 128-byte
// swizzle. A dimension of extent 1 takes a packed stride (its own is
// never used and may be anything).
inline int encode(EncodeTiled fn, CUtensorMap* map, const void* x, const long long* st, int b,
                  int h, int t, int hd, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(t),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2, static_cast<cuuint64_t>(st[1]) * 2,
                           static_cast<cuuint64_t>(st[0]) * 2};
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] == 1) strides[i] = (i == 0 ? dims[0] * 2 : strides[i - 1] * dims[i]);
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box, unit,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

template <int HD, int kEntry>
int launch_hd(EncodeTiled fn, const void* q, const void* k, const void* v, const float* bias,
              void* out, float* m, float* l, int b, int h, int t, int t_kv,
              const long long* strides, float scale, cudaStream_t stream) {
  using P = Plan<HD>;
  CUtensorMap tq, tk, tv;
  int err = encode(fn, &tq, q, strides, b, h, t, HD, kBM);
  if (err == 0) err = encode(fn, &tk, k, strides + 3, b, h, t_kv, HD, kBN);
  if (err == 0) err = encode(fn, &tv, v, strides + 6, b, h, t_kv, HD, kBN);
  if (err != 0) return err;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto kern = attention_kernel<HD, kEntry>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  ArgsOf<kEntry> a;
  a.bias = bias;
  a.out = nullptr;
  a.h = h;
  a.t = t;
  a.n_items = b * h * (t / kBM);
  a.scale = scale;
  if constexpr (kEntry == kStats) {
    a.acc = static_cast<float*>(out);
    a.m = m;
    a.l = l;
    a.t_kv = t_kv;
  } else {
    a.out = static_cast<__nv_bfloat16*>(out);
  }
  const int grid = a.n_items < sms ? a.n_items : sms;
  kern<<<grid, kThreads, P::kSmem, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_entry(int entry, EncodeTiled fn, const void* q, const void* k, const void* v,
                 const float* bias, void* out, float* m, float* l, int b, int h, int t, int t_kv,
                 const long long* strides, float scale, cudaStream_t stream) {
  switch (entry) {
    case kBlockwise:
      return launch_hd<HD, kBlockwise>(fn, q, k, v, bias, out, m, l, b, h, t, t, strides, scale,
                                       stream);
    case kFlash:
      return launch_hd<HD, kFlash>(fn, q, k, v, bias, out, m, l, b, h, t, t, strides, scale,
                                   stream);
    default:
      return launch_hd<HD, kStats>(fn, q, k, v, bias, out, m, l, b, h, t, t_kv, strides, scale,
                                   stream);
  }
}

// A bf16 entry (kBlockwise, kFlash or kStats): q [B, H, T, hd], k, v
// [B, H, T_kv, hd] (T_kv == T but for kStats) through 9 element strides
// (batch, head, row of q, k, v; the rows 16-byte aligned), bias [B, T_kv]
// f32 clamped; out [B, H, T, hd] contiguous, bf16 (kStats: acc f32, and m,
// l [B, H, T] f32 contiguous); T and T_kv multiples of 128, hd 64 or 128
// (checked by the caller). Returns 0, a CUDA error, or kErrEntryPoint /
// kErrEncode + CUresult.
inline int launch(int entry, const void* q, const void* k, const void* v, const float* bias,
                  void* out, float* m, float* l, int b, int h, int t, int t_kv, int hd,
                  const long long* strides, float scale, cudaStream_t stream) {
  EncodeTiled fn;
  const int err = encode_tiled(&fn);
  if (err != 0) return err;
  int e;
  if (hd == 64 && std::frexp(scale, &e) != 0.5f)  // hd 64 folds the scale into one FMA
    return static_cast<int>(cudaErrorInvalidValue);
  return hd == 64 ? launch_entry<64>(entry, fn, q, k, v, bias, out, m, l, b, h, t, t_kv, strides,
                                     scale, stream)
                  : launch_entry<128>(entry, fn, q, k, v, bias, out, m, l, b, h, t, t_kv,
                                      strides, scale, stream);
}

}  // namespace attention_wgmma
