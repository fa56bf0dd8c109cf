// Exact masked top-k selection shared by the port's scan kernels, for
// Hopper (sm_90a). Included by topk_pruned.cu (bf16), topk_int8_pruned.cu
// and topk_int4_pruned.cu (brute scans) and topk_blocks.cu (per-block
// candidates, see below); the scoring differs between them, and each
// source passes it in as a Scorer (topk_scorers.cuh, contract below). The
// IVF scans (ivf_scan_tma.cuh) take its selection helpers, its list
// classes and RowSource, and run a kernel of their own.
//
// Contract of every kernel built from this header (the TPU kernels'):
//   result = the k best (score desc, row asc) per query, as
//            (f32 scores [q, k], int32 rows [q, k]);
//   slots that no live row fills keep the initial entry (NEG_INF, row 0),
//   as the TPU kernels' running top-k starts from (NEG_INF, 0). A row whose
//   bias is NEG_INF scores NEG_INF exactly (a small product added to the
//   float32 minimum rounds back to it) and never enters a list: only a
//   strictly better entry displaces one.
//
// Design. The TPU grid runs in order, so its pruned kernels carry one
// running top-k across all blocks. Hopper CTAs run at the same time, so:
//  1. topk_scan_kernel: CTA b owns a contiguous row range and keeps one
//     sorted top-k list per query of its query tile (8 queries) in shared
//     memory. It walks the range in tiles of 128 rows:
//     - scoring: bf16 and int8 (Scorer::group): each of the 8 warps takes
//       4 groups of R = 4 rows; each lane reads 16-byte chunks of the 4
//       rows (coalesced across the warp) and accumulates the 4 x 8 partial
//       dots; a transposing butterfly (31 shuffles) leaves lane L holding
//       the full dot of (row L/8, query L%8). int4 (Scorer::warp_tile):
//       each warp scores its 16 rows of the tile against the 8 queries on
//       the tensor cores and lane (g, t) holds the dots of rows g and g + 8
//       with queries 2t and 2t + 1. Either way the dots go into a shared
//       score tile (double-buffered, so one __syncthreads per tile
//       separates scoring from selection);
//     - selection: warp j alone owns the list of query j. It finishes its
//       query's 128 scores (the bias and, for the quantized tiers, the
//       scales, all loaded at the start of the tile so that their latency
//       hides under the scoring loads), and a score that cannot beat the
//       list's current k-th entry skips insertion: the per-row form of the
//       TPU kernels' block prune. After warm-up almost no row inserts, so
//       the loop is a streaming read of the index.
//     At the end warp j writes its list as the CTA's candidates [n_cta, q, k].
//  2. topk_merge_kernel: one warp per query merges the n_cta sorted
//     candidate lists into [q, k] with the same (score desc, row asc)
//     order, so the result equals a stable descending sort.
// Queries are covered in tiles of 8 by the grid's second dimension; each
// tile reads the index again (q = 64 reads it 8 times).
//
// Brute scans: CTA b owns the contiguous rows [b * rows_per_cta, (b + 1) *
// rows_per_cta).
//
// Per-block candidates (the kBlocks template flag, topk_blocks.cu). CTA b
// owns exactly one block of block_rows stored rows: rows [b * block_rows,
// (b + 1) * block_rows) (brute) or, with the kIvf flag, block ids[b] of
// the probe plan (a block at b >= n_valid, n_valid read on the device, is
// not read and counts as all NEG_INF). There is no merge: each
// selecting warp writes its block's own list, k_out = k_pad entries, as
// the TPU's per-block kernels (_select_topk) leave it: the live rows in
// (score desc, row asc), then the fill _select_topk picks once they run
// out (see the epilogue), then (NEG_INF, 0) past k.
//
// Three k classes (ListKind). Up to kSmallK = 128 an insertion stages the
// shifted list entries in registers (kSmallK / 32 per lane). Above it, up
// to kMaxK = 1024, the lists stay in dynamic shared memory as before (8
// queries x k x 8 B = 64 KB at k = 1024) and an insertion shifts them
// through shared memory, 32 entries at a time from the top, so no register
// array grows with k. Above kMaxK (the JAX kernels take any k up to their
// block_rows, which the JAX index grows to 8192) 8 lists would outgrow the
// 227 KB a CTA may have, so each selecting warp keeps its query's list in
// its own slot of the candidate buffer in device memory ([n_cta, q, k],
// or [blocks, q, k_pad]), where the epilogue would write it anyway; an
// insertion shifts only the entries filled so far (the rest are all the
// initial (NEG_INF, 0)). The wrappers bound that buffer by launching fewer
// CTAs. Simple first: this class is right, not yet fast.
//
// A Scorer provides:
//   static constexpr bool kScaled;      // score = f32(acc) * (qs * xs) + bias
//   static constexpr int kWarpRows;     // kR (group) or 16 (warp_tile)
//   static bool width_ok(int d);        // d is the unpacked width
//   static size_t q_bytes(int d);       // shared bytes of the query tile
//   __device__ static void load_queries(unsigned char* qt, const void* queries,
//                                       int q0, int q_valid, int d);
// and, for kWarpRows == kR,
//   __device__ static float group(const unsigned char* qt, const void* x,
//                                 int row0, int row_end, int d, int lane);
// which returns the lane's dot of (row row0 + lane/8, query lane%8) as f32,
// before the scales and the bias (rows row0.. are contiguous stored rows,
// those at or past row_end score nothing); for kWarpRows == 16,
//   __device__ static void warp_tile(const unsigned char* qt, const void* x,
//                                    int ra, int rb, int d, int lane, float (&out)[4]);
// which scores the warp's 16 rows at once: lane (g, t) = (lane / 4, lane % 4)
// is given the stored rows ra and rb of the warp's rows g and g + 8 (-1 past
// the range) and returns out[e], the dot of row (e < 2 ? ra : rb) with
// query 2t + (e & 1), as f32 before the scales and the bias.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;        // warps per scan CTA
constexpr int kQT = 8;           // queries per tile; warp j selects query j
constexpr int kR = 4;            // rows per warp step (kR * kQT == 32 lanes)
constexpr int kSteps = 4;        // warp steps per row tile
constexpr int kTile = kWarps * kR * kSteps;  // rows scored between barriers
constexpr int kSmallK = 128;     // largest k whose insert stages in registers
constexpr int kMaxK = 1024;      // largest k whose lists stay in shared memory
constexpr int kMaxQ = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -3.4028234663852886e38f;  // float32 min (NEG_INF)

static_assert(kR * kQT == 32, "one score per lane after the butterfly");
static_assert(kQT == kWarps, "one selecting warp per query of the tile");
static_assert(kTile % 32 == 0, "selection reads the tile 32 rows at a time");

// Where a selecting warp keeps its sorted list (the k classes above).
enum ListKind { kListRegs = 0, kListShared = 1, kListDevice = 2 };

__host__ __device__ inline int list_kind(int k) {
  return k <= kSmallK ? kListRegs : (k <= kMaxK ? kListShared : kListDevice);
}

// A probe plan's blocks: the per-block IVF candidates' (kIvf) and the IVF
// scans' of ivf_scan_tma.cuh (unused by the brute scans). Virtual row v,
// v < n_valid * block_rows, is the stored row ids[v / block_rows] *
// block_rows + v % block_rows.
struct RowSource {
  const int* ids;      // probed block ids [max_blocks]
  const int* n_valid;  // device scalar: ids[0 .. n_valid) are probed
  int max_blocks;
  int block_rows;      // any that divides the rows

  // stored row of virtual row v (v < n_valid * block_rows)
  __device__ __forceinline__ int row(int v) const {
    return __ldg(ids + v / block_rows) * block_rows + v % block_rows;
  }
};

// (as, ai) ranks before (bs, bi): higher score, then lower row.
__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// Insert (s, row) into the sorted list (ls, li) of length k <= kSmallK. The
// caller guarantees that (s, row) beats entry k-1. All 32 lanes take part.
__device__ __forceinline__ void warp_insert(float* ls, int* li, int k, float s,
                                            int row, int lane) {
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    int i = base + lane;
    bool b = i < k && better(ls[i], li[i], s, row);
    pos += __popc(__ballot_sync(kFull, b));
  }
  float vs[kSmallK / 32];
  int vi[kSmallK / 32];
#pragma unroll
  for (int t = 0; t < kSmallK / 32; ++t) {
    int i = t * 32 + lane;
    if (i > pos && i < k) {
      vs[t] = ls[i - 1];
      vi[t] = li[i - 1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < kSmallK / 32; ++t) {
    int i = t * 32 + lane;
    if (i > pos && i < k) {
      ls[i] = vs[t];
      li[i] = vi[t];
    }
  }
  if (lane == 0) {
    ls[pos] = s;
    li[pos] = row;
  }
  __syncwarp();
}

// The same for kSmallK < k <= kMaxK: the position scan stops at the first
// 32-entry chunk that holds a worse entry, and entries [pos, k-1) move up
// by one through shared memory, top chunk first (a chunk reads entries
// i-1 before the chunk below overwrites them).
__device__ __forceinline__ void warp_insert_smem(float* ls, int* li, int k, float s,
                                                 int row, int lane) {
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    const int i = base + lane;
    const unsigned b = __ballot_sync(kFull, i < k && better(ls[i], li[i], s, row));
    pos += __popc(b);
    if (b != kFull) break;
  }
  for (int base = ((k - 1) / 32) * 32; base + 31 > pos; base -= 32) {
    const int i = base + lane;
    const bool mv = i > pos && i < k;
    float v = 0.f;
    int vi = 0;
    if (mv) {
      v = ls[i - 1];
      vi = li[i - 1];
    }
    __syncwarp();
    if (mv) {
      ls[i] = v;
      li[i] = vi;
    }
    __syncwarp();
  }
  if (lane == 0) {
    ls[pos] = s;
    li[pos] = row;
  }
  __syncwarp();
}

// The same for the device-memory lists (k > kMaxK): entries at and past
// n_live all hold the initial (NEG_INF, 0), which no inserted entry ranks
// below (a NEG_INF row never enters), so pos <= n_live and only entries
// [pos, n_live) move up, through device memory (the warp alone touches its
// list; __syncwarp orders the lanes' accesses).
__device__ __forceinline__ void warp_insert_device(float* ls, int* li, int k, int n_live,
                                                   float s, int row, int lane) {
  int pos = 0;
  for (int base = 0; base < n_live; base += 32) {
    const int i = base + lane;
    const unsigned b = __ballot_sync(kFull, i < n_live && better(ls[i], li[i], s, row));
    pos += __popc(b);
    if (b != kFull) break;
  }
  const int top = min(n_live, k - 1);  // the highest index that receives an entry
  for (int base = (top / 32) * 32; base + 31 > pos; base -= 32) {
    const int i = base + lane;
    const bool mv = i > pos && i <= top;
    float v = 0.f;
    int vi = 0;
    if (mv) {
      v = ls[i - 1];
      vi = li[i - 1];
    }
    __syncwarp();
    if (mv) {
      ls[i] = v;
      li[i] = vi;
    }
    __syncwarp();
  }
  if (lane == 0) {
    ls[pos] = s;
    li[pos] = row;
  }
  __syncwarp();
}

// One step of the transposing butterfly over 2*H values per lane: lanes
// with bit H set keep the upper half, the others the lower half, and each
// adds its partner's copy of the half it keeps.
template <int H, typename T>
__device__ __forceinline__ void butterfly_step(T* acc, int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    T send = upper ? acc[i] : acc[i + H];
    T keep = upper ? acc[i + H] : acc[i];
    acc[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

// Lane L ends with the warp sum of acc[L] over all 32 lanes' copies.
template <typename T>
__device__ __forceinline__ void butterfly(T* acc, int lane) {
  butterfly_step<16>(acc, lane);
  butterfly_step<8>(acc, lane);
  butterfly_step<4>(acc, lane);
  butterfly_step<2>(acc, lane);
  butterfly_step<1>(acc, lane);
}

template <class Scorer>
__host__ __device__ inline size_t scan_smem_bytes(int d, int k) {
  const size_t lists = list_kind(k) == kListDevice ? 0 : (size_t)kQT * k;
  return Scorer::q_bytes(d) + sizeof(float) * 2 * kQT * kTile +
         (sizeof(float) + sizeof(int)) * lists;
}

// Shared memory: the Scorer's query tile, score tiles f32 [2, kQT, kTile],
// then per query a list of k scores and k rows (not for kListDevice).
template <class Scorer, int kList, bool kIvf, bool kBlocks>
__global__ void __launch_bounds__(kWarps * 32, 2)
topk_scan_kernel(const void* __restrict__ queries,    // [q, d] (Scorer's type)
                 const float* __restrict__ qscale,    // [q] (kScaled only)
                 const void* __restrict__ x,          // [n, row bytes]
                 const float* __restrict__ xscale,    // [n] (kScaled only)
                 const float* __restrict__ bias,      // [n]
                 float* __restrict__ cand_s,          // [n_cta, q, k_out]
                 int* __restrict__ cand_i,            // [n_cta, q, k_out]
                 int q, int n, int d, int k, int k_out,
                 int rows_per_cta,                 // kBlocks: block_rows
                 RowSource src) {                  // kIvf only
  static_assert(kBlocks || !kIvf, "an IVF scan reads one block per CTA");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qt = smem;
  float* tiles = reinterpret_cast<float*>(smem + Scorer::q_bytes(d));
  float* list_s = tiles + 2 * kQT * kTile;
  int* list_i = reinterpret_cast<int*>(list_s + kQT * k);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cta = blockIdx.x;
  const int q0 = blockIdx.y * kQT;
  const int q_valid = min(kQT, q - q0);

  Scorer::load_queries(qt, queries, q0, q_valid, d);
  if constexpr (kList != kListDevice) {
    for (int e = threadIdx.x; e < kQT * k; e += blockDim.x) {
      list_s[e] = kNegInf;
      list_i[e] = 0;
    }
  }
  __syncthreads();

  // this warp's list: query q0 + warp; (thr_s, thr_i) mirrors its entry k-1
  float* my_s = list_s + warp * k;
  int* my_i = list_i + warp * k;
  float thr_s = kNegInf;
  int thr_i = 0;
  const bool selects = warp < q_valid;
  int n_live = 0;  // kListDevice: entries filled so far (the rest are initial)
  if constexpr (kList == kListDevice) {
    if (selects) {
      // the slot of this warp's query in the candidates, where it ends
      const size_t slot = ((size_t)cta * q + q0 + warp) * k_out;
      my_s = cand_s + slot;
      my_i = cand_i + slot;
      for (int t = lane; t < k; t += 32) {
        my_s[t] = kNegInf;
        my_i[t] = 0;
      }
      __syncwarp();
    }
  }
  float qs_w = 0.f;
  if constexpr (Scorer::kScaled) qs_w = selects ? qscale[q0 + warp] : 0.f;
  // stored rows [row_begin, row_end)
  int row_begin, row_end;
  int base = 0;       // kBlocks: the block's first stored row
  bool valid = true;  // kBlocks: the block is read (IVF: cta < n_valid)
  int c0 = INT_MAX;   // kBlocks: this lane's lowest row scoring >= NEG_INF
  if constexpr (kBlocks) {
    if constexpr (kIvf) {
      valid = cta < min(max(*src.n_valid, 0), src.max_blocks);
      // ids[cta] * block_rows in int32 as the TPU kernel computes it (an
      // id past n_valid is never read, only written back in the fill)
      base = (int)((unsigned)__ldg(src.ids + cta) * (unsigned)rows_per_cta);
    } else {
      base = cta * rows_per_cta;
    }
    row_begin = base;
    row_end = valid ? base + rows_per_cta : base;
  } else {
    row_begin = cta * rows_per_cta;
    row_end = min(n, row_begin + rows_per_cta);
  }

  int buf = 0;
  for (int tile0 = row_begin; tile0 < row_end; tile0 += kTile, buf ^= 1) {
    float* tile = tiles + buf * kQT * kTile;  // [kQT, kTile]
    // the bias (and scale) of the rows this lane selects, loaded now so
    // that their latency hides under the scoring loads
    float tile_bias[kTile / 32];
    float tile_xs[kTile / 32];
#pragma unroll
    for (int c = 0; c < kTile / 32; ++c) {
      const int row = tile0 + c * 32 + lane;
      const bool ok = selects && row < row_end;
      tile_bias[c] = ok ? bias[row] : 0.f;
      if constexpr (Scorer::kScaled) tile_xs[c] = ok ? xscale[row] : 0.f;
    }
    if constexpr (Scorer::kWarpRows == kTile / kWarps) {
      // the warp's 16 rows of the tile at once
      const int r0 = warp * Scorer::kWarpRows, g = lane / 4, t = lane % 4;
      int rows[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = tile0 + r0 + g + 8 * h;
        rows[h] = v < row_end ? v : -1;
      }
      float dots[4];
      Scorer::warp_tile(qt, x, rows[0], rows[1], d, lane, dots);
#pragma unroll
      for (int e = 0; e < 4; ++e) tile[(2 * t + (e & 1)) * kTile + r0 + g + 8 * (e >> 1)] = dots[e];
    } else {
      for (int step = 0; step < kSteps; ++step) {
        const int r0 = (step * kWarps + warp) * kR;  // first row of the group, in the tile
        const float v = Scorer::group(qt, x, tile0 + r0, row_end, d, lane);
        tile[(lane % kQT) * kTile + r0 + lane / kQT] = v;
      }
    }
    // the tile is complete; the other buffer is free for the next tile,
    // whose scoring starts only after every warp passed this barrier, that
    // is, after every warp finished selecting from it
    __syncthreads();

    if (selects) {
#pragma unroll
      for (int c = 0; c < kTile / 32; ++c) {
        const int row = tile0 + c * 32 + lane;
        const bool ok = row < row_end;
        float s = 0.f;
        if (ok) {
          const float t = tile[warp * kTile + c * 32 + lane];
          if constexpr (Scorer::kScaled)
            // the TPU kernels' epilogue, rounded op by op (no contraction)
            s = __fadd_rn(__fmul_rn(t, __fmul_rn(qs_w, tile_xs[c])), tile_bias[c]);
          else
            s = t + tile_bias[c];
          // rows ascend along the loop: the first such row is the lowest
          if constexpr (kBlocks)
            if (s >= kNegInf && c0 == INT_MAX) c0 = row;
        }
        unsigned pending = __ballot_sync(kFull, ok && better(s, row, thr_s, thr_i));
        while (pending) {
          int src = __ffs(pending) - 1;
          float ss = __shfl_sync(kFull, s, src);
          int rr = __shfl_sync(kFull, row, src);
          if constexpr (kList == kListDevice) {
            warp_insert_device(my_s, my_i, k, n_live, ss, rr, lane);
            n_live = min(n_live + 1, k);
          } else if constexpr (kList == kListShared) {
            warp_insert_smem(my_s, my_i, k, ss, rr, lane);
          } else {
            warp_insert(my_s, my_i, k, ss, rr, lane);
          }
          thr_s = my_s[k - 1];
          thr_i = my_i[k - 1];
          pending &= pending - 1;
          // entry k-1 moved: drop the candidates that no longer beat it
          pending &= __ballot_sync(kFull, better(s, row, thr_s, thr_i));
        }
      }
    }
  }

  if (selects) {
    if constexpr (kBlocks) {
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) c0 = min(c0, __shfl_xor_sync(kFull, c0, o));
      if (!valid) c0 = base;  // the TPU kernel's all-NEG_INF block: column 0
    }
    // kListDevice: the list already sits in this slot; each lane rewrites
    // only the entries it reads
    size_t out = ((size_t)cta * q + q0 + warp) * k_out;
    for (int t = lane; t < k_out; t += 32) {
      float s = kNegInf;  // the pad past k (k_out == k outside kBlocks)
      int r = 0;
      if (t < k) {
        s = my_s[t];
        r = my_i[t];
        if constexpr (kBlocks) {
          if (!(s > kNegInf)) {
            // a slot no live row fills: _select_topk's pick once the live
            // rows are used up is the first column >= the max, each pick
            // overwritten with NEG_INF. That is (NEG_INF, c0) for the lowest
            // column c0 scoring >= NEG_INF (a tombstone counts, a -inf row
            // does not); in a block scoring -inf throughout, (-inf, base)
            // first and then (NEG_INF, base).
            r = c0 != INT_MAX ? c0 : base;
            s = (c0 == INT_MAX && t == 0) ? -INFINITY : kNegInf;
          }
        }
      }
      cand_s[out + t] = s;
      cand_i[out + t] = r;
    }
  }
}

// One warp per query: merge n_cta sorted lists of k into the top k.
// Shared memory: per list its position and its current head (score, row).
__global__ void __launch_bounds__(32)
topk_merge_kernel(const float* __restrict__ cand_s, const int* __restrict__ cand_i,
                  float* __restrict__ out_s, int* __restrict__ out_i,
                  int q, int k, int n_cta) {
  extern __shared__ __align__(16) unsigned char msmem[];
  int* pos = reinterpret_cast<int*>(msmem);
  float* head_s = reinterpret_cast<float*>(pos + n_cta);
  int* head_i = reinterpret_cast<int*>(head_s + n_cta);
  const int lane = threadIdx.x;
  const int qi = blockIdx.x;
  // list l belongs to lane l % 32, which alone reads and writes its entries
  for (int l = lane; l < n_cta; l += 32) {
    size_t off = ((size_t)l * q + qi) * k;
    pos[l] = 0;
    head_s[l] = cand_s[off];
    head_i[l] = cand_i[off];
  }

  auto local_best = [&](float& bs, int& bi, int& bl) {
    bs = -INFINITY;
    bi = 0x7fffffff;
    bl = 0x7fffffff;
    for (int l = lane; l < n_cta; l += 32) {
      float s = head_s[l];
      int i = head_i[l];
      if (better(s, i, bs, bi) || (s == bs && i == bi && l < bl)) {
        bs = s;
        bi = i;
        bl = l;
      }
    }
  };

  float ls;
  int li, ll;
  local_best(ls, li, ll);
  for (int t = 0; t < k; ++t) {
    float bs = ls;
    int bi = li, bl = ll;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      float os = __shfl_xor_sync(kFull, bs, o);
      int oi = __shfl_xor_sync(kFull, bi, o);
      int ol = __shfl_xor_sync(kFull, bl, o);
      if (better(os, oi, bs, bi) || (os == bs && oi == bi && ol < bl)) {
        bs = os;
        bi = oi;
        bl = ol;
      }
    }
    if (lane == 0) {
      out_s[(size_t)qi * k + t] = bs;
      out_i[(size_t)qi * k + t] = bi;
    }
    if (bl < n_cta && lane == bl % 32) {
      int p = ++pos[bl];
      if (p < k) {
        size_t off = ((size_t)bl * q + qi) * k + p;
        head_s[bl] = cand_s[off];
        head_i[bl] = cand_i[off];
      } else {
        head_s[bl] = -INFINITY;
        head_i[bl] = 0x7fffffff;
      }
      local_best(ls, li, ll);
    }
    __syncwarp();
  }
}

typedef void (*ScanKernel)(const void*, const float*, const void*, const float*, const float*,
                           float*, int*, int, int, int, int, int, int, RowSource);

template <class Scorer, bool kIvf, bool kBlocks = false>
ScanKernel scan_kernel_for(int k) {
  switch (list_kind(k)) {
    case kListRegs:
      return topk_scan_kernel<Scorer, kListRegs, kIvf, kBlocks>;
    case kListShared:
      return topk_scan_kernel<Scorer, kListShared, kIvf, kBlocks>;
    default:
      return topk_scan_kernel<Scorer, kListDevice, kIvf, kBlocks>;
  }
}

// Scan CTAs that fit on one SM for width d and top-k k (the register cap
// of __launch_bounds__ allows 2), or minus a CUDA error code.
template <class Scorer>
int scan_ctas_per_sm(int d, int k) {
  ScanKernel kern = scan_kernel_for<Scorer, false>(k);
  int smem = (int)scan_smem_bytes<Scorer>(d, k);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kWarps * 32, smem);
  if (err != cudaSuccess) return -(int)err;
  return blocks;
}

// Brute: all n rows; the contract wants n >= k. Launches the scan and the
// merge on `stream`. Returns cudaGetLastError() (0 = ok) or
// cudaErrorInvalidValue for shapes outside the contract.
template <class Scorer>
int topk_launch(const void* queries, const float* qscale, const void* x, const float* xscale,
                const float* bias, void* cand_s, void* cand_i, void* out_s, void* out_i,
                int q, int n, int d, int k, int n_cta, void* stream) {
  if (q < 1 || q > kMaxQ || k < 1 || !Scorer::width_ok(d) || n_cta < 1 || n < k)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  ScanKernel kern = scan_kernel_for<Scorer, false>(k);
  int smem = (int)scan_smem_bytes<Scorer>(d, k);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int rows_per_cta = (n + n_cta - 1) / n_cta;
  dim3 grid(n_cta, (q + kQT - 1) / kQT);
  kern<<<grid, kWarps * 32, smem, st>>>(queries, qscale, x, xscale, bias,
                                        static_cast<float*>(cand_s), static_cast<int*>(cand_i),
                                        q, n, d, k, k, rows_per_cta, RowSource{});
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t merge_smem = (size_t)n_cta * (2 * sizeof(int) + sizeof(float));
  topk_merge_kernel<<<q, 32, merge_smem, st>>>(
      static_cast<const float*>(cand_s), static_cast<const int*>(cand_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), q, k, n_cta);
  return (int)cudaGetLastError();
}

// Per-block candidates: one CTA per (block, 8-query tile), each writing its
// block's list of k_pad entries into cand [n_blocks, q, k_pad]; no merge.
// Brute: n_blocks = n / block_rows; IVF: n_blocks = max_blocks, block i
// being ids[i] (read only for i < *n_valid, which must be in range).
template <class Scorer, bool kIvf>
int blocks_launch(const void* queries, const float* qscale, const void* x, const float* xscale,
                  const float* bias, const int* ids, const int* n_valid, void* cand_s,
                  void* cand_i, int q, int n, int d, int k, int k_pad, int n_blocks,
                  int block_rows, void* stream) {
  if (q < 1 || q > kMaxQ || k < 1 || k > block_rows || k_pad < k ||
      !Scorer::width_ok(d) || n_blocks < 1 || block_rows < 1 || n % block_rows ||
      (!kIvf && n_blocks != n / block_rows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  ScanKernel kern = scan_kernel_for<Scorer, kIvf, true>(k);
  int smem = (int)scan_smem_bytes<Scorer>(d, k);
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_blocks, (q + kQT - 1) / kQT);
  kern<<<grid, kWarps * 32, smem, st>>>(queries, qscale, x, xscale, bias,
                                        static_cast<float*>(cand_s), static_cast<int*>(cand_i),
                                        q, n, d, k, k_pad, block_rows,
                                        RowSource{ids, n_valid, n_blocks, block_rows});
  return (int)cudaGetLastError();
}

}  // namespace

// Each brute source defines its C interface with this macro: <name>_launch,
// <name>_ctas_per_sm and <name>_error_string.
#define TOPK_C_INTERFACE(NAME, SCORER)                                                        \
  extern "C" {                                                                                \
  const char* NAME##_error_string(int err) {                                                  \
    return cudaGetErrorString(static_cast<cudaError_t>(err));                                 \
  }                                                                                           \
  int NAME##_ctas_per_sm(int d, int k) { return scan_ctas_per_sm<SCORER>(d, k); }            \
  int NAME##_launch(const void* queries, const void* qscale, const void* x, const void* xscale, \
                    const void* bias, void* cand_s, void* cand_i, void* out_s, void* out_i,   \
                    int q, int n, int d, int k, int n_cta, void* stream) {                    \
    return topk_launch<SCORER>(queries, static_cast<const float*>(qscale), x,                 \
                               static_cast<const float*>(xscale),                             \
                               static_cast<const float*>(bias), cand_s, cand_i, out_s, out_i, \
                               q, n, d, k, n_cta, stream);                                    \
  }                                                                                           \
  }

// The per-block source defines one entry per (scorer, row source) with this
// macro: <name>_launch (ids and n_valid are null for the brute entries).
#define BLOCKS_C_INTERFACE(NAME, SCORER, IVF)                                                 \
  extern "C" int NAME##_launch(const void* queries, const void* qscale, const void* x,        \
                               const void* xscale, const void* bias, const void* ids,         \
                               const void* n_valid, void* cand_s, void* cand_i, int q, int n, \
                               int d, int k, int k_pad, int n_blocks, int block_rows,         \
                               void* stream) {                                                \
    return blocks_launch<SCORER, IVF>(queries, static_cast<const float*>(qscale), x,          \
                                      static_cast<const float*>(xscale),                      \
                                      static_cast<const float*>(bias),                        \
                                      static_cast<const int*>(ids),                           \
                                      static_cast<const int*>(n_valid), cand_s, cand_i, q, n, \
                                      d, k, k_pad, n_blocks, block_rows, stream);             \
  }
