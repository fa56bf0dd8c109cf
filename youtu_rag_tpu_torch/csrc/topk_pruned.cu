// Exact masked top-k over a bf16 vector index, for Hopper (sm_90a).
//
// Replaces the TPU kernel youtu_rag_tpu/ops/topk.py::pallas_topk_pruned
// (kernel body _topk_kernel_pruned). Same contract:
//   score[q, row] = sum_d f32(bf16 Q[q, d]) * f32(bf16 X[row, d])  (f32 sums)
//                   + bias[row]
//   result        = the k best (score desc, row asc) per query, as
//                   (f32 scores [q, k], int32 rows [q, k]).
// Slots that no live row fills keep the initial entry (NEG_INF, row 0),
// as the TPU kernel's running top-k starts from (NEG_INF, 0).
//
// Bound: the kernel must read the whole index once, N*d*2 bytes (plus
// N*4 bytes of bias); at q <= 64 queries it does 2*q*N*d flops, far below
// the card's FMA rate per byte, so it is bound by HBM reads.
//
// Design. The TPU grid runs in order, so its pruned kernel carries one
// running top-k across all blocks. Hopper CTAs run at the same time, so:
//  1. topk_scan_kernel: CTA b owns a contiguous row range and keeps one
//     sorted top-k list per query of its query tile (8 queries) in shared
//     memory. It walks the range in tiles of 128 rows:
//     - scoring: each of the 8 warps takes 4 groups of R = 4 rows. The
//       query tile sits in shared memory as f32. Each lane reads 16-byte
//       chunks of the 4 rows (coalesced across the warp), accumulates the
//       4 x 8 partial dots, and a transposing butterfly (31 shuffles)
//       leaves lane L holding the full score of (row L/8, query L%8),
//       which goes into a shared score tile (double-buffered, so one
//       __syncthreads per tile separates scoring from selection);
//     - selection: warp j alone owns the list of query j. It adds the bias
//       (loaded at the start of the tile) to its query's 128 scores, and a
//       score that cannot beat the list's current k-th entry skips
//       insertion: the per-row form of the TPU kernel's block prune. After
//       warm-up almost no row inserts, so the loop is a streaming read of
//       the index. One list per query over the CTA's whole range (not one
//       per warp) keeps the warp-serial insertions few: about
//       k(1 + ln(rows/k)) per list.
//     At the end warp j writes its list as the CTA's candidates [n_cta, q, k].
//  2. topk_merge_kernel: one warp per query merges the n_cta sorted
//     candidate lists into [q, k] with the same (score desc, row asc)
//     order, so the result equals a stable descending sort.
// Queries are covered in tiles of 8 by the grid's second dimension; each
// tile reads the index again (q = 64 reads it 8 times).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;        // warps per scan CTA
constexpr int kQT = 8;           // queries per tile; warp j selects query j
constexpr int kR = 4;            // rows per warp step (kR * kQT == 32 lanes)
constexpr int kSteps = 4;        // warp steps per row tile
constexpr int kTile = kWarps * kR * kSteps;  // rows scored between barriers
constexpr int kMaxK = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -3.4028234663852886e38f;  // float32 min (NEG_INF)

static_assert(kR * kQT == 32, "one score per lane after the butterfly");
static_assert(kQT == kWarps, "one selecting warp per query of the tile");
static_assert(kTile % 32 == 0, "selection reads the tile 32 rows at a time");

// (as, ai) ranks before (bs, bi): higher score, then lower row.
__device__ __forceinline__ bool better(float as, int ai, float bs, int bi) {
  return as > bs || (as == bs && ai < bi);
}

// Insert (s, row) into the sorted list (ls, li) of length k. The caller
// guarantees that (s, row) beats entry k-1. All 32 lanes take part.
__device__ __forceinline__ void warp_insert(float* ls, int* li, int k, float s,
                                            int row, int lane) {
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    int i = base + lane;
    bool b = i < k && better(ls[i], li[i], s, row);
    pos += __popc(__ballot_sync(kFull, b));
  }
  float vs[kMaxK / 32];
  int vi[kMaxK / 32];
#pragma unroll
  for (int t = 0; t < kMaxK / 32; ++t) {
    int i = t * 32 + lane;
    if (i > pos && i < k) {
      vs[t] = ls[i - 1];
      vi[t] = li[i - 1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < kMaxK / 32; ++t) {
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

// One step of the transposing butterfly over 2*H values per lane: lanes
// with bit H set keep the upper half, the others the lower half, and each
// adds its partner's copy of the half it keeps.
template <int H>
__device__ __forceinline__ void butterfly_step(float* acc, int lane) {
  const bool upper = lane & H;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    float send = upper ? acc[i] : acc[i + H];
    float keep = upper ? acc[i + H] : acc[i];
    acc[i] = keep + __shfl_xor_sync(kFull, send, H);
  }
}

__device__ __forceinline__ void bf16x2_to_f32(uint32_t w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// Shared memory: q_tile f32 [kQT, d], score tiles f32 [2, kQT, kTile],
// then per query a list of k scores and k rows.
__global__ void __launch_bounds__(kWarps * 32, 2)
topk_scan_kernel(const __nv_bfloat16* __restrict__ queries,  // [q, d]
                 const __nv_bfloat16* __restrict__ x,        // [n, d]
                 const float* __restrict__ bias,             // [n]
                 float* __restrict__ cand_s,                 // [n_cta, q, k]
                 int* __restrict__ cand_i,                   // [n_cta, q, k]
                 int q, int n, int d, int k, int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* tiles = qs + kQT * d;
  float* list_s = tiles + 2 * kQT * kTile;
  int* list_i = reinterpret_cast<int*>(list_s + kQT * k);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cta = blockIdx.x;
  const int q0 = blockIdx.y * kQT;
  const int q_valid = min(kQT, q - q0);

  // query tile -> f32 (rows past q are zero)
  for (int e = threadIdx.x; e < kQT * d; e += blockDim.x) {
    int j = e / d;
    qs[e] = j < q_valid ? __bfloat162float(queries[(size_t)(q0 + j) * d + e % d]) : 0.f;
  }
  for (int e = threadIdx.x; e < kQT * k; e += blockDim.x) {
    list_s[e] = kNegInf;
    list_i[e] = 0;
  }
  __syncthreads();

  // this warp's list: query q0 + warp; (thr_s, thr_i) mirrors its entry k-1
  float* my_s = list_s + warp * k;
  int* my_i = list_i + warp * k;
  float thr_s = kNegInf;
  int thr_i = 0;
  const bool selects = warp < q_valid;
  const int row_begin = cta * rows_per_cta;
  const int row_end = min(n, row_begin + rows_per_cta);
  const int n_chunks = d / 8;  // 16-byte chunks per row

  int buf = 0;
  for (int tile0 = row_begin; tile0 < row_end; tile0 += kTile, buf ^= 1) {
    float* tile = tiles + buf * kQT * kTile;  // [kQT, kTile]
    // the bias of the rows this lane selects, loaded now so that its
    // latency hides under the scoring loads
    float tile_bias[kTile / 32];
#pragma unroll
    for (int c = 0; c < kTile / 32; ++c) {
      const int row = tile0 + c * 32 + lane;
      tile_bias[c] = selects && row < row_end ? bias[row] : 0.f;
    }
    for (int step = 0; step < kSteps; ++step) {
      const int r0 = (step * kWarps + warp) * kR;  // first row of the group, in the tile
      const int row0 = tile0 + r0;
      float acc[kR * kQT];
#pragma unroll
      for (int v = 0; v < kR * kQT; ++v) acc[v] = 0.f;

      for (int c = lane; c < n_chunks && row0 < row_end; c += 32) {
        uint4 xv[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          int row = row0 + r;
          xv[r] = row < row_end
                      ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * d) + c)
                      : make_uint4(0, 0, 0, 0);
        }
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

      // transposing butterfly: lane L ends with the warp sum of acc[L]
      butterfly_step<16>(acc, lane);
      butterfly_step<8>(acc, lane);
      butterfly_step<4>(acc, lane);
      butterfly_step<2>(acc, lane);
      butterfly_step<1>(acc, lane);
      tile[(lane % kQT) * kTile + r0 + lane / kQT] = acc[0];
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
        const float s = ok ? tile[warp * kTile + c * 32 + lane] + tile_bias[c] : 0.f;
        unsigned pending = __ballot_sync(kFull, ok && better(s, row, thr_s, thr_i));
        while (pending) {
          int src = __ffs(pending) - 1;
          float ss = __shfl_sync(kFull, s, src);
          int rr = __shfl_sync(kFull, row, src);
          warp_insert(my_s, my_i, k, ss, rr, lane);
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
    size_t out = ((size_t)cta * q + q0 + warp) * k;
    for (int t = lane; t < k; t += 32) {
      cand_s[out + t] = my_s[t];
      cand_i[out + t] = my_i[t];
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

}  // namespace

extern "C" {

const char* topk_pruned_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Shared memory bytes the scan kernel needs for width d and top-k k.
int topk_pruned_smem_bytes(int d, int k) {
  return (int)(sizeof(float) * (kQT * d + 2 * kQT * kTile) + (sizeof(float) + sizeof(int)) * kQT * k);
}

// Launch both kernels on `stream`. Returns cudaGetLastError() (0 = ok) or
// cudaErrorInvalidValue for shapes outside the contract.
int topk_pruned_launch(const void* queries, const void* x, const void* bias,
                       void* cand_s, void* cand_i, void* out_s, void* out_i,
                       int q, int n, int d, int k, int n_cta, void* stream) {
  if (q < 1 || q > 64 || k < 1 || k > kMaxK || d % 128 != 0 || n < k || n_cta < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int smem = topk_pruned_smem_bytes(d, k);
  cudaError_t err = cudaFuncSetAttribute(
      topk_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int rows_per_cta = (n + n_cta - 1) / n_cta;
  dim3 grid(n_cta, (q + kQT - 1) / kQT);
  topk_scan_kernel<<<grid, kWarps * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(queries), static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(bias), static_cast<float*>(cand_s), static_cast<int*>(cand_i),
      q, n, d, k, rows_per_cta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t merge_smem = (size_t)n_cta * (2 * sizeof(int) + sizeof(float));
  topk_merge_kernel<<<q, 32, merge_smem, st>>>(
      static_cast<const float*>(cand_s), static_cast<const int*>(cand_i),
      static_cast<float*>(out_s), static_cast<int*>(out_i), q, k, n_cta);
  return (int)cudaGetLastError();
}

}  // extern "C"
