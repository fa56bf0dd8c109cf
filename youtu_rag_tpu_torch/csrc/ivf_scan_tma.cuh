// The IVF and brute scans for Hopper (sm_90a): the exact masked top-k over
// the rows of the probed blocks ids[0 .. n_valid), or over every row, in
// ONE launch that prepares the queries, streams the rows through a ring of
// bulk asynchronous copies, scores them on the tensor cores and merges the
// CTAs' lists. Three tiers: Bf16, Int8 and Int4 (packed nibbles) below.
// Included by ivf_topk_bf16.cu, ivf_topk_int8.cu and ivf_topk_int4.cu, one
// source per tier, whose entries ivf_topk_<tier> (the DMA contract),
// ivf_blocks_bf16 and ivf_blocks_int8 (the per-block contract, the kProbe
// template flag), topk_merged_bf16 and topk_merged_int8 (the per-block
// contract over the identity plan: the brute per-block kernels merged) and
// topk_pruned_<tier> (the DMA contract over the identity plan: the brute
// pruned scans, pallas_topk_pruned, pallas_topk_int8_pruned and
// pallas_topk_int4_pruned) they define; the per-block candidates
// (topk_blocks.cu) stay on topk_select.cuh's scan.
//
// DMA contract (the TPU kernels' pallas_ivf_topk_dma, pallas_ivf_topk_int8_dma
// and pallas_ivf_topk_int4_dma):
//  - rows: the stored rows of blocks ids[0 .. n_valid), block b covering
//    rows [b * block_rows, (b + 1) * block_rows); n_valid is read on the
//    device and clamped to [0, max_blocks]; ids past it are never read;
//    any block_rows that divides n, bias and scales at any 4-byte alignment
//    (JAX asserts only n % block_rows == 0 and d % 128 == 0, int4 d % 256);
//  - scores: bf16 f32(bf16 q) . f32(x) + bias, summed in f32 (in another
//    order than the plain version's matmul); int8 the exact integer dot of
//    the queries quantized as quantize_rows_int8 does (below) with the
//    stored rows, int4 the same with the rows' nibbles (quantize_rows_int4's
//    layout: packed byte j holds column j in its low nibble and column
//    j + d/2 in its high one, each a 4-bit two's complement value), then
//    f32(acc) * (qs * xs) + bias rounded op by op;
//  - result: the k best per query in the TPU kernels' order, (score desc,
//    probe position i asc, row in block asc), that is (score desc, virtual
//    row v asc): the lists hold v, and the output maps v to its stored row
//    ids[v / block_rows] * block_rows + v % block_rows (with ids ascending,
//    as the probe plan lists them, the order is (score desc, row asc));
//  - the fill: when a query has T < k live rows (score > NEG_INF), slots
//    T .. k-1 hold (NEG_INF, r), as the TPU kernels leave them: with L the
//    probe position of the last block holding a live row, r is the stored
//    row of the query's best live entry at a position before L, or 0 if
//    there is none (the TPU kernel merges every block with a live row while
//    its list is not full, and a merge's dead picks repeat the running
//    list's top entry). The scan records the last live v of each tile by
//    atomicMax in the counters the launch's memset zeroes (7. below). Over
//    the identity plan (the topk_pruned entries) r is 0, the pruned
//    kernels' fill: their running top-k starts from (NEG_INF, 0).
//  - any q (8-query tiles on the grid's y, up to 64 per launch) and any k
//    (4.'s list classes).
//
// Per-block contract (kProbe; pallas_ivf_topk and pallas_ivf_topk_int8
// merged, as ops/ivf.py's _probed_blocks + merge_blocks compute it):
//  - rows and scores as above;
//  - order (score desc, probe position i asc, row in block asc), that is
//    (score desc, virtual row v asc): the lists hold v, and the output maps
//    v to its stored row ids[v / block_rows] * block_rows + v % block_rows;
//  - the tail: when a query has T < k live rows (score > NEG_INF), slots
//    T .. k-1 repeat what the per-block lists put first among their
//    NEG_INF entries, in position order: position 0's fill (NEG_INF,
//    ids[0] * block_rows + c0), c0 its lowest column scoring >= NEG_INF, or
//    0 if it scores -inf throughout; with n_valid = 0, (NEG_INF, ids[0] *
//    block_rows). One exception: no live row, position 0 all -inf (its
//    list is (-inf, base), k - 1 times (NEG_INF, base), then the pad):
//    slot k - 1 is the pad's (NEG_INF, 0) when k is not a multiple of 128,
//    else position 1's first NEG_INF entry (its own c0, 0 past n_valid),
//    or (-inf, base) when max_blocks is 1. The scan keeps each query's c0
//    of positions 0 and 1 by atomicMax in the tile's counters (7. below).
//
// The identity plan (ids null; the topk_merged entries: pallas_topk and
// pallas_topk_int8 merged, as ops/topk.py's merge_blocks computes it from
// their candidates; the topk_pruned entries with one block of all n rows): position
// i is block i, all max_blocks = n / block_rows of them valid, so virtual
// row v is stored row v, the tail's ids[0] and ids[1] are 0 and 1, and the
// order is (score desc, row asc).
// Nothing of the plan is read on the device. A stage's rows are one run
// even where it spans blocks (one bulk copy each for the rows, bias and
// scales), so only n % 4 != 0 or unaligned bias and scales take 8.'s
// element copies. A runtime test of ids, not a template flag: the flag
// would compile the kProbe kernels twice (11 more instantiations), and the
// build counts against the chip run's time; the test costs thread 0 one
// uniform branch per run and the merge one per written row.
//
// Design. The rows a plan probes are few (phase 5c's adaptive plan: ~60
// blocks of 1024 rows, 48.5 MB in int8) and are read once per 8-query tile,
// so the scan is a short stream: fixed costs, bytes in flight and the work
// per row decide it.
//  1. Grid: n_cta CTAs per 8-query tile, one wave (the wrapper sizes it).
//     The virtual rows v < n_valid * block_rows (stored row
//     ids[v / block_rows] * block_rows + v % block_rows) are cut into
//     stages of R rows. CTA c owns stages c S .. c S + S - 1 (S the ring's
//     depth: the first fill needs no atomic); the rest it takes in pairs
//     from a counter of the tile, the next pair's atomicAdd always in
//     flight, so a CTA whose SM streams faster takes more and the CTAs
//     finish together.
//  2. A ring of S stages of R rows (R 32 or 16, S up to 4; int4 64 rows
//     and S up to 3, or 32 and up to 7; the host picks them from d and k,
//     9. below: int8 at d = 768 holds 4 x 32 rows, 99 KB in flight per CTA,
//     int4 3 x 64 packed rows, 75 KB, and both still fit two CTAs on an SM
//     at the search's k). The ring has a fixed cost per stage (a barrier,
//     the refill, a selection pass per 32 rows, its latency chain), so
//     int4's stages hold as many bytes as int8's: in 32-row stages (half
//     the bytes) the int4 stream over 1,048,576 x 768 took 0.186 ms without
//     selection, 66 % of its bound (H100 SXM, 700 W). Thread 0 fills a stage with 1-D bulk copies
//     (cp.async.bulk, completing on the stage's mbarrier): per run of rows
//     inside one block, the rows, their bias and (int8, int4) their scales. A
//     stage may hold rows of several blocks (block_rows 4, 8, 12); where
//     block_rows is a multiple of 4 every run starts and ends on a multiple
//     of 4 rows, so each copy is a multiple of 16 bytes (else 8.). The first S stages go out once the query prep's loads are
//     out (they would otherwise wait behind the ring in the memory queues);
//     stage i + S goes out as soon as every warp has passed stage i's
//     barrier, by which point its rows are scored and its bias and scales
//     sit in registers, so no empty barrier is needed. A slot records which
//     rows it holds; once the stages run past the plan, thread 0 arrives on
//     the next slot's barrier with no rows, which ends the CTA's scan.
//  3. Scoring on the tensor cores: warp w takes the 16 rows 16 (w / 4) ..
//     of the stage (64-row stages: also 16 (w / 4 + 2) ..) and a quarter of
//     the width, the 16-byte chunks c with
//     c / 4 % 4 == w % 4, and computes their dots with the 8 queries with
//     mma.sync (int8: m16n8k32 s8 x s8, exact; bf16: m16n8k16, f32 sums).
//     Lane (g, t) reads chunk 4 (w % 4) + t + 16 i of rows g and g + 8 and
//     of query g; the k order inside a step is free as long as A and B
//     agree, so words 0 and 1 of the chunk are the step's two k groups, then
//     words 2 and 3, and no fragment needs a shuffle. The four quarters'
//     partial dots go to a double-buffered tile [4, kQT, R] (one
//     __syncthreads per stage); selection adds them (int8 and int4 as
//     integers).
//     int4 (Int4::dots): packed chunk c of a row (16 bytes: columns 16c..
//     in the low nibbles, d/2 + 16c.. in the high ones) meets chunk c of
//     the query's low half and chunk c of its high half. A packed word XOR
//     0x88888888, masked to its low or high nibbles, is four biased u8
//     values u = x + 8, so mma.sync m16n8k32 u8 x s8 sums dot(q, u) exactly
//     and quarter 0 subtracts 8 sum(q), kept per query beside the tile
//     (no sign extension per nibble; topk_scorers.cuh's mma_u8s8). The d/32 packed chunks
//     would split over the quarters unevenly by the rule above (d = 768:
//     8/8/4/4), so int4 takes rounds of 16 chunks, chunk 16r + 4 quarter +
//     t to lane t with its four words as four steps, and the 8 chunks past
//     the last round (d % 512 == 256) as 16 halves of 8 bytes, half
//     4 quarter + t to lane t, two steps: d/128 steps per quarter at every d.
//  4. Selection: warp j keeps query j's sorted list and lane L takes rows
//     L, L + 32, .. of the stage; only a row that beats the list's entry
//     k - 1 goes in. Up to k = 32 the list lives in registers, entry i in
//     lane i, and an insertion is one ballot and one shuffle (kListWarp).
//     Up to k = 64 and 128 it lives in two or four registers a lane, entry
//     32 r + lane in register r (kListWarp2, kListWarp4); up to k = 1024 in
//     shared memory (kListShared), above in the CTA's slot of the candidates
//     (kListDevice). Above k = 32 a row that beats entry k - 1 joins the
//     warp's buffer in shared memory (a ballot, a prefix count, one store),
//     and the buffer goes into the list 32 entries at once: a bitonic sort
//     of the 32 (15 exchanges between lanes), then, for a register list,
//     Batcher's merge (its last 32 against them reversed, then a bitonic
//     merge), for a list in memory a merge by rank (flush_memory: each entry
//     moves by the count of new ones before it, so it costs the entries
//     below the best new one, not k). A warp merges only when some warp's
//     buffer held 32 at the stage's barrier (__syncthreads_or), and then
//     every warp does, so the CTA waits for one merge where it would wait
//     for eight in turn. Merging each stage's rows as they came cost the
//     int4 scan 0.134 ms of 0.321 at k = 64 (every stage inserts at first,
//     and most still do ~60 stages in); one entry at a time into a shared
//     list costs k / 32 steps an entry (the int4 scan at k = 1024: 8.95 ms;
//     times on an H100 SXM at 700 W, 1,048,576 x 768, q = 8).
//  5. Query prep in the prologue, by every thread, with its loads in flight
//     at once (one round trip at d <= 1024): bf16 rounds f32 queries to
//     bf16 (__floats2bfloat162_rn, as .to(torch.bfloat16)) or takes bf16
//     ones; int8 quantizes each query as quantize_rows_int8: scale =
//     max(amax, 1e-12) times the f32 reciprocal of 127, q = round half even
//     of the true quotient x / scale (Int8::quantize), clamped to +-127;
//     int4 the same into rows padded by 64 bytes (so that the 16-byte loads
//     of two queries hit distinct banks), then warp j sums query j's bytes.
//  6. The merge in the same launch: each CTA writes its lists as
//     candidates [tiles, n_cta, kQT, k_pad] (k_pad: k rounded up to 4); the
//     last CTA of a query tile to finish (a ticket from atomicAdd on the
//     tile's counter, which the launch zeroes with cudaMemsetAsync; each
//     call has its own) merges them, warp j query j, in (score desc, row
//     asc) order. Each list's first W entries come into shared memory at
//     once (16-byte loads; W 4 or 8). The merged list is a list of 4.'s
//     classes (k <= 32 one register a lane; shared memory up to 1024; the
//     query's output row above), and takes entries as the scan's lists do:
//     through a buffer, 32 at a time. The lists offer their windows a
//     position at a time (first every list's best, then every second
//     best, ..); a list whose entry does not beat entry k - 1 offers no
//     more, and those still offering past their windows stream the rest
//     from the candidates 32 entries at a time, the next list's first 32
//     loading while one is offered. Its cost follows the entries that
//     enter, not k: one step per output slot (a head tournament of three
//     warp reductions) took ~0.6 us a step on an H100 (k = 256 over 264
//     lists: 163 us). The last CTA alone runs the merge, once, so its code
//     is kept small: one merge in each loop, no unrolled copies.
//  7. The lists and the merge key on v, not on the stored row, so ties come
//     in probe order whichever CTA took a stage; the merge stops at the
//     first entry that is not live and writes the fill (DMA) or the tail
//     (kProbe). DMA: each selecting warp keeps the last live v it scored
//     (a ballot a stage) and lane 0 takes it to the tile's counter by one
//     atomicMax before the CTA's ticket, which the last CTA loads beside
//     the windows (a probe plan's only: the identity plan's fill is row 0,
//     so the pruned scans neither write nor read it). kProbe: while it
//     scans v < 2 * block_rows, each selecting warp records its query's
//     lowest column scoring >= NEG_INF of positions 0 and 1 (a ballot, then
//     an atomicMax of block_rows - column, 0 meaning none, in counters the
//     launch's memset zeroes).
//     This replaces topk_blocks.cu's design for the merged calls, IVF and
//     brute (one CTA per listed block and 8 queries, for IVF most of them
//     past n_valid and idle, each valid one streaming its block alone;
//     k_pad candidates per block and query written to device memory, 8.4
//     MB at 1,048,576 rows, block_rows 1024, q = 8; a torch sort to merge
//     them).
//  8. Both contracts: where block_rows % 4 != 0 or bias or scales start off
//     a 16-byte boundary, thread 0 copies the bias and scales of a stage
//     element by element (4-byte cp.async, arriving on the stage's barrier,
//     which then counts two arrivals); the rows go by bulk copies as before
//     (d % 128 == 0 keeps every row a 16-byte multiple).
//  9. Any d and k (make_plan). The query tile (16d bytes bf16, 8d int8,
//     8 (d + 64) int4), the lists (64k bytes; 129 <= k <= 1024), the
//     buffers (64 (R + 32) bytes; k > 32) and at least one stage
//     (R (row bytes + 8)) share one CTA's 232,448 bytes. A plan first keeps the lists in shared memory
//     (the shapes of 2.), then in device memory (kListDevice, which k >
//     1024 takes anyway); past that (bf16 from d ~ 4,700) the wide plan
//     (kWide) reads the query tile from device memory, bf16 as the caller
//     gives it (the wrapper casts), and may stage 8 rows (rows g + 8 of the
//     m16 step repeat rows g and are never selected). A wide plan scores at
//     the rate of its one or two stages in flight: it answers, slowly.
//
// Bound: HBM reads of the probed rows (2d, d or d/2 packed bytes each,
// plus 4 or 8 of bias and scale), once per 8-query tile.

#pragma once

#include "topk_scorers.cuh"

namespace ivf_tma {

constexpr int kThreads = kWarps * 32;
constexpr int kGroupRows = 16;      // rows a warp scores (the mma's m)
constexpr int kQuarters = 4;        // warps that share a row group, each a quarter of the width
constexpr int kMaxRows = kGroupRows * kWarps / kQuarters;  // 32 rows per stage at most
constexpr int kSmemLimit = 232448;  // bytes of shared memory one CTA may have
constexpr int kBatch = 8;           // loads in flight per thread in the query prep
constexpr int kMergeBatch = 9;      // ... in the merge (every window at once up to 2304 x 4)
constexpr int kWindowMax = 8;       // merge: entries of a list kept in shared memory
constexpr int kPair = 2;            // stages a CTA takes from the tile's counter at once
constexpr int kListsPerLane = 9;    // merge: lists a lane owns at most (n_cta <= 288)
// a warp's buffer of entries waiting to merge into its list (4.): 32 more
// than a stage of R rows can add, so that it takes a stage below 32
template <class T>
constexpr int kBuf = T::kStageRows + 32;

constexpr float kRecip127 = 1.0f / 127.0f;  // f32(1 / 127), as the jitted quantizer folds it

static_assert(kWarps == 2 * kQuarters, "two row groups of 16 per 32-row stage");

// Where a selecting warp keeps its list: topk_select.cuh's ListKind, and
// in its lanes' registers up to k = 32 (one entry a lane, kListWarp), 64
// and 128 (two and four, kListWarp2 and kListWarp4: 4. and 6. below)
constexpr int kListWarp = 3;
constexpr int kListWarp2 = 4;
constexpr int kListWarp4 = 5;
__host__ __device__ inline int tma_list_kind(int k) {
  return k <= 32 ? kListWarp : k <= 64 ? kListWarp2 : k <= 128 ? kListWarp4 : list_kind(k);
}
// registers a lane holds of a kListWarp2 / kListWarp4 list (0: another class)
template <int kList>
constexpr int kListRegsPerLane = kList == kListWarp2 ? 2 : kList == kListWarp4 ? 4 : 0;

// Compare-exchange with the lane `mask` away: this lane keeps the better of
// the two entries (score desc, key asc) if keep_better, else the worse.
__device__ __forceinline__ void exchange(float& s, int& i, int mask, bool keep_better) {
  const float os = __shfl_xor_sync(kFull, s, mask);
  const int oi = __shfl_xor_sync(kFull, i, mask);
  if (keep_better ? better(os, oi, s, i) : better(s, i, os, oi)) {
    s = os;
    i = oi;
  }
}

// The warp's 32 entries (one a lane) sorted best first, entry `lane` in
// lane `lane`: a bitonic sort, 15 exchanges.
__device__ __forceinline__ void sort32(float& s, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1)
      exchange(s, i, stride, ((lane & stride) == 0) == ((lane & size) == 0));
}

// A sorted list of 32 L entries, entry 32 r + lane in (ls[r], li[r]), takes
// the best 32 L of itself and 32 sorted entries (cs, ci), entry `lane` in
// lane `lane`. Its last 32 against the new ones reversed (each place the
// better) make a bitonic sequence that holds them (Batcher's merge), which
// a bitonic merge sorts: strides 16 L .. 32 between a lane's registers,
// then 16 .. 1 between lanes.
template <int L>
__device__ __forceinline__ void merge32(float (&ls)[L], int (&li)[L], float cs, int ci, int lane) {
  const float os = __shfl_sync(kFull, cs, 31 - lane);
  const int oi = __shfl_sync(kFull, ci, 31 - lane);
  if (better(os, oi, ls[L - 1], li[L - 1])) {
    ls[L - 1] = os;
    li[L - 1] = oi;
  }
#pragma unroll
  for (int h = L / 2; h >= 1; h /= 2)
#pragma unroll
    for (int r = 0; r < L; ++r)
      if ((r & h) == 0 && better(ls[r + h], li[r + h], ls[r], li[r])) {
        const float ts = ls[r];
        const int ti = li[r];
        ls[r] = ls[r + h];
        li[r] = li[r + h];
        ls[r + h] = ts;
        li[r + h] = ti;
      }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
#pragma unroll
    for (int r = 0; r < L; ++r) exchange(ls[r], li[r], stride, (lane & stride) == 0);
}

// Entry e < 32 L of a register list, to every lane.
template <int L>
__device__ __forceinline__ void list_entry(const float (&ls)[L], const int (&li)[L], int e,
                                           float& s, int& i) {
  float ts = ls[0];
  int ti = li[0];
#pragma unroll
  for (int r = 1; r < L; ++r)
    if (r == e / 32) {
      ts = ls[r];
      ti = li[r];
    }
  s = __shfl_sync(kFull, ts, e % 32);
  i = __shfl_sync(kFull, ti, e % 32);
}

// The first 32 entries of a warp's buffer of n (fewer: padded with the
// lists' initial entry (NEG_INF, 0)), entry `lane` in (cs, ci); the rest
// move down 32 places, a chunk at a time, each read before it is written.
__device__ __forceinline__ void buffer_take(float* bs, int* bi, int n, float& cs, int& ci,
                                            int lane) {
  __syncwarp();
  cs = lane < n ? bs[lane] : kNegInf;
  ci = lane < n ? bi[lane] : 0;
  for (int base = 32; base < n; base += 32) {
    const bool has = base + lane < n;
    const float rs = has ? bs[base + lane] : 0.f;
    const int ri = has ? bi[base + lane] : 0;
    __syncwarp();
    if (has) {
      bs[base - 32 + lane] = rs;
      bi[base - 32 + lane] = ri;
    }
    __syncwarp();
  }
}

// A register list takes the first min(n, 32) entries of a warp's buffer
// (bs, bi) at once (sorted, then merge32; the pad (NEG_INF, 0) is the
// list's initial entry), and (ts, ti) becomes its entry k - 1. Entries 32 ..
// n - 1 move down 32 places; returns how many are left.
template <int L>
__device__ __forceinline__ int flush_buffer(float* bs, int* bi, int n, float (&ls)[L],
                                            int (&li)[L], int k, float& ts, int& ti, int lane) {
  float cs;
  int ci;
  buffer_take(bs, bi, n, cs, ci, lane);
  sort32(cs, ci, lane);
  merge32<L>(ls, li, cs, ci, lane);
  list_entry<L>(ls, li, k - 1, ts, ti);
  return n > 32 ? n - 32 : 0;
}

// The same for a sorted list of k entries in shared or device memory (ls,
// li), as a merge of the 32 sorted entries into it: list entry j moves to
// j + (the new entries that rank before it), new entry `lane` goes to
// lane + (the list entries that rank before it or tie it), and what lands
// at k or past it drops out. The list moves up 32 entries at a time from
// its end, each chunk read before it is written and written below the
// chunk above it (the places are increasing), down to where the best new
// entry goes in; so a merge costs the entries it moves, not k.
__device__ __forceinline__ int flush_memory(float* bs, int* bi, int n, float* ls, int* li, int k,
                                            float& ts, int& ti, int lane) {
  float cs;
  int ci;
  buffer_take(bs, bi, n, cs, ci, lane);
  sort32(cs, ci, lane);
  // this new entry's place in the list: the first entry it beats
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(cs, ci, ls[mid], li[mid]))
      hi = mid;
    else
      lo = mid + 1;
  }
  const int at = lane + lo;
  const int first = __shfl_sync(kFull, lo, 0);  // where the best new entry goes in
  for (int top = k; top > first; top -= 32) {
    const int j = top - 32 + lane;
    const bool moves = j >= first;
    float s = kNegInf;
    int i = 0;
    if (moves) {
      s = ls[j];
      i = li[j];
    }
    // the new entries that rank before list entry j: a prefix of the lanes
    int c_lo = 0, c_hi = 32;
#pragma unroll
    for (int step = 0; step < 6; ++step) {
      const int mid = (c_lo + c_hi) >> 1;
      const float ms = __shfl_sync(kFull, cs, mid & 31);
      const int mi = __shfl_sync(kFull, ci, mid & 31);
      if (c_lo < c_hi) {
        if (better(ms, mi, s, i))
          c_lo = mid + 1;
        else
          c_hi = mid;
      }
    }
    __syncwarp();
    if (moves && j + c_lo < k) {
      ls[j + c_lo] = s;
      li[j + c_lo] = i;
    }
    __syncwarp();
  }
  if (at < k) {
    ls[at] = cs;
    li[at] = ci;
  }
  __syncwarp();
  ts = ls[k - 1];
  ti = li[k - 1];
  return n > 32 ? n - 32 : 0;
}

// A warp's entries that beat its list's entry k - 1 (`in`, this lane's
// (s, i)) join the buffer behind its n entries; returns the new count.
__device__ __forceinline__ int buffer_append(float* bs, int* bi, int n, bool in, float s, int i,
                                             int lane) {
  const unsigned got = __ballot_sync(kFull, in);
  if (in) {
    const int at = n + __popc(got & ((1u << lane) - 1u));
    bs[at] = s;
    bi[at] = i;
  }
  return n + __popc(got);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
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

// `bytes` (a multiple of 16) contiguous bytes into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 4 bytes into shared memory (cp.async; completes on the barrier below)
__device__ __forceinline__ void copy4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// one arrival on `bar` once every cp.async this thread issued has landed
__device__ __forceinline__ void copy4_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(bar) : "memory");
}

// d = A . B + d over one k16 step: A 16 x 16 bf16 (row major), B 16 x 8 bf16
// (column major), d 16 x 8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = A . B + d over one k32 step: A 16 x 32 s8 (row major), B 32 x 8 s8
// (column major), d 16 x 8 s32, exact
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The warp's quarter of the dots of 16 rows (`rows`, row_bytes apart)
// with the kQT queries of the tile `qt` (q_row bytes apart), each row and
// query `chunks` 16-byte chunks long. Lane (g, t) = (lane / 4, lane % 4)
// adds to acc[e] the partial dot of row g + 8 (e >> 1) with query
// 2t + (e & 1). Chunk c of a row belongs to quarter c / 4 % 4; lane t takes
// c = 4 quarter + t + 16 i. Two mma steps per chunk: words 0 and 1, then 2
// and 3, as the two k groups of the step (A and B alike).
// kWide: the query tile lies in device memory with q_valid rows (lanes of
// the rows past it read the last one, whose dots are never selected), and
// the group's second 8 rows are rows g + hi (hi 0: an 8-row stage).
template <typename Acc, void (*Mma)(Acc (&)[4], const uint32_t (&)[4], const uint32_t (&)[2]),
          bool kWide = false>
__device__ __forceinline__ void quarter_dots(const unsigned char* qt, int q_row,
                                             const unsigned char* rows, int row_bytes, int chunks,
                                             int quarter, int lane, Acc (&acc)[4],
                                             int q_valid = kQT, int hi = 8) {
  const int g = lane >> 2, t = lane & 3;
  const uint4* ra = reinterpret_cast<const uint4*>(rows + (size_t)g * row_bytes);
  const uint4* rb = reinterpret_cast<const uint4*>(rows + (size_t)(g + (kWide ? hi : 8)) * row_bytes);
  const uint4* qg =
      reinterpret_cast<const uint4*>(qt + (size_t)(kWide ? min(g, q_valid - 1) : g) * q_row);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c0 = 4 * quarter; c0 < chunks; c0 += 16) {  // warp-uniform
    const int c = c0 + t;
    const uint4 xa = c < chunks ? ra[c] : zero, xb = c < chunks ? rb[c] : zero;
    const uint4 xq = c < chunks ? (kWide ? __ldg(qg + c) : qg[c]) : zero;
    {
      const uint32_t a[4] = {xa.x, xb.x, xa.y, xb.y};
      const uint32_t b[2] = {xq.x, xq.y};
      Mma(acc, a, b);
    }
    {
      const uint32_t a[4] = {xa.z, xb.z, xa.w, xb.w};
      const uint32_t b[2] = {xq.z, xq.w};
      Mma(acc, a, b);
    }
  }
}

// bf16 rows: the query tile as bf16 [kQT, d], rows 2d bytes
struct Bf16 {
  static constexpr bool kScaled = false;
  static constexpr int kStages = 4;  // stages in the ring at most
  static constexpr int kStageRows = kMaxRows;  // R at most
  typedef float Acc;
  static __host__ __device__ bool width_ok(int d) { return d % 128 == 0; }
  static __host__ __device__ int row_bytes(int d) { return 2 * d; }
  static __host__ __device__ size_t q_bytes(int d) { return (size_t)2 * kQT * d; }

  // queries f32 or (queries_bf16) bf16 [q, d], 16-byte aligned; rows past
  // q are zero. 16-byte loads, kBatch in flight per thread (d = 768: every
  // load of the tile at once); the ring's first fill (`loaded`) goes out
  // behind the first loads, before their values are used
  template <class Hook>
  static __device__ void prepare(unsigned char* qt, float*, const void* queries, bool queries_bf16,
                                 int q0, int q_valid, int d, Hook&& loaded) {
    if (queries_bf16) {  // a chunk: 8 bf16, copied
      uint4* dst = reinterpret_cast<uint4*>(qt);
      const uint4* src =
          reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(queries) + (size_t)q0 * d);
      const int chunks = kQT * d / 8, valid = q_valid * d / 8;
      for (int base = threadIdx.x; base < chunks; base += kThreads * kBatch) {
        uint4 v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int c = base + u * kThreads;
          v[u] = c < valid ? __ldg(src + c) : make_uint4(0, 0, 0, 0);
        }
        if (base == threadIdx.x) loaded();
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (base + u * kThreads < chunks) dst[base + u * kThreads] = v[u];
      }
      return;
    }
    // a chunk: 4 f32, rounded to 4 bf16 (8 bytes) as .to(torch.bfloat16)
    uint2* dst = reinterpret_cast<uint2*>(qt);
    const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(queries) +
                                                        (size_t)q0 * d);
    const int chunks = kQT * d / 4, valid = q_valid * d / 4;
    for (int base = threadIdx.x; base < chunks; base += kThreads * kBatch) {
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = base + u * kThreads;
        v[u] = c < valid ? __ldg(src + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      if (base == threadIdx.x) loaded();
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = base + u * kThreads;
        if (c < chunks) {
          __nv_bfloat162 lo = __floats2bfloat162_rn(v[u].x, v[u].y);
          __nv_bfloat162 hi = __floats2bfloat162_rn(v[u].z, v[u].w);
          dst[c] = make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
        }
      }
    }
  }

  template <bool kWide = false>
  static __device__ __forceinline__ void dots(const unsigned char* qt, const unsigned char* rows,
                                              int d, int quarter, int lane, float (&acc)[4],
                                              int q_valid = kQT, int hi = 8) {
    quarter_dots<float, mma_bf16, kWide>(qt, 2 * d, rows, 2 * d, d / 8, quarter, lane, acc,
                                         q_valid, hi);
  }
  static __device__ __forceinline__ float to_f32(float s) { return s; }
};

// int8 rows: the query tile as int8 [kQT, d], rows d bytes
struct Int8 {
  static constexpr bool kScaled = true;
  static constexpr int kStages = 4;
  static constexpr int kStageRows = kMaxRows;
  typedef int Acc;
  static __host__ __device__ bool width_ok(int d) { return d % 128 == 0; }
  static __host__ __device__ int row_bytes(int d) { return d; }
  static __host__ __device__ size_t q_bytes(int d) { return (size_t)kQT * d; }

  template <class Hook>
  static __device__ void prepare(unsigned char* qt, float* qscale, const void* queries, bool,
                                 int q0, int q_valid, int d, Hook&& loaded) {
    quantize_tile<0>(qt, qscale, queries, q0, q_valid, d, loaded);
  }

  // queries f32 [q, d], 16-byte aligned, quantized as quantize_rows_int8
  // into the tile, query j at qt + j (d + kPad) (rows past q: zeros, scale
  // 0). Every thread loads its float4 chunks of the tile, kBatch in flight
  // (d <= 1024: all of them, held in registers for the second pass); a
  // warp's 32 chunks belong to one query (d is a multiple of 128), whose
  // amax it takes to shared memory with one atomicMax (qscale's words as
  // f32 bits: non-negative floats order as their bits do). All threads
  // take part.
  template <int kPad, class Hook>
  static __device__ void quantize_tile(unsigned char* qt, float* qscale, const void* queries,
                                       int q0, int q_valid, int d, Hook&& loaded) {
    unsigned* qmax = reinterpret_cast<unsigned*>(qscale);
    uint32_t* qq = reinterpret_cast<uint32_t*>(qt);
    const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(queries) +
                                                        (size_t)q0 * d);
    const int n4 = d / 4, chunks = kQT * n4, valid = q_valid * n4;
    const int lane = threadIdx.x % 32;
    const bool held = chunks <= kThreads * kBatch;
    if (threadIdx.x < kQT) qmax[threadIdx.x] = 0u;
    __syncthreads();
    float4 v[kBatch];
    auto load = [&](int base) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = base + u * kThreads;
        v[u] = c < valid ? __ldg(src + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    for (int base = threadIdx.x; base < chunks; base += kThreads * kBatch) {
      load(base);
      if (base == threadIdx.x) loaded();  // the first loads are out
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = base + u * kThreads;
        if (c - lane < chunks) {  // warp-uniform
          float m = fmaxf(fmaxf(fabsf(v[u].x), fabsf(v[u].y)), fmaxf(fabsf(v[u].z), fabsf(v[u].w)));
#pragma unroll
          for (int o = 16; o >= 1; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
          if (lane == 0) atomicMax(qmax + c / n4, __float_as_uint(m));
        }
      }
    }
    __syncthreads();
    // the jitted quantizer's folded division: a product with f32(1 / 127)
    __shared__ float scale_s[kQT], inv_s[kQT];
    if (threadIdx.x < kQT) {
      const float scale = __fmul_rn(fmaxf(__uint_as_float(qmax[threadIdx.x]), 1e-12f), kRecip127);
      scale_s[threadIdx.x] = scale;
      inv_s[threadIdx.x] = __frcp_rn(scale);
    }
    __syncthreads();
    for (int base = threadIdx.x; base < chunks; base += kThreads * kBatch) {
      if (!held) load(base);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int c = base + u * kThreads;
        if (c < chunks) {
          uint32_t word = 0;
          if (c < valid) {
            const float scale = scale_s[c / n4], inv = inv_s[c / n4];
            word = quantize(v[u].x, scale, inv) | quantize(v[u].y, scale, inv) << 8 |
                   quantize(v[u].z, scale, inv) << 16 | quantize(v[u].w, scale, inv) << 24;
          }
          if constexpr (kPad == 0)
            qq[c] = word;
          else
            qq[c + c / n4 * (kPad / 4)] = word;
        }
      }
    }
    if (threadIdx.x < kQT) qscale[threadIdx.x] = threadIdx.x < q_valid ? scale_s[threadIdx.x] : 0.f;
  }

  // round half to even of the true quotient e / scale (f32), clamped to
  // +-127, as a byte. The product with the reciprocal is within 3e-5 of the
  // quotient for |quotient| <= 128 (two roundings of 2^-24), so its nearest
  // integer is the quotient's unless it lies within 1e-4 of a half; there
  // the true division decides.
  static __device__ __forceinline__ uint32_t quantize(float e, float scale, float inv) {
    float y = e * inv;
    if (fabsf(y - floorf(y) - 0.5f) < 1e-4f) y = __fdiv_rn(e, scale);
    return (uint32_t)(int)fminf(fmaxf(rintf(y), -127.f), 127.f) & 0xffu;
  }

  template <bool kWide = false>  // no wide plan (the tile fits up to d = 8192)
  static __device__ __forceinline__ void dots(const unsigned char* qt, const unsigned char* rows,
                                              int d, int quarter, int lane, int (&acc)[4],
                                              int = kQT, int = 8) {
    static_assert(!kWide, "int8 has no wide plan");
    quarter_dots<int, mma_s8>(qt, d, rows, d, d / 16, quarter, lane, acc);
  }
  static __device__ __forceinline__ float to_f32(int s) { return __int2float_rn(s); }
};

// int4 rows: packed [n, d/2] (quantize_rows_int4's layout), d/2 bytes a
// row; the query tile as int8 [kQT, d + kQPad], then 8 sum(q) per query as
// int32 (3. and 5. above)
struct Int4 {
  static constexpr bool kScaled = true;
  static constexpr int kStages = 7;  // 32-row stages, where 64-row ones do not fit
  // 64-row stages: the bytes of an int8 stage, so the ring's cost per stage
  // spreads over as many bytes (2.)
  static constexpr int kStageRows = 2 * kMaxRows;
  static constexpr int kQPad = 64;   // bytes past each query row: its 16-byte loads in other banks
  typedef int Acc;
  // the packed width a multiple of 128, as the TPU kernel asserts
  static __host__ __device__ bool width_ok(int d) { return d % 256 == 0; }
  static __host__ __device__ int row_bytes(int d) { return d / 2; }
  static __host__ __device__ size_t q_bytes(int d) {
    return corr_off(d) + sizeof(int) * kQT;
  }
  static __host__ __device__ size_t corr_off(int d) { return (size_t)kQT * (d + kQPad); }

  template <class Hook>
  static __device__ void prepare(unsigned char* qt, float* qscale, const void* queries, bool,
                                 int q0, int q_valid, int d, Hook&& loaded) {
    Int8::quantize_tile<kQPad>(qt, qscale, queries, q0, q_valid, d, loaded);
    __syncthreads();
    // warp j: 8 times the sum of query j's bytes (kWarps == kQT; rows past q are zero)
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int* row = reinterpret_cast<const int*>(qt + (size_t)warp * (d + kQPad));
    int s = 0;
    for (int w = lane; w < d / 4; w += 32) s = __dp4a(row[w], 0x01010101, s);
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) reinterpret_cast<int*>(qt + corr_off(d))[warp] = 8 * s;
  }

  // one k32 step: words wa and wb of rows g and g + 8 (their low nibbles as
  // k 4t.., their high ones as k 16 + 4t..) against the query words of the
  // same bytes in its low half (ql) and its high half (qh)
  static __device__ __forceinline__ void step(int (&acc)[4], uint32_t wa, uint32_t wb, uint32_t ql,
                                              uint32_t qh) {
    const uint32_t ua = wa ^ 0x88888888u, ub = wb ^ 0x88888888u;
    const uint32_t a[4] = {ua & 0x0f0f0f0fu, ub & 0x0f0f0f0fu, (ua >> 4) & 0x0f0f0f0fu,
                           (ub >> 4) & 0x0f0f0f0fu};
    const uint32_t b[2] = {ql, qh};
    mma_u8s8(acc, a, b);
  }

  // The warp's quarter of the dots of 16 packed rows (`rows`, d/2 bytes
  // apart) with the tile's queries, as 3. above: lane (g, t) adds to acc[e]
  // the partial dot of row g + 8 (e >> 1) with query 2t + (e & 1); quarter
  // 0 subtracts the queries' 8 sum(q).
  template <bool kWide = false>  // no wide plan (the tile fits up to d = 8192)
  static __device__ __forceinline__ void dots(const unsigned char* qt, const unsigned char* rows,
                                              int d, int quarter, int lane, int (&acc)[4],
                                              int = kQT, int = 8) {
    static_assert(!kWide, "int4 has no wide plan");
    const int half = d / 2, g = lane >> 2, t = lane & 3;
    const unsigned char* ra = rows + (size_t)g * half;  // rows g and g + 8
    const unsigned char* rb = ra + (size_t)8 * half;
    const unsigned char* ql = qt + (size_t)g * (d + kQPad);  // query g's low half
    const unsigned char* qh = ql + half;                     // and its high half
    const int rounds = d / 512;  // of 16 packed chunks
    for (int r = 0; r < rounds; ++r) {  // chunk 16r + 4 quarter + t, four steps
      const int off = 16 * (16 * r + 4 * quarter + t);
      const uint4 xa = *reinterpret_cast<const uint4*>(ra + off);
      const uint4 xb = *reinterpret_cast<const uint4*>(rb + off);
      const uint4 bl = *reinterpret_cast<const uint4*>(ql + off);
      const uint4 bh = *reinterpret_cast<const uint4*>(qh + off);
      step(acc, xa.x, xb.x, bl.x, bh.x);
      step(acc, xa.y, xb.y, bl.y, bh.y);
      step(acc, xa.z, xb.z, bl.z, bh.z);
      step(acc, xa.w, xb.w, bl.w, bh.w);
    }
    if (d % 512) {  // the last 8 chunks as 16 halves: half 4 quarter + t, two steps
      const int off = 256 * rounds + 8 * (4 * quarter + t);
      const uint2 xa = *reinterpret_cast<const uint2*>(ra + off);
      const uint2 xb = *reinterpret_cast<const uint2*>(rb + off);
      const uint2 bl = *reinterpret_cast<const uint2*>(ql + off);
      const uint2 bh = *reinterpret_cast<const uint2*>(qh + off);
      step(acc, xa.x, xb.x, bl.x, bh.x);
      step(acc, xa.y, xb.y, bl.y, bh.y);
    }
    if (quarter == 0) {
      const int* corr = reinterpret_cast<const int*>(qt + corr_off(d));
      const int c0 = corr[2 * t], c1 = corr[2 * t + 1];
      acc[0] -= c0;
      acc[1] -= c1;
      acc[2] -= c0;
      acc[3] -= c1;
    }
  }
  static __device__ __forceinline__ float to_f32(int s) { return __int2float_rn(s); }
};

// Stage geometry and shared-memory layout, the same on host and device.
// Shared memory: S mbarriers | query tile (not for a wide plan) | qscale
// f32 [kQT] | partial dots [2, kQuarters, kQT, 32] (T::Acc) | lists (k
// scores, k rows per query; not for device lists; a register list's
// buffer, kBuf scores and kBuf rows per query, instead) | S stages of R
// rows, R biases and R scales.
// The last CTA's merge reuses everything past the mbarriers: per query
// the windows' scores [n_cta, W] and rows [n_cta, W] (n_cta counted up to
// a multiple of 4), then (129 <= k <= 1024) the merged lists, k scores and
// k rows per query, then the buffers.
template <class T>
struct Plan {
  int rows;    // R, rows per stage: 32 or 16 (a wide plan also 8)
  int stages;  // S
  int row_bytes, d, k;
  int window;     // W, entries per list in the merge's windows (set at launch)
  int dev_lists;  // the lists in device memory (kListDevice)
  int wide;       // the query tile in device memory (kWide)

  __host__ __device__ size_t barriers() const { return 16 * ((8 * stages + 15) / 16); }
  __host__ __device__ size_t q_off() const { return barriers(); }
  __host__ __device__ size_t qscale_off() const { return q_off() + (wide ? 0 : T::q_bytes(d)); }
  __host__ __device__ size_t parts_off() const { return qscale_off() + sizeof(float) * kQT; }
  __host__ __device__ size_t lists_off() const {
    return parts_off() + sizeof(typename T::Acc) * 2 * kQuarters * kQT * T::kStageRows;
  }
  // the selecting warps' list class (4.): shared lists take k entries per
  // query here, and every class above k = 32 a buffer of kBuf
  __host__ __device__ int list_class() const { return dev_lists ? kListDevice : tma_list_kind(k); }
  __host__ __device__ size_t buf_off() const {
    return lists_off() + (list_class() == kListShared ? (size_t)kQT * k * 8 : 0);
  }
  __host__ __device__ size_t ring_off() const {
    const size_t buf = list_class() == kListWarp ? 0 : (size_t)kQT * kBuf<T> * 8;
    return 16 * ((buf_off() + buf + 15) / 16);
  }
  // a stage: rows, then biases, then scales (every part a multiple of 16 bytes)
  __host__ __device__ size_t stage_bytes() const { return (size_t)rows * (row_bytes + 8); }
  // the merge's: the windows, then (shared lists) the merged lists, then the buffers
  __host__ __device__ size_t merge_list_off(int n_cta) const {
    return barriers() + (size_t)kQT * ((n_cta + 3) & ~3) * 8 * window;
  }
  __host__ __device__ size_t merge_buf_off(int n_cta) const {
    return merge_list_off(n_cta) + (list_class() == kListShared ? (size_t)kQT * k * 8 : 0);
  }
  __host__ __device__ size_t merge_bytes(int n_cta) const {
    return merge_buf_off(n_cta) + (size_t)kQT * kBuf<T> * 8;
  }
  __host__ __device__ size_t smem(int n_cta) const {
    const size_t scan = ring_off() + stages * stage_bytes();
    const size_t merge = merge_bytes(n_cta);
    return scan > merge ? scan : merge;
  }
};

// R and S for width d and top-k k: the first of 3 and 2 x 64, 7, 6 and 5
// x 32 (int4 only), 4, 3 and 2 x 32, 4, 3 and 2 x 16, 1 x 32 and 1 x 16
// rows that fits (the merge
// at a window of 4) with the lists in shared memory (k <= 1024), then with
// the lists in device memory, then (bf16) the same and 4, 3, 2 and 1 x 8
// as a wide plan (9. above); rows = 0 if none does.
template <class T>
Plan<T> make_plan(int d, int k, int max_cta) {
  const int shapes[][2] = {{64, 3}, {64, 2}, {32, 7}, {32, 6}, {32, 5}, {32, 4}, {32, 3}, {32, 2}, {16, 4}, {16, 3},
                           {16, 2}, {32, 1}, {16, 1}, {8, 4},  {8, 3},  {8, 2},  {8, 1}};
  for (int dev = list_kind(k) == kListDevice; dev <= 1; ++dev)
    for (const auto& rs : shapes) {
      // 8-row stages only with the query tile in device memory
      if (rs[0] < 16 || rs[0] > T::kStageRows || rs[1] > T::kStages) continue;
      const Plan<T> p{rs[0], rs[1], T::row_bytes(d), d, k, 4, dev, 0};
      if (p.smem(max_cta) <= (size_t)kSmemLimit) return p;
    }
  if (!T::kScaled)
    for (const auto& rs : shapes) {
      if (rs[0] > T::kStageRows || rs[1] > T::kStages) continue;
      const Plan<T> p{rs[0], rs[1], T::row_bytes(d), d, k, 4, 1, 1};
      if (p.smem(max_cta) <= (size_t)kSmemLimit) return p;
    }
  return Plan<T>{0, 1, T::row_bytes(d), d, k, 4, 1, 0};
}

struct Args {
  const void* queries;  // [q, d] f32, or bf16 (queries_bf16, bf16 scan only)
  const void* x;        // [n, row bytes]
  const float* xscale;  // [n] (int8, int4)
  const float* bias;    // [n]
  float* cand_s;        // [tiles, n_cta, kQT, k_pad]
  int* cand_i;          // [tiles, n_cta, kQT, k_pad]
  int* counter;         // [2, tiles], zero at launch: the tiles' tickets, then their stages
  float* out_s;         // [q, k]
  int* out_i;           // [q, k]
  RowSource src;         // ids and n_valid null: the identity plan
  int q, d, k, queries_bf16;
};

// The plan's stored row of virtual row v and the block at position i; the
// identity plan (ids null) maps both to themselves
__device__ __forceinline__ int stored_row(const RowSource& s, int v) {
  return s.ids ? s.row(v) : v;
}
__device__ __forceinline__ int block_id(const RowSource& s, int i) {
  return s.ids ? __ldg(s.ids + i) : i;
}

// The counters past the tickets and stage pairs, [tiles, kFirstCols]:
// kProbe [kQT, 2], per query block_rows minus the lowest column of
// positions 0 and 1 that scores >= NEG_INF (0: none); the DMA entries the
// tile's last live v plus 1 in the first (0: none)
constexpr int kFirstCols = 2 * kQT;

template <class T, int kList, bool kProbe, bool kWide = false>
__global__ void __launch_bounds__(kThreads, 2) ivf_tma_kernel(const Args a, const Plan<T> p) {
  typedef typename T::Acc Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bars = smem_addr(smem);
  unsigned char* qt = smem + p.q_off();  // the tile's prepared queries (not kWide)
  float* qscale = reinterpret_cast<float*>(smem + p.qscale_off());
  Acc* parts = reinterpret_cast<Acc*>(smem + p.parts_off());
  float* list_s = reinterpret_cast<float*>(smem + p.lists_off());
  int* list_i = reinterpret_cast<int*>(list_s + kQT * a.k);
  unsigned char* ring = smem + p.ring_off();
  __shared__ int last_cta;
  __shared__ int slot_v0[T::kStages];  // the first virtual row of each slot's stage, -1: none

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cta = blockIdx.x, n_cta = gridDim.x;
  const int q0 = blockIdx.y * kQT;
  const int q_valid = min(kQT, a.q - q0);
  const int k = a.k, d = a.d, R = p.rows, S = p.stages;
  const int k_pad = (k + 3) & ~3;
  const int br = a.src.block_rows;
  const bool identity = a.src.ids == nullptr;  // every block, in order (no read)
  // the plan's virtual rows [0, total), taken a stage of R at a time
  const int nv = identity ? a.src.max_blocks : min(max(*a.src.n_valid, 0), a.src.max_blocks);
  const int total = nv * br;
  // bias and scales element by element where a bulk copy cannot take them
  // (runs off 4-row boundaries, or tensors off 16-byte ones); the identity
  // plan's runs are whole stages, cut only at the last row
  const bool aux_copy = (identity ? total : br) % 4 != 0 ||
                        ((reinterpret_cast<uintptr_t>(a.bias) |
                          reinterpret_cast<uintptr_t>(a.xscale)) & 15) != 0;
  int* next_pair = a.counter + gridDim.y + blockIdx.y;
  // thread 0: stages of its own issued, the pair claim in flight, the
  // stages left of the pair in hand and the next of them
  int own = 0, claim = 0, pair_left = 0, pair_stage = 0;
  bool more = true;  // thread 0: no stage past the plan issued yet
  if (threadIdx.x == 0) claim = atomicAdd(next_pair, 1);

  // slot i % S takes the CTA's next stage: one run of copies per block it
  // touches; past the plan, an arrival with no rows
  auto issue = [&](int i) {
    const int slot = i % S;
    long long stage;
    if (own < S) {
      stage = (long long)cta * S + own++;
    } else {
      if (pair_left == 0) {
        pair_stage = n_cta * S + kPair * claim;
        pair_left = kPair;
        claim = atomicAdd(next_pair, 1);
      }
      --pair_left;
      stage = pair_stage++;
    }
    const long long s0 = stage * R;
    more = s0 < total;
    const int v0 = more ? (int)s0 : -1;
    slot_v0[slot] = v0;
    if (!more) {
      mbar_arrive(bars + 8 * slot);
      if (aux_copy) mbar_arrive(bars + 8 * slot);
      return;
    }
    const int len = min(R, total - v0);
    unsigned char* st = ring + slot * p.stage_bytes();
    const int per_row = p.row_bytes + (aux_copy ? 0 : 4 + (T::kScaled ? 4 : 0));
    mbar_expect_tx(bars + 8 * slot, len * per_row);
    for (int r = 0; r < len;) {
      const int v = v0 + r;
      const int run = identity ? len - r : min(len - r, br - v % br);
      const int row = stored_row(a.src, v);
      bulk_load(smem_addr(st + (size_t)r * p.row_bytes),
                static_cast<const unsigned char*>(a.x) + (size_t)row * p.row_bytes,
                run * p.row_bytes, bars + 8 * slot);
      if (aux_copy) {
        for (int e = 0; e < run; ++e) {
          copy4(smem_addr(st + (size_t)R * p.row_bytes + 4 * (r + e)), a.bias + row + e);
          if constexpr (T::kScaled)
            copy4(smem_addr(st + (size_t)R * (p.row_bytes + 4) + 4 * (r + e)), a.xscale + row + e);
        }
      } else {
        bulk_load(smem_addr(st + (size_t)R * p.row_bytes + 4 * r), a.bias + row, 4 * run,
                  bars + 8 * slot);
        if constexpr (T::kScaled)
          bulk_load(smem_addr(st + (size_t)R * (p.row_bytes + 4) + 4 * r), a.xscale + row,
                    4 * run, bars + 8 * slot);
      }
      r += run;
    }
    if (aux_copy) copy4_arrive(bars + 8 * slot);  // the barrier's second arrival
  };

  // the ring's first fill goes out once the queries' loads are (their loads
  // would otherwise queue behind the ring's bytes)
  auto first_fill = [&]() {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, aux_copy ? 2 : 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int i = 0; i < S && more; ++i) issue(i);
    }
  };
  // the query tile the dots read: kWide the caller's bf16 rows in place
  const unsigned char* q_read = qt;
  if constexpr (kWide) {
    q_read = static_cast<const unsigned char*>(a.queries) + (size_t)q0 * T::row_bytes(d);
    first_fill();
  } else {
    T::prepare(qt, qscale, a.queries, a.queries_bf16 != 0, q0, q_valid, d, first_fill);
  }
  // kListWarp2/4: the list in registers, entry 32 r + lane in (wl_s[r], wl_i[r])
  constexpr int kRegList = kListRegsPerLane<kList>;
  if constexpr (kList == kListShared) {
    for (int e = threadIdx.x; e < kQT * k; e += kThreads) {
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
  // this list's candidates
  const size_t slot_out = (((size_t)blockIdx.y * n_cta + cta) * kQT + warp) * k_pad;
  [[maybe_unused]] int last_live = -1;  // DMA: the last live v this warp scored
  if constexpr (kList == kListDevice) {
    if (selects) {
      my_s = a.cand_s + slot_out;
      my_i = a.cand_i + slot_out;
      for (int t = lane; t < k; t += 32) {
        my_s[t] = kNegInf;
        my_i[t] = 0;
      }
      __syncwarp();
    }
  }
  const float qs_w = T::kScaled && selects ? qscale[warp] : 0.f;
  const int group = warp / kQuarters, quarter = warp % kQuarters;
  float reg_s = kNegInf;  // kListWarp: entry `lane` of this warp's list
  int reg_i = 0;
  float wl_s[kRegList > 0 ? kRegList : 1];
  int wl_i[kRegList > 0 ? kRegList : 1];
#pragma unroll
  for (int r = 0; r < (kRegList > 0 ? kRegList : 1); ++r) {
    wl_s[r] = kNegInf;
    wl_i[r] = 0;
  }
  // above k = 32: this warp's buffer of entries waiting to merge in (4.)
  float* buf_s = reinterpret_cast<float*>(smem + p.buf_off()) + warp * 2 * kBuf<T>;
  int* buf_i = reinterpret_cast<int*>(buf_s + kBuf<T>);
  int n_buf = 0;
  // the buffer's first 32 entries into the list (fewer: padded); returns the rest
  auto flush = [&]() {
    if constexpr (kRegList > 0)
      return flush_buffer(buf_s, buf_i, n_buf, wl_s, wl_i, k, thr_s, thr_i, lane);
    else
      return flush_memory(buf_s, buf_i, n_buf, my_s, my_i, k, thr_s, thr_i, lane);
  };
  int flush_all = 0;  // a selecting warp's buffer held 32 at the last barrier

  constexpr int kRows = T::kStageRows;   // the partial dots' row stride
  constexpr int kHalves = kRows / 32;     // the rows a lane selects in a stage
  for (int i = 0;; ++i) {
    const int slot = i % S;
    mbar_wait(bars + 8 * slot, (i / S) & 1);
    const int v0 = slot_v0[slot];
    if (v0 < 0) break;  // the same for every thread: the scan is over
    const int len = min(R, total - v0);
    const unsigned char* st = ring + slot * p.stage_bytes();
    Acc* part = parts + (i & 1) * kQuarters * kQT * kRows;  // [kQuarters, kQT, kRows]
    // the warp's row groups: group, group + 2, .. (rows past len are scored
    // and never selected)
#pragma unroll
    for (int grp = group; grp < kRows / kGroupRows; grp += kWarps / kQuarters) {
      if (kGroupRows * grp < len) {
        Acc acc[4] = {0, 0, 0, 0};
        T::template dots<kWide>(q_read, st + (size_t)kGroupRows * grp * p.row_bytes, d, quarter,
                                lane, acc, q_valid, R > 8 ? 8 : 0);
        const int g = lane >> 2, t = lane & 3;
        Acc* out = part + quarter * kQT * kRows + kGroupRows * grp + g;
#pragma unroll
        for (int e = 0; e < 4; ++e) out[(2 * t + (e & 1)) * kRows + 8 * (e >> 1)] = acc[e];
      }
    }
    // the bias and scale of the rows this lane selects (lane, lane + 32, ..),
    // out of the stage before it is refilled
    float b[kHalves], xs[kHalves];
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      b[h] = xs[h] = 0.f;
      if (selects && 32 * h + lane < len) {
        b[h] = reinterpret_cast<const float*>(st + (size_t)R * p.row_bytes)[32 * h + lane];
        if constexpr (T::kScaled)
          xs[h] = reinterpret_cast<const float*>(st + (size_t)R * (p.row_bytes + 4))[32 * h + lane];
      }
    }
    // the partial dots are complete and the stage consumed; the other
    // buffer is free for the next stage, whose scoring starts only after
    // every warp passed this barrier, that is, after every warp finished
    // selecting from it
    if constexpr (kList == kListWarp)
      __syncthreads();
    else
      flush_all = __syncthreads_or(selects && n_buf >= 32);
    if (threadIdx.x == 0 && more) issue(i + S);

    // when a warp's buffer held 32 at the barrier, every warp merges its
    // buffer in, down to fewer than 32 (a stage then adds at most kRows)
    if constexpr (kList != kListWarp)
      if (flush_all && selects && n_buf > 0) {
        n_buf = flush();
        while (n_buf >= 32) n_buf = flush();
      }
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      if (!selects || 32 * h >= len) break;  // warp-uniform
      const int vh = v0 + 32 * h;  // the virtual row of lane 0
      const bool ok = lane < len - 32 * h;
      // the list's key: the virtual row
      const int row = ok ? vh + lane : 0;
      float s = 0.f;
      if (ok) {
        const Acc* in = part + warp * kRows + 32 * h + lane;
        const float t = T::to_f32(((in[0] + in[kQT * kRows]) + in[2 * kQT * kRows]) +
                                  in[3 * kQT * kRows]);
        if constexpr (T::kScaled)
          // the TPU kernels' epilogue, rounded op by op (no contraction)
          s = __fadd_rn(__fmul_rn(t, __fmul_rn(qs_w, xs[h])), b[h]);
        else
          s = t + b[h];
      }
      if constexpr (!kProbe) {
        const unsigned lv = __ballot_sync(kFull, ok && s > kNegInf);
        if (lv) last_live = max(last_live, vh + 31 - __clz(lv));
      }
      if constexpr (kProbe) {
        if (vh < 2 * br) {  // positions 0 and 1: their lowest columns scoring >= NEG_INF
          const bool seen = ok && s >= kNegInf;
          const unsigned m0 = __ballot_sync(kFull, seen && row < br);
          const unsigned m1 = __ballot_sync(kFull, seen && row >= br && row < 2 * br);
          int* first = a.counter + 2 * gridDim.y + (blockIdx.y * kQT + warp) * 2;
          if (lane == 0 && m0) atomicMax(first, br - (vh + __ffs(m0) - 1));
          if (lane == 0 && m1) atomicMax(first + 1, 2 * br - (vh + __ffs(m1) - 1));
        }
      }
      if constexpr (kList == kListWarp) {
        // entry i in lane i: a row that beats entry k - 1 goes in at once,
        // the entries below it moving up a lane
        unsigned pending = __ballot_sync(kFull, ok && better(s, row, thr_s, thr_i));
        while (pending) {
          const int src = __ffs(pending) - 1;
          const float ss = __shfl_sync(kFull, s, src);
          const int rr = __shfl_sync(kFull, row, src);
          const int at = __popc(__ballot_sync(kFull, lane < k && better(reg_s, reg_i, ss, rr)));
          const float up_s = __shfl_up_sync(kFull, reg_s, 1);
          const int up_i = __shfl_up_sync(kFull, reg_i, 1);
          if (lane == at) {
            reg_s = ss;
            reg_i = rr;
          } else if (lane > at) {
            reg_s = up_s;
            reg_i = up_i;
          }
          thr_s = __shfl_sync(kFull, reg_s, k - 1);
          thr_i = __shfl_sync(kFull, reg_i, k - 1);
          pending &= pending - 1;
          // entry k-1 moved: drop the candidates that no longer beat it
          pending &= __ballot_sync(kFull, better(s, row, thr_s, thr_i));
        }
      } else {
        // the rows that beat entry k - 1 join the buffer
        n_buf = buffer_append(buf_s, buf_i, n_buf, ok && better(s, row, thr_s, thr_i), s, row,
                              lane);
      }
    }
  }

  if constexpr (kList != kListWarp)
    while (selects && n_buf > 0) n_buf = flush();
  // this CTA's lists as candidates (kListDevice: already there)
  if constexpr (kList == kListWarp) {
    if (selects && lane < k) {
      a.cand_s[slot_out + lane] = reg_s;
      a.cand_i[slot_out + lane] = reg_i;
    }
  } else if constexpr (kRegList > 0) {
    if (selects)
#pragma unroll
      for (int r = 0; r < kRegList; ++r)
        if (32 * r + lane < k) {
          a.cand_s[slot_out + 32 * r + lane] = wl_s[r];
          a.cand_i[slot_out + 32 * r + lane] = wl_i[r];
        }
  } else if constexpr (kList != kListDevice) {
    if (selects)
      for (int t = lane; t < k; t += 32) {
        a.cand_s[slot_out + t] = my_s[t];
        a.cand_i[slot_out + t] = my_i[t];
      }
  }
  int* first_cols = a.counter + 2 * gridDim.y + blockIdx.y * kFirstCols;
  if constexpr (!kProbe)
    if (lane == 0 && last_live >= 0 && !identity) atomicMax(first_cols, last_live + 1);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_cta = atomicAdd(a.counter + blockIdx.y, 1) == n_cta - 1;
  __syncthreads();
  if (!last_cta) return;
  __threadfence();

  // The merge: warp j merges query q0 + j's n_cta sorted lists into the
  // top k in (score desc, virtual row asc) (the lists hold distinct virtual
  // rows: no ties between lists). Per warp in shared memory: the windows'
  // scores [n_cta, W] and rows [n_cta, W], each part 16-byte aligned (the
  // lists counted up to a multiple of 4; W is a power of two from 4). Lane
  // L offers lists L + 32 m.
  const int W = p.window, n_pad = (n_cta + 3) & ~3;
  // DMA over a probe plan: the tile's last live v (7. above), loaded beside
  // the windows (the identity plan's fill is row 0: no load)
  const int last_v = !kProbe && !identity ? __ldcg(first_cols) : 0;
  const size_t per_warp = (size_t)n_pad * 2 * W;
  float* win_all = reinterpret_cast<float*>(smem + p.barriers());
  const float* tile_s = a.cand_s + (size_t)blockIdx.y * n_cta * kQT * k_pad;
  const int* tile_i = a.cand_i + (size_t)blockIdx.y * n_cta * kQT * k_pad;
  // every window's first W entries, 4 at a time: e = (l * kQT + j) << w4 | c
  const int w4 = W == 8, n_vec = n_cta * kQT << w4;
  for (int base = threadIdx.x; base < n_vec; base += kThreads * kMergeBatch) {
    float4 vs[kMergeBatch];
    int4 vi[kMergeBatch];
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      const int e = base + u * kThreads;
      const int lj = e >> w4, c = e & w4;
      if (e < n_vec && lj % kQT < q_valid && 4 * c < k) {
        const size_t off = (size_t)lj * k_pad + 4 * c;
        vs[u] = __ldcg(reinterpret_cast<const float4*>(tile_s + off));
        vi[u] = __ldcg(reinterpret_cast<const int4*>(tile_i + off));
      }
    }
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      const int e = base + u * kThreads;
      const int lj = e >> w4, c = e & w4;
      if (e < n_vec && lj % kQT < q_valid && 4 * c < k) {
        float* wj = win_all + (lj % kQT) * per_warp;
        const int l = lj / kQT;
        reinterpret_cast<float4*>(wj)[(l * W) / 4 + c] = vs[u];
        reinterpret_cast<int4*>(wj + n_pad * W)[(l * W) / 4 + c] = vi[u];
      }
    }
  }
  __syncthreads();
  if (!selects) return;
  float* win_s = win_all + warp * per_warp;
  int* win_i = reinterpret_cast<int*>(win_s + n_pad * W);
  const int qi = q0 + warp;
  int n_out = k;  // the slots the live entries fill
  // DMA: the fill's entries lie before the last block with a live row
  // (v < fill_end), the first in the merged order (-1: none)
  int fill_v = -1;
  const int fill_end = last_v > 0 ? (last_v - 1) / br * br : 0;
  // The merged list (6. above): up to k = 128 in registers, entry 32 r +
  // lane in (ls[r], li[r]) (k <= 32 in one), up to 1024 in shared memory
  // past the windows, above in this query's output row; it holds virtual
  // rows until the outputs are written. A list whose entry does not beat
  // the merged list's entry k - 1 offers no more: its later entries are
  // worse, and entry k - 1 only improves. (1) The windows a position at a
  // time, list by list; (2) the lists still offering past their windows,
  // one at a time, 32 entries at a time, the next list's first 32 loading
  // while one is offered. Offered entries that beat entry k - 1 wait in the
  // warp's buffer, and go in 32 at a time (flush_buffer, flush_memory).
  constexpr int kMergeRegs = kList == kListWarp ? 1 : kRegList;  // 0: in memory
  float ls[kMergeRegs > 0 ? kMergeRegs : 1];
  int li[kMergeRegs > 0 ? kMergeRegs : 1];
#pragma unroll
  for (int r = 0; r < (kMergeRegs > 0 ? kMergeRegs : 1); ++r) {
    ls[r] = kNegInf;
    li[r] = 0;
  }
  float* ms = reinterpret_cast<float*>(smem + p.merge_list_off(n_cta)) + warp * 2 * k;
  int* mi = reinterpret_cast<int*>(ms + k);
  if (p.list_class() == kListDevice) {
    ms = a.out_s + (size_t)qi * k;
    mi = a.out_i + (size_t)qi * k;
  }
  if constexpr (kMergeRegs == 0) {
    for (int t = lane; t < k; t += 32) {
      ms[t] = kNegInf;
      mi[t] = 0;
    }
  }
  float* mb_s = reinterpret_cast<float*>(smem + p.merge_buf_off(n_cta)) + warp * 2 * kBuf<T>;
  int* mb_i = reinterpret_cast<int*>(mb_s + kBuf<T>);
  int m_buf = 0;
  float ts = kNegInf;  // entry k - 1
  int ti = 0;
  auto offer = [&](bool in, float cs, int ci) {
    m_buf = buffer_append(mb_s, mb_i, m_buf, in, cs, ci, lane);
    if (m_buf >= 32) {
      if constexpr (kMergeRegs > 0)
        m_buf = flush_buffer(mb_s, mb_i, m_buf, ls, li, k, ts, ti, lane);
      else
        m_buf = flush_memory(mb_s, mb_i, m_buf, ms, mi, k, ts, ti, lane);
    }
  };
  auto drain = [&]() {
    while (m_buf > 0) {
      if constexpr (kMergeRegs > 0)
        m_buf = flush_buffer(mb_s, mb_i, m_buf, ls, li, k, ts, ti, lane);
      else
        m_buf = flush_memory(mb_s, mb_i, m_buf, ms, mi, k, ts, ti, lane);
    }
  };
  unsigned open = 0;  // bit m: list lane + 32 m still offers
  for (int m = 0; m < kListsPerLane; ++m)
    if (lane + 32 * m < n_cta) open |= 1u << m;
  const int wk = min(W, k);
  // (a position ends the pass once every list has stopped offering)
#pragma unroll 1
  for (int e = 0; e < wk && __any_sync(kFull, open != 0); ++e) {
#pragma unroll 1
    for (int m = 0; m < kListsPerLane; ++m) {
      if (!__any_sync(kFull, open >> m & 1)) continue;
      float cs = kNegInf;
      int ci = 0;
      bool in = false;
      if (open >> m & 1) {
        const int l = lane + 32 * m;
        cs = win_s[l * W + e];
        ci = win_i[l * W + e];
        in = better(cs, ci, ts, ti);
        if (!in) open &= ~(1u << m);
      }
      offer(in, cs, ci);
    }
  }
  drain();
  // a list offered its window against an older entry k - 1: it goes on
  // only if its last window entry beats the merged list's entry k - 1 now
  for (int m = 0; m < kListsPerLane; ++m) {
    const int l = lane + 32 * m;
    if ((open >> m & 1) && !better(win_s[l * W + wk - 1], win_i[l * W + wk - 1], ts, ti))
      open &= ~(1u << m);
  }
  // (2): the open lists in turn (-1: none left)
  int m_next = 0;
  unsigned pend = 0;
  auto next_list = [&]() {
    while (!pend && m_next < kListsPerLane) {
      pend = __ballot_sync(kFull, (open >> m_next & 1) && wk < k);
      if (!pend) ++m_next;
    }
    if (!pend) return -1;
    const int l = __ffs(pend) - 1 + 32 * m_next;
    pend &= pend - 1;
    if (!pend) ++m_next;
    return l;
  };
  // entry `base` + lane of list l, or none
  auto entry_of = [&](int l, int base, float& cs, int& ci) {
    cs = kNegInf;
    ci = 0;
    if (l >= 0 && base + lane < k) {
      const size_t off = ((size_t)l * kQT + warp) * k_pad + base + lane;
      cs = __ldcg(tile_s + off);
      ci = __ldcg(tile_i + off);
    }
  };
  int l = next_list();
  float cs, ns;
  int ci, ni;
  entry_of(l, wk, cs, ci);
  int nl = next_list();  // the next list, its first 32 loading while this one is offered
  entry_of(nl, wk, ns, ni);
#pragma unroll 1
  for (int base = wk; l >= 0;) {
    const bool in = base + lane < k && better(cs, ci, ts, ti);
    const unsigned got = __ballot_sync(kFull, in);
    offer(in, cs, ci);
    base += 32;
    // a sorted run: once an entry falls short, so do the rest
    if (got != kFull || base >= k) {
      l = nl;
      cs = ns;
      ci = ni;
      base = wk;
      nl = next_list();
      entry_of(nl, wk, ns, ni);
    } else {
      entry_of(l, base, cs, ci);  // this list's next 32
    }
  }
  drain();
  // the live entries, a prefix of slots 0 .. k - 1 (the fill or the tail
  // below), and the DMA fill's first entry
  int live = 0;
  if constexpr (kMergeRegs > 0) {
#pragma unroll
    for (int r = 0; r < kMergeRegs; ++r) {
      live += __popc(__ballot_sync(kFull, 32 * r + lane < k && ls[r] > kNegInf));
      if constexpr (!kProbe) {
        const unsigned m = __ballot_sync(kFull, 32 * r + lane < k && ls[r] > kNegInf &&
                                                    li[r] < fill_end);
        const int first = __shfl_sync(kFull, li[r], m ? __ffs(m) - 1 : 0);
        if (fill_v < 0 && m) fill_v = first;
      }
    }
    n_out = live;
#pragma unroll
    for (int r = 0; r < kMergeRegs; ++r) {
      const int e = 32 * r + lane;
      if (e < n_out) {
        a.out_s[(size_t)qi * k + e] = ls[r];
        a.out_i[(size_t)qi * k + e] = stored_row(a.src, li[r]);
      }
    }
  } else {
    __syncwarp();
    for (int base = 0; base < k; base += 32) {
      const int e = base + lane;
      const float s = e < k ? ms[e] : kNegInf;
      const int v = e < k ? mi[e] : 0;
      const unsigned m = __ballot_sync(kFull, s > kNegInf);
      live += __popc(m);
      if constexpr (!kProbe) {
        const unsigned f = __ballot_sync(kFull, s > kNegInf && v < fill_end);
        const int first = __shfl_sync(kFull, v, f ? __ffs(f) - 1 : 0);
        if (fill_v < 0 && f) fill_v = first;
      }
      if (e < k && s > kNegInf) {
        a.out_s[(size_t)qi * k + e] = s;
        a.out_i[(size_t)qi * k + e] = stored_row(a.src, v);
      }
      if (m != kFull) break;
    }
    n_out = live;
  }
  if constexpr (!kProbe) {
    // the fill (contract above); the identity plan's pruned fill is row 0
    const int fill = fill_v >= 0 && !identity ? stored_row(a.src, fill_v) : 0;
    for (int t = n_out + lane; t < k; t += 32) {
      a.out_s[(size_t)qi * k + t] = kNegInf;
      a.out_i[(size_t)qi * k + t] = fill;
    }
  } else {
    if (n_out < k) {
      // the tail (contract above): ids * block_rows in 32 bits, as the TPU
      // kernel's fill computes it
      const unsigned ubr = (unsigned)br;
      const int* first = first_cols + warp * 2;
      const int e0 = nv > 0 ? __ldcg(first) : 0;
      const int fill = (int)((unsigned)block_id(a.src, 0) * ubr + (e0 ? br - e0 : 0));
      float last_s = kNegInf;
      int last_i = fill;
      if (n_out == 0 && nv > 0 && e0 == 0) {  // no live row; position 0 all -inf
        if (k % 128) {
          last_i = 0;
        } else if (a.src.max_blocks == 1) {
          last_s = __uint_as_float(0xff800000u);  // -inf
        } else {
          const int e1 = __ldcg(first + 1);
          last_i = (int)((unsigned)block_id(a.src, 1) * ubr + (e1 ? br - e1 : 0));
        }
      }
      for (int t = n_out + lane; t < k; t += 32) {
        a.out_s[(size_t)qi * k + t] = t == k - 1 ? last_s : kNegInf;
        a.out_i[(size_t)qi * k + t] = t == k - 1 ? last_i : fill;
      }
    }
  }
}

template <class T, bool kProbe>
const void* kernel_for(const Plan<T>& p) {
  if constexpr (!T::kScaled)
    if (p.wide) return reinterpret_cast<const void*>(ivf_tma_kernel<T, kListDevice, kProbe, true>);
  if (p.dev_lists) return reinterpret_cast<const void*>(ivf_tma_kernel<T, kListDevice, kProbe>);
  switch (tma_list_kind(p.k)) {
    case kListWarp:
      return reinterpret_cast<const void*>(ivf_tma_kernel<T, kListWarp, kProbe>);
    case kListWarp2:
      return reinterpret_cast<const void*>(ivf_tma_kernel<T, kListWarp2, kProbe>);
    case kListWarp4:
      return reinterpret_cast<const void*>(ivf_tma_kernel<T, kListWarp4, kProbe>);
    case kListShared:
      return reinterpret_cast<const void*>(ivf_tma_kernel<T, kListShared, kProbe>);
    default:
      return reinterpret_cast<const void*>(ivf_tma_kernel<T, kListDevice, kProbe>);
  }
}

// the most CTAs a launch takes per query tile: two per SM (the merge's
// lanes hold up to 32 kListsPerLane lists)
inline int max_ctas() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return min(2 * sms, 32 * kListsPerLane);
}

// CTAs that fit on one SM for width d and top-k k (at most 2, the
// register cap), 0 if one does not fit, or minus a CUDA error code.
template <class T, bool kProbe>
int ctas_per_sm(int d, int k) {
  if (!T::width_ok(d) || k < 1) return -(int)cudaErrorInvalidValue;
  const Plan<T> p = make_plan<T>(d, k, max_ctas());
  if (p.rows == 0) return 0;
  const void* kern = kernel_for<T, kProbe>(p);
  const int smem = (int)p.smem(max_ctas());
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  return blocks;
}

// The plan for width d and top-k k as {rows, stages, lists in device
// memory, wide}: rows 0 where none fits; a wide plan takes bf16 queries.
template <class T>
int plan_of(int d, int k, int* out) {
  if (!T::width_ok(d) || k < 1) return (int)cudaErrorInvalidValue;
  const Plan<T> p = make_plan<T>(d, k, max_ctas());
  out[0] = p.rows;
  out[1] = p.stages;
  out[2] = p.dev_lists;
  out[3] = p.wide;
  return 0;
}

// Zero the tiles' counters and launch the scan-and-merge on `stream`.
// Returns cudaGetLastError() (0 = ok), cudaErrorInvalidValue for shapes
// outside the contract (a wide plan with f32 queries among them) or
// cudaErrorInvalidConfiguration where no plan fits one CTA's shared
// memory. The counters: int32 [2, tiles], then [tiles, kFirstCols]. The
// identity plan (ids and n_valid null) takes max_blocks = n / block_rows.
template <class T, bool kProbe>
int launch(const Args& a, int n, int n_cta, void* stream) {
  const int br = a.src.block_rows;
  if (a.q < 1 || a.q > kMaxQ || a.k < 1 || !T::width_ok(a.d) || n_cta < 1 ||
      n_cta > max_ctas() || br < 1 || n % br || a.src.max_blocks < 1 ||
      (!a.src.ids != !a.src.n_valid) || (!a.src.ids && a.src.max_blocks != n / br) ||
      (a.queries_bf16 && T::kScaled))
    return (int)cudaErrorInvalidValue;
  const Plan<T> p = make_plan<T>(a.d, a.k, max_ctas());
  if (p.rows == 0) return (int)cudaErrorInvalidConfiguration;
  if (p.wide && !a.queries_bf16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const void* kern = kernel_for<T, kProbe>(p);
  const int smem = (int)p.smem(max_ctas());
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.q + kQT - 1) / kQT;
  err = cudaMemsetAsync(a.counter, 0, sizeof(int) * (2 + kFirstCols) * tiles, st);
  if (err != cudaSuccess) return (int)err;
  // the widest merge window (4 or 8 entries; no wider than k needs)
  // that fits in the shared memory the launch takes anyway
  Plan<T> run = p;
  while (run.window < kWindowMax && run.window < a.k) {
    run.window *= 2;
    if (run.merge_bytes(n_cta) > (size_t)smem) {
      run.window /= 2;
      break;
    }
  }
  Args args = a;
  void* params[] = {&args, &run};
  err = cudaLaunchKernel(kern, dim3(n_cta, tiles), dim3(kThreads), params, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace ivf_tma

// The IVF source defines its entries with this macro:
// <name>_launch, <name>_ctas_per_sm and <name>_plan; PROBE selects the
// per-block contract, IDENTITY the identity plan (ids and n_valid ignored,
// max_blocks n / block_rows: the same kernels, no plan read).
#define IVF_TMA_C_INTERFACE(NAME, T, PROBE, IDENTITY)                                         \
  extern "C" {                                                                                \
  int NAME##_ctas_per_sm(int d, int k) { return ivf_tma::ctas_per_sm<T, PROBE>(d, k); }      \
  int NAME##_plan(int d, int k, int* out) { return ivf_tma::plan_of<T>(d, k, out); }         \
  int NAME##_launch(const void* queries, int queries_bf16, const void* x, const void* xscale, \
                    const void* bias, const void* ids, const void* n_valid, void* cand_s,     \
                    void* cand_i, void* counter, void* out_s, void* out_i, int q, int n, int d, \
                    int k, int max_blocks, int block_rows, int n_cta, void* stream) {         \
    ivf_tma::Args a{queries,                                                                  \
                    x,                                                                        \
                    static_cast<const float*>(xscale),                                        \
                    static_cast<const float*>(bias),                                          \
                    static_cast<float*>(cand_s),                                              \
                    static_cast<int*>(cand_i),                                                \
                    static_cast<int*>(counter),                                               \
                    static_cast<float*>(out_s),                                               \
                    static_cast<int*>(out_i),                                                 \
                    RowSource{IDENTITY ? nullptr : static_cast<const int*>(ids),              \
                              IDENTITY ? nullptr : static_cast<const int*>(n_valid),          \
                              max_blocks, block_rows},                                        \
                    q,                                                                        \
                    d,                                                                        \
                    k,                                                                        \
                    queries_bf16};                                                            \
    return ivf_tma::launch<T, PROBE>(a, n, n_cta, stream);                                    \
  }                                                                                           \
  }
