// Segment-sum kernels for Hopper (sm_90a), in plain fp32 CUDA C++.
//
// Replaces, in flink_ml_tpu/ops/pallas_kernels.py:
//   segment_tiles_kernel    <- _segreduce_kernel (:332), pallas_call at :359
//   segment_combine_kernel  <- its accumulation into out_ref across the
//                              sequential grid steps
// segment_ranges_kernel plans the other two; segment_reduce_sum below
// launches all three on the caller's stream, so a call is one C entry.
//
// Output: out[s][j] = sum of values[i][j] over the rows i with ids[i] == s,
// for s in [0, u) and j in [0, c); rows whose id lies outside [0, u) (the -1
// padding included) add nothing, as jax.ops.segment_sum drops them.
//
// What bounds it on an H100: device-memory bytes. FTRL's sparse path calls
// it twice a batch at n = 1,048,576 stored values: the per-row dots (c = 1,
// u = 131,072 rows, ids ascending, then id-0 padding) must read 8.4 MB and
// write 0.5 MB, about 0.0027 ms at 3.35 TB/s; the per-coordinate sums (c =
// 2, u = 100) 12.6 MB, about 0.004 ms. The Pallas kernel turns the scatter
// into a one-hot matmul on the MXU, u times the work; here the scatter stays
// a scatter, without atomics, so that reruns give identical bits.
//
// The segment domain is cut into tiles of ut segments and the value columns
// into groups of cg columns (ut * cg <= kTileFloats), so that one warp's
// (ut, cg) accumulator fits shared memory; the rows are cut into chunks of
// rows_per_chunk (at most kMaxChunks chunks). Three stages:
//
// - segment_ranges_kernel (only when there is more than one tile): the
//   lowest and highest in-range id of each chunk, and its runs (rows whose
//   id differs from the row before), one read of the ids. A chunk "meets" a
//   tile when its range overlaps the tile's segments. With one tile every
//   chunk meets it and this stage is skipped.
// - segment_tiles_kernel, block (tile-group tg, slot q): the m chunks that
//   meet tile t are cut, in chunk order, into q_t = min(m, slots) items of
//   contiguous rank; block q takes item q, or returns at once when q >= q_t.
//   So a chunk is read once per tile it meets, not once per tile: with
//   ascending ids a chunk meets one or two tiles, and every item is one or
//   a few chunks, which spreads the work of a narrow domain over the card.
//   A random wide domain meets every tile from every chunk and keeps the
//   earlier cost: one pass over the ids per tile, items of many chunks.
//   Each warp owns a private (ut, cg) accumulator in shared memory; of it,
//   only the item's id range [a, e) (the union of its chunks' ranges, within
//   the tile) is zeroed, filled and written out. The item's runs of
//   neighbouring chunks are split into one contiguous share per warp; a
//   warp takes 32 rows at a time (loading the ids of kSteps steps at once).
//   Lanes whose ids fall in the tile add into the accumulator by groups of
//   equal id (__match_any_sync), one lane of a group writing its sum, so no
//   two lanes write one address. Where the item's chunks hold runs of
//   kScanRunRows rows or more on average (ascending ids, padding), a step
//   whose lanes hold few runs first sums each run by a segmented scan of
//   shuffles, and the group adds its runs' ends; else the group's lowest
//   lane adds its values in lane order. (The scan's own checks cost a
//   random wide domain a fifth of its time, so items of short runs, and
//   one-tile calls, which have no run counts, skip them.) The block adds its warps' accumulators in warp order
//   into slot (tg, q) of `partials` for [a, e) only and, with more than one
//   tile, records (a, e) in `items` and q_t in `counts`.
// - segment_combine_kernel, block (tg, element tile): output element (s, j)
//   of tile-group tg is the sum, over the items q < q_t whose range holds s,
//   of slot q; the items are cut into at most 32 contiguous slices added in
//   order, then the slices in order (with one tile every item covers it
//   all, and no range is read). Every output element is written, so
//   nothing is zeroed in device memory; no slot outside an item's range is
//   written or read.
//
// Every sum is taken in one fixed order, so reruns are bit-identical.
//
// Shared memory of segment_tiles_kernel, in floats: acc [kWarps][ut * cg],
// then scr [kWarps][32].

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileFloats = 4096;  // one warp's accumulator: 16 KB
// 32-row steps whose ids load together: one tile (every row is in it) and
// more tiles (most steps hold no row of the tile, so loads set the pace)
constexpr int kStepsOneTile = 4;
constexpr int kStepsTiles = 8;
constexpr int kPre = 2;            // value columns loaded with them
constexpr int kMaxChunks = 1024;   // row chunks at most
constexpr int kScanRuns = 8;       // runs of a step at most for the scan
constexpr int kScanRunRows = 4;    // mean rows of a run for an item to scan
constexpr int kRangeThreads = 256;
constexpr int kCombThreads = 256;
constexpr int kMaxSlices = 32;
constexpr unsigned kFull = 0xffffffffu;

// range: a chunk's lowest and highest in-range id (x, y) and its runs (z)
__device__ __forceinline__ bool meets(int4 range, int s0, int us) {
  return range.x < s0 + us && range.y >= s0;
}

__global__ void __launch_bounds__(kRangeThreads)
    segment_ranges_kernel(const int* __restrict__ ids, int4* __restrict__ ranges,
                          int64_t n, int u, int64_t rows_per_chunk) {
  __shared__ int lo_w[kRangeThreads / 32], hi_w[kRangeThreads / 32],
      runs_w[kRangeThreads / 32];
  const int64_t r0 = blockIdx.x * rows_per_chunk;
  const int64_t r1 = min(n, r0 + rows_per_chunk);
  int lo = INT_MAX, hi = -1, runs = 0;
  for (int64_t r = r0 + threadIdx.x; r < r1; r += kRangeThreads) {
    const int id = ids[r];
    runs += r == r0 || id != ids[r - 1];
    if (id >= 0 && id < u) {
      lo = min(lo, id);
      hi = max(hi, id);
    }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  runs = __reduce_add_sync(kFull, runs);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    lo_w[warp] = lo;
    hi_w[warp] = hi;
    runs_w[warp] = runs;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kRangeThreads / 32; ++w) {
      lo = min(lo, lo_w[w]);
      hi = max(hi, hi_w[w]);
      runs += runs_w[w];
    }
    ranges[blockIdx.x] = make_int4(lo, hi, runs, 0);
  }
}

// One warp adds column j of one 32-row step into its accumulator: lane
// value v, lane segment s (-1: not in the tile), its group of equal s, and
// (scan) the step's run heads.
__device__ __forceinline__ void add_step(float v, int s, unsigned group,
                                         bool scan, unsigned heads,
                                         float* wacc, float* wscr, int cg,
                                         int j) {
  const int lane = threadIdx.x & 31;
  const bool leader = s >= 0 && lane == __ffs(group) - 1;
  unsigned parts = group;  // the lanes whose values the leader adds
  if (scan && __popc(heads) <= kScanRuns) {  // warp-uniform: long runs
    const unsigned below = heads & (kFull >> (31 - lane));  // lanes <= me
    const int run0 = 31 - __clz(below);
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {  // segmented inclusive scan
      const float o = __shfl_up_sync(kFull, v, d);
      if (lane - d >= run0) v += o;
    }
    parts &= (heads >> 1) | 0x80000000u;  // the last lane of each run
  }
  wscr[lane] = v;
  __syncwarp();
  if (leader) {  // the group's values or runs, in lane order
    float sum = 0.f;
    for (unsigned m = parts; m; m &= m - 1) sum += wscr[__ffs(m) - 1];
    wacc[s * cg + j] += sum;
  }
  __syncwarp();
}

// One warp adds rows [w0, w1) into its accumulator wacc: the rows whose id
// lies in [s0, s0 + us), columns [j0, j0 + cs) of c. The ids of kSteps
// steps load together, then the first kPre columns of their in-tile rows,
// so that a step's value loads do not wait on the step before. scan
// (block-uniform): runs of equal ids are summed by segmented scans where a
// step holds few of them.
template <int kSteps>
__device__ __forceinline__ void accumulate_rows(
    const float* __restrict__ values, const int* __restrict__ ids,
    float* wacc, float* wscr, int64_t w0, int64_t w1, int c, int cg, int s0,
    int us, int j0, int cs, bool scan) {
  const int lane = threadIdx.x & 31;
  for (int64_t r0 = w0; r0 < w1; r0 += 32 * kSteps) {
    int sv[kSteps];
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const int64_t r = r0 + 32 * q + lane;
      sv[q] = (r < w1) ? ids[r] : -1;
    }
    float pv[kSteps][kPre];
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const int64_t r = r0 + 32 * q + lane;
      // this lane's segment within the tile, or -1
      sv[q] = (sv[q] >= s0 && sv[q] < s0 + us) ? sv[q] - s0 : -1;
#pragma unroll
      for (int j = 0; j < kPre; ++j)
        pv[q][j] = (sv[q] >= 0 && j < cs) ? values[r * c + j0 + j] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
      const int s = sv[q];
      if (__ballot_sync(kFull, s >= 0) == 0) continue;  // warp-uniform
      const unsigned group = __match_any_sync(kFull, s);
      unsigned heads = 0;  // runs of equal s among neighbouring lanes
      if (scan) {
        const int prev = __shfl_up_sync(kFull, s, 1);
        heads = __ballot_sync(kFull, lane == 0 || prev != s);
      }
#pragma unroll
      for (int j = 0; j < kPre; ++j)
        if (j < cs)
          add_step(pv[q][j], s, group, scan, heads, wacc, wscr, cg, j);
      const int64_t r = r0 + 32 * q + lane;
      for (int j = kPre; j < cs; ++j)
        add_step((s >= 0) ? values[r * c + j0 + j] : 0.f, s, group, scan,
                 heads, wacc, wscr, cg, j);
    }
  }
}

// kOneTile: the domain is one tile, which every chunk meets (no ranges).
template <bool kOneTile, int kSteps>
__global__ void __launch_bounds__(kThreads)
    segment_tiles_kernel(const float* __restrict__ values,
                         const int* __restrict__ ids,
                         const int4* __restrict__ ranges,
                         float* __restrict__ partials, int2* __restrict__ items,
                         int* __restrict__ counts, int64_t n, int u, int c,
                         int ut, int cg, int groups, int64_t rows_per_chunk,
                         int chunks, int slots) {
  extern __shared__ __align__(16) float acc[];  // then the scratch
  __shared__ int warp_counts[kWarps], lo_w[kWarps], hi_w[kWarps];
  __shared__ int64_t runs_w[kWarps], rows_w[kWarps];
  __shared__ int first_chunk, last_chunk;
  const int width = ut * cg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t tg = blockIdx.x;
  const int q = blockIdx.y;
  const int s0 = (int)(tg / groups) * ut, j0 = (int)(tg % groups) * cg;
  const int us = min(ut, u - s0);  // segments of this tile
  const int cs = min(cg, c - j0);  // columns of this group

  // the item: chunks [first, last] that meet the tile, and its range [a, e)
  int first, last, a = 0, e = us;
  bool scan = false;
  if (kOneTile) {  // every item covers the tile: nothing to record
    const int qt = min(chunks, slots);
    if (q >= qt) return;
    first = (int)((int64_t)q * chunks / qt);
    last = (int)((int64_t)(q + 1) * chunks / qt) - 1;
  } else {
    // this thread's stripe of chunks, counted; ranks by a block scan
    const int stripe = (chunks + kThreads - 1) / kThreads;
    const int b0 = min(chunks, threadIdx.x * stripe);
    const int b1 = min(chunks, b0 + stripe);
    int mine = 0;
    for (int b = b0; b < b1; ++b) mine += meets(ranges[b], s0, us);
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int o = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) warp_counts[warp] = incl;
    __syncthreads();
    int rank = incl - mine, m = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      rank += w < warp ? warp_counts[w] : 0;
      m += warp_counts[w];
    }
    const int qt = min(m, slots);
    if (q == 0 && threadIdx.x == 0) counts[tg] = qt;
    if (q >= qt) return;  // block-uniform
    const int r0 = (int)((int64_t)q * m / qt);
    const int r1 = (int)((int64_t)(q + 1) * m / qt);
    int lo = INT_MAX, hi = -1;
    int64_t runs = 0, rows = 0;
    for (int b = b0; b < b1; ++b) {
      const int4 rg = ranges[b];
      if (!meets(rg, s0, us)) continue;
      if (rank == r0) first_chunk = b;
      if (rank == r1 - 1) last_chunk = b;
      if (rank >= r0 && rank < r1) {
        lo = min(lo, rg.x);
        hi = max(hi, rg.y);
        runs += rg.z;
        rows += min(n, (b + 1) * rows_per_chunk) - b * rows_per_chunk;
      }
      ++rank;
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
#pragma unroll
    for (int d = 16; d > 0; d /= 2) {
      runs += __shfl_xor_sync(kFull, runs, d);
      rows += __shfl_xor_sync(kFull, rows, d);
    }
    if (lane == 0) {
      lo_w[warp] = lo;
      hi_w[warp] = hi;
      runs_w[warp] = runs;
      rows_w[warp] = rows;
    }
    __syncthreads();
    runs = rows = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      lo = min(lo, lo_w[w]);
      hi = max(hi, hi_w[w]);
      runs += runs_w[w];
      rows += rows_w[w];
    }
    scan = kScanRunRows * runs <= rows;
    first = first_chunk;
    last = last_chunk;
    a = max(lo, s0) - s0;
    e = min(hi + 1, s0 + us) - s0;
  }

  float* wacc = acc + warp * width;
  float* wscr = acc + kWarps * width + warp * 32;
  for (int i = a * cg + lane; i < e * cg; i += 32) wacc[i] = 0.f;
  __syncwarp();

  // the item's chunks, 32 at a time, as runs of neighbouring chunks; each
  // run's rows in one contiguous share per warp
  for (int base = first; base <= last; base += 32) {
    const int b = base + lane;
    const bool f = b <= last && (kOneTile || meets(ranges[b], s0, us));
    unsigned mask = __ballot_sync(kFull, f);
    while (mask) {
      const int start = __ffs(mask) - 1;
      const unsigned rest = ~(mask >> start);
      const int len = rest == 0 ? 32 - start : __ffs(rest) - 1;
      mask &= ~((len == 32 ? kFull : ((1u << len) - 1)) << start);
      const int64_t lo_r = (int64_t)(base + start) * rows_per_chunk;
      const int64_t hi_r = min(n, (int64_t)(base + start + len) * rows_per_chunk);
      const int64_t share = (hi_r - lo_r + kWarps - 1) / kWarps;
      const int64_t w0 = min(hi_r, lo_r + warp * share);
      accumulate_rows<kSteps>(values, ids, wacc, wscr, w0,
                              min(hi_r, w0 + share), c, cg, s0, us, j0, cs,
                              scan);
    }
  }
  __syncthreads();

  // the item's slot: its warps' accumulators added in warp order, [a, e)
  float* dst = partials + (tg * slots + q) * (int64_t)width;
  for (int i = a * cg + threadIdx.x; i < e * cg; i += kThreads) {
    if (i % cg >= cs) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += acc[w * width + i];
    dst[i] = sum;
  }
  if (!kOneTile && threadIdx.x == 0) items[tg * slots + q] = make_int2(a, e);
}

// uniform > 0: every tile-group has that many items, each over the whole
// tile (one tile: no ranges), and neither counts nor items are read.
__global__ void __launch_bounds__(kCombThreads)
    segment_combine_kernel(const float* __restrict__ partials,
                           const int2* __restrict__ items,
                           const int* __restrict__ counts,
                           float* __restrict__ out, int u, int c, int ut,
                           int cg, int groups, int slots, int slices,
                           int uniform) {
  __shared__ int2 rng[kMaxChunks];
  __shared__ float sums[kCombThreads];
  const int width = ut * cg;
  const int64_t tg = blockIdx.x;
  const int qt = uniform > 0 ? uniform : counts[tg];
  if (uniform == 0)
    for (int i = threadIdx.x; i < qt; i += kCombThreads)
      rng[i] = items[tg * slots + i];
  __syncthreads();

  const int cols = kCombThreads / slices;
  const int col = threadIdx.x % cols, j = threadIdx.x / cols;
  const int i = blockIdx.y * cols + col;  // element of the tile's slab
  const int s = i / cg, jj = i - s * cg;
  const int s0 = (int)(tg / groups) * ut, j0 = (int)(tg % groups) * cg;
  const bool valid = s < min(ut, u - s0) && jj < min(cg, c - j0);
  const int per = (qt + slices - 1) / slices;  // items of a slice, <= 32
  const int q0 = min(qt, j * per), q1 = min(qt, q0 + per);
  const float* p = partials + tg * slots * (int64_t)width + i;
  float v[32];  // the slice's loads, all in flight at once
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int q = q0 + k;
    bool take = valid && q < q1;
    if (take && uniform == 0) take = rng[q].x <= s && s < rng[q].y;
    v[k] = take ? p[(int64_t)q * width] : 0.f;
  }
  float sum = 0.f;  // adding the zeros past the slice changes no bit
#pragma unroll
  for (int k = 0; k < 32; ++k) sum += v[k];
  sums[threadIdx.x] = sum;
  __syncthreads();
  if (j != 0 || !valid) return;
  float t[kMaxSlices];  // the slice sums, read at once, added in order
#pragma unroll
  for (int k = 1; k < kMaxSlices; ++k)
    t[k] = k < slices ? sums[k * cols + col] : 0.f;
#pragma unroll
  for (int k = 1; k < kMaxSlices; ++k) sum += t[k];
  out[(int64_t)(s0 + s) * c + j0 + jj] = sum;
}

int smem_bytes(int ut, int cg) { return 4 * kWarps * (ut * cg + 32); }

// Raises a tile kernel's shared-memory cap to smem when it is below it, so
// that a call in a CUDA graph capture makes no attribute call after the
// first at that size.
template <bool kOneTile, int kSteps>
cudaError_t allow_smem_of(int smem) {
  static int allowed = 48 * 1024;  // the cap without the attribute
  if (smem <= allowed) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      segment_tiles_kernel<kOneTile, kSteps>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

cudaError_t allow_smem(bool one_tile, int smem) {
  return one_tile ? allow_smem_of<true, kStepsOneTile>(smem)
                  : allow_smem_of<false, kStepsTiles>(smem);
}

}  // namespace

extern "C" {

const char* segment_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Resident blocks of the tile kernel on one SM for this many bytes of
// dynamic shared memory: its one-tile instance, or the other.
int segment_blocks_per_sm(int one_tile, int smem, int* out) {
  cudaError_t e = allow_smem(one_tile, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)(one_tile
                   ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         out, segment_tiles_kernel<true, kStepsOneTile>,
                         kThreads, (size_t)smem)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         out, segment_tiles_kernel<false, kStepsTiles>,
                         kThreads, (size_t)smem));
}

// out (u, c) from values (n, c) and ids (n,), all three stages on `stream`.
// Segment tiles are ut segments wide and column groups cg columns wide
// (ut * cg <= kTileFloats, cg = min(c, kTileFloats)); chunk b holds rows
// [b * rows_per_chunk, (b + 1) * rows_per_chunk); each tile-group has
// `slots` item slots. Scratch, written before it is read: partials (tiles *
// groups * slots * ut * cg floats) and meta, ints: the chunks' ranges and
// runs (chunks int4), the items' ranges (tiles * groups * slots int2), then
// the item counts (tiles * groups).
int segment_reduce_sum(const float* values, const int* ids, float* out,
                       float* partials, int* meta, long long n, int u, int c,
                       int ut, int cg, long long rows_per_chunk, int chunks,
                       int slots, void* stream) {
  if (n < 1 || u < 1 || c < 1 || ut < 1 || ut > u || cg < 1 || cg > c ||
      (long long)ut * cg > kTileFloats || rows_per_chunk < 1 || chunks < 1 ||
      chunks > kMaxChunks || (long long)chunks * rows_per_chunk < n ||
      slots < 1 || slots > chunks)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (u + (long long)ut - 1) / ut;
  const long long groups = (c + (long long)cg - 1) / cg;
  if (tiles * groups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(ut, cg);
  cudaError_t e = allow_smem(tiles == 1, smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  int4* ranges = tiles > 1 ? reinterpret_cast<int4*>(meta) : nullptr;
  int2* items = reinterpret_cast<int2*>(meta + 4 * (int64_t)chunks);
  int* counts = meta + 4 * (int64_t)chunks + 2 * tiles * groups * slots;
  if (ranges != nullptr) {
    segment_ranges_kernel<<<chunks, kRangeThreads, 0, st>>>(
        ids, ranges, (int64_t)n, u, (int64_t)rows_per_chunk);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)(tiles * groups), slots);
  if (ranges == nullptr)
    segment_tiles_kernel<true, kStepsOneTile><<<grid, kThreads, smem, st>>>(
        values, ids, ranges, partials, items, counts, (int64_t)n, u, c, ut, cg,
        (int)groups, (int64_t)rows_per_chunk, chunks, slots);
  else
    segment_tiles_kernel<false, kStepsTiles><<<grid, kThreads, smem, st>>>(
        values, ids, ranges, partials, items, counts, (int64_t)n, u, c, ut, cg,
        (int)groups, (int64_t)rows_per_chunk, chunks, slots);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // slices: the fewest (a power of two) that leave 32 items or fewer each
  int slices = 1;
  while (slices < kMaxSlices && (slots + slices - 1) / slices > 32) slices *= 2;
  const int cols = kCombThreads / slices;
  segment_combine_kernel<<<dim3((unsigned)(tiles * groups),
                                (ut * cg + cols - 1) / cols),
                           kCombThreads, 0, st>>>(
      partials, items, counts, out, u, c, ut, cg, (int)groups, slots, slices,
      ranges == nullptr ? min(chunks, slots) : 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
