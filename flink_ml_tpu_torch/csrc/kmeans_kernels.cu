// KMeans kernels for Hopper (sm_90a): nearest-centroid assignment and the
// Lloyd round's weighted partial sums, in plain fp32 CUDA C++.
//
// Replaces, in flink_ml_tpu/ops/pallas_kernels.py:
//   assign_kernel          <- _assign_kernel (:26), pallas_call at :41
//   lloyd_partials_kernel  <- _lloyd_accum_kernel (:132), pallas_call at :165
//   reduce_tile_kernel,    <- the accumulation of _lloyd_accum_kernel into
//   reduce_rows_kernel        out_ref across sequential grid steps (:141-157)
//                             (sgd_kernels.cu keeps its own copy of
//                             reduce_tile_kernel as its second stage)
//
// What bounds them on an H100: device-memory bytes. At the main-path shape
// (1,000,000 x 100 float32, k = 10) each call must read the 400 MB input
// once, about 0.12 ms at 3.35 TB/s, while the 2.2 GFLOP of fp32 FMA it does
// take about 0.03 ms at 67 TFLOP/s. So the design reads every row of x from
// device memory once per call, with coalesced 16-byte loads into a shared
// memory tile, keeps a row's distances in registers, and writes only the
// argmin (assign) or one (k, d+1) partial per block (Lloyd): the (n, k)
// distances and the (n, k) one-hot never exist in device memory.
//
// Determinism, with no atomics: a Lloyd block owns a contiguous range of
// row tiles and adds into its shared-memory accumulator in row order, one
// thread per output column; reduce_tile_kernel (or reduce_rows_kernel)
// then sums the per-block partials in a fixed two-level order. The same
// inputs on the same card give the same bits.
//
// Accumulation by label runs: once a tile's labels are known, each row's
// thread ranks its (label, row) key among the tile's keys (a count over
// the tile, no atomics) and writes its entry (where its label's
// accumulator and its x row lie, and its weight) to that place, so the
// tile's rows stand in label order, ascending rows within a label. Thread
// f then walks that order once: it takes acc[j][f] into a register where
// label j's run begins, adds the run's rows with fmaf(weight, x, acc), and
// stores it where the run ends. Each accumulator sees the same adds in the
// same order as a row-order walk that adds acc[lab[r]][f] += v[r] * x[r][f]
// straight into shared memory, so the bits are the same; but the chain of
// dependent adds runs through a register, not a shared-memory round trip
// per row, and a batch of rows' loads is issued before their adds. Only
// the labels a tile holds are touched, whatever k.
//
// Tile copies: each thread issues kLoadBatch loads of x before it stores
// any of them to shared memory, so that enough bytes are in flight to
// cover device-memory latency at three blocks per SM.
//
// Arithmetic: full fp32 FMA, no TF32 and no tensor cores. The distance rule
// is the Pallas kernel's: d2_j = ||c_j||^2 - 2 x.c_j, first minimum over
// ascending j (strict <), as jnp.argmin and torch.argmin pick it.
//
// Shared memory, in floats, in this order (ops/kernels.py `_layout` sizes
// it and passes rows = blockDim.x, kchunk and the byte count):
//   cT  [d][kchunk]     centroid chunk, transposed; first, so 16-byte aligned
//   csq [kchunk]
//   xs  [rows][d | 1]   x tile; an odd row stride keeps the per-row reads
//                       of the 32 threads of a warp on 32 different banks
//   ent [rows][2]       Lloyd only: in label order, each row's offsets in
//                       acc and xs, (label * (d+1)) << 16 | row * (d | 1),
//                       and its weight; until the tile is ranked, its first
//                       rows ints hold the tile's keys, (label << kRowBits
//                       | row) by row
//   acc [k][d+1]        Lloyd only: the block's [sums | counts]
// Every array before acc starts 16-byte aligned (kchunk is a multiple of
// 16 and rows of 32). Centroids beyond the staged chunk are scored chunk by
// chunk, so any k works; but the x tile, and for Lloyd the whole (k, d+1)
// accumulator, must fit one block's shared memory beside it. These fused
// kernels run where a 128-row tile fits (ops/kernels.py `kmeans_plan`,
// the main path among them); every other shape takes the tiled route.
//
// The tiled route (any k and d; its comment below):
//   assign_tile_kernel     <- _assign_kernel (:26), pallas_call at :41
//   lloyd_label_kernel,    <- _lloyd_accum_kernel (:132), pallas_call at
//   label_sort_kernel,        :165, with its accumulation across grid
//   scan_*_kernel,            steps (:141-157)
//   piece_sums_kernel,
//   piece_combine_kernel
// labels each row by the register-blocked tile engine of tile_engine.cuh
// (the one knn_kernels.cu runs), then, for Lloyd, sorts the row ids by
// label (a stable counting sort) and adds each label's rows in ascending
// row order, in fixed pieces of the sorted rows: no (k, d+1) accumulator in
// shared memory and no (blocks, k, d+1) partials in device memory.

#include <climits>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_engine.cuh"

namespace {

constexpr int KG = 16;  // centroids scored together, in registers
constexpr int kLoadBatch = 16;  // loads of x a thread has in flight
constexpr int kAccBatch = 8;   // rows whose loads an accumulating thread
                               // issues before their adds
constexpr int kRowBits = 10;   // a key's row bits: rows <= 1024
constexpr int kOffBits = 16;   // an ent offset's bits: the accumulator and
                               // the x tile hold fewer than 2^16 floats

__host__ __device__ __forceinline__ int x_stride(int d) { return d | 1; }

// Centroids [j0, j0 + kc) -> cT[f * kchunk + j], csq_s[j]; lanes kc..kchunk
// are zero and never compared.
__device__ void stage_centroids(const float* __restrict__ c,
                                const float* __restrict__ csq, float* cT,
                                float* csq_s, int j0, int kc, int kchunk,
                                int d) {
  for (int i = threadIdx.x; i < kchunk * d; i += blockDim.x) {
    const int j = i / d, f = i - j * d;
    cT[f * kchunk + j] = (j < kc) ? c[(int64_t)(j0 + j) * d + f] : 0.f;
  }
  for (int j = threadIdx.x; j < kchunk; j += blockDim.x)
    csq_s[j] = (j < kc) ? csq[j0 + j] : 0.f;
}

__device__ __forceinline__ void store_x(float* dst, float q) { dst[0] = q; }
__device__ __forceinline__ void store_x(float* dst, float4 q) {
  dst[0] = q.x;
  dst[1] = q.y;
  dst[2] = q.z;
  dst[3] = q.w;
}

// Elements i, i + T, ..., i + (kLoadBatch - 1) T of src (V = float or a
// float4 that stays in one row) -> the x tile: all the loads, then all the
// stores; kAll says every element is below n, else each is checked.
template <bool kAll, typename V>
__device__ __forceinline__ void copy_batch(const V* __restrict__ src,
                                           float* xs, int i, int n, int d) {
  constexpr int kWidth = sizeof(V) / sizeof(float);
  const int T = blockDim.x;
  V q[kLoadBatch];
#pragma unroll
  for (int b = 0; b < kLoadBatch; ++b)
    if (kAll || i + b * T < n) q[b] = src[i + b * T];
#pragma unroll
  for (int b = 0; b < kLoadBatch; ++b)
    if (kAll || i + b * T < n) {
      const int e = kWidth * (i + b * T), r = e / d;
      store_x(xs + r * x_stride(d) + (e - r * d), q[b]);
    }
}

template <typename V>
__device__ __forceinline__ void copy_tile(const V* __restrict__ src,
                                          float* xs, int n, int d) {
  const int T = blockDim.x;
  int i = threadIdx.x;
  for (; i + (kLoadBatch - 1) * T < n; i += kLoadBatch * T)
    copy_batch<true>(src, xs, i, n, d);
  if (i < n) copy_batch<false>(src, xs, i, n, d);
}

// Rows [r0, r0 + rows) of x (row-major, d wide) -> xs[r * x_stride + f];
// each thread issues kLoadBatch loads, then stores them.
__device__ void load_tile(const float* __restrict__ x, float* xs, int64_t r0,
                          int rows, int d, bool vec4) {
  const float* src = x + r0 * d;
  if (vec4)  // d % 4 == 0 and x 16-byte aligned: a float4 stays in one row
    copy_tile(reinterpret_cast<const float4*>(src), xs, rows * d / 4, d);
  else
    copy_tile(src, xs, rows * d, d);
}

// Scores one row (in shared memory) against the staged chunk, keeping the
// first minimum in (best, best_j).
__device__ __forceinline__ void score_chunk(const float* xrow, const float* cT,
                                            const float* csq_s, int kc,
                                            int kchunk, int d, int j0,
                                            float& best, int& best_j) {
  for (int g = 0; g < kc; g += KG) {
    float acc[KG];
#pragma unroll
    for (int q = 0; q < KG; ++q) acc[q] = 0.f;
    const float* cg = cT + g;
    for (int f = 0; f < d; ++f) {
      const float xv = xrow[f];
      const float4* cp = reinterpret_cast<const float4*>(cg + f * kchunk);
#pragma unroll
      for (int q4 = 0; q4 < KG / 4; ++q4) {
        const float4 cc = cp[q4];
        acc[4 * q4 + 0] = fmaf(xv, cc.x, acc[4 * q4 + 0]);
        acc[4 * q4 + 1] = fmaf(xv, cc.y, acc[4 * q4 + 1]);
        acc[4 * q4 + 2] = fmaf(xv, cc.z, acc[4 * q4 + 2]);
        acc[4 * q4 + 3] = fmaf(xv, cc.w, acc[4 * q4 + 3]);
      }
    }
#pragma unroll
    for (int q = 0; q < KG; ++q) {
      const int j = g + q;
      if (j < kc) {
        const float dist = csq_s[j] - 2.0f * acc[q];
        if (dist < best) {
          best = dist;
          best_j = j0 + j;
        }
      }
    }
  }
}

// Nearest centroid of the tile row this thread owns, over all k centroids.
// With one chunk the centroids were staged once, before the tile loop;
// otherwise every chunk is staged here (all threads must call this).
__device__ int nearest(const float* __restrict__ c,
                       const float* __restrict__ csq, float* cT, float* csq_s,
                       const float* xs, int rows, int k, int kchunk, int d) {
  const float* xrow = xs + threadIdx.x * x_stride(d);
  float best = __int_as_float(0x7f800000);  // +inf
  int best_j = 0;
  if (k <= kchunk) {
    __syncthreads();  // the tile is in shared memory
    if ((int)threadIdx.x < rows)
      score_chunk(xrow, cT, csq_s, k, kchunk, d, 0, best, best_j);
    return best_j;
  }
  for (int j0 = 0; j0 < k; j0 += kchunk) {
    const int kc = min(kchunk, k - j0);
    if (j0 > 0) __syncthreads();  // every thread is done with the last chunk
    stage_centroids(c, csq, cT, csq_s, j0, kc, kchunk, d);
    __syncthreads();
    if ((int)threadIdx.x < rows)
      score_chunk(xrow, cT, csq_s, kc, kchunk, d, j0, best, best_j);
  }
  return best_j;
}

__global__ void assign_kernel(const float* __restrict__ x,
                              const float* __restrict__ c,
                              const float* __restrict__ csq,
                              int* __restrict__ out, int64_t n, int k, int d,
                              int kchunk, int vec4) {
  extern __shared__ __align__(16) float smem[];
  float* cT = smem;
  float* csq_s = cT + kchunk * d;
  float* xs = csq_s + kchunk;
  const int T = blockDim.x;
  const int64_t ntiles = (n + T - 1) / T;
  if (k <= kchunk) stage_centroids(c, csq, cT, csq_s, 0, k, kchunk, d);
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t r0 = t * T;
    const int rows = (int)min((int64_t)T, n - r0);
    __syncthreads();  // every thread is done with the last tile
    load_tile(x, xs, r0, rows, d, vec4 != 0);
    const int j = nearest(c, csq, cT, csq_s, xs, rows, k, kchunk, d);
    if ((int)threadIdx.x < rows) out[r0 + threadIdx.x] = j;
  }
}

#ifdef LLOYD_PHASE_CLOCKS
// per thread of block 0: cycles in the barrier before the copy, the copy,
// the barrier after it (a barrier of its own in this build only), scoring,
// the barrier after the labels, the ordering by label and the accumulation
// of all its tiles
constexpr int kPhases = 7;
__device__ long long lloyd_phase_cycles[1024 * kPhases];
#define PHASE_START() long long phase_t_ = clock64()
#define PHASE_END(q)                  \
  do {                                \
    const long long now_ = clock64(); \
    phase_c_[q] += now_ - phase_t_;   \
    phase_t_ = now_;                  \
  } while (0)
#define PHASE_BARRIER() __syncthreads()
#else
#define PHASE_START() \
  do {                \
  } while (0)
#define PHASE_END(q) \
  do {               \
  } while (0)
#define PHASE_BARRIER() \
  do {                  \
  } while (0)
#endif

// The place of this row's key among the tile's keys: the count of smaller
// keys. Keys are (label << kRowBits | row), all different, so the places
// order the rows by label, ascending rows within a label. Four counts, one
// per lane of an int4, keep four short chains of adds in flight.
__device__ __forceinline__ int rank_in_tile(const int* keys, int rows,
                                            int key) {
  const int4* k4 = reinterpret_cast<const int4*>(keys);
  int r0 = 0, r1 = 0, r2 = 0, r3 = 0, q = 0;
#pragma unroll 4
  for (; q + 4 <= rows; q += 4) {
    const int4 kk = k4[q / 4];
    r0 += kk.x < key;
    r1 += kk.y < key;
    r2 += kk.z < key;
    r3 += kk.w < key;
  }
  for (; q < rows; ++q) r0 += keys[q] < key;
  return (r0 + r1) + (r2 + r3);
}

// Column f of [x | 1] over the tile's rows in label order: a run of label j
// adds into a register that takes acc[j][f] where the run begins and is
// stored back where it ends, one fmaf(weight, x, acc) a row. The adds each
// accumulator sees, and their order, are those of a row-order walk. Rows
// come kAccBatch at a time, and all their loads are issued before any add:
// the weight, the value and acc[label][f] of every row. A label's run
// begins once in a tile, after the last store to its accumulator, so the
// value loaded with the row where it begins is the current one, and no
// load waits inside the chain of adds. A ragged tile's last rows come one
// at a time. A run is told by its accumulator offset, label * (d + 1).
__device__ __forceinline__ void accumulate_column(const int2* ent,
                                                  const float* xs, float* acc,
                                                  int rows, int f, int d) {
  constexpr unsigned kOffMask = (1u << kOffBits) - 1;
  const bool xcol = f < d;
  const float* col = xs + min(f, d - 1);
  float* accf = acc + f;
  unsigned cur = (unsigned)ent[0].x >> kOffBits;
  float a = accf[cur];
  int p = 0;
  for (; p + kAccBatch <= rows; p += kAccBatch) {
    unsigned lab[kAccBatch];
    float wt[kAccBatch], val[kAccBatch], start[kAccBatch];
#pragma unroll
    for (int b = 0; b < kAccBatch; ++b) {
      const int2 e = ent[p + b];
      lab[b] = (unsigned)e.x >> kOffBits;
      wt[b] = __int_as_float(e.y);
      val[b] = col[e.x & kOffMask];
      start[b] = accf[lab[b]];
    }
#pragma unroll
    for (int b = 0; b < kAccBatch; ++b) {
      if (lab[b] != cur) {
        accf[cur] = a;
        cur = lab[b];
        a = start[b];
      }
      a = fmaf(wt[b], xcol ? val[b] : 1.0f, a);
    }
  }
  for (; p < rows; ++p) {
    const int2 e = ent[p];
    if ((unsigned)e.x >> kOffBits != cur) {
      accf[cur] = a;
      cur = (unsigned)e.x >> kOffBits;
      a = accf[cur];
    }
    a = fmaf(__int_as_float(e.y), xcol ? col[e.x & kOffMask] : 1.0f, a);
  }
  accf[cur] = a;
}

__global__ void lloyd_partials_kernel(const float* __restrict__ x,
                                      const float* __restrict__ v,
                                      const float* __restrict__ c,
                                      const float* __restrict__ csq,
                                      float* __restrict__ partials, int64_t n,
                                      int k, int d, int kchunk,
                                      int64_t tiles_per_block, int vec4) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const int w = d + 1;
  const int xst = x_stride(d);
  float* cT = smem;
  float* csq_s = cT + kchunk * d;
  float* xs = csq_s + kchunk;
  int2* ent = reinterpret_cast<int2*>(xs + T * xst);
  int* keys = reinterpret_cast<int*>(ent);  // until the tile is ranked
  float* acc = reinterpret_cast<float*>(ent + T);
  const int me = threadIdx.x;

  for (int i = me; i < k * w; i += T) acc[i] = 0.f;
  if (k <= kchunk) stage_centroids(c, csq, cT, csq_s, 0, k, kchunk, d);

  const int64_t ntiles = (n + T - 1) / T;
  const int64_t t0 = (int64_t)blockIdx.x * tiles_per_block;
  const int64_t t1 = min(ntiles, t0 + tiles_per_block);
#ifdef LLOYD_PHASE_CLOCKS
  long long phase_c_[kPhases] = {0, 0, 0, 0, 0, 0, 0};
#endif
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t r0 = t * T;
    const int rows = (int)min((int64_t)T, n - r0);
    PHASE_START();
    __syncthreads();  // every thread is done with the last tile
    PHASE_END(0);
    const float weight = me < rows ? v[r0 + me] : 0.f;  // this row's
    load_tile(x, xs, r0, rows, d, vec4 != 0);
    PHASE_END(1);
    PHASE_BARRIER();
    PHASE_END(2);
    const int label = nearest(c, csq, cT, csq_s, xs, rows, k, kchunk, d);
    const int key = (label << kRowBits) | me;
    if (me < rows) keys[me] = key;
    PHASE_END(3);
    __syncthreads();  // the tile's keys are in shared memory
    PHASE_END(4);
    const int rank = me < rows ? rank_in_tile(keys, rows, key) : 0;
    __syncthreads();  // every key is read: ent may take their place
    if (me < rows)
      ent[rank] = make_int2((int)((unsigned)(label * w) << kOffBits |
                                  (unsigned)(me * xst)),
                            __float_as_int(weight));
    __syncthreads();  // the tile's rows are in label order
    PHASE_END(5);
    // thread f owns column f of [x | 1]: no two threads touch one address
    for (int f = me; f < w; f += T)
      accumulate_column(ent, xs, acc, rows, f, d);
    PHASE_END(6);
  }
#ifdef LLOYD_PHASE_CLOCKS
  if (blockIdx.x == 0)
    for (int q = 0; q < kPhases; ++q)
      lloyd_phase_cycles[me * kPhases + q] = phase_c_[q];
#endif
  __syncthreads();
  float* dst = partials + (int64_t)blockIdx.x * k * w;
  for (int i = me; i < k * w; i += T) dst[i] = acc[i];
}

// out[i] = the sum over b of partials[b][i] in a fixed two-level order,
// the one reduce_partials_plain follows, so the two agree bit for bit:
// - the B rows are cut into Q contiguous slices of L = ceil(B / 32) rows
//   (Q = ceil(B / L) <= 32, the last slice possibly shorter), and each
//   slice is added in row order from 0: s = 0, s += partials[r][i];
// - the Q slice sums are added by a fixed pairwise tree: at strides 1, 2,
//   4, 8, 16, sum j (j a multiple of twice the stride) takes sum j + stride
//   when that exists. The result is sum 0.
// Every call on the same shape adds in the same order, so reruns and a
// resumed fit give the same bits.
//
// What bounds it on an H100: latency. The partials are small (391 x 1,010
// for Lloyd, some hundreds x 102 for SGD): their bytes take a tenth of a
// microsecond at 3.35 TB/s, but the exact block order of the Pallas grid,
// one chain of B dependent adds per column, took about 8 ns a row in the
// best design found for it (kept and timed in scripts/port_reduce_order.py)
// and lost to torch.sum at Lloyd's, SGD's and FTRL's gradient shapes.
// Slices cut the chain to L adds plus five tree levels:
// - reduce_tile_kernel: a block of kRedThreads threads owns a tile of
//   kRedCols columns (one 32-byte sector of a row), so narrow partials
//   still spread over many SMs (SGD's 102 columns are 13 blocks, Lloyd's
//   1,010 are 127); thread (j, c) adds slice j of column c, its loads issued
//   kRedBatch at a time, a warp's load reading four rows' sectors whole;
//   the slice sums meet in shared memory, and thread c < kRedCols adds
//   column c's tree in registers;
// - reduce_rows_kernel, for partials of at most kRedSlices rows whose rows
//   are 16-byte aligned (FTRL's 131,072 per-row dots come in 25 chunks):
//   every slice is one row, and a thread adds the tree over the rows for
//   four neighbouring columns, all B 16-byte loads in flight at once.
// No atomics.
constexpr int kRedCols = 8;     // columns of a tile block
constexpr int kRedSlices = 32;  // slices at most
constexpr int kRedThreads = kRedCols * kRedSlices;
constexpr int kRedBatch = 32;   // loads in flight per thread
constexpr int kRedVec = 4;      // columns a reduce_rows_kernel thread adds

// s = 0, s += p[r * width] for the rows r of [r0, r1), issued in batches
__device__ __forceinline__ float slice_sum(const float* __restrict__ p,
                                           int64_t width, int r0, int r1) {
  float s = 0.f;
  int r = r0;
  for (; r + kRedBatch <= r1; r += kRedBatch) {
    float v[kRedBatch];
#pragma unroll
    for (int b = 0; b < kRedBatch; ++b) v[b] = p[(r + b) * width];
#pragma unroll
    for (int b = 0; b < kRedBatch; ++b) s += v[b];
  }
  for (; r < r1; ++r) s += p[r * width];
  return s;
}

// t[0] += t[1], t[2] += t[3], ...; then at strides 2, 4, 8, 16; t[i + stride]
// only where it is one of the q slices
__device__ __forceinline__ float slice_tree(float (&t)[kRedSlices], int q) {
#pragma unroll
  for (int stride = 1; stride < kRedSlices; stride *= 2)
#pragma unroll
    for (int i = 0; i + stride < kRedSlices; i += 2 * stride)
      if (i + stride < q) t[i] += t[i + stride];
  return t[0];
}

__global__ void __launch_bounds__(kRedThreads)
    reduce_tile_kernel(const float* __restrict__ partials,
                       float* __restrict__ out, int blocks, int width,
                       int slice_rows) {
  __shared__ float sums[kRedSlices][kRedCols];
  const int c = threadIdx.x % kRedCols, j = threadIdx.x / kRedCols;
  const int col = blockIdx.x * kRedCols + c;
  const int q = (blocks + slice_rows - 1) / slice_rows;  // slices
  sums[j][c] = col < width && j < q
                   ? slice_sum(partials + col, width, j * slice_rows,
                               min(blocks, (j + 1) * slice_rows))
                   : 0.f;
  __syncthreads();
  if (j != 0 || col >= width) return;
  float t[kRedSlices];
#pragma unroll
  for (int i = 0; i < kRedSlices; ++i) t[i] = sums[i][c];
  out[col] = slice_tree(t, q);
}

__global__ void __launch_bounds__(256)
    reduce_rows_kernel(const float* __restrict__ partials,
                       float* __restrict__ out, int blocks, int width) {
  const int col = (blockIdx.x * 256 + threadIdx.x) * kRedVec;
  if (col >= width) return;
  float4 v[kRedSlices];
#pragma unroll
  for (int j = 0; j < kRedSlices; ++j) {
    v[j] = j < blocks ? *reinterpret_cast<const float4*>(
                            partials + (int64_t)j * width + col)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    v[j].x += 0.f;  // s = 0, s += partials[j]: -0 becomes +0, as there
    v[j].y += 0.f;
    v[j].z += 0.f;
    v[j].w += 0.f;
  }
#pragma unroll
  for (int stride = 1; stride < kRedSlices; stride *= 2)
#pragma unroll
    for (int i = 0; i + stride < kRedSlices; i += 2 * stride)
      if (i + stride < blocks) {
        v[i].x += v[i + stride].x;
        v[i].y += v[i + stride].y;
        v[i].z += v[i + stride].z;
        v[i].w += v[i + stride].w;
      }
  *reinterpret_cast<float4*>(out + col) = v[0];
}

// -- the tiled route -----------------------------------------------------
//
// What bounds it on an H100: fp32 operations where k is large (the 2 n k d
// of the distances: at 1,000,000 x 1,536 and k = 1,024, 3.15 TFLOP, 47 ms
// at 67 TFLOP/s, against 1.8 ms for the bytes of x), device-memory bytes
// where it is not (d = 768, k = 64: 98 GFLOP, 1.5 ms, against 0.9 ms to
// read x once). Each stage, in launch order:
//
// - Labels (assign_tile_kernel<TN, XRES> for assign_nearest,
//   lloyd_label_kernel<TN, XRES> for Lloyd: one body, two symbols, so that
//   a profile tells them apart): the KNN tile engine's micro-tile with the
//   list replaced by one running key a row. A block of 256 threads owns 128
//   rows of x and walks the centroids, transposed and zero-padded to (dpad,
//   kp) with norms +inf past k, in tiles of TN (64 where k <= 64, so small
//   k pads no centroid to 128; else 128), a step of 32 columns at a time.
//   A step's x box (128 rows x 32 columns) and centroid box (32 x TN) come
//   by TMA into one stage of a ring (label_stages: 4 for TN = 64, 3 for
//   128), counted by the stage's full mbarrier; each warp releases the
//   stage on its empty mbarrier when it has read it, and thread 0 refills
//   it for the step label_lead ahead once every warp has, so no block
//   barrier stands between steps.
//   The x box lands with the 128-byte swizzle (16-byte chunk c of row r at
//   chunk c ^ (r % 8)), so the two half-warps' reads of rows 4 apart meet
//   no bank conflict. Rows whose stride is no multiple of 16 bytes (d % 4
//   != 0), which TMA cannot describe, come by cp.async in the same swizzled
//   layout, a warp along a row's 32 columns (coalesced), each thread's
//   copies arriving on the full mbarrier. Rows of up to kXResMax padded
//   columns (XRES) keep the block's x tile resident instead, loaded once
//   and transposed, [column][row], as the KNN kernels hold it (a float4
//   spans four rows); the ring then carries the centroid boxes alone.
//   Each thread keeps an 8 x TN / 16
//   micro-tile of dots in registers, one fma chain per dot in column order
//   from 0, as score_chunk adds them, so a distance fmaf(-2, dot, ||c||^2)
//   has the bits of the fused kernel's ||c||^2 - 2 dot (-2 dot is exact).
//   Each of a thread's 8 rows keeps the smallest key (distance, index) it
//   has seen; after the last tile the 16 lanes of the half-warp that share
//   a row take the smallest of their keys. The smallest key is the first
//   minimum over ascending j, the rule of _assign_kernel and the fused
//   kernel, in any order of comparison. Padded centroids score +inf with a
//   higher index than any real one, so they never win. Where kp > 128 x is
//   copied again for each centroid tile; the phase split
//   (scripts/port_label_phases.py) shows its copies waited on for under 3%
//   of a step at k = 1,024, so the blocks do not share x in a cluster.
// - A stable counting sort of the row ids by label (label_sort_kernel,
//   twice, around an exclusive scan): block (c, t) takes chunk c of
//   chunk_rows rows and labels [t * label_tile, ...); each of its 8 warps
//   counts the labels of a contiguous eighth of the chunk into a private
//   row of shared memory, 32 rows at a time (__match_any_sync groups a
//   batch's equal labels; the lowest lane of a group adds the group's
//   size: no two lanes write one counter, and no atomics). The counts go
//   to offs[label][chunk]; scan_reduce_kernel, scan_top_kernel and
//   scan_down_kernel turn them into their exclusive prefix sum in that
//   order (integer sums: exact in any order); then the same blocks count
//   again, take each warp's first place from offs and the warps before it,
//   and write each row id to its place, the lanes of a batch by lane. So
//   order[] holds the rows label by label, ascending within a label, and
//   offs[l * nchunks] is where label l begins. chunk_rows >= k, so offs
//   holds at most n + k ints.
// - Sums (piece_sums_kernel): the sorted places are cut into pieces of
//   piece_rows; block (q, g) owns piece q and column group g of [x | 1],
//   a thread a column. It stages kPieceBatch row ids, weights and labels
//   at a time in shared memory and walks them in order, kPieceLoads rows'
//   loads of x issued before their adds, adding each run of one label with
//   fmaf(weight, x, a) from a = 0 in ascending row order. A label whose
//   rows lie in one piece is written to out[label] there; a longer one
//   leaves the piece's part in scratch slot (q, 0) if its run begins the
//   piece, else (q, 1) (it then ends the piece). piece_combine_kernel
//   writes zeros for empty labels and adds the parts of each long label in
//   piece order, so one cluster holding most rows is still spread over
//   every piece, and no add order depends on the launch. The scratch is 2
//   (d + 1) floats a piece, and ops/kernels.py cuts at most n / (d + 1) + k
//   pieces, so it holds at most 2 (n + k (d + 1)) floats.
//
// Every stage's offsets are 32-bit where they count rows or labels (n
// below 2^31, which the entries check) and 64-bit where they address the
// k * nchunks sort offsets or floats of x, scratch or out. No atomics: the same inputs on the
// same card give the same bits.

// The key (distance, index) order: the first minimum over ascending index.
__device__ __forceinline__ bool key_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

#ifdef LABEL_PHASE_CLOCKS
// per thread of block 0: cycles in the copy wait, the stage release, the
// copy issue, the FMAs and the tile epilogue of all its steps
constexpr int kLabelPhases = 5;
__device__ long long label_phase_cycles[kTileThreads * kLabelPhases];
#define LABEL_PHASE_START() long long label_t_ = clock64()
#define LABEL_PHASE_END(q)                \
  do {                                    \
    const long long now_ = clock64();     \
    label_c_[q] += now_ - label_t_;       \
    label_t_ = now_;                      \
  } while (0)
#else
#define LABEL_PHASE_START() \
  do {                      \
  } while (0)
#define LABEL_PHASE_END(q) \
  do {                     \
  } while (0)
#endif

// Stages of the label body's ring, and the shared memory of a block of
// the TN-centroid instance at padded width dpad: up to kXResMax columns the
// x tile stays resident (transposed, [dpad][kTM]) beside the stages'
// centroid boxes (kDK x TN); wider rows stream an x box (kTM x kDK,
// 1024-byte aligned for the swizzle) in each stage too; a full and an empty
// mbarrier a stage, and room to align the start.
// Stages of the ring: four for the 64-centroid tile, three for the
// 128-centroid one (so that two blocks share an SM). A step's copies go out
// label_lead steps ahead, into the stage of the step label_stages -
// label_lead before it: two ahead where x streams from device memory, one
// where only the centroid boxes (which stay in L2) come, so that with a
// resident x tile the stage refilled is one released two steps back.
__host__ __device__ constexpr int label_stages(int tn) {
  return tn == 64 ? 4 : 3;
}
__host__ __device__ constexpr int label_lead(bool xres) {
  return xres ? 1 : 2;
}

__host__ __device__ constexpr int64_t label_smem_bytes(int tn, int dpad) {
  return dpad <= kXResMax
             ? 128 + 4 * ((int64_t)dpad * kTM +
                          (int64_t)label_stages(tn) * kDK * tn) +
                   16 * label_stages(tn)
             : 1024 +
                   4 * (int64_t)label_stages(tn) * (kTM * kDK + kDK * tn) +
                   16 * label_stages(tn);
}

// The nearest of the kp padded centroids (cT (dpad, kp) by `cmap`, norms
// csq) for each of the block's kTM rows of x -> out. x: resident where
// XRES (dpad <= kXResMax), else streamed by `xmap` where tma_x, else by
// cp.async; one instance a mode, each with one FMA loop, keeps the
// registers under the two blocks' budget. TN (64 or 128) centroids a
// tile; a thread scores rows (p < 4 ? 0 : 64) + ty * 4 + p % 4 against
// centroids (q / 4) * 64 + tx * 4 + q % 4 of each tile, QN = TN / 16 of
// them.
template <int TN, bool XRES>
__device__ __forceinline__ void nearest_tiles(const CUtensorMap* cmap,
                                              const CUtensorMap* xmap,
                                              const float* __restrict__ x,
                                              const float* __restrict__ csq,
                                              int* __restrict__ out,
                                              int64_t n, int d, int dpad,
                                              int kp, int tma_x) {
  constexpr int QN = TN / 16;
  constexpr int kLabelStages = label_stages(TN);
  constexpr int kLabelLead = label_lead(XRES);
  constexpr int XS = kTM * kDK;  // floats of a stage's x box
  constexpr int CS = kDK * TN;   // floats of its centroid box
  extern __shared__ __align__(128) unsigned char label_raw[];
  constexpr bool xres = XRES;
  const unsigned align = xres ? 128u : 1024u;
  float* xs = reinterpret_cast<float*>(
      label_raw + ((align - (smem_addr(label_raw) & (align - 1))) &
                   (align - 1)));
  float* cs = xs + (xres ? dpad * kTM : kLabelStages * XS);
  uint64_t* full = reinterpret_cast<uint64_t*>(cs + kLabelStages * CS);
  uint64_t* empty = full + kLabelStages;
  const float inf = __int_as_float(0x7f800000);

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4, lane = t & 31;
  const int64_t i0 = (int64_t)blockIdx.x * kTM;
  const int nchunks = dpad / kDK;
  const int nsteps = kp / TN * nchunks;
  // the stages' copies are thread 0's alone, unless x streams by cp.async
  const bool solo = xres || tma_x;
  const unsigned bytes = 4 * (CS + (!xres && tma_x ? XS : 0));

  // step s's copies: centroid tile s / nchunks, columns of chunk s %
  // nchunks, into stage s % kLabelStages once every warp has released the
  // step that held it (kLabelStages steps before); whoever copies waits
  // for that
  auto issue = [&](int s) {
    const int st = s % kLabelStages, tile = s / nchunks;
    const int c = s - tile * nchunks;
    if (s >= kLabelStages && (t == 0 || !solo))
      mbar_wait(&empty[st], (s / kLabelStages - 1) & 1);
    if (t == 0) {
      mbar_arrive_expect_tx(&full[st], bytes);
      tma_load_2d(cs + st * CS, cmap, tile * TN, c * kDK, &full[st]);
      if (!xres && tma_x)
        tma_load_2d(xs + st * XS, xmap, c * kDK, (int)i0, &full[st]);
    }
    if (!solo) {  // lanes along a row's columns; the swizzle TMA would give
      float* dst = xs + st * XS;
      for (int e = t; e < XS; e += kTileThreads) {
        const int i = e >> 5, f = e & 31, col = c * kDK + f;
        const bool ok = i0 + i < n && col < d;
        cp_async4(dst + i * kDK + ((((f >> 2) ^ (i & 7))) << 2) + (f & 3),
                  ok ? x + (i0 + i) * d + col : x, ok ? 4 : 0);
      }
      cp_async_mbar_arrive_noinc(&full[st]);
    }
  };

  if (t == 0) {
    for (int st = 0; st < kLabelStages; ++st) {
      mbar_init(&full[st], solo ? 1 : 1 + kTileThreads);
      mbar_init(&empty[st], kTileThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < kLabelLead && s < nsteps; ++s) issue(s);
  if (xres) {  // the x tile, transposed and zero-padded, once
    for (int e = t; e < dpad * kTM; e += kTileThreads) {
      const int f = e / kTM, i = e - f * kTM;
      xs[e] = (i0 + i < n && f < d) ? x[(i0 + i) * d + f] : 0.f;
    }
    __syncthreads();
  }

  // each of this thread's 8 rows: the smallest key so far
  float bd[8];
  int bi[8];
  float acc[8][QN];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    bd[p] = inf;
    bi[p] = 0;
#pragma unroll
    for (int q = 0; q < QN; ++q) acc[p][q] = 0.f;
  }
  // a streamed box's swizzle of row p: (row & 7) is ty % 2 * 4 + p % 4
  const int sw = (ty & 1) * 4;

#ifdef LABEL_PHASE_CLOCKS
  long long label_c_[kLabelPhases] = {0, 0, 0, 0, 0};
#endif
  for (int s = 0; s < nsteps; ++s) {
    LABEL_PHASE_START();
    if (s + kLabelLead < nsteps) issue(s + kLabelLead);
    LABEL_PHASE_END(2);
    const int st = s % kLabelStages;
    mbar_wait(&full[st], (s / kLabelStages) & 1);
    LABEL_PHASE_END(0);
    const int tile = s / nchunks, c = s - tile * nchunks;
    const float* cb = cs + st * CS;
    if constexpr (XRES) {
      const float* xc = xs + c * kDK * kTM;
#pragma unroll
      for (int kk = 0; kk < kDK; ++kk) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(xc + kk * kTM + ty * 4);
        const float4 a1 =
            *reinterpret_cast<const float4*>(xc + kk * kTM + 64 + ty * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bb[QN];
#pragma unroll
        for (int g = 0; g < QN / 4; ++g) {
          const float4 v = *reinterpret_cast<const float4*>(
              cb + kk * TN + g * 64 + tx * 4);
          bb[4 * g] = v.x;
          bb[4 * g + 1] = v.y;
          bb[4 * g + 2] = v.z;
          bb[4 * g + 3] = v.w;
        }
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int q = 0; q < QN; ++q)
            acc[p][q] = fmaf(a[p], bb[q], acc[p][q]);
      }
    } else {
      // a row's x in loads of AW columns (four with the 64-centroid tile,
      // whose thread holds fewer dots; two else, to stay in registers)
      constexpr int AW = QN == 4 ? 4 : 2;
      const float* xa = xs + st * XS;
#pragma unroll
      for (int kk = 0; kk < kDK; kk += AW) {
        float a[8][AW];
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          const int r = (p < 4 ? 0 : 64) + ty * 4 + (p & 3);
          const float* src =
              xa + r * kDK + (((kk >> 2) ^ (sw + (p & 3))) << 2) + (kk & 3);
          if constexpr (AW == 4) {
            const float4 v = *reinterpret_cast<const float4*>(src);
            a[p][0] = v.x;
            a[p][1] = v.y;
            a[p][2] = v.z;
            a[p][3] = v.w;
          } else {
            const float2 v = *reinterpret_cast<const float2*>(src);
            a[p][0] = v.x;
            a[p][1] = v.y;
          }
        }
#pragma unroll
        for (int h = 0; h < AW; ++h) {
          float bb[QN];
#pragma unroll
          for (int g = 0; g < QN / 4; ++g) {
            const float4 v = *reinterpret_cast<const float4*>(
                cb + (kk + h) * TN + g * 64 + tx * 4);
            bb[4 * g] = v.x;
            bb[4 * g + 1] = v.y;
            bb[4 * g + 2] = v.z;
            bb[4 * g + 3] = v.w;
          }
#pragma unroll
          for (int p = 0; p < 8; ++p)
#pragma unroll
            for (int q = 0; q < QN; ++q)
              acc[p][q] = fmaf(a[p][h], bb[q], acc[p][q]);
        }
      }
    }
    LABEL_PHASE_END(3);
    __syncwarp();  // the warp's reads of the stage are done
    if (lane == 0) mbar_arrive(&empty[st]);
    LABEL_PHASE_END(1);
    if (c != nchunks - 1) continue;
    // the tile is done: its distances against each row's smallest key
    const int j0 = tile * TN;
    float tn[QN];
#pragma unroll
    for (int g = 0; g < QN / 4; ++g) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(csq + j0 + g * 64 + tx * 4));
      tn[4 * g] = v.x;
      tn[4 * g + 1] = v.y;
      tn[4 * g + 2] = v.z;
      tn[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < QN; ++q) {
        const float dist = fmaf(-2.f, acc[p][q], tn[q]);
        const int j = j0 + (q >> 2) * 64 + 4 * tx + (q & 3);
        if (key_less(dist, j, bd[p], bi[p])) {
          bd[p] = dist;
          bi[p] = j;
        }
        acc[p][q] = 0.f;
      }
    LABEL_PHASE_END(4);
  }
#ifdef LABEL_PHASE_CLOCKS
  if (blockIdx.x == 0)
    for (int q = 0; q < kLabelPhases; ++q)
      label_phase_cycles[t * kLabelPhases + q] = label_c_[q];
#endif

  // the smallest key of the 16 lanes that share each row
#pragma unroll
  for (int p = 0; p < 8; ++p) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, bd[p], off, 16);
      const int oi = __shfl_xor_sync(kFull, bi[p], off, 16);
      if (key_less(od, oi, bd[p], bi[p])) {
        bd[p] = od;
        bi[p] = oi;
      }
    }
    const int64_t row = i0 + (p < 4 ? 0 : 64) + ty * 4 + (p & 3);
    if (tx == 0 && row < n) out[row] = bi[p];
  }
}

constexpr int kTileBlocksPerSm = 2;  // the register budget it is built for

template <int TN, bool XRES>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSm)
    assign_tile_kernel(const __grid_constant__ CUtensorMap cmap,
                       const __grid_constant__ CUtensorMap xmap,
                       const float* __restrict__ x,
                       const float* __restrict__ csq, int* __restrict__ out,
                       int64_t n, int d, int dpad, int kp, int tma_x) {
  nearest_tiles<TN, XRES>(&cmap, &xmap, x, csq, out, n, d, dpad, kp, tma_x);
}

template <int TN, bool XRES>
__global__ void __launch_bounds__(kTileThreads, kTileBlocksPerSm)
    lloyd_label_kernel(const __grid_constant__ CUtensorMap cmap,
                       const __grid_constant__ CUtensorMap xmap,
                       const float* __restrict__ x,
                       const float* __restrict__ csq, int* __restrict__ out,
                       int64_t n, int d, int dpad, int kp, int tma_x) {
  nearest_tiles<TN, XRES>(&cmap, &xmap, x, csq, out, n, d, dpad, kp, tma_x);
}

constexpr int kSortWarps = 8;
constexpr int kSortThreads = 32 * kSortWarps;

// Count (scatter = 0) or place (scatter = 1) the rows of chunk blockIdx.x
// whose labels lie in tile blockIdx.y (its comment above). A warp's rows
// are [r0, r1); a batch of 32 of them groups its equal labels with
// __match_any_sync, lanes outside the tile in a group of their own.
__global__ void __launch_bounds__(kSortThreads)
    label_sort_kernel(const int* __restrict__ labels, int* __restrict__ offs,
                      int* __restrict__ order, int64_t n, int k,
                      int chunk_rows, int nchunks, int label_tile,
                      int scatter) {
  extern __shared__ int sort_counts[];  // [kSortWarps][label_tile]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x, l0 = blockIdx.y * label_tile;
  const int lt = min(label_tile, k - l0);
  int* mine = sort_counts + warp * label_tile;
  for (int i = threadIdx.x; i < kSortWarps * label_tile; i += kSortThreads)
    sort_counts[i] = 0;
  __syncthreads();
  const int span = chunk_rows / kSortWarps;
  const int64_t r0 = (int64_t)c * chunk_rows + (int64_t)warp * span;
  const int64_t r1 = min(n, r0 + span);
  for (int64_t base = r0; base < r1; base += 32) {
    const int64_t r = base + lane;
    const int lab = r < r1 ? labels[r] - l0 : -1;
    const bool in = lab >= 0 && lab < lt;
    const unsigned peers = __match_any_sync(kFull, in ? lab : -1);
    if (in && lane == __ffs(peers) - 1) mine[lab] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  if (!scatter) {
    for (int l = threadIdx.x; l < lt; l += kSortThreads) {
      int s = 0;
      for (int w = 0; w < kSortWarps; ++w)
        s += sort_counts[w * label_tile + l];
      offs[(int64_t)(l0 + l) * nchunks + c] = s;
    }
    return;
  }
  // each warp's first place for each label: the chunk's, past the warps
  // before it
  for (int l = threadIdx.x; l < lt; l += kSortThreads) {
    int s = offs[(int64_t)(l0 + l) * nchunks + c];
    for (int w = 0; w < kSortWarps; ++w) {
      const int e = sort_counts[w * label_tile + l];
      sort_counts[w * label_tile + l] = s;
      s += e;
    }
  }
  __syncthreads();
  for (int64_t base = r0; base < r1; base += 32) {
    const int64_t r = base + lane;
    const int lab = r < r1 ? labels[r] - l0 : -1;
    const bool in = lab >= 0 && lab < lt;
    const unsigned peers = __match_any_sync(kFull, in ? lab : -1);
    if (in) order[mine[lab] + __popc(peers & ((1u << lane) - 1u))] = (int)r;
    __syncwarp();
    if (in && lane == __ffs(peers) - 1) mine[lab] += __popc(peers);
    __syncwarp();
  }
}

constexpr int kScanThreads = 256;
constexpr int kScanPerThread = 4;  // block sums a scan_top_kernel thread takes
constexpr int kScanMaxBlocks = kScanThreads * kScanPerThread;

// The exclusive prefix of each thread's v over the block, and the block's
// total; every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int& total) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kScanThreads / 32; ++w) {
    const int s = warp_sums[w];
    before += w < warp ? s : 0;
    total += s;
  }
  __syncthreads();  // warp_sums is free for the next call
  return before + incl - v;
}

// bsum[b] = the sum of data[b * span, (b + 1) * span)
__global__ void __launch_bounds__(kScanThreads)
    scan_reduce_kernel(const int* __restrict__ data, int* __restrict__ bsum,
                       int64_t m, int span) {
  const int64_t lo = (int64_t)blockIdx.x * span;
  const int64_t hi = min(m, lo + span);
  int s = 0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kScanThreads) s += data[i];
  int total;
  block_exclusive_scan(s, total);
  if (threadIdx.x == 0) bsum[blockIdx.x] = total;
}

// bsum[0, blocks) -> its exclusive prefix sums (one block)
__global__ void __launch_bounds__(kScanThreads)
    scan_top_kernel(int* __restrict__ bsum, int blocks) {
  int v[kScanPerThread], s = 0;
#pragma unroll
  for (int i = 0; i < kScanPerThread; ++i) {
    const int b = threadIdx.x * kScanPerThread + i;
    v[i] = b < blocks ? bsum[b] : 0;
    s += v[i];
  }
  int total;
  int before = block_exclusive_scan(s, total);
#pragma unroll
  for (int i = 0; i < kScanPerThread; ++i) {
    const int b = threadIdx.x * kScanPerThread + i;
    if (b < blocks) bsum[b] = before;
    before += v[i];
  }
}

// data[b * span, (b + 1) * span) -> its exclusive prefix sums, from bsum[b]
__global__ void __launch_bounds__(kScanThreads)
    scan_down_kernel(int* __restrict__ data, const int* __restrict__ bsum,
                     int64_t m, int span) {
  const int64_t lo = (int64_t)blockIdx.x * span;
  const int64_t hi = min(m, lo + span);
  int carry = bsum[blockIdx.x];
  for (int64_t base = lo; base < hi; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    const int v = i < hi ? data[i] : 0;
    int total;
    const int before = block_exclusive_scan(v, total);
    if (i < hi) data[i] = carry + before;
    carry += total;
  }
}

constexpr int kPieceBatch = 256;  // sorted places a piece block stages at once
constexpr int kPieceLoads = 8;    // rows whose loads a thread issues first

// Label l's sorted places [s, e), from the sort's offsets.
__device__ __forceinline__ void label_span(const int* __restrict__ offs, int l,
                                           int k, int nchunks, int64_t n,
                                           int& s, int& e) {
  s = offs[(int64_t)l * nchunks];
  e = l + 1 < k ? offs[(int64_t)(l + 1) * nchunks] : (int)n;
}

// Piece blockIdx.x of the sorted rows, column blockIdx.y * blockDim.x +
// threadIdx.x of [x | 1] (its comment above).
__global__ void __launch_bounds__(256)
    piece_sums_kernel(const float* __restrict__ x, const float* __restrict__ v,
                      const int* __restrict__ labels,
                      const int* __restrict__ order,
                      const int* __restrict__ offs, float* __restrict__ out,
                      float* __restrict__ scratch, int64_t n, int k, int d,
                      int nchunks, int piece_rows) {
  __shared__ int rid_s[kPieceBatch];
  __shared__ float w_s[kPieceBatch];
  __shared__ int lab_s[kPieceBatch];
  const int w = d + 1;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  const bool live = f < w, xcol = f < d;
  const int q = blockIdx.x;
  const int64_t p0 = (int64_t)q * piece_rows;
  const int64_t p1 = min(n, p0 + piece_rows);
  int cur = -1;       // the label of the run being added
  bool head = false;  // whether that run began the piece
  float a = 0.f;
  auto flush = [&]() {
    int s, e;
    label_span(offs, cur, k, nchunks, n, s, e);
    if (s / piece_rows == (e - 1) / piece_rows)
      out[(int64_t)cur * w + f] = a;
    else
      scratch[((int64_t)q * 2 + (head ? 0 : 1)) * w + f] = a;
  };
  for (int64_t b0 = p0; b0 < p1; b0 += kPieceBatch) {
    const int nb = (int)min((int64_t)kPieceBatch, p1 - b0);
    __syncthreads();  // every thread is done with the last batch
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      const int r = order[b0 + i];
      rid_s[i] = r;
      w_s[i] = v[r];
      lab_s[i] = labels[r];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < nb; i += kPieceLoads) {
      float val[kPieceLoads];
#pragma unroll
      for (int u = 0; u < kPieceLoads; ++u)
        val[u] =
            (i + u < nb && xcol) ? x[(int64_t)rid_s[i + u] * d + f] : 1.f;
#pragma unroll
      for (int u = 0; u < kPieceLoads; ++u) {
        if (i + u < nb) {
          const int lab = lab_s[i + u];
          if (lab != cur) {
            if (cur >= 0) flush();
            cur = lab;
            a = 0.f;
            head = b0 + i + u == p0;
          }
          a = fmaf(w_s[i + u], val[u], a);
        }
      }
    }
  }
  if (live && cur >= 0) flush();
}

// Label blockIdx.x, column blockIdx.y * blockDim.x + threadIdx.x of [x | 1]:
// zeros for an empty label, the sum of a long label's piece parts in piece
// order; a label within one piece was written by piece_sums_kernel.
__global__ void __launch_bounds__(256)
    piece_combine_kernel(const int* __restrict__ offs,
                         const float* __restrict__ scratch,
                         float* __restrict__ out, int64_t n, int k, int d,
                         int nchunks, int piece_rows) {
  const int l = blockIdx.x, w = d + 1;
  const int f = blockIdx.y * blockDim.x + threadIdx.x;
  if (f >= w) return;
  int s, e;
  label_span(offs, l, k, nchunks, n, s, e);
  float* dst = out + (int64_t)l * w + f;
  if (s == e) {
    *dst = 0.f;
    return;
  }
  const int q0 = s / piece_rows, q1 = (e - 1) / piece_rows;
  if (q0 == q1) return;
  const int slot = s == q0 * piece_rows ? 0 : 1;
  float a = scratch[((int64_t)q0 * 2 + slot) * w + f];
#pragma unroll 8
  for (int q = q0 + 1; q <= q1; ++q) a += scratch[(int64_t)q * 2 * w + f];
  *dst = a;
}

// The label kernel (the Lloyd or the assign symbol) of the instance that
// kp and dpad ask for: 64 centroids a tile where kp is 64, else 128; x
// resident up to kXResMax columns.
const void* label_kernel_of(bool lloyd, int kp, int dpad) {
  const bool res = dpad <= kXResMax;
  if (kp == 64) {
    if (res)
      return lloyd ? (const void*)lloyd_label_kernel<64, true>
                   : (const void*)assign_tile_kernel<64, true>;
    return lloyd ? (const void*)lloyd_label_kernel<64, false>
                 : (const void*)assign_tile_kernel<64, false>;
  }
  if (res)
    return lloyd ? (const void*)lloyd_label_kernel<128, true>
                 : (const void*)assign_tile_kernel<128, true>;
  return lloyd ? (const void*)lloyd_label_kernel<128, false>
               : (const void*)assign_tile_kernel<128, false>;
}

template <int TN, bool XRES>
void launch_label_instance(bool lloyd, const CUtensorMap& cmap,
                           const CUtensorMap& xmap, const float* x,
                           const float* csq, int* out, int64_t n, int d,
                           int dpad, int kp, int tma_x, int smem,
                           cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + kTM - 1) / kTM);
  if (lloyd)
    lloyd_label_kernel<TN, XRES><<<grid, kTileThreads, smem, stream>>>(
        cmap, xmap, x, csq, out, n, d, dpad, kp, tma_x);
  else
    assign_tile_kernel<TN, XRES><<<grid, kTileThreads, smem, stream>>>(
        cmap, xmap, x, csq, out, n, d, dpad, kp, tma_x);
}

// The tiled labels of n rows into out, through the assign or the Lloyd
// instance.
cudaError_t launch_labels(bool lloyd, const float* x, const float* cT,
                          const float* csq, int* out, int64_t n, int d,
                          int dpad, int kp, cudaStream_t stream) {
  const int tn = kp == 64 ? 64 : 128;
  CUtensorMap cmap, xmap;
  cudaError_t e = encode_tile_map(&cmap, cT, dpad, kp, tn);
  if (e != cudaSuccess) return e;
  // TMA takes rows whose stride is a multiple of 16 bytes; a box no
  // larger than the tensor
  const int tma_x = d % 4 == 0 && d >= kDK && n >= kTM &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (tma_x) {
    e = encode_rows_map(&xmap, x, n, d);
    if (e != cudaSuccess) return e;
  } else {
    xmap = cmap;  // unread
  }
  const int smem = (int)label_smem_bytes(tn, dpad);
  e = cudaFuncSetAttribute(label_kernel_of(lloyd, kp, dpad),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const bool res = dpad <= kXResMax;
  if (tn == 64 && res)
    launch_label_instance<64, true>(lloyd, cmap, xmap, x, csq, out, n, d,
                                    dpad, kp, tma_x, smem, stream);
  else if (tn == 64)
    launch_label_instance<64, false>(lloyd, cmap, xmap, x, csq, out, n, d,
                                     dpad, kp, tma_x, smem, stream);
  else if (res)
    launch_label_instance<128, true>(lloyd, cmap, xmap, x, csq, out, n, d,
                                     dpad, kp, tma_x, smem, stream);
  else
    launch_label_instance<128, false>(lloyd, cmap, xmap, x, csq, out, n, d,
                                      dpad, kp, tma_x, smem, stream);
  return cudaGetLastError();
}

bool tiled_ok(long long n, int k, int d, int dpad, int kp) {
  return n >= 1 && (n + kTM - 1) / kTM <= INT_MAX && k >= 1 && d >= 1 &&
         dpad >= d && dpad % kDK == 0 && kp >= k &&
         (kp == 64 || kp % kTN == 0);
}

int64_t smem_floats(int lloyd, int k, int d, int rows, int kchunk) {
  int64_t f = (int64_t)kchunk * d + kchunk + (int64_t)rows * x_stride(d);
  if (lloyd) f += (int64_t)k * (d + 1) + 2 * rows;
  return f;
}

// The launch configuration the Python side chose must be one these kernels
// were written for.
cudaError_t check_config(int lloyd, int k, int d, int rows, int kchunk,
                         int smem) {
  if (k < 1 || d < 1 || rows < 32 || rows > (1 << kRowBits) ||
      rows % 32 != 0 || kchunk < KG || kchunk % KG != 0 ||
      (lloyd && ((int64_t)k * (d + 1) > (1 << kOffBits) ||
                 (int64_t)rows * x_stride(d) > (1 << kOffBits))) ||
      (int64_t)smem < 4 * smem_floats(lloyd, k, d, rows, kchunk))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

const void* kernel_of(int lloyd) {
  return lloyd ? (const void*)lloyd_partials_kernel
               : (const void*)assign_kernel;
}

cudaError_t allow_smem(int lloyd, int smem) {
  return cudaFuncSetAttribute(kernel_of(lloyd),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" {

const char* kmeans_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Resident blocks of one SM for the assign (lloyd = 0) or Lloyd (lloyd = 1)
// kernel at this block size and shared memory.
int kmeans_blocks_per_sm(int lloyd, int rows, int smem, int* out) {
  cudaError_t e = allow_smem(lloyd, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel_of(lloyd), rows, (size_t)smem);
}

int kmeans_assign_nearest(const float* x, const float* c, const float* csq,
                          int* out, long long n, int k, int d, int rows,
                          int kchunk, int smem, int vec4, int grid,
                          void* stream) {
  cudaError_t e = check_config(0, k, d, rows, kchunk, smem);
  if (e == cudaSuccess) e = allow_smem(0, smem);
  if (e != cudaSuccess) return (int)e;
  assign_kernel<<<grid, rows, smem, (cudaStream_t)stream>>>(
      x, c, csq, out, (int64_t)n, k, d, kchunk, vec4);
  return (int)cudaGetLastError();
}

int kmeans_lloyd_partials(const float* x, const float* v, const float* c,
                          const float* csq, float* partials, long long n,
                          int k, int d, int rows, int kchunk, int smem,
                          int vec4, int blocks, long long tiles_per_block,
                          void* stream) {
  cudaError_t e = check_config(1, k, d, rows, kchunk, smem);
  if (e == cudaSuccess) e = allow_smem(1, smem);
  if (e != cudaSuccess) return (int)e;
  lloyd_partials_kernel<<<blocks, rows, smem, (cudaStream_t)stream>>>(
      x, v, c, csq, partials, (int64_t)n, k, d, kchunk,
      (int64_t)tiles_per_block, vec4);
  return (int)cudaGetLastError();
}

// (blocks, width) partials -> (width,) sums in the two-level order:
// reduce_rows_kernel where every slice is one row and the rows are 16-byte
// aligned, else reduce_tile_kernel.
int kmeans_reduce_partials(const float* partials, float* out, int blocks,
                           int width, void* stream) {
  if (blocks < 1 || width < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks <= kRedSlices && width % kRedVec == 0 &&
      ((uintptr_t)partials | (uintptr_t)out) % 16 == 0)
    reduce_rows_kernel<<<(width / kRedVec + 255) / 256, 256, 0, s>>>(
        partials, out, blocks, width);
  else
    reduce_tile_kernel<<<(width + kRedCols - 1) / kRedCols, kRedThreads, 0,
                         s>>>(partials, out, blocks, width,
                              (blocks + kRedSlices - 1) / kRedSlices);
  return (int)cudaGetLastError();
}

// Resident blocks of one SM for the tiled label kernel of the instance kp
// asks for at this padded width.
int kmeans_label_blocks_per_sm(int dpad, int kp, int* out) {
  if (dpad < kDK || dpad % kDK != 0 || kp < 1 || (kp != 64 && kp % kTN != 0))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)label_smem_bytes(kp == 64 ? 64 : 128, dpad);
  const void* fn = label_kernel_of(false, kp, dpad);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, kTileThreads, (size_t)smem);
}

// Shared memory of a label block of the instance kp asks for at this
// padded width.
long long kmeans_label_smem_bytes(int kp, int dpad) {
  return label_smem_bytes(kp == 64 ? 64 : 128, dpad);
}

// The tiled route's labels: cT the (dpad, kp) transposed centroids, zero
// past d and k, csq their (kp,) norms, +inf past k (ops/kernels.py
// `kmeans_plan` sizes dpad and kp).
int kmeans_assign_tiled(const float* x, const float* cT, const float* csq,
                        int* out, long long n, int k, int d, int dpad, int kp,
                        void* stream) {
  if (!tiled_ok(n, k, d, dpad, kp)) return (int)cudaErrorInvalidValue;
  return (int)launch_labels(false, x, cT, csq, out, (int64_t)n, d, dpad, kp,
                            (cudaStream_t)stream);
}

// One Lloyd round's (k, d+1) [sums | counts] by the tiled route, every stage
// launched here in order; labels (n), offs (k * nchunks), bsum
// (scan_blocks), order (n) and scratch (2 (d + 1) ceil(n / piece_rows)
// floats) are its workspace, left as the stages wrote them.
int kmeans_lloyd_sorted(const float* x, const float* v, const float* cT,
                        const float* csq, int* labels, int* offs, int* bsum,
                        int* order, float* scratch, float* out, long long n,
                        int k, int d, int dpad, int kp, int chunk_rows,
                        int nchunks, int label_tile, int scan_span,
                        int scan_blocks, int piece_rows, int col_threads,
                        void* stream) {
  const int64_t m = (int64_t)k * nchunks;
  const int64_t sort_smem = 4LL * kSortWarps * label_tile;
  if (!tiled_ok(n, k, d, dpad, kp) || n > INT_MAX ||
      chunk_rows < kSortThreads || chunk_rows % kSortThreads != 0 ||
      (int64_t)nchunks != (n + chunk_rows - 1) / chunk_rows ||
      label_tile < 1 || sort_smem > 232448 ||
      (k + label_tile - 1) / label_tile > 65535 || scan_blocks < 1 ||
      scan_blocks > kScanMaxBlocks || scan_span < 1 ||
      (int64_t)scan_blocks * scan_span < m ||
      (int64_t)(scan_blocks - 1) * scan_span >= m || piece_rows < 1 ||
      col_threads < 32 || col_threads > 256 || col_threads % 32 != 0 ||
      (d + col_threads) / col_threads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = launch_labels(true, x, cT, csq, labels, (int64_t)n, d, dpad,
                                kp, s);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(label_sort_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sort_smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 sort_grid((unsigned)nchunks,
                       (unsigned)((k + label_tile - 1) / label_tile));
  label_sort_kernel<<<sort_grid, kSortThreads, (int)sort_smem, s>>>(
      labels, offs, order, (int64_t)n, k, chunk_rows, nchunks, label_tile, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_reduce_kernel<<<scan_blocks, kScanThreads, 0, s>>>(offs, bsum, m,
                                                          scan_span);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_top_kernel<<<1, kScanThreads, 0, s>>>(bsum, scan_blocks);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  scan_down_kernel<<<scan_blocks, kScanThreads, 0, s>>>(offs, bsum, m,
                                                        scan_span);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  label_sort_kernel<<<sort_grid, kSortThreads, (int)sort_smem, s>>>(
      labels, offs, order, (int64_t)n, k, chunk_rows, nchunks, label_tile, 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const unsigned groups = (unsigned)((d + col_threads) / col_threads);
  const unsigned pieces = (unsigned)((n + piece_rows - 1) / piece_rows);
  piece_sums_kernel<<<dim3(pieces, groups), col_threads, 0, s>>>(
      x, v, labels, order, offs, out, scratch, (int64_t)n, k, d, nchunks,
      piece_rows);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  piece_combine_kernel<<<dim3((unsigned)k, groups), col_threads, 0, s>>>(
      offs, scratch, out, (int64_t)n, k, d, nchunks, piece_rows);
  return (int)cudaGetLastError();
}

#ifdef LABEL_PHASE_CLOCKS
// Block 0's label_phase_cycles of the last label launch, into host memory.
int kmeans_label_phase_cycles_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, label_phase_cycles,
                                   sizeof(label_phase_cycles));
}
#endif

#ifdef LLOYD_PHASE_CLOCKS
// Block 0's lloyd_phase_cycles of the last launch, into host memory.
int kmeans_lloyd_phase_cycles_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, lloyd_phase_cycles,
                                   sizeof(lloyd_phase_cycles));
}
#endif

}  // extern "C"
