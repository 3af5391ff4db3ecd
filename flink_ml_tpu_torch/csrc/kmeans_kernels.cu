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
// chunk, so any k works; the gate on d is the tile's shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

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

#ifdef LLOYD_PHASE_CLOCKS
// Block 0's lloyd_phase_cycles of the last launch, into host memory.
int kmeans_lloyd_phase_cycles_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, lloyd_phase_cycles,
                                   sizeof(lloyd_phase_cycles));
}
#endif

}  // extern "C"
