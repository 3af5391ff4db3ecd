// KMeans kernels for Hopper (sm_90a): nearest-centroid assignment and the
// Lloyd round's weighted partial sums, in plain fp32 CUDA C++.
//
// Replaces, in flink_ml_tpu/ops/pallas_kernels.py:
//   assign_kernel          <- _assign_kernel (:26), pallas_call at :41
//   lloyd_partials_kernel  <- _lloyd_accum_kernel (:132), pallas_call at :165
//   reduce_tile_kernel,    <- the accumulation of _lloyd_accum_kernel into
//   reduce_rows_kernel        out_ref across sequential grid steps (:141-157),
//                             and of _sgd_terms_kernel (:231): the second
//                             stage of sgd_kernels.cu and segment_kernels.cu
//                             too
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
// Arithmetic: full fp32 FMA, no TF32 and no tensor cores. The distance rule
// is the Pallas kernel's: d2_j = ||c_j||^2 - 2 x.c_j, first minimum over
// ascending j (strict <), as jnp.argmin and torch.argmin pick it.
//
// Shared memory, in floats, in this order (ops/kernels.py `_layout` sizes
// it and passes rows = blockDim.x, kchunk and the byte count):
//   cT  [d][kchunk]     centroid chunk, transposed; first, so 16-byte aligned
//   csq [kchunk]
//   acc [k][d+1]        Lloyd only: the block's [sums | counts]
//   xs  [rows][d | 1]   x tile; an odd row stride keeps the per-row reads
//                       of the 32 threads of a warp on 32 different banks
//   vs  [rows]          Lloyd only: row weights
//   lab [rows] (int)    Lloyd only: the tile's assignments
// Centroids beyond the staged chunk are scored chunk by chunk, so any k
// works; the gate on d is the tile's shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KG = 16;  // centroids scored together, in registers

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

// Rows [r0, r0 + rows) of x (row-major, d wide) -> xs[r * x_stride + f].
__device__ void load_tile(const float* __restrict__ x, float* xs, int64_t r0,
                          int rows, int d, bool vec4) {
  const int xst = x_stride(d);
  const float* src = x + r0 * d;
  const int total = rows * d;
  if (vec4) {  // d % 4 == 0 and x 16-byte aligned: a float4 stays in one row
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int i = threadIdx.x; i < total / 4; i += blockDim.x) {
      const float4 q = s4[i];
      const int e = 4 * i, r = e / d, f = e - r * d;
      float* dst = xs + r * xst + f;
      dst[0] = q.x;
      dst[1] = q.y;
      dst[2] = q.z;
      dst[3] = q.w;
    }
  } else {
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i / d, f = i - r * d;
      xs[r * xst + f] = src[i];
    }
  }
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
  float* cT = smem;
  float* csq_s = cT + kchunk * d;
  float* acc = csq_s + kchunk;
  float* xs = acc + k * w;
  float* vs = xs + T * x_stride(d);
  int* lab = reinterpret_cast<int*>(vs + T);
  const int xst = x_stride(d);

  for (int i = threadIdx.x; i < k * w; i += T) acc[i] = 0.f;
  if (k <= kchunk) stage_centroids(c, csq, cT, csq_s, 0, k, kchunk, d);

  const int64_t ntiles = (n + T - 1) / T;
  const int64_t t0 = (int64_t)blockIdx.x * tiles_per_block;
  const int64_t t1 = min(ntiles, t0 + tiles_per_block);
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t r0 = t * T;
    const int rows = (int)min((int64_t)T, n - r0);
    __syncthreads();  // every thread is done with the last tile
    load_tile(x, xs, r0, rows, d, vec4 != 0);
    if ((int)threadIdx.x < rows) vs[threadIdx.x] = v[r0 + threadIdx.x];
    const int j = nearest(c, csq, cT, csq_s, xs, rows, k, kchunk, d);
    if ((int)threadIdx.x < rows) lab[threadIdx.x] = j;
    __syncthreads();  // the tile's assignments are in shared memory
    // thread f owns column f of [x | 1]: no two threads touch one address,
    // and every column adds its rows in row order
    for (int f = threadIdx.x; f < w; f += T) {
      for (int r = 0; r < rows; ++r) {
        const float val = (f < d) ? xs[r * xst + f] : 1.0f;
        acc[lab[r] * w + f] += vs[r] * val;
      }
    }
  }
  __syncthreads();
  float* dst = partials + (int64_t)blockIdx.x * k * w;
  for (int i = threadIdx.x; i < k * w; i += T) dst[i] = acc[i];
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
// for Lloyd, 782 x 102 for SGD): their bytes take a tenth of a microsecond
// at 3.35 TB/s, but the exact block order of the Pallas grid, one chain of
// B dependent adds per column, took about 8 ns a row in the best
// design found for it (kept and timed in scripts/port_reduce_order.py)
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
  if (k < 1 || d < 1 || rows < 32 || rows > 1024 || rows % 32 != 0 ||
      kchunk < KG || kchunk % KG != 0 ||
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

}  // extern "C"
