// SGD kernel for Hopper (sm_90a): one round's fused forward, loss terms and
// gradient over the minibatch window, in plain fp32 CUDA C++.
//
// Replaces, in flink_ml_tpu/ops/pallas_kernels.py:
//   sgd_terms_kernel<LOSS> <- _sgd_terms_kernel (:206), pallas_call at :282
// The accumulation of _sgd_terms_kernel into out_ref across sequential grid
// steps (:231) is the second stage, reduce_partials_kernel of
// kmeans_kernels.cu, which sums the per-block partials in block order.
//
// Output, over the window rows [start, start + lb) of x (n, d), y (n,),
// w (n,): the packed (d + 2,) vector [sum mult * x | sum w | sum loss], where
// rows whose window index is below `clip` weigh 0 and (loss, mult) are the
// per-row terms of ops/losses.py (logistic, hinge or least-square; one
// template instance each).
//
// What bounds it on an H100: device-memory bytes. At the main-path window
// (lb = 100,000 rows, d = 100) a call must read 40.8 MB once, about 0.012 ms
// at 3.35 TB/s, while its 4 * lb * d = 40 MFLOP of fp32 take about 0.0006 ms
// at 67 TFLOP/s. So the design reads every row of the window from device
// memory once where the row tile fits shared memory: a block stages a tile
// of rows with coalesced (16-byte where aligned) loads, each warp takes a
// row's dot with the coefficients and its loss terms, and thread j adds
// mult * x[:, j] of the tile into column j of the block's partial. The
// (lb,) dots and multipliers never exist in device memory.
//
// Any d: a tile is staged `dc` columns at a time. Up to SGD_CHUNK_COLS
// columns (ops/kernels.py) dc = d and the tile is staged once. Wider rows
// build each dot up across the column chunks, then take a second pass over
// the chunks for mult * x (the last chunk is still staged, so it is read
// once; the others twice, the second time mostly from L2).
//
// Determinism, with no atomics: a block owns a contiguous range of row
// tiles and adds them in row order; column j of the block's partial is only
// ever touched by thread j % blockDim.x (dc is d or a multiple of
// blockDim.x, so every chunk maps column j to the same thread), and the
// weight and loss sums by thread 0. The partial is the block's own row of
// `partials` in device memory, so d has no shared-memory limit. The same
// inputs on the same card give the same bits.
//
// Arithmetic: full fp32 (FMA), no TF32, no fast-math intrinsics. The logistic
// loss is softplus(-m) = max(-m, 0) + log1p(exp(-|m|)), which never
// overflows; its multiplier -w * ys / (exp(m) + 1) is +-0 once exp(m)
// overflows to inf (|m| > 88), as in the reference.
//
// Shared memory, in floats, in this order (ops/kernels.py `_sgd_layout`
// sizes it and passes rows, dc and the byte count):
//   xs   [rows][dc]  a column chunk of the row tile; first, so 16-byte aligned
//   cs   [dc]        the same columns of the coefficients
//   mult [rows]      the tile's dots, built up chunk by chunk, then its
//                    multipliers
//   wv   [rows]      the tile's masked weights
//   lv   [rows]      the tile's weighted losses

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block: 8 warps

enum Loss { kLogistic = 0, kHinge = 1, kLeastSquare = 2 };

// (weighted loss, multiplier) of one row, as ops/losses.py computes them.
template <int LOSS>
__device__ __forceinline__ void row_terms(float dot, float y, float w,
                                          float& loss, float& mult) {
  if (LOSS == kLogistic) {
    const float ys = 2.0f * y - 1.0f;
    const float m = dot * ys;
    loss = w * (fmaxf(-m, 0.0f) + log1pf(expf(-fabsf(m))));
    mult = w * (-ys / (expf(m) + 1.0f));
  } else if (LOSS == kHinge) {
    const float ys = 2.0f * y - 1.0f;
    const float hinge = 1.0f - ys * dot;
    loss = w * fmaxf(hinge, 0.0f);
    mult = -ys * w * (hinge > 0.0f ? 1.0f : 0.0f);
  } else {
    const float err = dot - y;
    loss = w * 0.5f * err * err;
    mult = w * err;
  }
}

// Sum over the 32 lanes of a warp, in a fixed order; every lane gets it.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Columns [0, dw) of nr rows of stride ld at src -> dst[nr][dw]. With vec4,
// src, ld and dw are multiples of 4 floats and src is 16-byte aligned.
__device__ void stage_chunk(const float* __restrict__ src, int64_t ld,
                            float* dst, int nr, int dw, bool vec4) {
  if (dw == ld) {  // the whole rows: one contiguous run
    const int count = nr * dw;
    if (vec4) {
      const float4* s4 = reinterpret_cast<const float4*>(src);
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int i = threadIdx.x; i < count / 4; i += blockDim.x) d4[i] = s4[i];
    } else {
      for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
    }
  } else if (vec4) {
    const int w4 = dw / 4;
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < nr * w4; i += blockDim.x) {
      const int r = i / w4, q = i - r * w4;
      d4[i] = *reinterpret_cast<const float4*>(src + r * ld + 4 * q);
    }
  } else {
    for (int i = threadIdx.x; i < nr * dw; i += blockDim.x) {
      const int r = i / dw, f = i - r * dw;
      dst[i] = src[r * ld + f];
    }
  }
}

template <int LOSS>
__global__ void __launch_bounds__(kThreads)
    sgd_terms_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ w,
                     const float* __restrict__ coeffs,
                     float* __restrict__ partials, int64_t start, int64_t lb,
                     int64_t clip, int d, int dc, int rows,
                     int64_t tiles_per_block, int vec4) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* cs = xs + rows * dc;
  float* mult = cs + dc;
  float* wv = mult + rows;
  float* lv = wv + rows;
  const int T = blockDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = T / 32;
  const int last_c0 = (d - 1) / dc * dc;  // first column of the last chunk

  // the block's partial: column j belongs to thread j % T throughout
  float* dst = partials + (int64_t)blockIdx.x * (d + 2);
  for (int j = threadIdx.x; j < d; j += T) dst[j] = 0.f;
  float w_sum = 0.f, loss_sum = 0.f;  // thread 0's

  const int64_t ntiles = (lb + rows - 1) / rows;
  const int64_t t0 = (int64_t)blockIdx.x * tiles_per_block;
  const int64_t t1 = min(ntiles, t0 + tiles_per_block);
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t r0 = t * rows;  // window index of the tile's first row
    const int nr = (int)min((int64_t)rows, lb - r0);
    const float* xt = x + (start + r0) * d;
    // pass 1: the dots, chunk by chunk, then the rows' terms
    for (int c0 = 0; c0 < d; c0 += dc) {
      const int dw = min(dc, d - c0);
      __syncthreads();  // every thread is done with the last chunk and terms
      stage_chunk(xt + c0, d, xs, nr, dw, vec4 != 0);
      for (int f = threadIdx.x; f < dw; f += T) cs[f] = coeffs[c0 + f];
      __syncthreads();  // the chunk is in shared memory
      for (int r = warp; r < nr; r += nwarps) {
        const float* xrow = xs + r * dw;
        float s = 0.f;
        for (int f = lane; f < dw; f += 32) s = fmaf(xrow[f], cs[f], s);
        s = warp_sum(s);
        if (lane == 0) {
          if (c0 > 0) s = mult[r] + s;
          if (c0 == last_c0) {
            const int64_t i = r0 + r;
            const float wi = (i >= clip) ? w[start + i] : 0.f;
            float loss, m;
            row_terms<LOSS>(s, y[start + i], wi, loss, m);
            mult[r] = m;
            wv[r] = wi;
            lv[r] = loss;
          } else {
            mult[r] = s;
          }
        }
      }
    }
    __syncthreads();  // the tile's terms are in shared memory
    // pass 2: mult * x, last chunk first (it is still staged); every column
    // adds its rows in row order
    for (int c0 = last_c0; c0 >= 0; c0 -= dc) {
      const int dw = min(dc, d - c0);
      if (c0 != last_c0) {
        __syncthreads();  // every thread is done with the chunk before
        stage_chunk(xt + c0, d, xs, nr, dw, vec4 != 0);
        __syncthreads();
      }
      for (int f = threadIdx.x; f < dw; f += T) {
        float a = dst[c0 + f];
        for (int r = 0; r < nr; ++r) a = fmaf(mult[r], xs[r * dw + f], a);
        dst[c0 + f] = a;
      }
    }
    if (threadIdx.x == 0) {
      for (int r = 0; r < nr; ++r) {
        w_sum += wv[r];
        loss_sum += lv[r];
      }
    }
  }
  if (threadIdx.x == 0) {
    dst[d] = w_sum;
    dst[d + 1] = loss_sum;
  }
}

int64_t smem_floats(int dc, int rows) {
  return (int64_t)rows * dc + dc + 3 * (int64_t)rows;
}

const void* kernel_of(int loss) {
  switch (loss) {
    case kLogistic:
      return (const void*)sgd_terms_kernel<kLogistic>;
    case kHinge:
      return (const void*)sgd_terms_kernel<kHinge>;
    case kLeastSquare:
      return (const void*)sgd_terms_kernel<kLeastSquare>;
    default:
      return nullptr;
  }
}

// The launch configuration the Python side chose must be one this kernel
// was written for: dc is d, or a multiple of the block's threads below d.
cudaError_t check_config(int loss, int d, int dc, int rows, int smem) {
  if (kernel_of(loss) == nullptr || d < 1 || rows < 1 || dc < 1 ||
      !(dc == d || (dc < d && dc % kThreads == 0)) ||
      (int64_t)smem < 4 * smem_floats(dc, rows))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

cudaError_t allow_smem(int loss, int smem) {
  return cudaFuncSetAttribute(kernel_of(loss),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" {

const char* sgd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Resident blocks of one SM for the loss's instance at this shared memory.
int sgd_blocks_per_sm(int loss, int smem, int* out) {
  if (kernel_of(loss) == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(loss, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, kernel_of(loss), kThreads, (size_t)smem);
}

int sgd_terms_partials(const float* x, const float* y, const float* w,
                       const float* coeffs, float* partials, long long start,
                       long long lb, long long clip, int d, int dc, int rows,
                       int smem, int vec4, int blocks,
                       long long tiles_per_block, int loss, void* stream) {
  cudaError_t e = check_config(loss, d, dc, rows, smem);
  if (e == cudaSuccess) e = allow_smem(loss, smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
#define SGD_LAUNCH(L)                                                       \
  sgd_terms_kernel<L><<<blocks, kThreads, smem, s>>>(                       \
      x, y, w, coeffs, partials, (int64_t)start, (int64_t)lb, (int64_t)clip, \
      d, dc, rows, (int64_t)tiles_per_block, vec4)
  switch (loss) {
    case kLogistic:
      SGD_LAUNCH(kLogistic);
      break;
    case kHinge:
      SGD_LAUNCH(kHinge);
      break;
    default:
      SGD_LAUNCH(kLeastSquare);
      break;
  }
#undef SGD_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
