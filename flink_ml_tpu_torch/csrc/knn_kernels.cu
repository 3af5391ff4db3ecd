// KNN kernel for Hopper (sm_90a): fused distance + top-k over the streamed
// train set, in plain fp32 CUDA C++.
//
// Replaces, in flink_ml_tpu/ops/pallas_kernels.py:
//   knn_topk_kernel<DPAD, KCAP> <- _knn_kernel (:421), pallas_call at :482
//
// Output: for each test row x_i of x (n, d), the indices of the k train rows
// t_j of train (nt, d) with the smallest ||t_j||^2 - 2 x_i.t_j (||x_i||^2 is
// the same for every j and is dropped, as the Pallas kernel drops it), in
// ascending order of that distance, ties to the lowest j: the order of
// lax.top_k. The norms ||t_j||^2 come precomputed (ops/kernels.py, one torch
// op, as _knn_padded computes them at :476).
//
// What bounds it on an H100: fp32 operations. At the main path (10,000,000
// test rows against 50,000 train rows, d = 32) the 2 n nt d = 3.2e13
// operations take about 0.48 s at 67 TFLOP/s, while its bytes (1.28 GB of x,
// 6.4 MB of train, 400 MB of output) take about 0.5 ms at 3.35 TB/s. So the
// design feeds the FMA units: one thread per test row holds its row in
// registers (DPAD floats, zero past d) and its sorted top-k list (KCAP
// distances and indices) in registers (the wider instances put part of the
// list on the stack: ptxas -v, printed by chip_smoke.py); the block streams
// the train set through shared memory, kTileT rows at a time, and every
// float4 of a train row, read from shared memory as a broadcast to the whole
// warp, feeds four FMAs of each thread. The (n, nt) distance matrix never
// exists, not even a tile of it.
//
// Top-k insertion: a candidate enters only when its distance is strictly
// below the current k-th; it goes before the first entry it is strictly
// below, and the entries after it shift down by one. Train rows arrive in
// ascending index order, so among equal distances the earlier, lower index
// stays ahead: the lax.top_k rule that the Pallas merge keeps (:430-435). The
// ragged last train tile is masked by its row count (the Pallas kernel pads
// it with +inf norms instead).
//
// Determinism: each thread adds its row's products in a fixed order (four
// partial sums over the float4 lanes, then (a0 + a1) + (a2 + a3)); no atomics,
// and no data shared between threads but the read-only tile. The same inputs
// on the same card give the same bits.
//
// Shared memory, in floats: ts [kTileT][DPAD] the train tile (zero past d),
// then tsq [kTileT] its norms.
//
// Wider rows (d > 128) or longer lists (k > 32) take the wide instance,
// knn_topk_wide_kernel, with the same insertion rule: the block stages its
// 128 test rows and a tile of kWideT train rows through shared memory
// kWideD columns at a time (the test chunk transposed, so that each thread
// reads its own row without bank conflicts), each thread carries kWideT
// partial dots in registers across the column chunks, one fma chain per
// dot in column order, and merges the finished tile into its sorted list,
// which lives in a (k, n) scratch in device memory (entry q of row i at
// q * n + i, so that a warp's accesses coalesce). Its shared memory, in
// floats: xs [kWideD][kThreads + 1], ts [kWideT][kWideD], tsq [kWideT].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // test rows per block, one per thread
constexpr int kTileT = 128;    // train rows per shared-memory tile

constexpr int smem_bytes(int dpad) { return 4 * (kTileT * dpad + kTileT); }

// Train rows [j0, j0 + rows) -> ts[r * DPAD + f] (zero for f >= d and for
// r >= rows), their norms -> tsq_s[r].
template <int DPAD>
__device__ void load_train_tile(const float* __restrict__ train,
                                const float* __restrict__ tsq, float* ts,
                                float* tsq_s, int64_t j0, int rows, int d) {
  for (int i = threadIdx.x; i < kTileT * DPAD; i += kThreads) {
    const int r = i / DPAD, f = i - r * DPAD;
    ts[i] = (r < rows && f < d) ? train[(j0 + r) * d + f] : 0.f;
  }
  for (int r = threadIdx.x; r < kTileT; r += kThreads)
    tsq_s[r] = (r < rows) ? tsq[j0 + r] : 0.f;
}

template <int DPAD, int KCAP>
__global__ void __launch_bounds__(kThreads)
    knn_topk_kernel(const float* __restrict__ x,
                    const float* __restrict__ train,
                    const float* __restrict__ tsq, int* __restrict__ out,
                    int64_t n, int64_t nt, int d, int k) {
  extern __shared__ __align__(16) float smem[];
  float* ts = smem;
  float* tsq_s = ts + kTileT * DPAD;
  const float inf = __int_as_float(0x7f800000);

  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < n;
  float xr[DPAD];
#pragma unroll
  for (int f = 0; f < DPAD; ++f)
    xr[f] = (live && f < d) ? x[row * d + f] : 0.f;
  float bd[KCAP];
  int bi[KCAP];
#pragma unroll
  for (int q = 0; q < KCAP; ++q) {
    bd[q] = inf;
    bi[q] = 0;
  }
  float kth = inf;  // the k-th smallest distance so far

  for (int64_t j0 = 0; j0 < nt; j0 += kTileT) {
    const int rows = (int)min((int64_t)kTileT, nt - j0);
    __syncthreads();  // every thread is done with the last tile
    load_train_tile<DPAD>(train, tsq, ts, tsq_s, j0, rows, d);
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const float4* tp = reinterpret_cast<const float4*>(ts + r * DPAD);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
      for (int q = 0; q < DPAD / 4; ++q) {
        const float4 tv = tp[q];
        a0 = fmaf(xr[4 * q + 0], tv.x, a0);
        a1 = fmaf(xr[4 * q + 1], tv.y, a1);
        a2 = fmaf(xr[4 * q + 2], tv.z, a2);
        a3 = fmaf(xr[4 * q + 3], tv.w, a3);
      }
      const float dist = tsq_s[r] - 2.0f * ((a0 + a1) + (a2 + a3));
      if (dist < kth) {
        float cd = dist;
        int ci = (int)(j0 + r);
        bool shift = false;  // once placed, every later entry moves down
#pragma unroll
        for (int q = 0; q < KCAP; ++q) {
          const bool take = shift || cd < bd[q];
          const float td = bd[q];
          const int ti = bi[q];
          bd[q] = take ? cd : td;
          bi[q] = take ? ci : ti;
          cd = take ? td : cd;
          ci = take ? ti : ci;
          shift = take;
        }
        // entries past k - 1 only ever shift; the guard is the k-th
#pragma unroll
        for (int q = 0; q < KCAP; ++q)
          if (q == k - 1) kth = bd[q];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int q = 0; q < KCAP; ++q)
      if (q < k) out[row * k + q] = bi[q];
  }
}

constexpr int kWideT = 32;              // train rows per tile, wide kernel
constexpr int kWideD = 64;              // columns staged at once
constexpr int kXPitch = kThreads + 1;   // floats per staged test column

constexpr int wide_smem_bytes() {
  return 4 * (kWideD * kXPitch + kWideT * kWideD + kWideT);
}

__global__ void __launch_bounds__(kThreads)
    knn_topk_wide_kernel(const float* __restrict__ x,
                         const float* __restrict__ train,
                         const float* __restrict__ tsq, int* __restrict__ out,
                         float* __restrict__ dl, int* __restrict__ il,
                         int64_t n, int64_t nt, int d, int k) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;
  float* ts = xs + kWideD * kXPitch;
  float* tsq_s = ts + kWideT * kWideD;
  const float inf = __int_as_float(0x7f800000);

  const int64_t row0 = (int64_t)blockIdx.x * kThreads;
  const int64_t row = row0 + threadIdx.x;
  const bool live = row < n;
  const int xrows = (int)min((int64_t)kThreads, n - row0);
  if (live) {
    for (int q = 0; q < k; ++q) {
      dl[q * n + row] = inf;
      il[q * n + row] = 0;
    }
  }
  float kth = inf;  // the k-th smallest distance so far

  for (int64_t j0 = 0; j0 < nt; j0 += kWideT) {
    const int rows = (int)min((int64_t)kWideT, nt - j0);
    float acc[kWideT];
#pragma unroll
    for (int t = 0; t < kWideT; ++t) acc[t] = 0.f;
    for (int f0 = 0; f0 < d; f0 += kWideD) {
      const int fc = min(kWideD, d - f0);
      __syncthreads();  // every thread is done with the last chunk
      for (int i = threadIdx.x; i < kThreads * kWideD; i += kThreads) {
        const int r = i / kWideD, f = i - r * kWideD;
        xs[f * kXPitch + r] =
            (r < xrows && f < fc) ? x[(row0 + r) * d + f0 + f] : 0.f;
      }
      for (int i = threadIdx.x; i < kWideT * kWideD; i += kThreads) {
        const int r = i / kWideD, f = i - r * kWideD;
        ts[i] = (r < rows && f < fc) ? train[(j0 + r) * d + f0 + f] : 0.f;
      }
      if (f0 == 0 && threadIdx.x < kWideT)
        tsq_s[threadIdx.x] = (threadIdx.x < rows) ? tsq[j0 + threadIdx.x] : 0.f;
      __syncthreads();
      // zero past fc on both sides: the padded columns add exact zeros
      for (int q = 0; q < kWideD / 4; ++q) {
        const float x0 = xs[(4 * q + 0) * kXPitch + threadIdx.x];
        const float x1 = xs[(4 * q + 1) * kXPitch + threadIdx.x];
        const float x2 = xs[(4 * q + 2) * kXPitch + threadIdx.x];
        const float x3 = xs[(4 * q + 3) * kXPitch + threadIdx.x];
#pragma unroll
        for (int t = 0; t < kWideT; ++t) {
          const float4 tv = reinterpret_cast<const float4*>(ts + t * kWideD)[q];
          acc[t] = fmaf(x0, tv.x, acc[t]);
          acc[t] = fmaf(x1, tv.y, acc[t]);
          acc[t] = fmaf(x2, tv.z, acc[t]);
          acc[t] = fmaf(x3, tv.w, acc[t]);
        }
      }
    }
    if (!live) continue;
    // the tile's train rows in index order: strict "less than" keeps the
    // lower index ahead among equal distances
#pragma unroll
    for (int t = 0; t < kWideT; ++t) {
      if (t >= rows) break;
      const float dist = tsq_s[t] - 2.0f * acc[t];
      if (dist < kth) {
        int p = k - 1;
        while (p > 0) {
          const float prev = dl[(p - 1) * n + row];
          if (!(dist < prev)) break;
          dl[p * n + row] = prev;
          il[p * n + row] = il[(p - 1) * n + row];
          --p;
        }
        dl[p * n + row] = dist;
        il[p * n + row] = (int)(j0 + t);
        kth = dl[(k - 1) * n + row];
      }
    }
  }
  if (live) {
    for (int q = 0; q < k; ++q) out[row * k + q] = il[q * n + row];
  }
}

template <int DPAD, int KCAP>
cudaError_t launch(const float* x, const float* train, const float* tsq,
                   int* out, int64_t n, int64_t nt, int d, int k,
                   cudaStream_t stream) {
  if (d > DPAD || k > KCAP) return cudaErrorInvalidValue;
  const int smem = smem_bytes(DPAD);
  cudaError_t e = cudaFuncSetAttribute(
      knn_topk_kernel<DPAD, KCAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  knn_topk_kernel<DPAD, KCAP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, train, tsq, out, n, nt, d, k);
  return cudaGetLastError();
}

cudaError_t launch_wide(const float* x, const float* train, const float* tsq,
                        int* out, float* scratch, int64_t n, int64_t nt,
                        int d, int k, cudaStream_t stream) {
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int smem = wide_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      knn_topk_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  knn_topk_wide_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      x, train, tsq, out, scratch, reinterpret_cast<int*>(scratch + k * n),
      n, nt, d, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* knn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The (n, k) int32 indices of the k nearest train rows of each test row, for
// 1 <= k <= nt: (dpad, kcap) one of the register instances, with d <= dpad
// and k <= kcap, or (0, 0) for the wide instance, which takes any d and k
// and a scratch of 2 k n floats (ops/kernels.py `_knn_layout` picks them).
int knn_topk(const float* x, const float* train, const float* tsq, int* out,
             float* scratch, long long n, long long nt, int d, int k,
             int dpad, int kcap, void* stream) {
  if (n < 1 || nt < 1 || nt > 0x7fffffffLL || d < 1 || k < 1 || k > nt)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dpad == 0 && kcap == 0)
    return (int)launch_wide(x, train, tsq, out, scratch, (int64_t)n,
                            (int64_t)nt, d, k, s);
#define KNN_CASE(DP, KC)                                                   \
  if (dpad == DP && kcap == KC)                                            \
    return (int)launch<DP, KC>(x, train, tsq, out, (int64_t)n, (int64_t)nt, \
                               d, k, s);
  KNN_CASE(32, 16)
  KNN_CASE(32, 32)
  KNN_CASE(64, 16)
  KNN_CASE(64, 32)
  KNN_CASE(128, 16)
  KNN_CASE(128, 32)
#undef KNN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
