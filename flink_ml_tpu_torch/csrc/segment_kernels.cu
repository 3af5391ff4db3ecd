// Segment-sum kernel for Hopper (sm_90a), in plain fp32 CUDA C++.
//
// Replaces, in flink_ml_tpu/ops/pallas_kernels.py:
//   segreduce_partials_kernel <- _segreduce_kernel (:332), pallas_call at :359
// The accumulation of _segreduce_kernel into out_ref across sequential grid
// steps is the second stage, reduce_partials_kernel of kmeans_kernels.cu,
// which sums the per-chunk partials in chunk order.
//
// Output: out[s][j] = sum of values[i][j] over the rows i with ids[i] == s,
// for s in [0, u) and j in [0, c); rows whose id lies outside [0, u) (the -1
// padding included) add nothing, as jax.ops.segment_sum drops them.
//
// What bounds it on an H100: device-memory bytes. At the FTRL sparse path's
// per-coordinate pass (n = 1,048,576 stored values, c = 2, u = 100) a call
// must read 12.6 MB of values and ids once, about 0.004 ms at 3.35 TB/s; its
// n c additions are nothing beside that. The Pallas kernel turns the scatter
// into a one-hot matmul on the MXU, u times the work; here the scatter stays
// a scatter, without atomics, so that reruns give identical bits:
//
// - The grid is (row chunks) x (segment blocks). A segment block is one
//   tile of ut segments [s0, s0 + ut) and one group of cg value columns
//   [j0, j0 + cg), with cg = min(c, kTileFloats) and ut * cg <= kTileFloats,
//   so every u and every c has a layout. Block (b, y) takes the segment
//   blocks y, y + gridDim.y, ... in turn (gridDim.y stops at 65,535), over
//   row chunk b; each warp owns a contiguous share of the chunk and a
//   private (ut, cg) accumulator in shared memory, zeroed per segment block.
// - A warp takes 32 rows at a time (loading the ids of kSteps such steps
//   at once). Lanes whose ids fall in the tile are grouped by id with
//   __match_any_sync; each lane puts its value into the warp's 32-float
//   scratch, and the group's lowest lane adds the group's values in lane
//   order and that sum into the warp's accumulator. Different groups have
//   different ids, so no two lanes write one address, and __syncwarp orders
//   one step's writes before the next step's.
// - The block then adds its warps' accumulators in warp order and writes the
//   sum to its own (chunk, tile, group) slice of `partials` (chunks, u, c);
//   every slice is written by exactly one block, so no memset is needed.
// - reduce_partials_kernel adds the chunks in chunk order.
//
// Every sum is taken in one fixed order: chunks, then warps, then 32-row
// steps, then lanes. A wide segment domain costs re-reads of the ids, one
// pass per segment tile (ops/kernels.py sizes the chunks so that the card
// holds about two waves of blocks).
//
// Shared memory, in floats: acc [kWarps][ut * cg], then scr [kWarps][32].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileFloats = 4096;  // one warp's accumulator: 16 KB
constexpr int kSteps = 4;          // 32-row steps whose ids load together
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
    segreduce_partials_kernel(const float* __restrict__ values,
                              const int* __restrict__ ids,
                              float* __restrict__ partials, int64_t n, int u,
                              int c, int ut, int cg, int tiles, int groups,
                              int64_t rows_per_chunk) {
  extern __shared__ __align__(16) float acc[];  // then the scratch
  const int width = ut * cg;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t chunk = blockIdx.x;

  // this warp's contiguous share of the chunk's rows
  const int64_t c0 = chunk * rows_per_chunk;
  const int64_t c1 = min(n, c0 + rows_per_chunk);
  const int64_t share = (c1 - c0 + kWarps - 1) / kWarps;
  const int64_t w0 = min(c1, c0 + warp * share);
  const int64_t w1 = min(c1, w0 + share);
  float* wacc = acc + warp * width;
  float* wscr = acc + kWarps * width + warp * 32;

  for (int64_t sb = blockIdx.y; sb < (int64_t)tiles * groups;
       sb += gridDim.y) {
    const int s0 = (int)(sb / groups) * ut;
    const int j0 = (int)(sb % groups) * cg;
    const int us = min(ut, u - s0);  // segments of this tile
    const int cs = min(cg, c - j0);  // columns of this group

    __syncthreads();  // the last segment block's sums are written out
    for (int i = threadIdx.x; i < kWarps * width; i += kThreads) acc[i] = 0.f;
    __syncthreads();

    for (int64_t r0 = w0; r0 < w1; r0 += 32 * kSteps) {
      // the ids of kSteps steps at once: independent loads in flight
      int idv[kSteps];
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        const int64_t r = r0 + 32 * q + lane;
        idv[q] = (r < w1) ? ids[r] : -1;
      }
#pragma unroll
      for (int q = 0; q < kSteps; ++q) {
        const int64_t r = r0 + 32 * q + lane;
        const int id = idv[q];
        // this lane's segment within the tile, or -1
        const int s = (r < w1 && id >= s0 && id < s0 + us) ? id - s0 : -1;
        if (__ballot_sync(kFull, s >= 0) == 0) continue;  // warp-uniform
        const unsigned group = __match_any_sync(kFull, s);
        const bool leader = s >= 0 && lane == __ffs(group) - 1;
        for (int j = 0; j < cs; ++j) {
          wscr[lane] = (s >= 0) ? values[r * c + j0 + j] : 0.f;
          __syncwarp();
          if (leader) {  // the group's values, in lane order
            float sum = 0.f;
            for (unsigned m = group; m; m &= m - 1) sum += wscr[__ffs(m) - 1];
            wacc[s * cg + j] += sum;
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();

    // the block's partial: its warps' accumulators added in warp order
    float* dst = partials + (chunk * u + s0) * (int64_t)c + j0;
    for (int i = threadIdx.x; i < us * cg; i += kThreads) {
      const int s = i / cg, j = i - s * cg;
      if (j >= cs) continue;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += acc[w * width + i];
      dst[(int64_t)s * c + j] = sum;
    }
  }
}

int smem_bytes(int ut, int cg) { return 4 * kWarps * (ut * cg + 32); }

cudaError_t allow_smem(int smem) {
  return cudaFuncSetAttribute(segreduce_partials_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

extern "C" {

const char* segment_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Resident blocks of one SM for this many bytes of shared memory.
int segment_blocks_per_sm(int smem, int* out) {
  cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, segreduce_partials_kernel, kThreads, (size_t)smem);
}

// Stage 1: partials (chunks, u, c) from values (n, c) and ids (n,); the
// segment tiles are ut segments wide and the column groups cg columns wide
// (ut * cg <= kTileFloats, cg = min(c, kTileFloats)), and chunk b holds
// rows [b * rows_per_chunk, (b + 1) * rows_per_chunk).
int segment_reduce_partials(const float* values, const int* ids,
                            float* partials, long long n, int u, int c,
                            int ut, int cg, long long rows_per_chunk,
                            int chunks, void* stream) {
  if (n < 1 || u < 1 || c < 1 || ut < 1 || ut > u || cg < 1 || cg > c ||
      (long long)ut * cg > kTileFloats || rows_per_chunk < 1 || chunks < 1 ||
      (long long)chunks * rows_per_chunk < n)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (u + (long long)ut - 1) / ut;
  const long long groups = (c + (long long)cg - 1) / cg;
  if (tiles * groups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(ut, cg);
  cudaError_t e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  const unsigned gy = (unsigned)(tiles * groups < 65535 ? tiles * groups
                                                         : 65535);
  segreduce_partials_kernel<<<dim3(chunks, gy), kThreads, smem,
                              (cudaStream_t)stream>>>(
      values, ids, partials, (int64_t)n, u, c, ut, cg, (int)tiles,
      (int)groups, (int64_t)rows_per_chunk);
  return (int)cudaGetLastError();
}

}  // extern "C"
