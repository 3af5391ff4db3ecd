// The register-blocked fp32 tile engine's building blocks, shared by
// knn_kernels.cu (knn_tile_kernel, knn_long_kernel, knn_key_tile_kernel)
// and kmeans_kernels.cu (assign_tile_kernel, lloyd_label_kernel): the tile
// shape, the shared memory of a KNN block, cp.async and TMA copies counted
// by mbarriers, and the TMA descriptors of a transposed, zero-padded (dpad,
// ntp) operand and of x's rows (the labels' swizzled boxes).
//
// A block of kTileThreads threads owns kTM rows of x and walks tiles of kTN
// rows of the other operand (train rows, or centroids), kDK columns a step:
// the operand's (kDK, kTN) box of a step comes by one TMA copy into a
// double buffer, the x rows by cp.async beside it where they do not stay
// resident (dpad > kXResMax); the KMeans label body keeps the micro-tile
// but runs its own ring of stages (kmeans_kernels.cu). ops/_build.py
// hashes this header into the
// name of every library built from a source of csrc/, so an edited header
// builds them anew.

#ifndef FLINK_ML_TPU_TORCH_TILE_ENGINE_CUH
#define FLINK_ML_TPU_TORCH_TILE_ENGINE_CUH

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 128;             // rows of x per block
constexpr int kTN = 128;             // rows of the operand per tile
constexpr int kDK = 32;              // columns per step
constexpr int kTileThreads = 256;    // 16 x 16 threads, 8 x 8 dots each
constexpr int kXResMax = 128;        // widest dpad whose x tile stays resident
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int64_t tile_smem_bytes(int dpad) {
  return 4 * ((int64_t)(dpad <= kXResMax ? dpad * kTM : 2 * kDK * kTM) +
              2 * kDK * kTN + 2 * kTN) +
         16;  // two mbarriers
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// The train chunks come by TMA: thread 0 arms an mbarrier with the bytes
// it expects and issues one 2D tensor copy, which completes them; every
// thread waits on the barrier's phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` of copies to complete on the
// barrier.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// The thread's cp.async copies issued so far arrive on the barrier when
// they complete, as one of its expected arrivals.
__device__ __forceinline__ void cp_async_mbar_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The box of the 2D tensor `map` describes at (inner coordinate c0, outer
// c1) -> dst, completing its bytes on the barrier.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// rows [row, row + kDK) and columns [col, col + kTN) of the (dpad, ntp)
// tensor `map` describes -> dst, [kDK][kTN]
__device__ __forceinline__ void tma_chunk(float* dst, const CUtensorMap* map,
                                          int col, int row, uint64_t* bar) {
  mbar_arrive_expect_tx(bar, 4 * kDK * kTN);
  tma_load_2d(dst, map, col, row, bar);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// 2D float32 TMA tensors. cuTensorMapEncodeTiled comes from the driver
// through the runtime, so the library links no libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encode_2d(CUtensorMap* map, const float* base, uint64_t inner,
                      uint64_t outer, uint32_t box_inner, uint32_t box_outer,
                      CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * sizeof(float)};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elems[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(base), dims, strides, box, elems,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The (dpad, ntp) transposed operand, in boxes of kDK rows by box_cols
// columns (kTN unless given).
cudaError_t encode_tile_map(CUtensorMap* map, const float* opT, int dpad,
                            int ntp, int box_cols = kTN) {
  return encode_2d(map, opT, (uint64_t)ntp, (uint64_t)dpad,
                   (uint32_t)box_cols, kDK, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The (n, d) rows of x, in boxes of kTM rows by kDK columns (128 bytes a
// row) with the 128-byte swizzle: 16-byte chunk c of box row r lands at
// chunk c ^ (r & 7) of the row, in a box 1024-byte aligned; zeros past n
// and d. TMA takes a row stride that is a multiple of 16 bytes only: d % 4
// == 0, x 16-byte aligned.
cudaError_t encode_rows_map(CUtensorMap* map, const float* x, int64_t n,
                            int d) {
  return encode_2d(map, x, (uint64_t)d, (uint64_t)n, kDK, kTM,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace

#endif  // FLINK_ML_TPU_TORCH_TILE_ENGINE_CUH
