// KNN kernels for Hopper (sm_90a): fused distance + top-k over the streamed
// train set, in plain fp32 CUDA C++.
//
// Replaces, in flink_ml_tpu/ops/pallas_kernels.py:
//   knn_tile_kernel<KCAP>, knn_merge_kernel<KCAP>, knn_long_kernel<KCAP>,
//   knn_long_merge_kernel<KCAP>, knn_key_tile_kernel, knn_select_kernel
//     <- _knn_kernel (:421), pallas_call at :482
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
// design feeds the FMA units from registers, as a matrix product does, and
// the (n, nt) distance matrix never exists in device memory.
//
// knn_tile_kernel<KCAP> (k <= KCAP, KCAP 16 or 32; any d):
// - Distance tiles by register blocking. A block of 256 threads owns 128
//   test rows and walks train tiles of 128 rows; each thread accumulates an
//   8 x 8 micro-tile of dot products (test rows ty*4 + {0..3} and 64 + ty*4
//   + {0..3}, train rows tx*4 + {0..3} and 64 + tx*4 + {0..3}, tx = t % 16,
//   ty = t / 16: a quarter-warp's float4 reads are 128 contiguous bytes, so
//   no bank conflicts). x and train sit transposed ([column][row]) in shared
//   memory, so one column step costs a thread four float4 loads for 64
//   FMAs. Columns are walked 32 at a time, so any d works; each dot is one
//   fma chain in column order, zero columns past d adding exact zeros.
// - Copies overlap the FMAs. The wrapper hands the train set over transposed
//   and zero-padded ((dpad, ntp), dpad and ntp multiples of 32 and 128) with
//   its norms padded by +inf, so a (train tile, 32-column chunk) step is a
//   32 x 128 box of it: one TMA tensor copy, issued by one thread and
//   counted by an mbarrier, into a double buffer, the next step's copy in
//   flight while this step's FMAs run, and no thread spends instructions on
//   its addresses; the box's norms come by cp.async. The x tile is loaded
//   once per block when dpad <= 128; wider rows stream their x chunk beside
//   the train chunk (4-byte cp.async, zero-filled past n and d). Padded
//   train rows score +inf and never enter a list.
// - Selection keeps lax.top_k's order, in registers. Test row r's 128
//   candidates of a tile lie with the 16 lanes of one half-warp (those
//   with ty = r / 4 % 16), and so does r's sorted list: entry j of it with
//   lane j % 16, in slot j / 16 (KCAP / 16 slots a lane). After a tile's
//   last chunk each thread forms tsq - 2 dot for its 64 pairs (fmaf(-2,
//   dot, tsq): -2 dot is exact, so this rounds as the subtraction does) and
//   keeps those strictly below its row's k-th distance (kth, in every lane
//   of the half-warp). A threshold from before the tile's own insertions is
//   higher than the current one and only admits extra candidates. On a
//   tile where a row's list is not yet full (the first of each split),
//   candidates above the k-th smallest of the 16 lanes' minima are dropped
//   too: k candidates of the tile lie at or below it, so none above can
//   enter (k <= 16). The half-warp then walks its rows' survivors in
//   ascending train index (ballot, lowest lane, lowest column) and inserts
//   each one with the rule of the Pallas merge (:430-435): a candidate
//   enters only when strictly below the current k-th, goes before the first
//   entry it is strictly below (its place is the count of entries at or
//   below it, a ballot), and the entries after it shift down by one (a
//   shuffle). Among equal distances the earlier, lower index stays ahead.
//   A round inserts the next survivor of each of the half-warp's 8 rows, so
//   the rows' shuffles overlap; a row with no survivor in the warp costs two
//   votes, a warp with none at all one. No shared memory, no barrier and no
//   owner thread serialises it.
// - Train split for small batches. Blocks are (test tile, split): grid.y
//   cuts the train tiles into `splits` contiguous ranges when the test
//   tiles alone would leave SMs idle (ops/kernels.py `_knn_plan`). With one
//   split the lanes write the indices; with more, each (test tile, split)
//   writes its sorted (distance, index) list to a (splits, n, k) scratch,
//   padded with +inf where a split holds fewer than k rows, and
//   knn_merge_kernel<KCAP> merges the lists of each row in split order with
//   the same strict-less insertion: the earlier split, which holds the
//   lower indices, wins ties. Both give the same lists as one pass over the
//   whole train set.
// - Shared memory, in floats (tile_smem_bytes; knn_tile_smem_bytes tells
//   the Python side): xs [dpad][128] (resident) or [2][32][128] (streamed),
//   ts [2][32][128], tsq [2][128], then two mbarriers: 49 KB at d = 32, at
//   most 97 KB.
//   Registers bound the block to one per SM (8 warps): the 64 accumulators,
//   the lists and the selection's temporaries take about 180 a thread, and
//   held to 128 for two blocks they spill (chip_smoke.py prints ptxas'
//   registers and spills and the blocks per SM). Built with
//   -DKNN_PHASE_CLOCKS, block (0, 0) adds up clock64() per phase of its
//   steps for knn_phase_cycles_read, and with -DKNN_NO_SELECTION the tiles
//   skip selection: scripts/port_knn_phases.py builds and times both.
//
// Lists of 33 to 80 entries take knn_long_kernel<KCAP> (KCAP 64 or 128;
// its comment below): the same engine, split and TMA copies, with the
// lists and a buffer of candidates a row in shared memory, merged in
// batches, and ordered by the key (distance, index), so that any merge
// order, and so any split, gives the same lists.
//
// Longer lists take the radix route (its comment below; ops/kernels.py
// `KNN_LONG_MAX_K` holds the measured hand-over): the
// same engine writes every distance as a sortable uint32 key to a scratch,
// and a block a test row selects the k-th key by radix passes, compacts
// the keys at or below it in index order and sorts them by a stable radix
// sort, so that a list of any length costs a few passes over its row, not
// an insertion into a list in device memory per candidate.
//
// Arithmetic: full fp32 FMA, no TF32 and no tensor cores (TF32 would move
// distances far past the tie tolerance the card check allows and flip
// neighbours). Determinism: every dot is one fixed fma chain, every list
// is built in a fixed order, no atomics; the same inputs on the same card
// give the same bits, whatever the split.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_engine.cuh"

namespace {

// -- tiled kernel ---------------------------------------------------------

// Inserts (dist, j) into the sorted register list (bd, bi) of capacity
// KCAP, of which the first k entries count, and refreshes kth (its k-th
// distance): strict "less than", the entries after the new one shift down.
template <int KCAP>
__device__ __forceinline__ void insert_sorted(float (&bd)[KCAP],
                                              int (&bi)[KCAP], float& kth,
                                              int k, float dist, int j) {
  if (!(dist < kth)) return;
  float cd = dist;
  int ci = j;
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

__device__ __forceinline__ float row_min(const float (&v)[8]) {
  return fminf(fminf(fminf(v[0], v[1]), fminf(v[2], v[3])),
               fminf(fminf(v[4], v[5]), fminf(v[6], v[7])));
}

// One row's list spread over a half-warp: entry j in lane j % 16, slot
// j / 16. Every lane of the warp calls these together (the shuffles and
// ballots are warp-wide; `half` is this lane's 0 or 16).
template <int SL>
struct HalfList {
  float d[SL];
  int i[SL];

  // Entry k - 1, in every lane of the half-warp.
  __device__ __forceinline__ float kth(int k) const {
    float v = d[0];
#pragma unroll
    for (int s = 1; s < SL; ++s)
      if ((k - 1) >> 4 == s) v = d[s];
    return __shfl_sync(kFull, v, (k - 1) & 15, 16);
  }

  // Inserts (cd, ci) where `ins` (the same in all lanes of a half-warp).
  __device__ __forceinline__ void insert(bool ins, float cd, int ci, int hl,
                                         int half) {
    int pos = 0;  // entries at or below cd: a prefix of the sorted list
#pragma unroll
    for (int s = 0; s < SL; ++s)
      pos += __popc((__ballot_sync(kFull, d[s] <= cd) >> half) & 0xffffu);
    float ud[SL];
    int ui[SL];
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      ud[s] = __shfl_up_sync(kFull, d[s], 1, 16);
      ui[s] = __shfl_up_sync(kFull, i[s], 1, 16);
    }
#pragma unroll
    for (int s = 1; s < SL; ++s) {  // entry 16 s - 1 is lane 15, slot s - 1
      const float ld = __shfl_sync(kFull, d[s - 1], 15, 16);
      const int li = __shfl_sync(kFull, i[s - 1], 15, 16);
      if (hl == 0) {
        ud[s] = ld;
        ui[s] = li;
      }
    }
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      const int j = 16 * s + hl;
      const bool at = ins && j == pos, after = ins && j > pos;
      d[s] = at ? cd : after ? ud[s] : d[s];
      i[s] = at ? ci : after ? ui[s] : i[s];
    }
  }
};

#ifdef KNN_PHASE_CLOCKS
// per thread of block (0, 0): cycles in the copy wait, the barrier, the copy
// issue, the FMAs, the epilogue and the insertion rounds of all its steps
constexpr int kPhases = 6;
__device__ long long knn_phase_cycles[kTileThreads * kPhases];
#define PHASE_START() long long phase_t_ = clock64()
#define PHASE_END(q)                      \
  do {                                    \
    const long long now_ = clock64();     \
    phase_c_[q] += now_ - phase_t_;       \
    phase_t_ = now_;                      \
  } while (0)
#else
#define PHASE_START() \
  do {                \
  } while (0)
#define PHASE_END(q) \
  do {               \
  } while (0)
#endif

template <int KCAP>
__global__ void __launch_bounds__(kTileThreads, 1)
    knn_tile_kernel(const __grid_constant__ CUtensorMap train_map,
                    const float* __restrict__ x,
                    const float* __restrict__ tsq, int* __restrict__ out,
                    float* __restrict__ sd, int* __restrict__ si, int64_t n,
                    int d, int dpad, int ntp, int k, int splits) {
  constexpr int SL = KCAP / 16;
  extern __shared__ __align__(128) float smem[];
  const bool xres = dpad <= kXResMax;
  const int nchunks = dpad / kDK;
  float* xs = smem;
  float* ts = xs + (xres ? dpad * kTM : 2 * kDK * kTM);
  float* tsq_s = ts + 2 * kDK * kTN;
  uint64_t* bars = reinterpret_cast<uint64_t*>(tsq_s + 2 * kTN);
  const float inf = __int_as_float(0x7f800000);

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int half = t & 16;  // this lane's half of the warp: lanes half..+15
  const int64_t i0 = (int64_t)blockIdx.x * kTM;
  const int tiles = ntp / kTN;
  const int tile0 = (int)((int64_t)blockIdx.y * tiles / splits);
  const int tile1 = (int)((int64_t)(blockIdx.y + 1) * tiles / splits);
  const int nsteps = (tile1 - tile0) * nchunks;

  // step s: train tile tile0 + s / nchunks, columns of chunk s % nchunks,
  // into buffer s & 1
  auto issue = [&](int s) {
    const int tile = tile0 + s / nchunks, c = s - (s / nchunks) * nchunks;
    const int b = s & 1, j0 = tile * kTN;
    if (t == 0)
      tma_chunk(ts + b * kDK * kTN, &train_map, j0, c * kDK, &bars[b]);
    if (c == 0 && t < kTN / 4)
      cp_async16(tsq_s + (tile & 1) * kTN + 4 * t, tsq + j0 + 4 * t);
    if (!xres) {
      float* xdst = xs + b * kDK * kTM;
      for (int e = t; e < kDK * kTM; e += kTileThreads) {
        const int f = e / kTM, i = e - f * kTM, col = c * kDK + f;
        const bool ok = i0 + i < n && col < d;
        cp_async4(xdst + e, ok ? x + (i0 + i) * d + col : x, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  if (t == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (nsteps > 0) issue(0);
  if (xres) {
    for (int e = t; e < dpad * kTM; e += kTileThreads) {
      const int f = e / kTM, i = e - f * kTM;
      xs[e] = (i0 + i < n && f < d) ? x[(i0 + i) * d + f] : 0.f;
    }
  }

  // rows p of this thread: (p < 4 ? 0 : 64) + ty * 4 + p % 4, shared with
  // the 15 other lanes of its half-warp; their lists and k-th distances
  HalfList<SL> list[8];
  float kth[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      list[p].d[s] = inf;
      list[p].i[s] = 0;
    }
    kth[p] = inf;
  }
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;

#ifdef KNN_PHASE_CLOCKS
  long long phase_c_[kPhases] = {0, 0, 0, 0, 0, 0};
#endif
  for (int s = 0; s < nsteps; ++s) {
    PHASE_START();
    mbar_wait(&bars[s & 1], (s >> 1) & 1);
    cp_async_wait_all();
    PHASE_END(0);
    __syncthreads();  // step s is in shared memory; step s - 1 is read
    PHASE_END(1);
    if (s + 1 < nsteps) issue(s + 1);  // in flight during these FMAs
    PHASE_END(2);
    const int c = s % nchunks, b = s & 1;
    const float* xc = xs + (xres ? c : b) * kDK * kTM;
    const float* tc = ts + b * kDK * kTN;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(xc + kk * kTM + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(xc + kk * kTM + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(tc + kk * kTN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(tc + kk * kTN + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p], bb[q], acc[p][q]);
    }
    PHASE_END(3);
    if (c != nchunks - 1) continue;
#ifdef KNN_NO_SELECTION
    {  // the distance tiles alone: fold the dots into a sink
      float z = 0.f;
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          z += acc[p][q];
          acc[p][q] = 0.f;
        }
      if (z == 1234.5f) out[0] = 7;
      continue;
    }
#endif

    // the tile is done: distances, then the survivors into the lists
    const int tile = tile0 + s / nchunks, j0 = tile * kTN;
    const float* tq = tsq_s + (tile & 1) * kTN;
    const float4 q0 = *reinterpret_cast<const float4*>(tq + tx * 4);
    const float4 q1 = *reinterpret_cast<const float4*>(tq + 64 + tx * 4);
    const float tn[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    bool filling = false;
#pragma unroll
    for (int p = 0; p < 8; ++p) {
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(-2.f, acc[p][q], tn[q]);
      filling |= kth[p] == inf;
    }
    // row p's survivors: bit q of byte p % 4 of keep[p / 4]
    unsigned keep[2] = {0u, 0u};
    if (__any_sync(kFull, filling) && k <= 16) {
      // a list is not full yet: drop what lies above the k-th smallest of
      // the half-warp's 16 lane minima (ties by lane)
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const float lo = row_min(acc[p]);
        int rank = 0;
#pragma unroll
        for (int l = 0; l < 16; ++l) {
          const float o = __shfl_sync(kFull, lo, l, 16);
          rank += (o < lo) || (o == lo && l < tx);
        }
        const unsigned at =
            (__ballot_sync(kFull, rank == k - 1) >> half) & 0xffffu;
        const float bound = __shfl_sync(kFull, lo, __ffs(at) - 1, 16);
        unsigned m = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          m |= (unsigned)(acc[p][q] < kth[p] && acc[p][q] <= bound) << q;
        keep[p >> 2] |= m << (8 * (p & 3));
      }
    } else {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        if (row_min(acc[p]) < kth[p]) {  // rare once the lists are full
          unsigned m = 0;
#pragma unroll
          for (int q = 0; q < 8; ++q) m |= (unsigned)(acc[p][q] < kth[p]) << q;
          keep[p >> 2] |= m << (8 * (p & 3));
        }
      }
    }
    PHASE_END(4);
    // the survivors into the lists, a round at a time: a round inserts the
    // next survivor of each of the half-warp's 8 rows, the rows' shuffles
    // independent of each other; columns g * 64 + lane * 4 + q % 4 (g = q
    // / 4) ascend by g, then lane, then q
    while (__any_sync(kFull, (keep[0] | keep[1]) != 0)) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int sh = 8 * (p & 3);
        const unsigned row = (keep[p >> 2] >> sh) & 0xffu;
        const unsigned lo_all = __ballot_sync(kFull, row & 15u);
        const unsigned hi_all = __ballot_sync(kFull, row >> 4);
        if (!(lo_all | hi_all)) continue;  // row p has none in either half
        const unsigned lo4 = (lo_all >> half) & 0xffffu;
        const unsigned hi4 = (hi_all >> half) & 0xffffu;
        const unsigned lanes = lo4 ? lo4 : hi4;
        const int src = lanes ? __ffs(lanes) - 1 : 0;
        const unsigned mine = lo4 ? row & 15u : row;
        const int q = mine ? __ffs(mine) - 1 : 0;
        float mv = acc[p][0];
#pragma unroll
        for (int r = 1; r < 8; ++r) mv = q == r ? acc[p][r] : mv;
        const float cd = __shfl_sync(kFull, mv, src, 16);
        const int cq = __shfl_sync(kFull, q, src, 16);
        if (lanes && tx == src) keep[p >> 2] &= ~(1u << (sh + q));
        list[p].insert(lanes != 0 && cd < kth[p], cd,
                       j0 + (cq & 4) * 16 + 4 * src + (cq & 3), tx, half);
        kth[p] = list[p].kth(k);
      }
    }
    PHASE_END(5);
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  }
#ifdef KNN_PHASE_CLOCKS
  if (blockIdx.x == 0 && blockIdx.y == 0)
    for (int q = 0; q < kPhases; ++q)
      knn_phase_cycles[t * kPhases + q] = phase_c_[q];
#endif

  // each lane writes its entries of its 8 rows
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int64_t row = i0 + (p < 4 ? 0 : 64) + ty * 4 + (p & 3);
    if (row >= n) continue;
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      const int j = 16 * s + tx;
      if (j >= k) continue;
      if (splits == 1) {
        out[row * k + j] = list[p].i[s];
      } else {
        const int64_t at = ((int64_t)blockIdx.y * n + row) * k + j;
        sd[at] = list[p].d[s];
        si[at] = list[p].i[s];
      }
    }
  }
}

constexpr int kMergeThreads = 128;

// One thread per test row: the splits' sorted lists, (splits, n, k), merged
// in split order into the row's k indices.
template <int KCAP>
__global__ void __launch_bounds__(kMergeThreads)
    knn_merge_kernel(const float* __restrict__ sd,
                     const int* __restrict__ si, int* __restrict__ out,
                     int64_t n, int k, int splits) {
  const int64_t row = (int64_t)blockIdx.x * kMergeThreads + threadIdx.x;
  if (row >= n) return;
  float bd[KCAP];
  int bi[KCAP];
#pragma unroll
  for (int q = 0; q < KCAP; ++q) {
    bd[q] = q < k ? sd[row * k + q] : __int_as_float(0x7f800000);
    bi[q] = q < k ? si[row * k + q] : 0;
  }
  float kth = __int_as_float(0x7f800000);
#pragma unroll
  for (int q = 0; q < KCAP; ++q)
    if (q == k - 1) kth = bd[q];
  for (int s = 1; s < splits; ++s) {
    const int64_t base = ((int64_t)s * n + row) * k;
    for (int q = 0; q < k; ++q) {
      const float dist = sd[base + q];
      if (!(dist < kth)) break;  // the split's list is sorted: none after
      insert_sorted<KCAP>(bd, bi, kth, k, dist, si[base + q]);
    }
  }
#pragma unroll
  for (int q = 0; q < KCAP; ++q)
    if (q < k) out[row * k + q] = bi[q];
}


template <int KCAP>
cudaError_t launch_tiled(const CUtensorMap& train_map, const float* x,
                         const float* tsq, int* out, float* scratch,
                         int64_t n, int d, int dpad, int ntp, int k,
                         int splits, cudaStream_t stream) {
  const int smem = (int)tile_smem_bytes(dpad);
  cudaError_t e = cudaFuncSetAttribute(
      knn_tile_kernel<KCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  float* sd = splits > 1 ? scratch : nullptr;
  int* si = splits > 1 ? reinterpret_cast<int*>(scratch + splits * n * k)
                       : nullptr;
  const dim3 grid((unsigned)((n + kTM - 1) / kTM), (unsigned)splits);
  knn_tile_kernel<KCAP><<<grid, kTileThreads, smem, stream>>>(
      train_map, x, tsq, out, sd, si, n, d, dpad, ntp, k, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  knn_merge_kernel<KCAP><<<(unsigned)((n + kMergeThreads - 1) /
                                      kMergeThreads),
                           kMergeThreads, 0, stream>>>(sd, si, out, n, k,
                                                       splits);
  return cudaGetLastError();
}

// -- long-list kernel (32 < k <= 128) ---------------------------------------

constexpr int kLongPad = 4;  // floats after each row's list and buffer
constexpr int kNoIndex = 0x7fffffff;  // index of an empty list entry
constexpr int64_t kSmemBlockMax = 232448;  // dynamic shared memory a block may use

// Test rows a thread scores and a block holds: the tiled kernel's 8 and 128
// for lists of up to 64 entries; longer lists of 128 rows with their
// buffers would not fit a block's shared memory, so those instances score
// 64 rows a block, 4 a thread, against the same 128-row train tiles.
__host__ __device__ constexpr int long_rows_per_thread(int kcap) {
  return kcap <= 64 ? 8 : 4;
}
__host__ __device__ constexpr int long_tile_rows(int kcap) {
  return 16 * long_rows_per_thread(kcap);
}
// Keys a row's buffer holds before they are merged into its list: 32 for
// lists of up to 64 entries, 64 for longer ones, whose merges cost more a
// list entry (scripts/port_knn_phases.py times the phases).
__host__ __device__ constexpr int long_buffer(int kcap) {
  return kcap <= 64 ? 32 : 64;
}

__host__ __device__ constexpr int64_t long_smem_bytes_for(int kcap, int dpad,
                                                          bool xres) {
  return 4 * ((int64_t)(xres ? dpad * long_tile_rows(kcap)
                             : 2 * kDK * long_tile_rows(kcap)) +
              2 * kDK * kTN + 2 * kTN) +
         8 * (int64_t)long_tile_rows(kcap) *
             (kcap + long_buffer(kcap) + 2 * kLongPad) +
         16;  // two mbarriers
}

// The x tile stays resident where it and the lists fit beside the train
// chunks; else it streams beside them, as in the tiled kernel past kXResMax.
__host__ __device__ constexpr bool long_x_resident(int kcap, int dpad) {
  return dpad <= kXResMax &&
         long_smem_bytes_for(kcap, dpad, true) <= kSmemBlockMax;
}

__host__ __device__ constexpr int64_t long_smem_bytes(int kcap, int dpad) {
  return long_smem_bytes_for(kcap, dpad, long_x_resident(kcap, dpad));
}

// Key order: distance, then train index. Every list is the k smallest keys
// it has seen, in key order, so the order in which candidates or lists
// arrive cannot change it.
__device__ __forceinline__ bool key_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

struct Key {
  float d;
  int i;
};

// Merges one row's buffer of nb keys (bd, bi; nb <= CB, in no order) into
// its sorted list of k keys (rd, ri), keeping the k smallest, and returns
// the new k-th key. The 16 lanes of the half-warp that owns the
// row call it together (lane hl of the half-warp; every lane of the warp
// calls it at once, for its half's own row): the buffer is sorted by a
// bitonic network over 16 lanes (CB / 16 keys a lane, empty keys last),
// written back, then each lane finds by binary search (merge path) how many
// of the outputs before its own ceil(k / 16) come from the list, merges its
// outputs in registers and writes them once every lane has read.
template <int KCAP, int CB>
__device__ __forceinline__ Key long_merge(float* rd, int* ri, float* bd,
                                          int* bi, int nb, int k, int hl) {
  constexpr int EL = CB / 16, PER = KCAP / 16;
  const float inf = __int_as_float(0x7f800000);
  __syncwarp();  // the lanes' appends to the buffer are visible
  float ed[EL];
  int ei[EL];
#pragma unroll
  for (int s = 0; s < EL; ++s) {
    const int i = 16 * s + hl;
    ed[s] = i < nb ? bd[i] : inf;
    ei[s] = i < nb ? bi[i] : kNoIndex;
  }
  // key 16 s + hl of the network in slot s of lane hl
#pragma unroll
  for (int size = 2; size <= CB; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      float nd[EL];
      int ni[EL];
#pragma unroll
      for (int s = 0; s < EL; ++s) {
        const int i = 16 * s + hl;
        float od;
        int oi;
        if (stride >= 16) {  // slot s ^ (stride / 16) of this lane
          od = ed[(s ^ (stride >> 4)) & (EL - 1)];
          oi = ei[(s ^ (stride >> 4)) & (EL - 1)];
        } else {
          od = __shfl_xor_sync(kFull, ed[s], stride, 16);
          oi = __shfl_xor_sync(kFull, ei[s], stride, 16);
        }
        // the lower key of a pair keeps the smaller where its run ascends
        const bool want_min = ((i & stride) == 0) == ((i & size) == 0);
        const bool take = want_min ? key_less(od, oi, ed[s], ei[s])
                                   : key_less(ed[s], ei[s], od, oi);
        nd[s] = take ? od : ed[s];
        ni[s] = take ? oi : ei[s];
      }
#pragma unroll
      for (int s = 0; s < EL; ++s) {
        ed[s] = nd[s];
        ei[s] = ni[s];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < EL; ++s) {
    bd[16 * s + hl] = ed[s];
    bi[16 * s + hl] = ei[s];
  }
  __syncwarp();
  // outputs [o0, o1) of this lane; the list wins equal keys (only empty
  // ones are equal)
  const int per = (k + 15) / 16;
  const int o0 = min(k, hl * per), o1 = min(k, o0 + per);
  int lo = max(0, o0 - nb), hi = o0;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!key_less(bd[o0 - 1 - mid], bi[o0 - 1 - mid], rd[mid], ri[mid]))
      lo = mid + 1;
    else
      hi = mid;
  }
  int ia = lo, ib = o0 - lo;  // ia stays below k: o1 <= k outputs
  float od[PER];
  int oi[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    if (o0 + e < o1) {
      const bool from_a =
          ib >= nb || !key_less(bd[ib], bi[ib], rd[ia], ri[ia]);
      od[e] = from_a ? rd[ia] : bd[ib];
      oi[e] = from_a ? ri[ia] : bi[ib];
      ia += from_a;
      ib += !from_a;
    }
  }
  __syncwarp();  // every lane has read the old list
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    if (o0 + e < o1) {
      rd[o0 + e] = od[e];
      ri[o0 + e] = oi[e];
    }
  }
  __syncwarp();
  return Key{rd[k - 1], ri[k - 1]};
}

// knn_long_kernel<KCAP>: 32 < k <= KCAP (64 or 128). The tiled
// kernel's engine: blocks of (test tile, train split), train chunks of 32 x
// 128 by TMA on an mbarrier into a double buffer, the next one in flight
// while the FMAs run, PM x 8 dots a thread in registers (test rows p of a
// thread: (p / 4) * 64 + ty * 4 + p % 4; train rows tx * 4 + {0..3} and 64
// + tx * 4 + {0..3}; PM = 8, 128 x 128 tiles, for lists of up to 64, PM =
// 4 and 64 x 128 tiles for longer ones), one fma chain per dot in column
// order. What differs is the list: each test row's sorted list of k keys
// lives in shared memory beside a buffer of CB keys (long_buffer), both
// owned by the 16 lanes of the half-warp that holds the row's candidates;
// each lane keeps its rows' k-th keys and buffer counts in registers.
// After a tile, the candidates below a row's k-th key (every one on a
// split's first tiles, a handful a row once the lists are full) go to its
// buffer a column of the tile at a time (at most 16 keys: a ballot gives
// each its slot). Where a column's keys would overflow the buffer of
// either half's row, both rows' buffers are merged into their lists
// (long_merge), the rest of the row's keys are held against the lowered
// k-th keys, and appended. So a key costs a few instructions and a merge
// handles up to CB of them, where inserting keys one at a time into a list
// of up to 128 cost a pass over the list each. The rows and columns with
// keys are walked in loops, not unrolled, and the merge has one call site
// in the tile loop: unrolled over every (row, column), the kernel's code
// outgrew the instruction cache and every phase of the tile loop ran two
// to six times slower (scripts/port_knn_phases.py). Shared memory, in this
// order: the tiled kernel's x tile, train chunks and norms; the lists
// ([TM][KCAP + kLongPad] distances, then as many indices); the buffers
// ([TM][CB + kLongPad], the same); two mbarriers. The pads put the rows of
// a warp's two halves (4 apart) 16 banks apart. Train rows past nt (the
// padding) are no candidates. With one split the lanes write the indices;
// with more, each (test tile, split) writes its list to a (splits, n, k)
// scratch and knn_long_merge_kernel<KCAP> merges them; a split holding
// fewer than k rows leaves empty keys (+inf, kNoIndex) that never outrank
// a real one. Built with -DKNN_PHASE_CLOCKS or -DKNN_NO_SELECTION, it
// keeps phase cycles or skips selection as the tiled kernel does.
template <int KCAP>
__global__ void __launch_bounds__(kTileThreads, 1)
    knn_long_kernel(const __grid_constant__ CUtensorMap train_map,
                    const float* __restrict__ x,
                    const float* __restrict__ tsq, int* __restrict__ out,
                    float* __restrict__ sd, int* __restrict__ si, int64_t n,
                    int d, int dpad, int ntp, int nt, int k, int splits) {
  constexpr int PM = long_rows_per_thread(KCAP), TM = long_tile_rows(KCAP);
  constexpr int CB = long_buffer(KCAP);
  constexpr int LS = KCAP + kLongPad, BS = CB + kLongPad, SL = KCAP / 16;
  extern __shared__ __align__(128) float smem[];
  const bool xres = long_x_resident(KCAP, dpad);
  const int nchunks = dpad / kDK;
  float* xs = smem;
  float* ts = xs + (xres ? dpad * TM : 2 * kDK * TM);
  float* tsq_s = ts + 2 * kDK * kTN;
  float* ld = tsq_s + 2 * kTN;
  int* li = reinterpret_cast<int*>(ld + TM * LS);
  float* bd = reinterpret_cast<float*>(li + TM * LS);
  int* bi = reinterpret_cast<int*>(bd + TM * BS);
  uint64_t* bars = reinterpret_cast<uint64_t*>(bi + TM * BS);
  const float inf = __int_as_float(0x7f800000);

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int half = t & 16;
  const int64_t i0 = (int64_t)blockIdx.x * TM;
  const int tiles = ntp / kTN;
  const int tile0 = (int)((int64_t)blockIdx.y * tiles / splits);
  const int tile1 = (int)((int64_t)(blockIdx.y + 1) * tiles / splits);
  const int nsteps = (tile1 - tile0) * nchunks;

  auto issue = [&](int s) {
    const int tile = tile0 + s / nchunks, c = s - (s / nchunks) * nchunks;
    const int b = s & 1, j0 = tile * kTN;
    if (t == 0)
      tma_chunk(ts + b * kDK * kTN, &train_map, j0, c * kDK, &bars[b]);
    if (c == 0 && t < kTN / 4)
      cp_async16(tsq_s + (tile & 1) * kTN + 4 * t, tsq + j0 + 4 * t);
    if (!xres) {
      float* xdst = xs + b * kDK * TM;
      for (int e = t; e < kDK * TM; e += kTileThreads) {
        const int f = e / TM, i = e - f * TM, col = c * kDK + f;
        const bool ok = i0 + i < n && col < d;
        cp_async4(xdst + e, ok ? x + (i0 + i) * d + col : x, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  if (t == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = t; e < TM * LS; e += kTileThreads) {
    ld[e] = inf;
    li[e] = kNoIndex;
  }
  __syncthreads();
  if (nsteps > 0) issue(0);
  if (xres) {
    for (int e = t; e < dpad * TM; e += kTileThreads) {
      const int f = e / TM, i = e - f * TM;
      xs[e] = (i0 + i < n && f < d) ? x[(i0 + i) * d + f] : 0.f;
    }
  }

  float kd[PM];  // the k-th key of each of this thread's rows
  int ki[PM];
  int nb[PM];  // the keys in each row's buffer
#pragma unroll
  for (int p = 0; p < PM; ++p) {
    kd[p] = inf;
    ki[p] = kNoIndex;
    nb[p] = 0;
  }
  float acc[PM][8];
#pragma unroll
  for (int p = 0; p < PM; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;

#ifdef KNN_PHASE_CLOCKS
  long long phase_c_[kPhases] = {0, 0, 0, 0, 0, 0};
#endif
  for (int s = 0; s < nsteps; ++s) {
    PHASE_START();
    mbar_wait(&bars[s & 1], (s >> 1) & 1);
    cp_async_wait_all();
    PHASE_END(0);
    __syncthreads();  // step s is in shared memory; step s - 1 is read
    PHASE_END(1);
    if (s + 1 < nsteps) issue(s + 1);  // in flight during these FMAs
    PHASE_END(2);
    const int c = s % nchunks, b = s & 1;
    const float* xc = xs + (xres ? c : b) * kDK * TM;
    const float* tc = ts + b * kDK * kTN;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      float a[PM];
      const float4 a0 = *reinterpret_cast<const float4*>(xc + kk * TM + ty * 4);
      a[0] = a0.x;
      a[1] = a0.y;
      a[2] = a0.z;
      a[3] = a0.w;
      if constexpr (PM == 8) {
        const float4 a1 =
            *reinterpret_cast<const float4*>(xc + kk * TM + 64 + ty * 4);
        a[4] = a1.x;
        a[5] = a1.y;
        a[6] = a1.z;
        a[7] = a1.w;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(tc + kk * kTN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(tc + kk * kTN + 64 + tx * 4);
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int p = 0; p < PM; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p], bb[q], acc[p][q]);
    }
    PHASE_END(3);
    if (c != nchunks - 1) continue;
#ifdef KNN_NO_SELECTION
    {  // the distance tiles alone: fold the dots into a sink
      float z = 0.f;
#pragma unroll
      for (int p = 0; p < PM; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          z += acc[p][q];
          acc[p][q] = 0.f;
        }
      if (z == 1234.5f) out[0] = 7;
      continue;
    }
#endif

    // the tile is done: distances, then the keys below each row's k-th
    // into its buffer
    const int tile = tile0 + s / nchunks, j0 = tile * kTN;
    const float* tq = tsq_s + (tile & 1) * kTN;
    const float4 q0 = *reinterpret_cast<const float4*>(tq + tx * 4);
    const float4 q1 = *reinterpret_cast<const float4*>(tq + 64 + tx * 4);
    const float tn[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
    // row p's keys below its k-th: bit q of byte p % 4 of keep[p / 4];
    // column q of this lane is train row j0 + (q & 4) * 16 + 4 * tx + (q &
    // 3). One warp reduction finds the rows with keys in either half; their
    // keys go to the row's buffer a column at a time, while it has room,
    // and a row whose column does not fit keeps the rest in keep, for the
    // merge below.
    unsigned keep[PM / 4], rows = 0, pending = 0;
#pragma unroll
    for (int h = 0; h < PM / 4; ++h) keep[h] = 0u;
#pragma unroll
    for (int p = 0; p < PM; ++p) {
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(-2.f, acc[p][q], tn[q]);
      unsigned m = 0;
      if (row_min(acc[p]) <= kd[p]) {  // rare once the lists are full
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = j0 + (q & 4) * 16 + 4 * tx + (q & 3);
          m |= (unsigned)(j < nt && key_less(acc[p][q], j, kd[p], ki[p])) << q;
        }
      }
      keep[p >> 2] |= m << (8 * (p & 3));
      rows |= (unsigned)(m != 0) << p;
    }
    rows = __reduce_or_sync(kFull, rows);  // rows with keys in either half
#pragma unroll
    for (int p = 0; p < PM; ++p) {
      if (!((rows >> p) & 1u)) continue;
      unsigned m = (keep[p >> 2] >> (8 * (p & 3))) & 0xffu;
      // the columns with keys of row p in either half, in a loop (one copy
      // of its code a row keeps the kernel in the instruction cache)
      unsigned cols = __reduce_or_sync(kFull, m);
      const int rl = (p >> 2) * 64 + ty * 4 + (p & 3);
      while (cols) {
        const int q = __ffs(cols) - 1;
        cols &= cols - 1;
        const bool in = (m >> q) & 1u;
        const unsigned mine = (__ballot_sync(kFull, in) >> half) & 0xffffu;
        if (__any_sync(kFull, nb[p] + __popc(mine) > CB)) break;
        if (in) {
          float val = acc[p][0];
#pragma unroll
          for (int r = 1; r < 8; ++r) val = q == r ? acc[p][r] : val;
          const int at = rl * BS + nb[p] + __popc(mine & ((1u << tx) - 1u));
          bd[at] = val;
          bi[at] = j0 + (q & 4) * 16 + 4 * tx + (q & 3);
        }
        nb[p] += __popc(mine);
        m &= ~(1u << q);
      }
      keep[p >> 2] = (keep[p >> 2] & ~(0xffu << (8 * (p & 3)))) |
                     (m << (8 * (p & 3)));
      pending |= (unsigned)(m != 0) << p;
    }
    pending = __reduce_or_sync(kFull, pending);
    PHASE_END(4);
    // rows whose buffer filled (every row on a split's first tiles, rare
    // after): merge, hold the rest of the keys against the new k-th, append
    // them, and again while they do not fit; a loop over the rows, so that
    // one copy of the merge keeps the kernel in the instruction cache
    while (pending) {
      const int p = __ffs(pending) - 1;
      pending &= pending - 1;
      float v[8], rkd = kd[0];
      int rki = ki[0], rnb = nb[0];
      unsigned mm = keep[0] & 0xffu;
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = acc[0][q];
#pragma unroll
      for (int r = 1; r < PM; ++r) {
        if (p == r) {
#pragma unroll
          for (int q = 0; q < 8; ++q) v[q] = acc[r][q];
          rkd = kd[r];
          rki = ki[r];
          rnb = nb[r];
          mm = (keep[r >> 2] >> (8 * (r & 3))) & 0xffu;
        }
      }
      const int rl = (p >> 2) * 64 + ty * 4 + (p & 3);
      for (;;) {
        const Key kth = long_merge<KCAP, CB>(ld + rl * LS, li + rl * LS,
                                             bd + rl * BS, bi + rl * BS, rnb,
                                             k, tx);
        rkd = kth.d;
        rki = kth.i;
        rnb = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = j0 + (q & 4) * 16 + 4 * tx + (q & 3);
          if (!key_less(v[q], j, rkd, rki)) mm &= ~(1u << q);
        }
        const unsigned cols = __reduce_or_sync(kFull, mm);
        bool full = false;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (!((cols >> q) & 1u)) continue;
          const bool in = (mm >> q) & 1u;
          const unsigned mine = (__ballot_sync(kFull, in) >> half) & 0xffffu;
          if (__any_sync(kFull, rnb + __popc(mine) > CB)) {
            full = true;
            break;
          }
          if (in) {
            const int at = rl * BS + rnb + __popc(mine & ((1u << tx) - 1u));
            bd[at] = v[q];
            bi[at] = j0 + (q & 4) * 16 + 4 * tx + (q & 3);
          }
          rnb += __popc(mine);
          mm &= ~(1u << q);
        }
        if (!full) break;  // the same in every lane
      }
#pragma unroll
      for (int r = 0; r < PM; ++r) {
        if (p == r) {
          kd[r] = rkd;
          ki[r] = rki;
          nb[r] = rnb;
        }
      }
    }
    PHASE_END(5);
#pragma unroll
    for (int p = 0; p < PM; ++p)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;
  }
#ifdef KNN_PHASE_CLOCKS
  if (blockIdx.x == 0 && blockIdx.y == 0)
    for (int q = 0; q < kPhases; ++q)
      knn_phase_cycles[t * kPhases + q] = phase_c_[q];
#endif
  // what the buffers still hold
  unsigned rows = 0;
#pragma unroll
  for (int p = 0; p < PM; ++p) rows |= (unsigned)(nb[p] > 0) << p;
  rows = __reduce_or_sync(kFull, rows);
  while (rows) {
    const int p = __ffs(rows) - 1;
    rows &= rows - 1;
    int rnb = nb[0];
#pragma unroll
    for (int r = 1; r < PM; ++r) rnb = p == r ? nb[r] : rnb;
    const int rl = (p >> 2) * 64 + ty * 4 + (p & 3);
    long_merge<KCAP, CB>(ld + rl * LS, li + rl * LS, bd + rl * BS,
                         bi + rl * BS, rnb, k, tx);
  }

  // each lane writes its entries of its rows
#pragma unroll
  for (int p = 0; p < PM; ++p) {
    const int rl = (p >> 2) * 64 + ty * 4 + (p & 3);
    const int64_t row = i0 + rl;
    if (row >= n) continue;
#pragma unroll
    for (int s = 0; s < SL; ++s) {
      const int j = 16 * s + tx;
      if (j >= k) continue;
      if (splits == 1) {
        out[row * k + j] = li[rl * LS + j];
      } else {
        const int64_t at = ((int64_t)blockIdx.y * n + row) * k + j;
        sd[at] = ld[rl * LS + j];
        si[at] = li[rl * LS + j];
      }
    }
  }
}

constexpr int kLongMergeWarps = 4;  // rows of a merge block, a warp each

// Each row's splits' sorted lists of k keys, (splits, n, k), folded in split
// order into the row's k smallest keys: a warp per row, each fold a
// merge-path merge of two sorted lists of which the first k keys are kept
// (lane l writes outputs [l * ceil(k / 32), ...) after a binary search for
// how many of the outputs before them come from each list).
template <int KCAP>
__global__ void __launch_bounds__(32 * kLongMergeWarps)
    knn_long_merge_kernel(const float* __restrict__ sd,
                          const int* __restrict__ si, int* __restrict__ out,
                          int64_t n, int k, int splits) {
  __shared__ float md[kLongMergeWarps][3][KCAP];
  __shared__ int mi[kLongMergeWarps][3][KCAP];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * kLongMergeWarps + warp;
  if (row >= n) return;  // the whole warp
  int a = 0, c = 2;  // the kept list and the fold's output; 1 the split's
  for (int j = lane; j < k; j += 32) {
    md[warp][0][j] = sd[row * k + j];
    mi[warp][0][j] = si[row * k + j];
  }
  const int per = (k + 31) / 32;
  const int o0 = min(k, lane * per), o1 = min(k, o0 + per);
  for (int s = 1; s < splits; ++s) {
    const int64_t base = ((int64_t)s * n + row) * k;
    for (int j = lane; j < k; j += 32) {
      md[warp][1][j] = sd[base + j];
      mi[warp][1][j] = si[base + j];
    }
    __syncwarp();
    const float* ad = md[warp][a];
    const int* ai = mi[warp][a];
    const float* bd = md[warp][1];
    const int* bi = mi[warp][1];
    // how many of the first o0 outputs come from the kept list (which wins
    // equal keys: only empty ones are equal)
    int lo = 0, hi = o0;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (!key_less(bd[o0 - 1 - mid], bi[o0 - 1 - mid], ad[mid], ai[mid]))
        lo = mid + 1;
      else
        hi = mid;
    }
    int ia = lo, ib = o0 - lo;  // both stay below k: o1 <= k outputs
    for (int o = o0; o < o1; ++o) {
      const bool from_a = !key_less(bd[ib], bi[ib], ad[ia], ai[ia]);
      md[warp][c][o] = from_a ? ad[ia] : bd[ib];
      mi[warp][c][o] = from_a ? ai[ia] : bi[ib];
      if (from_a)
        ++ia;
      else
        ++ib;
    }
    __syncwarp();
    const int tmp = a;
    a = c;
    c = tmp;
  }
  for (int j = lane; j < k; j += 32) out[row * k + j] = mi[warp][a][j];
}

template <int KCAP>
cudaError_t launch_long(const CUtensorMap& train_map, const float* x,
                        const float* tsq, int* out, float* scratch, int64_t n,
                        int d, int dpad, int ntp, int nt, int k, int splits,
                        cudaStream_t stream) {
  const int smem = (int)long_smem_bytes(KCAP, dpad);
  cudaError_t e = cudaFuncSetAttribute(
      knn_long_kernel<KCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  float* sd = splits > 1 ? scratch : nullptr;
  int* si = splits > 1 ? reinterpret_cast<int*>(scratch + splits * n * k)
                       : nullptr;
  constexpr int TM = long_tile_rows(KCAP);
  const dim3 grid((unsigned)((n + TM - 1) / TM), (unsigned)splits);
  knn_long_kernel<KCAP><<<grid, kTileThreads, smem, stream>>>(
      train_map, x, tsq, out, sd, si, n, d, dpad, ntp, nt, k, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  knn_long_merge_kernel<KCAP>
      <<<(unsigned)((n + kLongMergeWarps - 1) / kLongMergeWarps),
         32 * kLongMergeWarps, 0, stream>>>(sd, si, out, n, k, splits);
  return cudaGetLastError();
}

const void* long_kernel_of(int kcap) {
  switch (kcap) {
    case 64: return (const void*)knn_long_kernel<64>;
    case 128: return (const void*)knn_long_kernel<128>;
    default: return nullptr;
  }
}

// -- long lists: distance keys, radix select, compaction, sort -----------
//
// knn_key_tile_kernel: the tiled kernel's engine (blocks of (test tile,
// train split), TMA train chunks into a double buffer, 8 x 8 dots a thread,
// one fma chain per dot in column order, fmaf(-2, dot, tsq)), so its
// distances have the bits of the other instances; it selects nothing, and
// writes each finished tile's distances as order-preserving uint32 keys
// into a (rows, ntp) scratch, a uint4 a thread and row (a half-warp's 16
// stores are 256 contiguous bytes). -0 is made +0 first, so the two tie as
// the float compare does.
//
// knn_select_kernel: one block of kSelThreads per test row, over its nt
// keys in the scratch (warp w takes a contiguous segment of them):
// - a threshold from a sample: kSample keys of the row (kSampleRuns runs
//   of 32, spread over it; the whole row where it is no longer), and the
//   key tau of rank sel_sample_rank among them, by the radix select below;
// - candidates: one pass over the row, each warp writing the keys at or
//   below tau of its segment, with their indices, to its own region of
//   cap_w pairs in shared memory, in index order (a ballot places them).
//   Where at least k keys are candidates and no region overflowed, the k
//   smallest keys and every key equal to the k-th are among them, so the
//   steps below run over the candidates; else over the whole row (the
//   exact route, only slower). cap_w = 0 (set where the regions would not
//   fit) takes the whole row always;
// - radix select: four passes of an 8-bit digit, most significant first,
//   each a histogram of the digit over the keys that share the prefix
//   chosen so far. Each warp counts its keys into its own row of counters,
//   32 keys at a time: __match_any_sync groups the batch's equal digits
//   and the lowest lane of a group adds its size, so no two lanes write one
//   counter and there are no atomics. The bin that holds the k-th key
//   extends the prefix. After four passes the prefix is the k-th smallest
//   key K, and `need` of the keys equal to K belong to the list (the first
//   ones by train index);
// - compaction: the keys below K and the first `need` keys equal to K, in
//   ascending train index (two sweeps of ballots: each warp's counts, then
//   the places), k (key, index) pairs;
// - a stable LSD radix sort of the pairs by key, 8 bits a pass, counted
//   the same way (a pass whose digit is one value for all k is skipped):
//   equal keys keep ascending index, the order of lax.top_k.
// The pairs live in shared memory where they fit (the sort's second
// buffer in the candidates' place), else in a (rows, 4, k) part of the
// scratch. ops/kernels.py `knn_select_layout` mirrors sel_smem_bytes and
// sizes cap_w, and `knn_radix_plan` cuts the test rows into chunks whose
// scratch stays under a fixed cap; knn_topk_radix launches both kernels
// for each chunk.
//
// What bounds it on an H100: the distances' fp32 operations (2 n nt d) and
// the keys' bytes, written once and read once (4 n nt each way); the
// selection reads each key once and touches a few candidates a row.

constexpr int kSelWarps = 16;
constexpr int kSelThreads = 32 * kSelWarps;
constexpr int kRadixBins = 256;
// shared ints before the pairs: the warps' counters, then kSelMisc slots
// (warp sums of the scans, the warps' counts, the chosen bin)
constexpr int kSelMisc = 64;
constexpr int kSelHead = kSelWarps * kRadixBins + kSelMisc;
constexpr int kSampleRuns = 64;
constexpr int kSample = 32 * kSampleRuns;

// The rank in the sample of the candidates' threshold: k where the sample
// is the row; else twice the sample's share of k, and 32 more, so that
// about 2 k + 32 nt / kSample keys of the row lie at or below it.
__host__ __device__ constexpr int sel_sample_rank(int nt, int k) {
  return nt <= kSample
             ? k
             : (2 * (int)(((int64_t)k * kSample + nt - 1) / nt) + 32 <
                        kSample
                    ? 2 * (int)(((int64_t)k * kSample + nt - 1) / nt) + 32
                    : kSample);
}

// ints of the region before the first pair buffer: the candidates (two
// ints a pair, cap_w pairs a warp), the sample, the sort's second buffer
__host__ __device__ constexpr int64_t sel_region_ints(int k, int cap_w) {
  return (int64_t)2 * kSelWarps * cap_w > 2 * (int64_t)k
             ? (int64_t)2 * kSelWarps * cap_w
             : 2 * (int64_t)k;
}

// shared memory of a select block: the head, then with candidates their
// region and one buffer of k (key, index) pairs; without, both buffers
// where pairs_smem, else none
__host__ __device__ constexpr int64_t sel_smem_bytes(int k, int cap_w,
                                                     int pairs_smem) {
  return 4 * ((int64_t)kSelHead +
              (cap_w > 0 ? sel_region_ints(k, cap_w) + 2 * (int64_t)k
                         : (pairs_smem ? 4 * (int64_t)k : 0)));
}

__device__ __forceinline__ unsigned dist_key(float v) {
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;  // -0 ties +0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(kTileThreads, 2)
    knn_key_tile_kernel(const __grid_constant__ CUtensorMap train_map,
                        const float* __restrict__ x,
                        const float* __restrict__ tsq,
                        unsigned* __restrict__ keys, int64_t n, int d,
                        int dpad, int ntp, int splits) {
  extern __shared__ __align__(128) float smem[];
  const bool xres = dpad <= kXResMax;
  const int nchunks = dpad / kDK;
  float* xs = smem;
  float* ts = xs + (xres ? dpad * kTM : 2 * kDK * kTM);
  float* tsq_s = ts + 2 * kDK * kTN;
  uint64_t* bars = reinterpret_cast<uint64_t*>(tsq_s + 2 * kTN);

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int64_t i0 = (int64_t)blockIdx.x * kTM;
  const int tiles = ntp / kTN;
  const int tile0 = (int)((int64_t)blockIdx.y * tiles / splits);
  const int tile1 = (int)((int64_t)(blockIdx.y + 1) * tiles / splits);
  const int nsteps = (tile1 - tile0) * nchunks;

  auto issue = [&](int s) {
    const int tile = tile0 + s / nchunks, c = s - (s / nchunks) * nchunks;
    const int b = s & 1, j0 = tile * kTN;
    if (t == 0)
      tma_chunk(ts + b * kDK * kTN, &train_map, j0, c * kDK, &bars[b]);
    if (c == 0 && t < kTN / 4)
      cp_async16(tsq_s + (tile & 1) * kTN + 4 * t, tsq + j0 + 4 * t);
    if (!xres) {
      float* xdst = xs + b * kDK * kTM;
      for (int e = t; e < kDK * kTM; e += kTileThreads) {
        const int f = e / kTM, i = e - f * kTM, col = c * kDK + f;
        const bool ok = i0 + i < n && col < d;
        cp_async4(xdst + e, ok ? x + (i0 + i) * d + col : x, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  if (t == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (nsteps > 0) issue(0);
  if (xres) {
    for (int e = t; e < dpad * kTM; e += kTileThreads) {
      const int f = e / kTM, i = e - f * kTM;
      xs[e] = (i0 + i < n && f < d) ? x[(i0 + i) * d + f] : 0.f;
    }
  }
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[p][q] = 0.f;

  for (int s = 0; s < nsteps; ++s) {
    mbar_wait(&bars[s & 1], (s >> 1) & 1);
    cp_async_wait_all();
    __syncthreads();  // step s is in shared memory; step s - 1 is read
    if (s + 1 < nsteps) issue(s + 1);  // in flight during these FMAs
    const int c = s % nchunks, b = s & 1;
    const float* xc = xs + (xres ? c : b) * kDK * kTM;
    const float* tc = ts + b * kDK * kTN;
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(xc + kk * kTM + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(xc + kk * kTM + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(tc + kk * kTN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(tc + kk * kTN + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p], bb[q], acc[p][q]);
    }
    if (c != nchunks - 1) continue;
    // the tile is done: its keys into the scratch
    const int tile = tile0 + s / nchunks, j0 = tile * kTN;
    const float* tq = tsq_s + (tile & 1) * kTN;
    const float4 q0 = *reinterpret_cast<const float4*>(tq + tx * 4);
    const float4 q1 = *reinterpret_cast<const float4*>(tq + 64 + tx * 4);
    const float tn[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int64_t row = i0 + (p < 4 ? 0 : 64) + ty * 4 + (p & 3);
      unsigned u[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        u[q] = dist_key(fmaf(-2.f, acc[p][q], tn[q]));
        acc[p][q] = 0.f;
      }
      if (row < n) {
        unsigned* dst = keys + row * ntp + j0 + tx * 4;
        *reinterpret_cast<uint4*>(dst) = make_uint4(u[0], u[1], u[2], u[3]);
        *reinterpret_cast<uint4*>(dst + 64) =
            make_uint4(u[4], u[5], u[6], u[7]);
      }
    }
  }
}

// The exclusive prefix of each thread's v over the select block, and the
// block's total; every thread of the block calls it (sums: kSelWarps
// shared ints).
__device__ __forceinline__ int sel_scan(int v, int& total, int* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kSelWarps; ++w) {
    const int s = sums[w];
    before += w < warp ? s : 0;
    total += s;
  }
  __syncthreads();  // sums is free for the next call
  return before + incl - v;
}

#ifdef KNN_PHASE_CLOCKS
// block 0 of the last select launch: cycles from its start to the end of
// the sample's threshold, the candidates, the radix select, the
// compaction, the sort and the output
constexpr int kSelPhases = 6;
__device__ long long knn_select_cycles[kSelPhases];
#define SEL_CLOCK(q)                                              \
  do {                                                            \
    if (blockIdx.x == 0 && threadIdx.x == 0) sel_t_[q] = clock64(); \
  } while (0)
#else
#define SEL_CLOCK(q) \
  do {               \
  } while (0)
#endif

// The warp's counts of the digit (key >> shift) & 255 over its keys wk[0,
// wn) whose bits under `mask` equal `prefix`, into its own counters h
// (zeroed here). A batch of 32 with no such key costs a load and a vote.
__device__ __forceinline__ void count_digits(const unsigned* wk, int wn,
                                             unsigned prefix, unsigned mask,
                                             int shift, int* h, int lane) {
  for (int b = lane; b < kRadixBins; b += 32) h[b] = 0;
  __syncwarp();
  for (int base = 0; base < wn; base += 32) {
    const int j = base + lane;
    const unsigned key = j < wn ? wk[j] : 0u;
    const bool in = j < wn && (key & mask) == prefix;
    if (!__any_sync(kFull, in)) continue;
    const int dig = in ? (int)((key >> shift) & 255u) : kRadixBins;
    const unsigned peers = __match_any_sync(kFull, dig);
    if (in && lane == __ffs(peers) - 1) h[dig] += __popc(peers);
    __syncwarp();
  }
}

// The k-th smallest key over the block's keys (each warp's wk[0, wn)) by
// four radix passes, and in `need` how many of the keys equal to it lie
// among the k smallest. Every thread of the block calls it.
__device__ unsigned radix_kth(const unsigned* wk, int wn, int k, int& need,
                              int* counters, int* misc, int lane) {
  int* h = counters + (threadIdx.x >> 5) * kRadixBins;
  unsigned prefix = 0u, mask = 0u;
  int want = k;  // the rank, among the keys under the prefix, of the k-th
  for (int shift = 24; shift >= 0; shift -= 8) {
    count_digits(wk, wn, prefix, mask, shift, h, lane);
    __syncthreads();
    int cnt = 0;
    if (threadIdx.x < kRadixBins)
      for (int w = 0; w < kSelWarps; ++w)
        cnt += counters[w * kRadixBins + threadIdx.x];
    int total;
    const int before = sel_scan(cnt, total, misc);
    if (threadIdx.x < kRadixBins && before < want && want <= before + cnt) {
      misc[48] = threadIdx.x;
      misc[49] = before;
    }
    __syncthreads();
    want -= misc[49];
    prefix |= (unsigned)misc[48] << shift;
    mask |= 255u << shift;
    __syncthreads();  // misc and the counters are read
  }
  need = want;
  return prefix;
}

// The k nearest train rows of test row blockIdx.x of the chunk, from its
// keys (a row of `keys`, stride ntp) into out[blockIdx.x * k ...].
__global__ void __launch_bounds__(kSelThreads)
    knn_select_kernel(const unsigned* __restrict__ keys,
                      int* __restrict__ out, unsigned* __restrict__ pairs,
                      int nt, int ntp, int k, int cap_w, int pairs_smem) {
  extern __shared__ __align__(16) int sel_smem[];
  int* misc = sel_smem + kSelWarps * kRadixBins;
  unsigned* region = reinterpret_cast<unsigned*>(sel_smem + kSelHead);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  int* h = sel_smem + warp * kRadixBins;
  const int64_t r = blockIdx.x;
  const unsigned* row = keys + r * ntp;
#ifdef KNN_PHASE_CLOCKS
  long long sel_t_[kSelPhases + 1];
#endif
  SEL_CLOCK(0);
  // warp w's segment of the row: whole batches of 32, in index order
  const int seg = (nt + 32 * kSelWarps - 1) / (32 * kSelWarps) * 32;
  const int lo = min(nt, warp * seg), hi = min(nt, lo + seg);
  // the keys the warp selects over: its segment, or its candidates
  const unsigned* wk = row + lo;
  const unsigned* wi = nullptr;  // their indices; lo + position if null
  int wn = hi - lo;

  // the pairs' two buffers
  unsigned *ak, *ai, *bk, *bi;
  if (cap_w > 0) {
    bk = region;
    bi = bk + k;
    ak = region + sel_region_ints(k, cap_w);
    ai = ak + k;
  } else if (pairs_smem) {
    ak = region;
    ai = ak + k;
    bk = ai + k;
    bi = bk + k;
  } else {
    ak = pairs + r * 4 * (int64_t)k;
    ai = ak + k;
    bk = ai + k;
    bi = bk + k;
  }

  if (cap_w > 0) {
    // the sample and its threshold
    const int ns = nt < kSample ? nt : kSample;
    unsigned* sample = region;
    for (int e = threadIdx.x; e < ns; e += kSelThreads) {
      const int64_t j =
          nt <= kSample ? e
                        : (int64_t)(e >> 5) * (nt - 32) / (kSampleRuns - 1) +
                              (e & 31);
      sample[e] = __ldg(row + j);
    }
    __syncthreads();
    const int sseg = (ns + 32 * kSelWarps - 1) / (32 * kSelWarps) * 32;
    const int slo = min(ns, warp * sseg), shi = min(ns, slo + sseg);
    int sneed;
    const unsigned tau = radix_kth(sample + slo, shi - slo,
                                   sel_sample_rank(nt, k), sneed, sel_smem,
                                   misc, lane);
    SEL_CLOCK(1);
    // the candidates: the keys at or below tau, four batches a step
    unsigned* ck = region + 2 * warp * cap_w;
    unsigned* ci = ck + cap_w;
    int c = 0;
    for (int base = lo; base < hi; base += 128) {
      unsigned kv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = base + 32 * u + lane;
        kv[u] = j < hi ? __ldg(row + j) : 0xffffffffu;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = base + 32 * u + lane;
        const bool in = j < hi && kv[u] <= tau;
        const unsigned m = __ballot_sync(kFull, in);
        const int pos = c + __popc(m & lt);
        if (in && pos < cap_w) {
          ck[pos] = kv[u];
          ci[pos] = (unsigned)j;
        }
        c += __popc(m);
      }
    }
    if (lane == 0) misc[16 + warp] = c;
    __syncthreads();
    int total = 0;
    bool over = false;
    for (int w = 0; w < kSelWarps; ++w) {
      total += misc[16 + w];
      over |= misc[16 + w] > cap_w;
    }
    if (total >= k && !over) {
      wk = ck;
      wi = ci;
      wn = c;
    }
    __syncthreads();  // the counts are read
  } else {
    SEL_CLOCK(1);
  }
  SEL_CLOCK(2);

  int need;
  const unsigned kth = radix_kth(wk, wn, k, need, sel_smem, misc, lane);
  SEL_CLOCK(3);

  // compaction: each warp's counts below and at kth, then the places
  {
    int nb = 0, ne = 0;
    for (int base = 0; base < wn; base += 32) {
      const int p = base + lane;
      const unsigned key = p < wn ? wk[p] : 0xffffffffu;
      nb += __popc(__ballot_sync(kFull, p < wn && key < kth));
      ne += __popc(__ballot_sync(kFull, p < wn && key == kth));
    }
    if (lane == 0) {
      misc[16 + warp] = nb;
      misc[32 + warp] = ne;
    }
    __syncthreads();
    int pb = 0, pe = 0;
    for (int w = 0; w < warp; ++w) {
      pb += misc[16 + w];
      pe += misc[32 + w];
    }
    for (int base = 0; base < wn; base += 32) {
      const int p = base + lane;
      const unsigned key = p < wn ? wk[p] : 0xffffffffu;
      const bool below = p < wn && key < kth, at = p < wn && key == kth;
      const unsigned mb = __ballot_sync(kFull, below);
      const unsigned me = __ballot_sync(kFull, at);
      const int eb = pb + __popc(mb & lt), ee = pe + __popc(me & lt);
      if (below || (at && ee < need)) {
        const int pos = eb + min(ee, need);
        ak[pos] = key;
        ai[pos] = wi ? wi[p] : (unsigned)(lo + p);
      }
      pb += __popc(mb);
      pe += __popc(me);
    }
    __syncthreads();  // the pairs are written; the candidates are read
  }
  SEL_CLOCK(4);

  // stable LSD radix sort of the k pairs by key
  const int seg2 = (k + 32 * kSelWarps - 1) / (32 * kSelWarps) * 32;
  const int lo2 = min(k, warp * seg2), hi2 = min(k, lo2 + seg2);
  constexpr int kPer = kSelWarps * kRadixBins / kSelThreads;
  for (int shift = 0; shift < 32; shift += 8) {
    count_digits(ak + lo2, hi2 - lo2, 0u, 0u, shift, h, lane);
    if (threadIdx.x == 0) misc[50] = 0;
    __syncthreads();
    if (threadIdx.x < kRadixBins) {
      int tot = 0;
      for (int w = 0; w < kSelWarps; ++w)
        tot += sel_smem[w * kRadixBins + threadIdx.x];
      if (tot == k) misc[50] = 1;  // one digit for all: nothing moves
    }
    // each digit's first place for each warp, in (digit, warp) order:
    // thread t takes entries [t * kPer, (t + 1) * kPer), entry e being
    // digit e / kSelWarps of warp e % kSelWarps
    int v[kPer], sum = 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x * kPer + i;
      v[i] = sel_smem[(e % kSelWarps) * kRadixBins + e / kSelWarps];
      sum += v[i];
    }
    int total;
    int at = sel_scan(sum, total, misc);  // its barriers order the reads
    const bool skip = misc[50] != 0;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x * kPer + i;
      sel_smem[(e % kSelWarps) * kRadixBins + e / kSelWarps] = at;
      at += v[i];
    }
    __syncthreads();
    if (skip) continue;  // the same in every thread
    for (int base = lo2; base < hi2; base += 32) {
      const int j = base + lane;
      const bool in = j < hi2;
      const unsigned key = in ? ak[j] : 0u;
      const int dig = in ? (int)((key >> shift) & 255u) : kRadixBins;
      const unsigned peers = __match_any_sync(kFull, dig);
      if (in) {
        const int pos = h[dig] + __popc(peers & lt);
        bk[pos] = key;
        bi[pos] = ai[j];
      }
      __syncwarp();
      if (in && lane == __ffs(peers) - 1) h[dig] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    unsigned* tk = ak;
    unsigned* ti = ai;
    ak = bk;
    ai = bi;
    bk = tk;
    bi = ti;
  }
  SEL_CLOCK(5);
  for (int j = threadIdx.x; j < k; j += kSelThreads)
    out[r * k + j] = (int)ai[j];
  __syncthreads();
  SEL_CLOCK(6);
#ifdef KNN_PHASE_CLOCKS
  if (blockIdx.x == 0 && threadIdx.x == 0)
    for (int q = 0; q < kSelPhases; ++q)
      knn_select_cycles[q] = sel_t_[q + 1] - sel_t_[q];
#endif
}

cudaError_t launch_radix(const CUtensorMap& train_map, const float* x,
                         const float* tsq, int* out, unsigned* scratch,
                         int64_t n, int d, int dpad, int ntp, int nt, int k,
                         int splits, int64_t chunk_rows, int cap_w,
                         int pairs_smem, cudaStream_t stream) {
  const int tile_smem = (int)tile_smem_bytes(dpad);
  const int sel_smem = (int)sel_smem_bytes(k, cap_w, pairs_smem);
  cudaError_t e = cudaFuncSetAttribute(
      knn_key_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tile_smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(knn_select_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           sel_smem);
  if (e != cudaSuccess) return e;
  unsigned* pairs = pairs_smem ? nullptr : scratch + chunk_rows * ntp;
  for (int64_t r0 = 0; r0 < n; r0 += chunk_rows) {
    const int64_t rows = n - r0 < chunk_rows ? n - r0 : chunk_rows;
    const dim3 grid((unsigned)((rows + kTM - 1) / kTM), (unsigned)splits);
    knn_key_tile_kernel<<<grid, kTileThreads, tile_smem, stream>>>(
        train_map, x + r0 * d, tsq, scratch, rows, d, dpad, ntp, splits);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
#ifndef KNN_NO_SELECTION  // the keys alone (scripts/port_knn_phases.py)
    knn_select_kernel<<<(unsigned)rows, kSelThreads, sel_smem, stream>>>(
        scratch, out + r0 * k, pairs, nt, ntp, k, cap_w, pairs_smem);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
#endif
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* knn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Shared memory of a knn_tile_kernel block at this padded width.
long long knn_tile_smem_bytes(int dpad) { return tile_smem_bytes(dpad); }

// Resident blocks of one SM for knn_tile_kernel<kcap> at this padded width.
int knn_tile_blocks_per_sm(int kcap, int dpad, int* out) {
  const void* fn = kcap == 16 ? (const void*)knn_tile_kernel<16>
                              : (const void*)knn_tile_kernel<32>;
  if ((kcap != 16 && kcap != 32) || dpad < kDK || dpad % kDK != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)tile_smem_bytes(dpad);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, kTileThreads, (size_t)smem);
}

// The (n, k) int32 indices of the k nearest train rows of each test row,
// 1 <= k <= kcap (16 or 32), through the tiled kernel: trainT is the
// (dpad, ntp) transposed train set, zero past d and past the train rows,
// tsq its (ntp,) norms, +inf past the train rows; splits train ranges, with
// a scratch of 2 splits n k floats when splits > 1 (ops/kernels.py
// `_knn_plan` picks them).
int knn_topk_tiled(const float* x, const float* trainT, const float* tsq,
                   int* out, float* scratch, long long n, int d, int dpad,
                   int ntp, int k, int kcap, int splits, void* stream) {
  if (n < 1 || d < 1 || dpad < d || dpad % kDK != 0 || ntp < kTN ||
      ntp % kTN != 0 || k < 1 || k > kcap || splits < 1 ||
      splits > 65535 || splits > ntp / kTN || (splits > 1 && !scratch) ||
      (int64_t)(n + kTM - 1) / kTM > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  CUtensorMap map;
  const cudaError_t e = encode_tile_map(&map, trainT, dpad, ntp);
  if (e != cudaSuccess) return (int)e;
  if (kcap == 16)
    return (int)launch_tiled<16>(map, x, tsq, out, scratch, (int64_t)n, d,
                                 dpad, ntp, k, splits, s);
  if (kcap == 32)
    return (int)launch_tiled<32>(map, x, tsq, out, scratch, (int64_t)n, d,
                                 dpad, ntp, k, splits, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory of a knn_long_kernel<kcap> block at this padded width.
long long knn_long_smem_bytes(int kcap, int dpad) {
  return long_smem_bytes(kcap, dpad);
}

// Resident blocks of one SM for knn_long_kernel<kcap> at this padded width.
int knn_long_blocks_per_sm(int kcap, int dpad, int* out) {
  const void* fn = long_kernel_of(kcap);
  if (fn == nullptr || dpad < kDK || dpad % kDK != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)long_smem_bytes(kcap, dpad);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, kTileThreads, (size_t)smem);
}

// The (n, k) int32 indices of the k nearest train rows of each test row,
// 1 <= k <= kcap (64 or 128), through the long-list kernel: trainT,
// tsq and the splits as for knn_topk_tiled, nt the real train rows (k <=
// nt <= ntp), with a scratch of 2 splits n k floats when splits > 1.
int knn_topk_long(const float* x, const float* trainT, const float* tsq,
                  int* out, float* scratch, long long n, int d, int dpad,
                  int ntp, int nt, int k, int kcap, int splits,
                  void* stream) {
  if (n < 1 || d < 1 || dpad < d || dpad % kDK != 0 || ntp < kTN ||
      ntp % kTN != 0 || nt < 1 || nt > ntp || k < 1 || k > kcap ||
      k > nt || long_kernel_of(kcap) == nullptr || splits < 1 ||
      splits > 65535 || splits > ntp / kTN || (splits > 1 && !scratch) ||
      (int64_t)(n + long_tile_rows(kcap) - 1) / long_tile_rows(kcap) >
          0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  CUtensorMap map;
  const cudaError_t e = encode_tile_map(&map, trainT, dpad, ntp);
  if (e != cudaSuccess) return (int)e;
  const int64_t rows = (int64_t)n;
  if (kcap == 64)
    return (int)launch_long<64>(map, x, tsq, out, scratch, rows, d, dpad,
                                ntp, nt, k, splits, s);
  return (int)launch_long<128>(map, x, tsq, out, scratch, rows, d, dpad, ntp,
                               nt, k, splits, s);
}

// Shared memory of a select block (knn_select_kernel) for lists of k, with
// candidate regions of cap_w pairs a warp (0: none), the pairs in shared
// memory or not.
long long knn_select_smem_bytes(int k, int cap_w, int pairs_smem) {
  return sel_smem_bytes(k, cap_w, pairs_smem);
}

// The rank in the sample of the select block's threshold.
int knn_sample_rank(int nt, int k) { return sel_sample_rank(nt, k); }

// The (n, k) int32 indices of the k nearest train rows of each test row,
// any 1 <= k <= nt, through the radix route: trainT and tsq as for
// knn_topk_tiled, nt the real train rows; for each chunk of chunk_rows
// test rows, knn_key_tile_kernel (train tiles in `splits` ranges) writes
// the chunk's keys to scratch ((chunk_rows, ntp) uint32, then, unless
// pairs_smem, (chunk_rows, 4, k) uint32 of pairs) and knn_select_kernel
// turns each row's keys into its list (cap_w: the candidates a warp's
// region holds; 0, none).
int knn_topk_radix(const float* x, const float* trainT, const float* tsq,
                   int* out, void* scratch, long long n, int d, int dpad,
                   int ntp, int nt, int k, int splits, long long chunk_rows,
                   int cap_w, int pairs_smem, void* stream) {
  if (n < 1 || d < 1 || dpad < d || dpad % kDK != 0 || ntp < kTN ||
      ntp % kTN != 0 || nt < 1 || nt > ntp || k < 1 || k > nt ||
      splits < 1 || splits > 65535 || splits > ntp / kTN ||
      chunk_rows < 1 || chunk_rows > 0x7fffffffLL || scratch == nullptr ||
      cap_w < 0 || (cap_w > 0 && 2 * kSelWarps * cap_w < kSample) ||
      sel_smem_bytes(k, cap_w, pairs_smem) > kSmemBlockMax)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cudaError_t e = encode_tile_map(&map, trainT, dpad, ntp);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_radix(map, x, tsq, out,
                           reinterpret_cast<unsigned*>(scratch), (int64_t)n,
                           d, dpad, ntp, nt, k, splits, (int64_t)chunk_rows,
                           cap_w, pairs_smem != 0, (cudaStream_t)stream);
}

#ifdef KNN_PHASE_CLOCKS
// Block 0's knn_select_cycles of the last select launch, into host memory.
int knn_select_cycles_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, knn_select_cycles,
                                   sizeof(knn_select_cycles));
}

// Block (0, 0)'s knn_phase_cycles of the last launch, into host memory.
int knn_phase_cycles_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, knn_phase_cycles,
                                   sizeof(knn_phase_cycles));
}
#endif

}  // extern "C"
