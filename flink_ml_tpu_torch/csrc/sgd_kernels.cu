// SGD kernels for Hopper (sm_90a): one round's fused forward, loss terms and
// gradient over the minibatch window, in plain fp32 CUDA C++, both stages
// launched on the caller's stream by one C entry, sgd_batch_terms.
//
// Replaces, in flink_ml_tpu/ops/pallas_kernels.py:
//   sgd_rows_kernel<LOSS, V, VEC4>  <- _sgd_terms_kernel (:206), pallas_call
//   sgd_staged_kernel<LOSS, NREG>      at :282 (rows of at most kRegCols
//   sgd_cluster_kernel<LOSS, NREG>     columns; wider rows as far as shared
//   sgd_grid_kernel<LOSS, NREG, ROWS>  memory holds a ring of them; wider
//   sgd_twopass_dots_kernel<VEC4>,     rows split over a cluster of 2, 4 or
//   sgd_twopass_mult_kernel<LOSS>,     8 CTAs; wider rows split over every
//   sgd_twopass_axpy_kernel<VEC4>      CTA the card holds; wider still,
//                                      three kernels that read the window
//                                      twice)
//   sgd_combine_kernel              <- the accumulation of _sgd_terms_kernel
//                                      into out_ref across sequential grid
//                                      steps (:231)
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
// at 67 TFLOP/s. What a byte-bound kernel lacks is bytes in flight: about
// 25 KB per SM cover 3.35 TB/s over a microsecond of loaded latency.
//
// Stage 1, rows of at most kRegCols columns (sgd_rows_kernel): a persistent
// grid, each warp owning one contiguous run of window rows (the runs differ
// by at most one row; ops/kernels.py `sgd_runs` mirrors them). A lane keeps
// its 4 * V columns of a row in registers (V float4s, 16-byte loads where d
// is a multiple of 4 and x is 16-byte aligned, else scalar loads of columns
// lane, lane + 32, ...), and the loads of the run's next R rows are issued
// before the current R are consumed (a register double buffer, R * V <= 4:
// at d = 100 a warp keeps 1.6 KB in flight). The labels and weights come 32
// rows at a time, one coalesced load per lane, and reach the lanes by
// shuffles. The R rows' dots are summed over the warp together (rows_sum),
// which leaves each row's dot in 32 / R lanes, so the lanes evaluate the R
// rows' terms at once; each row's multiplier is then shuffled to every
// lane, which adds mult * x into its columns' sums in registers, in row
// order. No shared memory or barrier inside the row loop, and no device
// memory written but the block's partial: the warps' sums meet in shared
// memory once and are added in warp order.
//
// Stage 1, rows of kRegCols + 1 up to about 13,000 columns
// (sgd_staged_kernel): a persistent grid, each block owning one contiguous
// run of window rows (the runs differ by at most one row; `sgd_runs`
// mirrors them), which it streams through a ring of kRing stages in shared
// memory, `rows` whole rows a stage. A stage is one contiguous run of x, so
// it comes by 16-byte cp.async (where x is 16-byte aligned: the copies start
// at the aligned address at or before the stage's first float, and the last
// one stops at its last float) or 4-byte cp.async, with the stage's labels
// and masked weights, kRing - 1 stages in flight while one is consumed (at d
// = 2,000 a block keeps 64 KB in flight). Every byte of the window is read
// from device memory once, and both uses read the one staged copy: thread t
// owns columns t + 256 j, keeping their coefficients and running sums in
// registers for j < NREG (4, 8 or 16 from the row width; ptxas' report,
// printed by chip_smoke.py's phase 1, shows no spills at two blocks per
// SM) and in shared memory past that, 4,096 columns. Per stage: each
// thread's partial dots of the
// stage's rows, four rows summed over the warp together (rows_sum), the
// warps' sums added in warp order by thread r for row r, which evaluates
// its terms; then every thread adds mult * x into its columns in row order.
// Each column's sum has one owner, so the block's partial needs no
// reduction; thread r keeps row slot r's loss and weight sums, added in
// slot order at the end.
//
// Stage 1, rows wider than one block's ring holds, up to what a cluster of
// kClusterMax CTAs holds (sgd_cluster_kernel; 105,568 columns): a thread
// block cluster of c CTAs (c = 2, 4 or 8: the smallest whose CTAs fit two
// an SM, else the smallest whose slice fits; ops/kernels.py
// `_sgd_cluster_size`) owns a contiguous run of window rows, as a staged
// block does, and CTA r of it the columns [r ds, (r + 1) ds) of every row
// (ds = ceil(d / c) rounded up to 4; the last CTA the rest). Each CTA
// streams its slice of the run's rows through a ring of kRing stages, a
// row's slice `row_pitch` floats apart: where x is 16-byte aligned, one
// bulk copy a row from the aligned address at or before the slice to the
// last 16-byte boundary in it, issued by one thread and completed on the
// stage's mbarrier, and the up to 3 floats after it by cp.async (with 16-
// byte cp.async by every thread, the issue took a third of a stage, the
// threads stalled on the copies' queue); else 4-byte cp.async. Its
// thread t owns the slice's columns t + 256 j as a staged thread owns a
// row's. Per stage: each warp's partial dots of the stage's rows
// over its columns, in the staged order, into the CTA's sums of the
// stage's parity; the cluster barrier's arrive (release), the copies of a
// later stage, its wait (acquire); then thread r of every CTA reads row
// r's kWarps sums of every CTA from the cluster's shared memory (mapa) and
// adds them, each CTA's in warp order and the CTAs' in rank order, so
// every CTA holds the same float for every dot, evaluates the row's
// terms, and every thread adds mult * x into its own columns. The sums
// alternate by stage parity: a CTA writes stage s + 1's only after every
// CTA has arrived at stage s's barrier, which each does only after
// reading stage s - 1's. Rank 0 alone keeps the weight and loss sums. A
// cluster writes one partial row, each CTA its slice, so stage 2 is
// unchanged, every byte of the window is read once, and no atomics are
// used. Two CTAs an SM hide one CTA's barrier behind the other's work (at
// d = 16,000 clusters of 4, two an SM, ran in two thirds of the time of
// clusters of 2, one an SM; PERF.md). With -DSGD_PHASE_CLOCKS, CTA 0 adds
// up clock64() per phase of its stages (sgd_phase_cycles_read;
// scripts/port_sgd_cluster.py builds and reads it).
//
// Stage 1, rows wider than a cluster of kClusterMax holds, up to what a
// grid of one CTA an SM holds (sgd_grid_kernel; 1,959,936 columns on an
// H100's 132 SMs): every CTA the card holds at once (G, from the occupancy
// query; the layout takes more than half an SM's shared memory, so one CTA
// an SM) owns the columns [g ds, (g + 1) ds) of every window row (ds =
// ceil(d / G) rounded up to 4; the last CTA the rest) for the whole call.
// A CTA has kGridThreads = 512 threads. Slices of at most kGridRowCols =
// 1,024 columns are taken by warps that own rows: lane l keeps the
// coefficients and running sums of the slice's columns l + 32 j in
// registers, a row's partial dot is one warp's, and the 16 warps' sums of
// each column are added in warp order once at the end. Wider slices are
// split over the threads: thread t owns columns t + 512 j, in registers
// for j < NREG (4, 8 or 16) and in shared memory past that, four rows'
// dots summed over each warp together and the warps' sums added in warp
// order. (At 8 columns a row or fewer a thread, the fixed work of a row
// led; the warps owning rows took 106,000 columns from 1.30 to 0.90 ms.)
// The window's rows stream through a ring of kRing stages of `rows` rows'
// slices (the most rows, up to kGridMaxRows, whose ring fits the block:
// about 74 KB a stage, a wave of G stages about 9.8 MB), lane r of warp 0
// copying row r's slice by one bulk copy on the stage's mbarrier where x
// is 16-byte aligned (from the aligned address at or before it; the up to
// 3 floats after its last 16-byte boundary by cp.async), 4-byte cp.async
// else, so every byte of the window is read once and both uses read the
// staged copy. The dots meet through device memory: each CTA stores its
// partial dots of a stage (the scratch `dots`, [2][rows][G] by stage
// parity) and arrives at the stage's first grid barrier (a block barrier,
// then one thread's acq_rel fence and add to an integer counter); after
// its wait (that thread spins on an acquire load until all G CTAs have
// arrived) row r's owner, CTA (s rows + r) % G, reads the row's G
// partials with one warp, every load issued at once (lane l adds those of
// CTAs l, l + 32, ... in order, then the lanes' sums by the fixed
// butterfly), and stores the dot; after a second grid barrier thread r of
// every CTA reads row r's dot, the same float in every CTA, and takes its
// terms. (With every CTA reading every row's partials, the 132 CTAs' reads
// of the same few L2 lines took 6,000 cycles a stage; with every CTA
// reading its own copy of them instead, written by all, one barrier a
// stage, 106,000 columns ran 1.11-1.26 ms against 0.90 here.)
// The loop is pipelined: iteration k takes the owners' sums of stage k -
// 1, then stage k's partial dots, then stage k - 1's terms and mult * x,
// so that each barrier's latency lies behind a stage's work. The partials
// and dots alternate by stage parity: a CTA writes stage s + 2's partials
// only after every CTA has arrived at stage s + 1's second barrier, long
// after every owner read stage s's before stage s's second barrier; an
// owner writes stage s + 2's dots only after every CTA has arrived at
// stage s + 2's first barrier, which each does only after reading stage
// s's dots. CTA 0 alone keeps the weight and loss sums. The grid writes
// one partial row, each CTA its slice, so stage 2 over one row is its
// copy. The launch is cooperative: a grid the card cannot hold at once is
// refused, never left spinning. With -DSGD_PHASE_CLOCKS, CTA 0 adds up
// clock64() per phase of its iterations (sgd_grid_phase_cycles_read;
// scripts/port_sgd_grid.py reads it).
//
// Stage 1, rows wider than a grid of one CTA an SM holds (the two-pass
// set; any width, used past 1,959,936 columns on 132 SMs): three kernels on
// the caller's stream, the window read twice, no atomic, no grid barrier,
// no cooperative launch. What bounds it is two reads of the window (at
// 2,097,152 columns, lb = 152: 2 x 1.28 GB, 0.765 ms at 3.35 TB/s, where
// the function's bound is one read, 0.382 ms); what the design does about
// that is fill the card with bytes in flight in both passes and keep
// everything but x out of device memory's way.
//   (a) sgd_twopass_dots_kernel: a 2-D grid of (column segment, row band)
//   CTAs, a segment kTwoSegCols columns of each of a band's kTwoBandRows
//   rows (at 2,097,152 x 152: 512 x 5 CTAs, several waves where the grid
//   instance's predecessor ran 10 blocks). A CTA holds its segment's
//   coefficients in shared memory and streams its rows kTwoBatch at a time,
//   each thread kTwoLoads 16-byte loads a row (from the aligned address at
//   or before the row's first float where x is 16-byte aligned: a row is
//   cut into segments of kTwoSegF4 float4s, up to 3 floats of the rows
//   beside it masked off) or 4-byte loads (else), 64 KB of the CTA's rows
//   in flight. The rows' partial dots are summed over each warp together
//   (rows_sum), then over the warps in warp order, and stored, one float a
//   (row, segment), to the scratch part [lb][segments].
//   (b) sgd_twopass_mult_kernel: a warp a row: lane l adds the row's
//   partials l, l + 32, ... in segment order, the lanes' sums meet by the
//   fixed butterfly, and lane 0 takes the row's terms (rows below clip
//   weigh 0) and writes mult[row]; each CTA adds its rows' weights and
//   losses in row order. (With one CTA for the whole window, a latency
//   chain of rows, it took 0.086-0.106 ms at lb = 2,441-3,019; PERF.md.)
//   (c) sgd_twopass_axpy_kernel: CTA b owns a slice of 4 T columns for the
//   whole window (T = 128 threads from 262,144 columns, fewer below:
//   twopass_owner_threads), thread t four of them. It walks the rows in
//   row order, kOwnerBatch rows' loads in flight a thread (16-byte loads
//   where d % 4 = 0 and x is aligned, coalesced 4-byte loads else), and
//   keeps its columns' sums in registers, as doubles (a float sum of a
//   thousand rows in row order drifted a wide LR fit off its float64
//   rounds; the bytes, not the double adds, bound the kernel). It writes out[slice] once: no
//   partial row reaches device memory and no combine runs. Thread 0 of
//   CTA 0 adds (b)'s CTAs' weight and loss sums in CTA order into out[d]
//   and out[d + 1].
// The multipliers pass between (b) and (c) through mult [lb], and (b)'s
// weight and loss sums through sums [ceil(lb / 8)][2], after part in the
// scratch the wrapper allocates.
//
// Stage 2 (sgd_combine_kernel): the per-block partials summed in the fixed
// two-level order of reduce_partials (kmeans_kernels.cu, kept here as its
// own copy): at most 32 contiguous slices, each added in row order from 0,
// then a fixed pairwise tree. So the output equals reduce_partials_plain of
// the partials, bit for bit. Where stage 1 writes one row, it writes it as
// the output and stage 2 does not run (reduce_partials_plain's 0 + p is p
// but for the sign of a zero).
//
// Determinism: every sum has a fixed order given the launch plan, which
// depends only on (lb, d, the card), so the same inputs on the same card
// give the same bits. The one atomic is the grid barrier's add to its
// integer arrival counter; no float passes through an atomic.
//
// Arithmetic: full fp32 (FMA; the two-pass owners' sums in fp64), no TF32,
// no fast-math intrinsics. The logistic loss is softplus(-m) = max(-m, 0)
// + log1p(exp(-|m|)), which never
// overflows; its multiplier -w * ys / (exp(m) + 1) is +-0 once exp(m)
// overflows to inf (|m| > 88), as in the reference.
//
// Shared memory, in floats:
//   sgd_rows_kernel: part [kWarps][d + 2], the warps' partials;
//   sgd_staged_kernel, in this order (staged_smem_floats; ops/kernels.py
//   `_sgd_staged_layout` mirrors it and passes rows and the byte count):
//     ring [kRing][stage]  the stages, each up to 3 floats before its
//                          first row, then its rows (stage_floats)
//     ys, wv [kRing][rows] each stage's labels and masked weights
//     red  [rows4][kWarps] the warps' sums of each row's dot (rows4: rows
//                          rounded up to a multiple of 4)
//     mult [rows]          the stage's multipliers
//     slot [2][rows]       the row slots' weight and loss sums at the end
//     gs, cs [over]        the running sums and the coefficients of the
//                          columns past the registers (staged_over)
//   sgd_cluster_kernel, in this order (cluster_smem_floats; ops/kernels.py
//   `_sgd_cluster_layout` mirrors it and passes rows and the byte count):
//     ring [kRing][rows][row_pitch(ds)]  the stages, a row's slice up to 3
//                          floats after the start of its pitch
//     full [kRing]         the stages' mbarriers (2 floats each)
//     ys, wv [kRing][rows] each stage's labels and masked weights
//     red  [2][rows4][kWarps]  the warps' sums of each row's partial dot,
//                          by stage parity (read by the whole cluster)
//     mult [rows]          the stage's multipliers
//     slot [2][rows]       the row slots' weight and loss sums at the end
//     gs, cs [over]        as the staged instance's, over the slice
//   sgd_grid_kernel, in this order (grid_smem_floats; ops/kernels.py
//   `_sgd_grid_layout` mirrors it and passes rows and the byte count):
//     ring [kRing][rows][row_pitch(ds)]  the stages, as the cluster
//                          instance's
//     full [kRing]         the stages' mbarriers (2 floats each)
//     ys, wv [kRing][rows] each stage's labels and masked weights
//     red  [rows4][kGridWarps]  the warps' sums of each row's partial dot
//     mult [rows]          the stage's multipliers
//     slot [2][rows]       the row slots' weight and loss sums at the end
//     gs, cs [over]        the running sums and the coefficients of the
//                          slice's columns past the registers (grid_over)
//   the two-pass set, static: (a) cs [kTwoSegCols + 8], its segment's
//   coefficients from 4 columns before it (0 outside the row), red [2]
//   [kTwoBatch][kTwoWarps], the warps' dot sums by batch parity; (b) wl
//   [2][kTermsRows], its rows' weights and losses; (c) none.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads per block: 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxV = 4;               // float4s of a row a lane holds at most
constexpr int kRegCols = 128 * kMaxV;  // widest row sgd_rows_kernel takes
constexpr unsigned kAll = 0xffffffffu;

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
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Stage 1 for rows of at most kRegCols columns.

// Rows a warp loads at once: R * V float4s a lane, twice for the double
// buffer.
template <int V>
constexpr int kBatchRows = V == 1 ? 4 : V == 2 ? 2 : 1;
// Blocks an SM must hold at least (24 or 16 warps, so 80 or 128 registers
// a thread): the warps' loads in flight are what covers the latency of
// device memory.
template <int V>
constexpr int kMinBlocks = V <= 2 ? 3 : 2;

// Column of a row that element k of a lane's 4 * V floats holds.
template <bool VEC4>
__device__ __forceinline__ int column(int k, int lane) {
  return VEC4 ? 4 * (lane + 32 * (k / 4)) + k % 4 : lane + 32 * k;
}

// Each row's v[r] summed over the warp, R rows at once, in a fixed order:
// at offsets 16, 8, ... a lane keeps half of its rows and sends the other
// half to its partner (lane ^ offset), until one row is left in each lane,
// then a butterfly over the remaining offsets. Lane l ends with the sum of
// row l / (32 / R), the same bits in each of those 32 / R lanes (a + b and
// b + a are one float).
template <int R>
__device__ __forceinline__ float rows_sum(float (&v)[R], int lane) {
#pragma unroll
  for (int n = R; n > 1; n /= 2) {
    const int off = 16 * n / R;
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float keep = upper ? v[i + n / 2] : v[i];
      const float send = upper ? v[i] : v[i + n / 2];
      v[i] = keep + __shfl_xor_sync(kAll, send, off);
    }
  }
  float s = v[0];
#pragma unroll
  for (int off = 16 / R; off > 0; off >>= 1)
    s += __shfl_xor_sync(kAll, s, off);
  return s;
}

// A lane's columns of R rows from table row `row` on, rows past `last`
// (the run's last row) read as copies of it; columns past d read 0.
template <int V, int R, bool VEC4>
__device__ __forceinline__ void load_rows(float (&buf)[R][4 * V],
                                          const float* __restrict__ x,
                                          int64_t row, int64_t last, int d,
                                          int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float* p = x + min(row + r, last) * (int64_t)d;
    if (VEC4) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int col = column<true>(4 * v, lane);
        float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
        if (col < d) t = __ldcs(reinterpret_cast<const float4*>(p + col));
        buf[r][4 * v] = t.x;
        buf[r][4 * v + 1] = t.y;
        buf[r][4 * v + 2] = t.z;
        buf[r][4 * v + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4 * V; ++k) {
        const int col = column<false>(k, lane);
        buf[r][k] = col < d ? __ldcs(p + col) : 0.f;
      }
    }
  }
}

// Labels and masked weights of the run's rows [i, i + 32), one a lane; 0
// past the run's `len` rows. Window index of run row j: r0 + j.
__device__ __forceinline__ void load_labels(const float* __restrict__ y,
                                            const float* __restrict__ w,
                                            int64_t base, int64_t r0,
                                            int64_t i, int64_t len,
                                            int64_t clip, int lane, float& yv,
                                            float& wv) {
  const int64_t j = i + lane;
  yv = 0.f;
  wv = 0.f;
  if (j < len) {
    yv = __ldcs(y + base + j);
    if (r0 + j >= clip) wv = __ldcs(w + base + j);
  }
}

// The R rows of `buf` (run rows i .. i + R - 1, of which those at len and
// past are copies that add nothing): their dots, terms and mult * x. The
// labels and weights of run rows i - j0 .. i - j0 + 31 are in the lanes'
// yv and wv.
template <int LOSS, int V, int R>
__device__ __forceinline__ void consume(const float (&buf)[R][4 * V],
                                        const float (&c)[4 * V],
                                        float (&g)[4 * V], int64_t i,
                                        int64_t len, float yv, float wv,
                                        int j0, int lane, float& lsum,
                                        float& wsum) {
  constexpr int F = 4 * V, G = 32 / R;
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < F; ++k) s = fmaf(buf[r][k], c[k], s);
    v[r] = s;
  }
  const float dot = rows_sum<R>(v, lane);
  const int mine = lane / G;  // the batch row whose terms this lane takes
  const float yy = __shfl_sync(kAll, yv, j0 + mine);
  const float ww = __shfl_sync(kAll, wv, j0 + mine);
  float loss, m;
  row_terms<LOSS>(dot, yy, ww, loss, m);
  if (i + mine >= len) loss = m = 0.f;
  if (lane % G == 0) {
    lsum += loss;
    wsum += ww;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float mr = __shfl_sync(kAll, m, r * G);
#pragma unroll
    for (int k = 0; k < F; ++k) g[k] = fmaf(mr, buf[r][k], g[k]);
  }
}

// One batch, run rows i .. i + R - 1 in `cur`: the next batch's loads go
// out into `nxt` (with the labels and weights of the next group of 32 run
// rows where the next batch opens one) before `cur` is consumed.
template <int LOSS, int V, int R, bool VEC4>
__device__ __forceinline__ void step(
    float (&cur)[R][4 * V], float (&nxt)[R][4 * V],
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ w, const float (&c)[4 * V], float (&g)[4 * V],
    int64_t base, int64_t last, int64_t r0, int64_t i, int64_t len,
    int64_t clip, int d, int lane, float& yv, float& wv, float& lsum,
    float& wsum) {
  const int j0 = (int)(i & 31);  // the batch's first lane of yv and wv
  const bool opens = j0 == 32 - R;
  float ny = 0.f, nw = 0.f;
  if (i + R < len) {
    load_rows<V, R, VEC4>(nxt, x, base + i + R, last, d, lane);
    if (opens) load_labels(y, w, base, r0, i + R, len, clip, lane, ny, nw);
  }
  consume<LOSS, V, R>(cur, c, g, i, len, yv, wv, j0, lane, lsum, wsum);
  if (opens) {
    yv = ny;
    wv = nw;
  }
}

template <int LOSS, int V, bool VEC4>
__global__ void __launch_bounds__(kThreads, kMinBlocks<V>)
    sgd_rows_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ w,
                    const float* __restrict__ coeffs,
                    float* __restrict__ partials, int64_t start, int64_t lb,
                    int64_t clip, int d) {
  constexpr int R = kBatchRows<V>, F = 4 * V;
  extern __shared__ __align__(16) float part[];  // [kWarps][d + 2]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // the warp's run of window rows [r0, r0 + len)
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  const int64_t gw = (int64_t)blockIdx.x * kWarps + warp;
  const int64_t q = lb / warps, rem = lb % warps;
  const int64_t r0 = gw * q + min(gw, rem);
  const int64_t len = q + (gw < rem ? 1 : 0);

  float c[F], g[F];
#pragma unroll
  for (int k = 0; k < F; ++k) {
    const int col = column<VEC4>(k, lane);
    c[k] = col < d ? __ldg(coeffs + col) : 0.f;
    g[k] = 0.f;
  }
  float lsum = 0.f, wsum = 0.f;
  if (len > 0) {
    const int64_t base = start + r0;       // table row of run row 0
    const int64_t last = base + len - 1;  // table row of the run's last row
    float a[R][F], b[R][F];
    float yv, wv;
    load_labels(y, w, base, r0, 0, len, clip, lane, yv, wv);
    load_rows<V, R, VEC4>(a, x, base, last, d, lane);
    // not unrolled: across unrolled batches ptxas hoists every row's
    // address into registers, and spilled at V = 4 and for scalar loads
#pragma unroll 1
    for (int64_t i = 0; i < len; i += 2 * R) {
      step<LOSS, V, R, VEC4>(a, b, x, y, w, c, g, base, last, r0, i, len,
                             clip, d, lane, yv, wv, lsum, wsum);
      if (i + R < len)
        step<LOSS, V, R, VEC4>(b, a, x, y, w, c, g, base, last, r0, i + R,
                               len, clip, d, lane, yv, wv, lsum, wsum);
    }
  }
  // the block's partial: each warp's sums into its row of part, then the
  // warps' rows added in warp order
  float* mine = part + warp * (d + 2);
#pragma unroll
  for (int k = 0; k < F; ++k) {
    const int col = column<VEC4>(k, lane);
    if (col < d) mine[col] = g[k];
  }
  wsum = warp_sum(wsum);
  lsum = warp_sum(lsum);
  if (lane == 0) {
    mine[d] = wsum;
    mine[d + 1] = lsum;
  }
  __syncthreads();
  float* dst = partials + (int64_t)blockIdx.x * (d + 2);
  for (int j = threadIdx.x; j < d + 2; j += kThreads) {
    float s = part[j];
#pragma unroll
    for (int q2 = 1; q2 < kWarps; ++q2) s += part[q2 * (d + 2) + j];
    dst[j] = s;
  }
}

// ---------------------------------------------------------------------------
// Stage 1 for rows wider than kRegCols, streamed whole through a ring of
// shared memory.

constexpr int kRing = 3;           // stages of the ring
constexpr int kStageMaxRows = 16;  // rows of a stage at most
constexpr int64_t kSmemBlockMax = 232448;  // dynamic shared memory a block

// Columns of a row a thread keeps in registers, kThreads apart: NREG of the
// staged instance for rows of width d. At most 16: with 32, ptxas held
// the instance to 128 registers and spilled, and d = 6,001 ran slower on
// an H100 than with the columns past 4,096 in shared memory.
__host__ __device__ constexpr int staged_nreg(int d) {
  return d <= 4 * kThreads ? 4 : d <= 8 * kThreads ? 8 : 16;
}

// Floats of one ring stage of `rows` rows: up to 3 before its first row
// (the 16-byte copies start at an aligned address), rounded up to 4.
__host__ __device__ constexpr int64_t stage_floats(int d, int rows) {
  return ((int64_t)rows * d + 6) / 4 * 4;
}

// Columns a thread owns past its registers, over all threads.
__host__ __device__ constexpr int64_t staged_over(int d) {
  return ((int64_t)d + kThreads - 1) / kThreads * kThreads >
                 (int64_t)kThreads * staged_nreg(d)
             ? ((int64_t)d + kThreads - 1) / kThreads * kThreads -
                   (int64_t)kThreads * staged_nreg(d)
             : 0;
}

__host__ __device__ constexpr int64_t staged_smem_floats(int d, int rows) {
  return kRing * stage_floats(d, rows) + 2 * kRing * (int64_t)rows +
         (int64_t)(rows + 3) / 4 * 4 * kWarps + 3 * (int64_t)rows +
         2 * staged_over(d);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes to shared memory, of which the first `bytes` from src and the
// rest zeros (src 16-byte aligned; nothing past src + bytes is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes to shared memory, from src where `bytes` is 4, a zero where 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int LOSS, int NREG>
__global__ void __launch_bounds__(kThreads, 2)
    sgd_staged_kernel(const float* __restrict__ x,
                      const float* __restrict__ y,
                      const float* __restrict__ w,
                      const float* __restrict__ coeffs,
                      float* __restrict__ partials, int64_t start, int64_t lb,
                      int64_t clip, int d, int rows, int vec4) {
  extern __shared__ __align__(16) float smem[];
  const int64_t sf = stage_floats(d, rows), over = staged_over(d);
  float* ring = smem;
  float* ys = ring + kRing * sf;
  float* wv = ys + kRing * rows;
  float* red = wv + kRing * rows;
  float* mult = red + (rows + 3) / 4 * 4 * kWarps;
  float* slot = mult + rows;
  float* gs = slot + 2 * rows;
  float* cs = gs + over;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  constexpr int kOwn = kThreads * NREG;  // first column past the registers

  // the block's run of window rows [r0, r0 + len), in stages of `rows`
  const int64_t nb = gridDim.x, b = blockIdx.x;
  const int64_t q = lb / nb, rem = lb % nb;
  const int64_t r0 = b * q + min(b, rem);
  const int64_t len = q + (b < rem ? 1 : 0);
  const int64_t nstages = (len + rows - 1) / rows;

  float c[NREG], g[NREG];
#pragma unroll
  for (int j = 0; j < NREG; ++j) {
    const int col = t + kThreads * j;
    c[j] = col < d ? __ldg(coeffs + col) : 0.f;
    g[j] = 0.f;
  }
  for (int64_t e = t; e < over; e += kThreads) {  // this thread's own
    gs[e] = 0.f;
    cs[e] = kOwn + e < d ? __ldg(coeffs + kOwn + e) : 0.f;
  }
  float lsum = 0.f, wsum = 0.f;  // thread r < rows: row slot r's

  // stage s into ring buffer s % kRing (an empty group past the last, so
  // that every thread counts one group a stage)
  auto issue = [&](int64_t s) {
    if (s < nstages) {
      const int nr = (int)min((int64_t)rows, len - s * rows);
      const int64_t i = r0 + s * rows;  // window index of the first row
      const int64_t g0 = (start + i) * d, g1 = g0 + (int64_t)nr * d;
      float* dst = ring + (s % kRing) * sf;
      if (vec4) {
        const int64_t a0 = g0 & ~(int64_t)3;
        const int64_t granules = (g1 - a0 + 3) / 4;
        for (int64_t e = t; e < granules; e += kThreads) {
          const int64_t at = a0 + 4 * e;
          cp_async16(dst + 4 * e, x + at, (int)(4 * min((int64_t)4, g1 - at)));
        }
      } else {
        for (int64_t e = t; e < g1 - g0; e += kThreads)
          cp_async4(dst + e, x + g0 + e, 4);
      }
      if (t < nr) {
        float* yd = ys + (s % kRing) * rows;
        float* wd = wv + (s % kRing) * rows;
        cp_async4(yd + t, y + start + i + t, 4);
        cp_async4(wd + t, w + start + i + t, i + t >= clip ? 4 : 0);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) issue(s);
  for (int64_t s = 0; s < nstages; ++s) {
    cp_async_wait<kRing - 2>();  // this thread's copies of stage s
    __syncthreads();  // everyone's; and stage s - 1's buffer is read
    issue(s + kRing - 1);
    const int nr = (int)min((int64_t)rows, len - s * rows);
    const int at = (int)(s % kRing);
    const float* xr =
        ring + at * sf + (vec4 ? (int)(((start + r0 + s * rows) * d) & 3) : 0);
    // each row's dot: this thread's columns in order, then four rows
    // summed over the warp together, then the warps in order
    for (int rb = 0; rb < nr; rb += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float acc = 0.f;
        if (rb + u < nr) {  // the same in every thread; past nr: zeros
          const float* xrow = xr + (int64_t)(rb + u) * d;
#pragma unroll
          for (int j = 0; j < NREG; ++j) {
            const int col = t + kThreads * j;
            if (col < d) acc = fmaf(xrow[col], c[j], acc);
          }
          for (int col = kOwn + t; col < d; col += kThreads)
            acc = fmaf(xrow[col], cs[col - kOwn], acc);
        }
        v[u] = acc;
      }
      const float dot = rows_sum<4>(v, lane);  // row rb + lane / 8
      if ((lane & 7) == 0 && rb + lane / 8 < nr)
        red[(rb + lane / 8) * kWarps + warp] = dot;
    }
    __syncthreads();
    if (t < nr) {
      float dot = red[t * kWarps];
#pragma unroll
      for (int q2 = 1; q2 < kWarps; ++q2) dot += red[t * kWarps + q2];
      const float wt = wv[at * rows + t];
      float loss, m;
      row_terms<LOSS>(dot, ys[at * rows + t], wt, loss, m);
      mult[t] = m;
      lsum += loss;
      wsum += wt;
    }
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      const float m = mult[r];
      const float* xrow = xr + (int64_t)r * d;
#pragma unroll
      for (int j = 0; j < NREG; ++j) {
        const int col = t + kThreads * j;
        if (col < d) g[j] = fmaf(m, xrow[col], g[j]);
      }
      for (int col = kOwn + t; col < d; col += kThreads)
        gs[col - kOwn] = fmaf(m, xrow[col], gs[col - kOwn]);
    }
  }
  cp_async_wait<0>();

  float* dst = partials + blockIdx.x * (int64_t)(d + 2);
#pragma unroll
  for (int j = 0; j < NREG; ++j) {
    const int col = t + kThreads * j;
    if (col < d) dst[col] = g[j];
  }
  for (int col = kOwn + t; col < d; col += kThreads) dst[col] = gs[col - kOwn];
  if (t < rows) {
    slot[t] = wsum;
    slot[rows + t] = lsum;
  }
  __syncthreads();
  if (t == 0) {
    float ws_ = 0.f, ls_ = 0.f;
    for (int r = 0; r < rows; ++r) {
      ws_ += slot[r];
      ls_ += slot[rows + r];
    }
    dst[d] = ws_;
    dst[d + 1] = ls_;
  }
}

// ---------------------------------------------------------------------------
// Stage 1 for rows past one block's ring: a cluster of CTAs splits each
// row's columns.

constexpr int kClusterMax = 8;  // CTAs of a cluster at most (portable)

// Columns of a cluster CTA's slice at width d in clusters of c: ceil(d / c)
// rounded up to a multiple of 4; the last CTA takes the rest.
__host__ __device__ constexpr int cluster_slice(int d, int c) {
  return ((d + c - 1) / c + 3) / 4 * 4;
}

// Floats between two rows' slices in a cluster stage: up to 3 before the
// slice (its 16-byte copies start at an aligned address), rounded up to 4.
__host__ __device__ constexpr int row_pitch(int ds) { return (ds + 6) / 4 * 4; }

__host__ __device__ constexpr int64_t cluster_smem_floats(int ds, int rows) {
  return kRing * (int64_t)rows * row_pitch(ds) + 2 * kRing +
         2 * kRing * (int64_t)rows +
         2 * ((int64_t)(rows + 3) / 4 * 4 * kWarps) + 3 * (int64_t)rows +
         2 * staged_over(ds);
}

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_nctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier in two halves, each for every thread of the
// cluster: what a thread wrote to shared memory before its arrive
// (release) is seen by every thread of the cluster after its wait
// (acquire); work between the two overlaps the barrier.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// The barrier's one arrival, which also expects `bytes` of copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
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

// `bytes` (a multiple of 16) from src to dst (both 16-byte aligned) by the
// copy engine, completing on the mbarrier bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The float at p in the shared memory of the cluster's CTA `rank`.
__device__ __forceinline__ float ld_cluster(const float* p, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

#ifdef SGD_PHASE_CLOCKS
// per thread of CTA 0: cycles in the copy wait and barrier, the partial
// dots, the cluster arrive, the copy issue after it, the cluster wait, the
// dots' sum and terms (to the barrier after them) and mult * x, over all
// its stages
constexpr int kPhases = 7;
__device__ long long sgd_phase_cycles[kThreads * kPhases];
// ptxas moves a clock read that follows a block barrier above it (on an
// H100 the warps that had waited read the time they arrived); a volatile
// load of the kernel's shared memory between them keeps the read after
// the barrier.
#define PHASE_START() long long phase_t_ = clock64()
#define PHASE_END(q)                  \
  do {                                \
    asm volatile("" ::"f"(((volatile float*)smem)[0])); \
    const long long now_ = clock64(); \
    phase_c_[q] += now_ - phase_t_;   \
    phase_t_ = now_;                  \
  } while (0)
#else
#define PHASE_START() \
  do {                \
  } while (0)
#define PHASE_END(q) \
  do {               \
  } while (0)
#endif

// The columns a thread owns past its registers (kOwn + t, kOwn + t + T,
// ... below wd; T the block's threads), four at a time with their loads
// issued first: the dot acc + x * c over them in column order ...
template <int T = kThreads>
__device__ __forceinline__ float over_dot(const float* xrow,
                                          const float* cs, float acc, int t,
                                          int kOwn, int wd) {
  int col = kOwn + t;
  for (; col + 3 * T < wd; col += 4 * T) {
    float xv[4], cv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      xv[u] = xrow[col + u * T];
      cv[u] = cs[col - kOwn + u * T];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) acc = fmaf(xv[u], cv[u], acc);
  }
  for (; col < wd; col += T) acc = fmaf(xrow[col], cs[col - kOwn], acc);
  return acc;
}

// ... and gs += m * x over them (the sums in shared memory, which the
// compiler would otherwise not load ahead of the stores)
template <int T = kThreads>
__device__ __forceinline__ void over_axpy(const float* xrow, float* gs,
                                          float m, int t, int kOwn, int wd) {
  int col = kOwn + t;
  for (; col + 3 * T < wd; col += 4 * T) {
    float xv[4], gv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      xv[u] = xrow[col + u * T];
      gv[u] = gs[col - kOwn + u * T];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      gs[col - kOwn + u * T] = fmaf(m, xv[u], gv[u]);
  }
  for (; col < wd; col += T)
    gs[col - kOwn] = fmaf(m, xrow[col], gs[col - kOwn]);
}

template <int LOSS, int NREG>
__global__ void __launch_bounds__(kThreads, 2)
    sgd_cluster_kernel(const float* __restrict__ x,
                       const float* __restrict__ y,
                       const float* __restrict__ w,
                       const float* __restrict__ coeffs,
                       float* __restrict__ partials, int64_t start,
                       int64_t lb, int64_t clip, int d, int ds, int rows,
                       int vec4) {
  extern __shared__ __align__(16) float smem[];
  const int pitch = row_pitch(ds);
  const int64_t sf = (int64_t)rows * pitch, over = staged_over(ds);
  const int rs = (rows + 3) / 4 * 4 * kWarps;  // floats of one red
  float* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRing * sf);
  float* ys = ring + kRing * sf + 2 * kRing;
  float* wv = ys + kRing * rows;
  float* red = wv + kRing * rows;  // [2][rs], by stage parity
  float* mult = red + 2 * rs;
  float* slot = mult + rows;
  float* gs = slot + 2 * rows;
  float* cs = gs + over;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  constexpr int kOwn = kThreads * NREG;  // first column past the registers
  const unsigned rank = cluster_ctarank(), csize = cluster_nctarank();
  const int c0 = (int)rank * ds;     // the slice's first column
  const int wd = min(ds, d - c0);    // and its width

  // the cluster's run of window rows [r0, r0 + len), in stages of `rows`
  const int64_t nb = gridDim.x / csize, b = blockIdx.x / csize;
  const int64_t q = lb / nb, rem = lb % nb;
  const int64_t r0 = b * q + min(b, rem);
  const int64_t len = q + (b < rem ? 1 : 0);
  const int64_t nstages = (len + rows - 1) / rows;

  float c[NREG], g[NREG];
#pragma unroll
  for (int j = 0; j < NREG; ++j) {
    const int col = t + kThreads * j;
    c[j] = col < wd ? __ldg(coeffs + c0 + col) : 0.f;
    g[j] = 0.f;
  }
  for (int64_t e = t; e < over; e += kThreads) {  // this thread's own
    gs[e] = 0.f;
    cs[e] = kOwn + e < wd ? __ldg(coeffs + c0 + kOwn + e) : 0.f;
  }
  float lsum = 0.f, wsum = 0.f;  // rank 0's thread r < rows: row slot r's

  // floats before the slice of table row `row` in its pitch
  auto lead = [&](int64_t row) {
    return vec4 ? (int)((row * d + c0) & 3) : 0;
  };
  if (t == 0) {
    for (int k = 0; k < kRing; ++k) mbar_init(&full[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // stage s into ring buffer s % kRing: where x is 16-byte aligned, thread
  // 0 arms the buffer's mbarrier and copies each row's slice from the
  // aligned address at or before it to the last 16-byte boundary in it by
  // one bulk copy, and lanes of warp 1 copy the up to 3 floats after that
  // by cp.async; else 4-byte cp.async copies all (thread 0 arms the
  // barrier for no bytes). Labels and weights by cp.async; every thread
  // commits one cp.async group a stage (an empty one past the last).
  auto issue = [&](int64_t s) {
    if (s < nstages) {
      const int nr = (int)min((int64_t)rows, len - s * rows);
      const int64_t i = r0 + s * rows;  // window index of the first row
      const int buf = (int)(s % kRing);
      float* dst = ring + buf * sf;
      if (vec4) {
        if (t == 0) {
          unsigned bytes = 0;
          for (int r = 0; r < nr; ++r) {
            const int64_t g0 = (start + i + r) * d + c0;
            bytes += (unsigned)(4 * (((g0 + wd) & ~(int64_t)3) -
                                     (g0 & ~(int64_t)3)));
          }
          mbar_arrive_expect_tx(&full[buf], bytes);
          for (int r = 0; r < nr; ++r) {
            const int64_t g0 = (start + i + r) * d + c0;
            const int64_t a0 = g0 & ~(int64_t)3, a1 = (g0 + wd) & ~(int64_t)3;
            bulk_copy(dst + r * pitch, x + a0, (unsigned)(4 * (a1 - a0)),
                      &full[buf]);
          }
        } else if (warp == 1) {
          for (int r = 0; r < nr; ++r) {
            const int64_t g0 = (start + i + r) * d + c0;
            const int64_t a0 = g0 & ~(int64_t)3, a1 = (g0 + wd) & ~(int64_t)3;
            if (lane < (int)(g0 + wd - a1))
              cp_async4(dst + r * pitch + (a1 - a0) + lane, x + a1 + lane, 4);
          }
        }
      } else {
        if (t == 0) mbar_arrive_expect_tx(&full[buf], 0);
        for (int r = 0; r < nr; ++r) {
          const int64_t g0 = (start + i + r) * d + c0;  // the slice's first
          for (int f = t; f < wd; f += kThreads)
            cp_async4(dst + r * pitch + f, x + g0 + f, 4);
        }
      }
      if (t < nr) {
        float* yd = ys + (s % kRing) * rows;
        float* wdst = wv + (s % kRing) * rows;
        cp_async4(yd + t, y + start + i + t, 4);
        cp_async4(wdst + t, w + start + i + t, i + t >= clip ? 4 : 0);
      }
    }
    cp_async_commit();
  };

#ifdef SGD_PHASE_CLOCKS
  long long phase_c_[kPhases] = {0, 0, 0, 0, 0, 0, 0};
#endif
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) issue(s);
  for (int64_t s = 0; s < nstages; ++s) {
    PHASE_START();
    const int at = (int)(s % kRing);
    cp_async_wait<kRing - 2>();  // this thread's copies of stage s
    mbar_wait(&full[at], (unsigned)(s / kRing) & 1);  // its bulk copies
    __syncthreads();  // everyone's; and stage s - 1's buffer is read
    PHASE_END(0);
    const int nr = (int)min((int64_t)rows, len - s * rows);
    const float* xs = ring + at * sf;
    const int64_t row0 = start + r0 + s * rows;  // table row of the first
    float* part = red + (s & 1) * rs;  // this stage's warp sums
    // each row's partial dot over the slice: this thread's columns in
    // order, then four rows summed over the warp together; the warps'
    // sums go to part, which the whole cluster reads
    for (int rb = 0; rb < nr; rb += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float acc = 0.f;
        if (rb + u < nr) {  // the same in every thread; past nr: zeros
          const float* xrow = xs + (rb + u) * pitch + lead(row0 + rb + u);
#pragma unroll
          for (int j = 0; j < NREG; ++j) {
            const int col = t + kThreads * j;
            if (col < wd) acc = fmaf(xrow[col], c[j], acc);
          }
          acc = over_dot(xrow, cs, acc, t, kOwn, wd);
        }
        v[u] = acc;
      }
      const float dot = rows_sum<4>(v, lane);  // row rb + lane / 8
      if ((lane & 7) == 0 && rb + lane / 8 < nr)
        part[(rb + lane / 8) * kWarps + warp] = dot;
    }
    PHASE_END(1);
    cluster_arrive();  // this thread's sums of stage s are written
    PHASE_END(2);
    issue(s + kRing - 1);  // while the cluster's other CTAs arrive
    PHASE_END(3);
    cluster_wait();  // every CTA's sums of stage s are in its part
    PHASE_END(4);
    if (t < nr) {
      // row t's dot: each CTA's warps added in warp order, the CTAs' sums
      // in rank order
      float dot = 0.f;
      for (unsigned q2 = 0; q2 < csize; ++q2) {
        float w8[kWarps];
#pragma unroll
        for (int k = 0; k < kWarps; ++k)
          w8[k] = ld_cluster(part + t * kWarps + k, q2);
        float p = w8[0];
#pragma unroll
        for (int k = 1; k < kWarps; ++k) p += w8[k];
        dot = q2 == 0 ? p : dot + p;
      }
      const float wt = wv[at * rows + t];
      float loss, m;
      row_terms<LOSS>(dot, ys[at * rows + t], wt, loss, m);
      mult[t] = m;
      if (rank == 0) {
        lsum += loss;
        wsum += wt;
      }
    }
    __syncthreads();
    PHASE_END(5);
    for (int r = 0; r < nr; ++r) {
      const float m = mult[r];
      const float* xrow = xs + r * pitch + lead(row0 + r);
#pragma unroll
      for (int j = 0; j < NREG; ++j) {
        const int col = t + kThreads * j;
        if (col < wd) g[j] = fmaf(m, xrow[col], g[j]);
      }
      over_axpy(xrow, gs, m, t, kOwn, wd);
    }
    PHASE_END(6);
  }
  cp_async_wait<0>();
  cluster_arrive();  // no CTA leaves while another may read its sums
  cluster_wait();

  float* dst = partials + b * (int64_t)(d + 2) + c0;
#pragma unroll
  for (int j = 0; j < NREG; ++j) {
    const int col = t + kThreads * j;
    if (col < wd) dst[col] = g[j];
  }
  for (int col = kOwn + t; col < wd; col += kThreads)
    dst[col] = gs[col - kOwn];
  if (rank == 0) {
    if (t < rows) {
      slot[t] = wsum;
      slot[rows + t] = lsum;
    }
    __syncthreads();
    if (t == 0) {
      float ws_ = 0.f, ls_ = 0.f;
      for (int r = 0; r < rows; ++r) {
        ws_ += slot[r];
        ls_ += slot[rows + r];
      }
      dst[d - c0] = ws_;
      dst[d - c0 + 1] = ls_;
    }
  }
#ifdef SGD_PHASE_CLOCKS
  if (blockIdx.x == 0)
    for (int k = 0; k < kPhases; ++k)
      sgd_phase_cycles[t * kPhases + k] = phase_c_[k];
#endif
}

// ---------------------------------------------------------------------------
// Stage 1 for rows past what a cluster of kClusterMax holds: every CTA the
// card holds at once splits each row's columns, the partial dots meeting
// through device memory once a stage.

constexpr int kGridThreads = 512;  // threads of a grid CTA: 16 warps
constexpr int kGridWarps = kGridThreads / 32;
constexpr int kGridMaxRows = 32;  // rows of a grid stage at most
// widest slice whose columns warps that own rows keep in registers (32 a
// lane)
constexpr int kGridRowCols = 32 * 32;
static_assert(kGridMaxRows <= 32, "a stage's rows are copied a lane each");
// partials a lane of an owner's warp loads for a row at once: 32 *
// kGridLoads CTAs a pass
constexpr int kGridLoads = 5;
// Clock cycles thread 0 of a grid CTA spins at a barrier before it traps
// (about 20 s at the H100's clocks): the cooperative launch makes every CTA
// resident, so the bound is only ever met by a fault, which it turns into
// a launch error instead of a hang.
constexpr long long kGridSpinCycles = 1LL << 35;

// Columns of a row a thread of the grid instance keeps in registers,
// kGridThreads apart: 4, 8 or 16.
__host__ __device__ constexpr int grid_nreg(int ds) {
  return ds <= 4 * kGridThreads ? 4 : ds <= 8 * kGridThreads ? 8 : 16;
}

// Columns of a grid CTA's slice past its threads' registers.
__host__ __device__ constexpr int64_t grid_over(int ds) {
  return ((int64_t)ds + kGridThreads - 1) / kGridThreads * kGridThreads >
                 (int64_t)kGridThreads * grid_nreg(ds)
             ? ((int64_t)ds + kGridThreads - 1) / kGridThreads *
                       kGridThreads -
                   (int64_t)kGridThreads * grid_nreg(ds)
             : 0;
}

__host__ __device__ constexpr int64_t grid_smem_floats(int ds, int rows) {
  return kRing * (int64_t)rows * row_pitch(ds) + 2 * kRing +
         2 * kRing * (int64_t)rows +
         (int64_t)(rows + 3) / 4 * 4 * kGridWarps + 3 * (int64_t)rows +
         2 * grid_over(ds);
}

// The grid instance's scratch: two stages' partial dots (2 * rows * grid
// floats) and dots (2 * rows), then its two barriers' uint32 counters.
constexpr int64_t grid_scratch_floats(int rows, int grid) {
  return 2 * (int64_t)rows * (grid + 1) + 2;
}

// The grid barriers' halves, as CUTLASS's generic barrier: the arrive, a
// block barrier (every thread's writes before it are made) then one
// thread's acq_rel fence and add to the barrier's counter; the wait, that
// thread's spin on an acquire load until every CTA has arrived, then a
// block barrier. Work between the two overlaps the barrier. A counter counts
// arrivals over the whole launch (the k-th wait of a barrier waits for G
// k), compared modulo 2^32.

// The thread that arrives at and waits for the grid barriers: lane 0 of the
// last warp, which issues no copies (a gpu-scope fence in the warp that
// issued the stage copies ran about 5% slower end to end).
constexpr int kGridBarrierThread = kGridThreads - 32;

__device__ __forceinline__ void grid_arrive(unsigned* counter) {
  __syncthreads();
  if (threadIdx.x == kGridBarrierThread)
    asm volatile(
        "fence.acq_rel.gpu;\n"
        "red.relaxed.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter)
        : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void grid_wait(const unsigned* counter,
                                          unsigned target) {
  if (threadIdx.x == kGridBarrierThread) {
    const long long t0 = clock64();
    while ((int)(ld_acquire(counter) - target) < 0)
      if (clock64() - t0 > kGridSpinCycles) __trap();
  }
  __syncthreads();
}

// gs += m[0] x[0] + m[1] x[1] + ... over the four rows' columns past the
// registers, the rows added in order, each column's loads issued first.
__device__ __forceinline__ void over_axpy4(const float* const* xr,
                                           float* gs, const float* m, int t,
                                           int kOwn, int wd) {
  for (int col = kOwn + t; col < wd; col += kGridThreads) {
    float xv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) xv[u] = xr[u][col];
    float a = gs[col - kOwn];
#pragma unroll
    for (int u = 0; u < 4; ++u) a = fmaf(m[u], xv[u], a);
    gs[col - kOwn] = a;
  }
}

#ifdef SGD_PHASE_CLOCKS
// per thread of CTA 0: cycles in the wait at stage k - 1's first barrier,
// the owners' sums of its partials and the second arrive, the copy wait
// of stage k, its partial dots (to their store), the first arrive, the
// wait at stage k - 1's second barrier, its dots' reads and terms, its
// mult * x, and the copy issue of stage k + 2, over all iterations
constexpr int kGridPhases = 9;
__device__ long long sgd_grid_phase_cycles[kGridThreads * kGridPhases];
#endif

template <int LOSS, int NREG, bool ROWS>
__global__ void __launch_bounds__(kGridThreads, 1)
    sgd_grid_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ w,
                    const float* __restrict__ coeffs, float* __restrict__ out,
                    float* __restrict__ dots, unsigned* __restrict__ counters,
                    int64_t start, int64_t lb, int64_t clip, int d, int ds,
                    int rows, int vec4) {
  extern __shared__ __align__(16) float smem[];
  const int pitch = row_pitch(ds);
  const int64_t sf = (int64_t)rows * pitch, over = grid_over(ds);
  float* ring = smem;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRing * sf);
  float* ys = ring + kRing * sf + 2 * kRing;
  float* wv = ys + kRing * rows;
  float* red = wv + kRing * rows;  // [rows4][kGridWarps]
  float* mult = red + (rows + 3) / 4 * 4 * kGridWarps;
  float* slot = mult + rows;
  float* gs = slot + 2 * rows;
  float* cs = gs + over;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  constexpr int kOwn = kGridThreads * NREG;  // first column past registers
  const int G = gridDim.x, g = blockIdx.x;
  const int c0 = g * ds;           // the slice's first column
  const int wd = min(ds, d - c0);  // and its width
  const int64_t nstages = (lb + rows - 1) / rows;
  unsigned* first = counters;       // the stages' first barrier
  unsigned* second = counters + 1;  // and their second
  // the slice's column of this thread's j-th coefficient and sum: lane +
  // 32 j of the whole slice where warps own rows, t + 512 j else
  auto column = [&](int j) {
    return ROWS ? lane + 32 * j : t + kGridThreads * j;
  };

  float c[NREG], gr[NREG];
#pragma unroll
  for (int j = 0; j < NREG; ++j) {
    const int col = column(j);
    c[j] = col < wd ? __ldg(coeffs + c0 + col) : 0.f;
    gr[j] = 0.f;
  }
  for (int64_t e = t; e < over; e += kGridThreads) {  // this thread's own
    gs[e] = 0.f;
    cs[e] = kOwn + e < wd ? __ldg(coeffs + c0 + kOwn + e) : 0.f;
  }
  float lsum = 0.f, wsum = 0.f;  // CTA 0's thread r < rows: row slot r's

  if (t == 0) {
    for (int k = 0; k < kRing; ++k) mbar_init(&full[k]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // rows of stage s, and the floats before its row r's slice in the
  // row's pitch: (lead(s) + r (d & 3)) & 3
  auto stage_rows = [&](int64_t s) {
    return (int)min((int64_t)rows, lb - s * rows);
  };
  auto lead = [&](int64_t s) {
    return vec4 ? (int)(((start + s * rows) * d + c0) & 3) : 0;
  };
  const int dlead = vec4 ? d & 3 : 0;

  // stage s into ring buffer s % kRing: where x is 16-byte aligned, lane r
  // of warp 0 copies row r's slice from the aligned address at or before
  // it to the last 16-byte boundary in it by one bulk copy (none where that
  // is empty) on the buffer's mbarrier, which lane 0 arms first with the
  // stage's bytes, and the up to 3 floats after it by cp.async (one lane
  // issuing every row's copies, as the cluster instance does, took up to
  // 3,800 cycles a stage of 23 rows); else 4-byte cp.async copies all.
  // Labels and weights by cp.async; every thread commits one cp.async
  // group a stage.
  auto issue = [&](int64_t s) {
    if (s < nstages) {
      const int nr = stage_rows(s);
      const int64_t i = s * rows;  // window index of the stage's first row
      const int buf = (int)(s % kRing);
      float* dst = ring + buf * sf;
      if (vec4) {
        if (warp == 0) {
          const int64_t g0 = (start + i + lane) * d + c0;
          const int64_t a0 = g0 & ~(int64_t)3, a1 = (g0 + wd) & ~(int64_t)3;
          int bytes = lane < nr ? (int)(4 * (a1 - a0)) : 0;
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            bytes += __shfl_xor_sync(kAll, bytes, off);
          if (lane == 0) mbar_arrive_expect_tx(&full[buf], (unsigned)bytes);
          __syncwarp();
          if (lane < nr) {
            if (a1 > a0)
              bulk_copy(dst + lane * pitch, x + a0, (unsigned)(4 * (a1 - a0)),
                        &full[buf]);
            for (int f = 0; f < (int)(g0 + wd - a1); ++f)
              cp_async4(dst + lane * pitch + (a1 - a0) + f, x + a1 + f, 4);
          }
        }
      } else {
        if (t == 0) mbar_arrive_expect_tx(&full[buf], 0);
        for (int r = 0; r < nr; ++r) {
          const int64_t g0 = (start + i + r) * d + c0;  // the slice's first
          for (int f = t; f < wd; f += kGridThreads)
            cp_async4(dst + r * pitch + f, x + g0 + f, 4);
        }
      }
      if (t < nr) {
        cp_async4(ys + buf * rows + t, y + start + i + t, 4);
        cp_async4(wv + buf * rows + t, w + start + i + t, i + t >= clip ? 4 : 0);
      }
    }
    cp_async_commit();
  };

#ifdef SGD_PHASE_CLOCKS
  long long phase_c_[kGridPhases] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
#endif
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) issue(s);
  // iteration k: the owners' sums of stage k - 1, then stage k's partial
  // dots, then stage k - 1's terms and mult * x, so that each grid
  // barrier's latency lies behind a stage's work
  for (int64_t k = 0; k <= nstages; ++k) {
    PHASE_START();
    if (k >= 1) {
      const int64_t p = k - 1;
      grid_wait(first, (unsigned)G * (unsigned)k);
      PHASE_END(0);
      // row r of stage p is owned by CTA (p rows + r) % G, whose warp (its
      // j-th owned row) % 16 sums the row's G partials: every load issued
      // at once, lane l adding those of CTAs l, l + 32, ... in order, then
      // the lanes' sums by the fixed butterfly; lane 0 stores the dot
      const int np = stage_rows(p);
      const float* part = dots + (p & 1) * (int64_t)rows * G;
      float* rdot = dots + 2 * (int64_t)rows * G + (p & 1) * rows;
      const int own0 = (int)((g - p * rows % G + G) % G);
      for (int r = own0 + G * warp; r < np; r += G * kGridWarps) {
        const float* pr = part + (int64_t)r * G;
        float acc = 0.f;
        for (int q0 = 0; q0 < G; q0 += 32 * kGridLoads) {
          float pv[kGridLoads];
#pragma unroll
          for (int j = 0; j < kGridLoads; ++j) {
            const int q = q0 + lane + 32 * j;
            pv[j] = q < G ? __ldcg(pr + q) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < kGridLoads; ++j) acc += pv[j];
        }
        acc = warp_sum(acc);
        if (lane == 0) __stcg(rdot + r, acc);
      }
      grid_arrive(second);  // the rows of stage p this CTA owns are summed
      PHASE_END(1);
    }
    if (k < nstages) {
      const int at = (int)(k % kRing);
      cp_async_wait<kRing - 2>();  // this thread's copies of stage k
      mbar_wait(&full[at], (unsigned)(k / kRing) & 1);  // its bulk copies
      __syncthreads();  // everyone's
      PHASE_END(2);
      const int nr = stage_rows(k);
      const float* xs = ring + at * sf;
      const int lead0 = lead(k);
      float* part = dots + (k & 1) * (int64_t)rows * G;  // [rows][G]
      if (ROWS) {
        // warp r % 16 takes row r's partial dot over the whole slice: each
        // lane its columns in order, then the fixed butterfly; lane 0
        // stores it for the grid
        for (int r = warp; r < nr; r += kGridWarps) {
          const float* xrow = xs + r * pitch + ((lead0 + r * dlead) & 3);
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < NREG; ++j)
            if (column(j) < wd) acc = fmaf(xrow[column(j)], c[j], acc);
          acc = warp_sum(acc);
          if (lane == 0) __stcg(part + (int64_t)r * G + g, acc);
        }
      }
      // else each row's partial dot over the slice: this thread's columns
      // in order, four rows summed over the warp together, the warps' sums
      // in warp order by thread r for row r, which stores it for the grid
      for (int rb = 0; !ROWS && rb < nr; rb += 4) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float acc = 0.f;
          if (rb + u < nr) {  // the same in every thread; past nr: zeros
            const float* xrow =
                xs + (rb + u) * pitch + ((lead0 + (rb + u) * dlead) & 3);
#pragma unroll
            for (int j = 0; j < NREG; ++j) {
              const int col = t + kGridThreads * j;
              if (col < wd) acc = fmaf(xrow[col], c[j], acc);
            }
            acc = over_dot<kGridThreads>(xrow, cs, acc, t, kOwn, wd);
          }
          v[u] = acc;
        }
        const float dot = rows_sum<4>(v, lane);  // row rb + lane / 8
        if ((lane & 7) == 0 && rb + lane / 8 < nr)
          red[(rb + lane / 8) * kGridWarps + warp] = dot;
      }
      if (!ROWS) {
        __syncthreads();
        if (t < nr) {
          float sum = red[t * kGridWarps];
#pragma unroll
          for (int q2 = 1; q2 < kGridWarps; ++q2)
            sum += red[t * kGridWarps + q2];
          __stcg(part + (int64_t)t * G + g, sum);
        }
      }
      PHASE_END(3);
      grid_arrive(first);  // this CTA's partial dots of stage k are stored
      PHASE_END(4);
    }
    if (k >= 1) {
      const int64_t p = k - 1;
      grid_wait(second, (unsigned)G * (unsigned)k);
      PHASE_END(5);
      // thread r takes row r's dot, the same float in every CTA, and its
      // terms
      const int np = stage_rows(p);
      const int at = (int)(p % kRing);
      const float* rdot = dots + 2 * (int64_t)rows * G + (p & 1) * rows;
      if (t < np) {
        const float wt = wv[at * rows + t];
        float loss, m;
        row_terms<LOSS>(__ldcg(rdot + t), ys[at * rows + t], wt, loss, m);
        mult[t] = m;
        if (g == 0) {
          lsum += loss;
          wsum += wt;
        }
      }
      __syncthreads();
      PHASE_END(6);
      // mult * x into this thread's columns, rows in order (where warps
      // own rows, the rows of warp w: r = w, w + 16, ...), four rows'
      // loads issued before their FMAs
      const float* xs = ring + at * sf;
      const int lead0 = lead(p);
      for (int r = warp; ROWS && r < np; r += kGridWarps) {
        const float m = mult[r];
        const float* xrow = xs + r * pitch + ((lead0 + r * dlead) & 3);
#pragma unroll
        for (int j = 0; j < NREG; ++j)
          if (column(j) < wd) gr[j] = fmaf(m, xrow[column(j)], gr[j]);
      }
      int r4 = ROWS ? np : 0;
      for (; r4 + 4 <= np; r4 += 4) {
        float m[4];
        const float* xr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          m[u] = mult[r4 + u];
          xr[u] = xs + (r4 + u) * pitch + ((lead0 + (r4 + u) * dlead) & 3);
        }
#pragma unroll
        for (int j = 0; j < NREG; ++j) {
          const int col = t + kGridThreads * j;
          if (col < wd) {
            float xv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) xv[u] = xr[u][col];
            float a = gr[j];
#pragma unroll
            for (int u = 0; u < 4; ++u) a = fmaf(m[u], xv[u], a);
            gr[j] = a;
          }
        }
        over_axpy4(xr, gs, m, t, kOwn, wd);
      }
      for (; r4 < np; ++r4) {
        const float m = mult[r4];
        const float* xrow = xs + r4 * pitch + ((lead0 + r4 * dlead) & 3);
#pragma unroll
        for (int j = 0; j < NREG; ++j) {
          const int col = t + kGridThreads * j;
          if (col < wd) gr[j] = fmaf(m, xrow[col], gr[j]);
        }
        over_axpy<kGridThreads>(xrow, gs, m, t, kOwn, wd);
      }
      PHASE_END(7);
    }
    __syncthreads();  // stage k - 1's buffer is read, and mult with it
    issue(k + 2);     // into that buffer
    PHASE_END(8);
  }
  cp_async_wait<0>();

  float* dst = out + c0;
  if (ROWS) {
    // the warps' sums of each column, through the ring (every stage is
    // consumed), added in warp order
    float* fin = ring;  // [kGridWarps][ds]
#pragma unroll
    for (int j = 0; j < NREG; ++j)
      if (column(j) < wd) fin[warp * ds + column(j)] = gr[j];
    __syncthreads();
    for (int col = t; col < wd; col += kGridThreads) {
      float sum = fin[col];
      for (int q = 1; q < kGridWarps; ++q) sum += fin[q * ds + col];
      dst[col] = sum;
    }
  } else {
#pragma unroll
    for (int j = 0; j < NREG; ++j) {
      const int col = t + kGridThreads * j;
      if (col < wd) dst[col] = gr[j];
    }
    for (int col = kOwn + t; col < wd; col += kGridThreads)
      dst[col] = gs[col - kOwn];
  }
  if (g == 0) {
    if (t < rows) {
      slot[t] = wsum;
      slot[rows + t] = lsum;
    }
    __syncthreads();
    if (t == 0) {
      float ws_ = 0.f, ls_ = 0.f;
      for (int q = 0; q < rows; ++q) {
        ws_ += slot[q];
        ls_ += slot[rows + q];
      }
      out[d] = ws_;
      out[d + 1] = ls_;
    }
  }
#ifdef SGD_PHASE_CLOCKS
  if (g == 0)
    for (int k = 0; k < kGridPhases; ++k)
      sgd_grid_phase_cycles[t * kGridPhases + k] = phase_c_[k];
#endif
}

// ---------------------------------------------------------------------------
// Stage 2: out[i] = the sum over b of partials[b][i] in reduce_partials'
// fixed two-level order (kmeans_kernels.cu): the B rows cut into Q
// contiguous slices of L = ceil(B / 32) rows, each added in row order from
// 0 (s = 0, s += partials[r][i]); then the slice sums added by a fixed
// pairwise tree at strides 1, 2, 4, 8, 16. A block of kCombThreads threads
// owns kCombCols columns; thread (j, c) adds slice j of column c, its loads
// issued kCombBatch at a time; thread c < kCombCols adds column c's tree.
constexpr int kCombCols = 8;     // columns of a combine block
constexpr int kCombSlices = 32;  // slices at most
constexpr int kCombThreads = kCombCols * kCombSlices;
constexpr int kCombBatch = 32;   // loads in flight per thread

// s = 0, s += p[r * width] for the rows r of [r0, r1), issued in batches
__device__ __forceinline__ float slice_sum(const float* __restrict__ p,
                                           int64_t width, int r0, int r1) {
  float s = 0.f;
  int r = r0;
  for (; r + kCombBatch <= r1; r += kCombBatch) {
    float v[kCombBatch];
#pragma unroll
    for (int b = 0; b < kCombBatch; ++b) v[b] = p[(r + b) * width];
#pragma unroll
    for (int b = 0; b < kCombBatch; ++b) s += v[b];
  }
  for (; r < r1; ++r) s += p[r * width];
  return s;
}

__global__ void __launch_bounds__(kCombThreads)
    sgd_combine_kernel(const float* __restrict__ partials,
                       float* __restrict__ out, int blocks, int width,
                       int slice_rows) {
  __shared__ float sums[kCombSlices][kCombCols];
  const int c = threadIdx.x % kCombCols, j = threadIdx.x / kCombCols;
  const int col = blockIdx.x * kCombCols + c;
  const int q = (blocks + slice_rows - 1) / slice_rows;  // slices
  sums[j][c] = col < width && j < q
                   ? slice_sum(partials + col, width, j * slice_rows,
                               min(blocks, (j + 1) * slice_rows))
                   : 0.f;
  __syncthreads();
  if (j != 0 || col >= width) return;
  float t[kCombSlices];
#pragma unroll
  for (int i = 0; i < kCombSlices; ++i) t[i] = sums[i][c];
  // t[0] += t[1], t[2] += t[3], ...; then at strides 2, 4, 8, 16;
  // t[i + stride] only where it is one of the q slices
#pragma unroll
  for (int stride = 1; stride < kCombSlices; stride *= 2)
#pragma unroll
    for (int i = 0; i + stride < kCombSlices; i += 2 * stride)
      if (i + stride < q) t[i] += t[i + stride];
  out[col] = t[0];
}

// ---------------------------------------------------------------------------
// Stage 1 for rows past what a grid of one CTA an SM holds: the two-pass
// set, (a) the partial dots, (b) the terms, (c) mult * x by column owners.

constexpr int kTwoThreads = 256;  // threads of a dots CTA: 8 warps
constexpr int kTwoWarps = kTwoThreads / 32;
constexpr int kTwoLoads = 4;  // float4s of a row a dots thread loads
constexpr int kTwoSegF4 = kTwoThreads * kTwoLoads;  // a segment's float4s
constexpr int kTwoSegCols = 4 * kTwoSegF4;  // a segment's columns: 4,096
constexpr int kTwoBandRows = 32;  // window rows of a dots CTA
constexpr int kTwoBatch = 4;      // rows a dots CTA loads at once
constexpr int kTwoMaxBands = 65535;  // row bands at most (gridDim.y)
constexpr int kTermsThreads = 256;  // threads of a terms CTA: a row a warp
constexpr int kTermsRows = kTermsThreads / 32;
constexpr int kTermsLoads = 16;  // partials a lane loads at once
constexpr int kOwnerThreads = 128;  // threads of an owner CTA at most
constexpr int kOwnerBatch = 16;  // rows an owner thread loads at once
static_assert(kTwoBatch == 4, "a batch's rows are summed by rows_sum<4>");

// Segments of a row of width d: its float4s from the aligned address at or
// before its first float where vec4 (up to 3 floats of the rows beside it:
// (d + 6) / 4 where d % 4 != 0), its columns in fours else, in runs of
// kTwoSegF4.
__host__ __device__ constexpr int twopass_segments(int d, int vec4) {
  return (int)(((vec4 && d % 4 ? ((int64_t)d + 6) / 4
                               : ((int64_t)d + 3) / 4) +
                kTwoSegF4 - 1) /
               kTwoSegF4);
}

// Threads of an owner CTA of (c) at width d, four columns each: 128 from
// 262,144 columns, 64 from 131,072 and 32 below, so that there are at
// least 512 owner CTAs (a few an SM on an H100) down to 65,536 columns.
__host__ __device__ constexpr int twopass_owner_threads(int d) {
  return d >= 4 * 128 * 512 ? 128 : d >= 4 * 64 * 512 ? 64 : 32;
}

// The two-pass set's scratch for a window of lb rows: the partial dots
// (lb * segments floats), the multipliers (lb), then the terms CTAs'
// weight and loss sums (2 * ceil(lb / kTermsRows)).
constexpr int64_t twopass_scratch_floats(int64_t lb, int segments) {
  return lb * segments + lb + 2 * ((lb + kTermsRows - 1) / kTermsRows);
}

// a plus the products of a row's columns col .. col + 3 (in xv; those
// outside [0, d) skipped) and cs[e .. e + 3], in column order.
__device__ __forceinline__ float dot4_masked(float a, float4 xv,
                                             const float* cs, int e, int col,
                                             int d) {
  a = fmaf((unsigned)col < (unsigned)d ? xv.x : 0.f, cs[e], a);
  a = fmaf((unsigned)(col + 1) < (unsigned)d ? xv.y : 0.f, cs[e + 1], a);
  a = fmaf((unsigned)(col + 2) < (unsigned)d ? xv.z : 0.f, cs[e + 2], a);
  return fmaf((unsigned)(col + 3) < (unsigned)d ? xv.w : 0.f, cs[e + 3], a);
}

// The floats p[0 .. n) (n < 4) as a float4, 0 past them: the window's
// last float4 where the window does not end on a 16-byte boundary, since
// nothing past the window's last float need belong to x.
__device__ __forceinline__ float4 ldcs_head(const float* p, int64_t n) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n > 0) v.x = __ldcs(p);
  if (n > 1) v.y = __ldcs(p + 1);
  if (n > 2) v.z = __ldcs(p + 2);
  return v;
}

// (a): CTA (s, b) stores part[j][s], the dot of window row j's segment s
// with the coefficients, for the rows j of band b. With VEC4 (x 16-byte
// aligned) segment s of a row is its float4s [s kTwoSegF4, (s + 1)
// kTwoSegF4) counted from the aligned address at or before its first
// float (o floats before it), thread t's the float4s s kTwoSegF4 + t +
// kTwoThreads u, column 4i + k - o for element k of float4 i (the
// window's last float4 read by 4-byte loads up to its last float where it
// ends inside one); else its columns [s kTwoSegCols, (s + 1) kTwoSegCols),
// thread t's s kTwoSegCols + t + kTwoThreads (4u + k), by 4-byte loads.
template <bool VEC4>
__global__ void __launch_bounds__(kTwoThreads, 2)
    sgd_twopass_dots_kernel(const float* __restrict__ x,
                            const float* __restrict__ coeffs,
                            float* __restrict__ part, int64_t start,
                            int64_t lb, int d, int segments) {
  __shared__ __align__(16) float cs[kTwoSegCols + 8];
  __shared__ float red[2][kTwoBatch][kTwoWarps];
  const int s = blockIdx.x, t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  const int c0 = s * kTwoSegCols;  // the column of the segment's float 0
  // cs[e]: the coefficient of column c0 - 4 + e, 0 outside the row
  for (int e = t; e < kTwoSegCols + 8; e += kTwoThreads) {
    const int col = c0 - 4 + e;
    cs[e] = col >= 0 && col < d ? coeffs[col] : 0.f;
  }
  __syncthreads();
  const int64_t j0 = (int64_t)blockIdx.y * kTwoBandRows;
  const int64_t j1 = min(lb, j0 + kTwoBandRows);
  const int64_t end = (start + lb) * (int64_t)d;  // past the window's floats
  int parity = 0;
  for (int64_t j = j0; j < j1; j += kTwoBatch, parity ^= 1) {
    float4 v[kTwoBatch][kTwoLoads];
    int o[kTwoBatch];
#pragma unroll
    for (int r = 0; r < kTwoBatch; ++r) {
      o[r] = 0;
#pragma unroll
      for (int u = 0; u < kTwoLoads; ++u)
        v[r][u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j + r >= j1) continue;
      const int64_t f = (start + j + r) * (int64_t)d;  // the row's float 0
      if (VEC4) {
        o[r] = (int)(f & 3);
        const int64_t nq = ((int64_t)o[r] + d + 3) / 4;  // the row's float4s
        const int64_t q = (f >> 2) + (int64_t)s * kTwoSegF4 + t;
        const float4* p = reinterpret_cast<const float4*>(x) + q;
#pragma unroll
        for (int u = 0; u < kTwoLoads; ++u) {
          if ((int64_t)s * kTwoSegF4 + t + kTwoThreads * u >= nq) continue;
          const int64_t e0 = 4 * (q + kTwoThreads * u);  // its first float
          v[r][u] = e0 + 4 <= end ? __ldcs(p + kTwoThreads * u)
                                  : ldcs_head(x + e0, end - e0);
        }
      } else {
        const float* p = x + f + c0 + t;
#pragma unroll
        for (int u = 0; u < kTwoLoads; ++u) {
          const int col = c0 + t + 4 * kTwoThreads * u;
          const float* q = p + 4 * kTwoThreads * u;
          if (col < d) v[r][u].x = __ldcs(q);
          if (col + kTwoThreads < d) v[r][u].y = __ldcs(q + kTwoThreads);
          if (col + 2 * kTwoThreads < d)
            v[r][u].z = __ldcs(q + 2 * kTwoThreads);
          if (col + 3 * kTwoThreads < d)
            v[r][u].w = __ldcs(q + 3 * kTwoThreads);
        }
      }
    }
    float acc[kTwoBatch];
#pragma unroll
    for (int r = 0; r < kTwoBatch; ++r) {
      float a = 0.f;
#pragma unroll
      for (int u = 0; u < kTwoLoads; ++u) {
        const float4 xv = v[r][u];
        if (!VEC4) {  // columns past d read 0, and their coefficients are 0
          const float* c = cs + 4 + t + 4 * kTwoThreads * u;
          a = fmaf(xv.x, c[0], a);
          a = fmaf(xv.y, c[kTwoThreads], a);
          a = fmaf(xv.z, c[2 * kTwoThreads], a);
          a = fmaf(xv.w, c[3 * kTwoThreads], a);
          continue;
        }
        const int e = 4 * (t + kTwoThreads * u) - o[r] + 4;
        const int col = c0 + e - 4;
        if (o[r] == 0 && col + 4 <= d) {
          const float4 cv = *reinterpret_cast<const float4*>(cs + e);
          a = fmaf(xv.x, cv.x, a);
          a = fmaf(xv.y, cv.y, a);
          a = fmaf(xv.z, cv.z, a);
          a = fmaf(xv.w, cv.w, a);
        } else {
          a = dot4_masked(a, xv, cs, e, col, d);
        }
      }
      acc[r] = a;
    }
    // lane l holds row l / 8's sum over the warp
    const float sum = rows_sum<kTwoBatch>(acc, lane);
    if (lane % (32 / kTwoBatch) == 0)
      red[parity][lane / (32 / kTwoBatch)][warp] = sum;
    __syncthreads();
    if (t < kTwoBatch && j + t < j1) {
      float dot = red[parity][t][0];
#pragma unroll
      for (int k = 1; k < kTwoWarps; ++k) dot += red[parity][t][k];
      part[(j + t) * segments + s] = dot;
    }
  }
}

// (b): CTA b's warp g takes window row j = kTermsRows b + g: lane l adds
// the row's partials l, l + 32, ... in segment order, the lanes' sums
// meet by the fixed butterfly, lane 0 takes the row's terms and writes its
// multiplier; the CTA's weight and loss, its rows' in row order, go to
// sums[b] for (c) to add.
template <int LOSS>
__global__ void __launch_bounds__(kTermsThreads)
    sgd_twopass_mult_kernel(const float* __restrict__ part,
                            const float* __restrict__ y,
                            const float* __restrict__ w,
                            float* __restrict__ mult, float* __restrict__ sums,
                            int64_t start, int64_t lb, int64_t clip,
                            int segments) {
  __shared__ float wl[2][kTermsRows];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t j = (int64_t)blockIdx.x * kTermsRows + warp;
  float wi = 0.f, loss = 0.f;
  if (j < lb) {
    const float* p = part + j * segments;
    float acc = 0.f;
    for (int q0 = lane; q0 < segments; q0 += 32 * kTermsLoads) {
      float v[kTermsLoads];
#pragma unroll
      for (int b = 0; b < kTermsLoads; ++b)
        v[b] = q0 + 32 * b < segments ? p[q0 + 32 * b] : 0.f;
#pragma unroll
      for (int b = 0; b < kTermsLoads; ++b)
        if (q0 + 32 * b < segments) acc += v[b];
    }
    const float dot = warp_sum(acc);
    if (lane == 0) {
      wi = j >= clip ? w[start + j] : 0.f;
      float m;
      row_terms<LOSS>(dot, y[start + j], wi, loss, m);
      mult[j] = m;
    }
  }
  if (lane == 0) {
    wl[0][warp] = wi;
    wl[1][warp] = loss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = wl[0][0], c = wl[1][0];
    for (int k = 1; k < kTermsRows; ++k) {
      a += wl[0][k];
      c += wl[1][k];
    }
    sums[2 * blockIdx.x] = a;
    sums[2 * blockIdx.x + 1] = c;
  }
}

// (c): CTA b of T threads owns the columns [4 T b, 4 T (b + 1)) of every
// window row and adds mult[j] * x[j] into them for the rows j in order,
// its sums in registers, kOwnerBatch rows' loads in flight a thread; first
// thread 0 of CTA 0 adds (b)'s nsums weight and loss sums in CTA order
// into out[d] and out[d + 1]. With
// VEC4 (x 16-byte aligned and d % 4 == 0, so every slice starts aligned)
// thread t owns the four columns from 4t, one 16-byte load a row; else
// the columns t + T k (k < 4), four 4-byte loads a row, each coalesced.
// The sums are doubles (each product exact, rounded to float once at the
// end): float sums in row order drifted an LR fit at 2,097,152 columns
// over 1,250 rows from its float64 rounds by 1.7 times chip_smoke.py's
// fit tolerance, where float dots with double sums stayed within 0.07 of
// it (scripts/port_sgd_fit_precision.py, PERF.md).
template <bool VEC4>
__global__ void __launch_bounds__(kOwnerThreads, 4)
    sgd_twopass_axpy_kernel(const float* __restrict__ x,
                            const float* __restrict__ mult,
                            const float* __restrict__ sums,
                            float* __restrict__ out, int64_t start,
                            int64_t lb, int d, int nsums) {
  const int t = threadIdx.x, T = blockDim.x;
  if (blockIdx.x == 0 && t == 0) {
    out[d] = slice_sum(sums, 2, 0, nsums);
    out[d + 1] = slice_sum(sums + 1, 2, 0, nsums);
  }
  const int c0 = blockIdx.x * 4 * T;
  const int width = min(4 * T, d - c0);  // the slice's columns
  // the offsets of the thread's four columns in the slice
  const int k0 = VEC4 ? 4 * t : t, step = VEC4 ? 1 : T;
  double g[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t j = 0; j < lb; j += kOwnerBatch) {
    float4 v[kOwnerBatch];
    float m[kOwnerBatch];
#pragma unroll
    for (int r = 0; r < kOwnerBatch; ++r) {
      v[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      m[r] = 0.f;
      if (j + r >= lb) continue;
      m[r] = __ldg(mult + j + r);
      const float* p = x + (start + j + r) * (int64_t)d + c0 + k0;
      if (VEC4) {
        if (k0 < width) v[r] = __ldcs(reinterpret_cast<const float4*>(p));
      } else {
        if (k0 < width) v[r].x = __ldcs(p);
        if (k0 + T < width) v[r].y = __ldcs(p + T);
        if (k0 + 2 * T < width) v[r].z = __ldcs(p + 2 * T);
        if (k0 + 3 * T < width) v[r].w = __ldcs(p + 3 * T);
      }
    }
#pragma unroll
    for (int r = 0; r < kOwnerBatch; ++r) {
      const double mr = m[r];
      g[0] = fma(mr, (double)v[r].x, g[0]);
      g[1] = fma(mr, (double)v[r].y, g[1]);
      g[2] = fma(mr, (double)v[r].z, g[2]);
      g[3] = fma(mr, (double)v[r].w, g[3]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k0 + k * step < width) out[c0 + k0 + k * step] = (float)g[k];
}

// ---------------------------------------------------------------------------
// Instances and launch checks.

template <int LOSS>
const void* rows_kernel_of(int v, int vec4) {
  switch (2 * v + (vec4 != 0)) {
    case 2: return (const void*)sgd_rows_kernel<LOSS, 1, false>;
    case 3: return (const void*)sgd_rows_kernel<LOSS, 1, true>;
    case 4: return (const void*)sgd_rows_kernel<LOSS, 2, false>;
    case 5: return (const void*)sgd_rows_kernel<LOSS, 2, true>;
    case 6: return (const void*)sgd_rows_kernel<LOSS, 3, false>;
    case 7: return (const void*)sgd_rows_kernel<LOSS, 3, true>;
    case 8: return (const void*)sgd_rows_kernel<LOSS, 4, false>;
    case 9: return (const void*)sgd_rows_kernel<LOSS, 4, true>;
    default: return nullptr;
  }
}

template <int LOSS>
const void* staged_kernel_of(int d) {
  switch (staged_nreg(d)) {
    case 4: return (const void*)sgd_staged_kernel<LOSS, 4>;
    case 8: return (const void*)sgd_staged_kernel<LOSS, 8>;
    default: return (const void*)sgd_staged_kernel<LOSS, 16>;
  }
}

// The cluster instance for slices of ds > 4 * kThreads columns (every
// planned slice is wider than 13,209 / 8).
template <int LOSS>
const void* cluster_kernel_of(int ds) {
  switch (staged_nreg(ds)) {
    case 8: return (const void*)sgd_cluster_kernel<LOSS, 8>;
    case 16: return (const void*)sgd_cluster_kernel<LOSS, 16>;
    default: return nullptr;
  }
}

// The grid instance for a slice of ds columns: warps owning rows for
// slices of at most kGridRowCols, else threads owning columns.
template <int LOSS>
const void* grid_kernel_of(int ds) {
  if (ds <= kGridRowCols) return (const void*)sgd_grid_kernel<LOSS, 32, true>;
  switch (grid_nreg(ds)) {
    case 4: return (const void*)sgd_grid_kernel<LOSS, 4, false>;
    case 8: return (const void*)sgd_grid_kernel<LOSS, 8, false>;
    default: return (const void*)sgd_grid_kernel<LOSS, 16, false>;
  }
}

// Whether a launch of width d > kRegCols with no cluster and no grid
// stages whole rows (dc == d): the staged instance.
bool staged(int d, int dc) { return d > kRegCols && dc == d; }

template <int LOSS>
const void* wide_kernel_of(int d, int dc, int cluster, int grid) {
  if (grid) return grid_kernel_of<LOSS>(dc);
  if (cluster) return cluster_kernel_of<LOSS>(dc);
  return staged(d, dc) ? staged_kernel_of<LOSS>(d) : nullptr;
}

// The stage-1 instance of one kernel: sgd_rows_kernel<loss, v, vec4> for v
// = 1..4, else sgd_grid_kernel<loss, grid_nreg(dc)> over a grid of CTAs (dc
// the slice), sgd_cluster_kernel<loss, staged_nreg(dc)> in clusters (dc the
// slice), sgd_staged_kernel<loss, staged_nreg(d)> where whole rows are
// staged; nullptr for any other launch (the two-pass set has its own).
const void* kernel_of(int loss, int v, int vec4, int d, int dc, int cluster,
                      int grid) {
  switch (loss) {
    case kLogistic:
      return v ? rows_kernel_of<kLogistic>(v, vec4)
               : wide_kernel_of<kLogistic>(d, dc, cluster, grid);
    case kHinge:
      return v ? rows_kernel_of<kHinge>(v, vec4)
               : wide_kernel_of<kHinge>(d, dc, cluster, grid);
    case kLeastSquare:
      return v ? rows_kernel_of<kLeastSquare>(v, vec4)
               : wide_kernel_of<kLeastSquare>(d, dc, cluster, grid);
    default:
      return nullptr;
  }
}

// The two-pass set's terms kernel for a loss.
const void* twopass_mult_kernel_of(int loss) {
  switch (loss) {
    case kLogistic: return (const void*)sgd_twopass_mult_kernel<kLogistic>;
    case kHinge: return (const void*)sgd_twopass_mult_kernel<kHinge>;
    case kLeastSquare:
      return (const void*)sgd_twopass_mult_kernel<kLeastSquare>;
    default: return nullptr;
  }
}

// Dynamic shared memory of a stage-1 block: the warps' partials for the
// register instance, the Python side's layout for the others.
int stage1_smem(int v, int d, int smem) {
  return v ? 4 * kWarps * (d + 2) : smem;
}

// The launch the Python side planned must be one these kernels were
// written for: v = ceil(d / 128) up to kRegCols columns (vec4 for 16-byte
// rows at an aligned x); wider rows staged whole (dc = d) with the ring's
// shared memory; or split over clusters of 2, 4 or 8 CTAs whose slice dc is
// cluster_slice(d, cluster), wider than 4 * kThreads, with every CTA some
// columns, and the ring's shared memory; or split over a grid of `grid`
// CTAs whose slice dc is cluster_slice(d, grid), every CTA some columns,
// one partial row and a scratch of grid_scratch_floats; or the two-pass
// set (`segments` > 0): segments of kTwoSegCols columns, bands of
// kTwoBandRows rows, at most kTwoMaxBands of them, owner CTAs of
// twopass_owner_threads(d) threads, one partial row and a scratch of
// twopass_scratch_floats. `owner` is 0 for the other instances. vec4 of
// the staged, cluster, grid and two-pass instances needs only an aligned x.
cudaError_t check_config(const float* x, long long start, long long lb,
                         long long clip, int d, int v, int vec4, int blocks,
                         int rows, int dc, int smem, int segments, int owner,
                         int cluster, int grid, const float* scratch,
                         long long scratch_floats, int loss) {
  const bool aligned = (uintptr_t)x % 16 == 0;
  if (d < 1 || blocks < 1 || start < 0 || lb < 1 || clip < 0 || clip > lb ||
      (vec4 && !aligned) || cluster < 0 || grid < 0 || segments < 0 ||
      (cluster && grid) || (segments && (cluster || grid)) ||
      (!segments && owner) || (!segments && !grid && scratch_floats) ||
      twopass_mult_kernel_of(loss) == nullptr)
    return cudaErrorInvalidValue;
  if (segments)
    return v == 0 && d > kRegCols && blocks == 1 && scratch != nullptr &&
                   rows == kTwoBandRows && dc == kTwoSegCols &&
                   segments == twopass_segments(d, vec4) &&
                   owner == twopass_owner_threads(d) &&
                   (lb + kTwoBandRows - 1) / kTwoBandRows <= kTwoMaxBands &&
                   scratch_floats >= twopass_scratch_floats(lb, segments)
               ? cudaSuccess
               : cudaErrorInvalidValue;
  if (kernel_of(loss, v, vec4, d, dc, cluster, grid) == nullptr)
    return cudaErrorInvalidValue;
  if (d <= kRegCols)
    return v == (d + 127) / 128 && !(vec4 && d % 4 != 0) && !cluster &&
                   !grid
               ? cudaSuccess
               : cudaErrorInvalidValue;
  if (v != 0 || rows < 1) return cudaErrorInvalidValue;
  if (grid)
    return blocks == 1 && scratch != nullptr &&
                   scratch_floats >= grid_scratch_floats(rows, grid) &&
                   dc == cluster_slice(d, grid) &&
                   (int64_t)(grid - 1) * dc < d && rows <= kGridMaxRows &&
                   (dc > kGridRowCols ||
                    kRing * (int64_t)rows * row_pitch(dc) >=
                        (int64_t)kGridWarps * dc) &&
                   smem <= kSmemBlockMax &&
                   (int64_t)smem >= 4 * grid_smem_floats(dc, rows)
               ? cudaSuccess
               : cudaErrorInvalidValue;
  if (cluster)
    return (cluster == 2 || cluster == 4 || cluster == kClusterMax) &&
                   dc == cluster_slice(d, cluster) && dc > 4 * kThreads &&
                   (int64_t)(cluster - 1) * dc < d &&
                   rows <= kStageMaxRows && smem <= kSmemBlockMax &&
                   (int64_t)smem >= 4 * cluster_smem_floats(dc, rows)
               ? cudaSuccess
               : cudaErrorInvalidValue;
  return rows <= kStageMaxRows && smem <= kSmemBlockMax &&
                 (int64_t)smem >= 4 * staged_smem_floats(d, rows)
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The launch of a cluster of `cluster` CTAs a grid of blocks * cluster.
cudaLaunchConfig_t cluster_config(int blocks, int cluster, int smem,
                                  cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

const char* sgd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Resident blocks of one SM for a stage-1 instance (v, vec4 and dc as in
// sgd_batch_terms, d the row width; smem is the staged instance's, 0 for
// the register one). Lets the instance use its dynamic shared
// memory first (the staged instances all a block may have, as their
// widths differ): the one place the attribute is set, so a process sets it
// once per instance (the Python side caches the answer).
int sgd_blocks_per_sm(int loss, int v, int vec4, int d, int dc, int smem,
                      int* out) {
  const void* fn = kernel_of(loss, v, vec4, d, dc, 0, 0);
  if (fn == nullptr || d < 1) return (int)cudaErrorInvalidValue;
  const int bytes = stage1_smem(v, d, smem);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      !v && staged(d, dc) ? (int)kSmemBlockMax : bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, fn, kThreads, (size_t)bytes);
}

// Clusters of the cluster instance the whole card holds at once (slice ds
// of width d, `cluster` CTAs of smem bytes each), from
// cudaOccupancyMaxActiveClusters. Lets the instance use all the dynamic
// shared memory a block may have first, as sgd_blocks_per_sm does for the
// others.
int sgd_clusters_on_card(int loss, int d, int ds, int cluster, int smem,
                         int* out) {
  const void* fn = kernel_of(loss, 0, 0, d, ds, cluster, 0);
  if (fn == nullptr || d < 1 || cluster < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBlockMax);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(1, cluster, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}

// CTAs of the grid instance the whole card holds at once (slice ds of width
// d, smem bytes a CTA): the SMs times the CTAs an SM holds, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor. Lets the instance use all
// the dynamic shared memory a block may have first, as sgd_blocks_per_sm
// does for the others.
int sgd_grid_ctas_on_card(int loss, int d, int ds, int smem, int* out) {
  const void* fn = kernel_of(loss, 0, 0, d, ds, 0, 1);
  if (fn == nullptr || d < 1 || ds < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBlockMax);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0, device = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                    kGridThreads, (size_t)smem);
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *out = per_sm * sms;
  return (int)e;
}

// One SGD round's terms: stage 1 writes `blocks` partial rows of d + 2
// floats to ws, then (where `combine`) stage 2 writes their sum to the d + 2
// floats after them; both on `stream`. Where `combine` and blocks = 1 (the
// grid and two-pass instances always, the others at short windows) stage
// 1 writes its one row there itself and stage 2 is not launched: the sum
// of one row is that row, and the first row of ws is left unwritten. v,
// vec4, blocks and the staged, cluster, grid or two-pass layout (rows, dc,
// smem, segments, owner, cluster, grid) are ops/kernels.py's plan, and
// scratch_floats the scratch's size, which must hold what the launch
// writes there; the cluster
// instance runs `blocks` clusters of `cluster` CTAs, one partial row each;
// the grid instance `grid` CTAs launched cooperatively (so a grid the card
// cannot hold at once is refused, never left waiting at its barrier), one
// partial row in all (blocks = 1), its dots exchanged through `scratch`:
// two stages' partial dots and dots, then its two barriers' uint32
// counters, zeroed here before the launch (grid_scratch_floats); the
// two-pass set (segments > 0) its three kernels in order, mult · x by owner
// CTAs of `owner` threads, one partial row in all, `scratch` holding the
// partial dots, the multipliers and the terms CTAs' weight and loss sums
// (twopass_scratch_floats). A launch the card refuses returns its error:
// there is no other instance to fall back to.
int sgd_batch_terms(const float* x, const float* y, const float* w,
                    const float* coeffs, float* ws, long long start,
                    long long lb, long long clip, int d, int v, int vec4,
                    int blocks, int rows, int dc, int smem, int segments,
                    int owner, int cluster, int grid, float* scratch,
                    long long scratch_floats, int loss, int combine,
                    void* stream) {
  cudaError_t e = check_config(x, start, lb, clip, d, v, vec4, blocks, rows,
                               dc, smem, segments, owner, cluster, grid,
                               scratch, scratch_floats, loss);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  int64_t start64 = start, lb64 = lb, clip64 = clip;
  const int width = d + 2;
  const bool one_row = combine && blocks == 1;
  float* partials = one_row ? ws + width : ws;
  if (segments) {
    float* part = scratch;
    float* mult = scratch + lb64 * segments;
    float* sums = mult + lb64;
    int nsums = (int)((lb + kTermsRows - 1) / kTermsRows);
    void* dots_args[] = {&x, &coeffs, &part, &start64, &lb64, &d, &segments};
    e = cudaLaunchKernel(
        vec4 ? (const void*)sgd_twopass_dots_kernel<true>
             : (const void*)sgd_twopass_dots_kernel<false>,
        dim3(segments, (unsigned)((lb + rows - 1) / rows)),
        dim3(kTwoThreads), dots_args, 0, s);
    if (e != cudaSuccess) return (int)e;
    void* mult_args[] = {&part, &y,    &w,      &mult,
                         &sums, &start64, &lb64, &clip64, &segments};
    e = cudaLaunchKernel(twopass_mult_kernel_of(loss), dim3(nsums),
                         dim3(kTermsThreads), mult_args, 0, s);
    if (e != cudaSuccess) return (int)e;
    void* axpy_args[] = {&x,       &mult, &sums, &partials,
                         &start64, &lb64, &d,    &nsums};
    e = cudaLaunchKernel(
        vec4 && d % 4 == 0 ? (const void*)sgd_twopass_axpy_kernel<true>
                           : (const void*)sgd_twopass_axpy_kernel<false>,
        dim3((d + 4 * owner - 1) / (4 * owner)), dim3(owner), axpy_args, 0,
        s);
    return (int)e;  // one partial row (blocks = 1): no combine
  }
  const void* fn = kernel_of(loss, v, vec4, d, dc, cluster, grid);
  if (v) {
    void* args[] = {&x, &y, &w, &coeffs, &partials, &start64, &lb64, &clip64,
                    &d};
    e = cudaLaunchKernel(fn, dim3(blocks), dim3(kThreads), args,
                         (size_t)stage1_smem(v, d, smem), s);
  } else if (grid) {
    unsigned* counters = reinterpret_cast<unsigned*>(
        scratch + 2 * (int64_t)rows * (grid + 1));
    e = cudaMemsetAsync(counters, 0, 2 * sizeof(unsigned), s);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {&x,       &y,    &w,      &coeffs, &partials,
                    &scratch, &counters, &start64, &lb64, &clip64,
                    &d,       &dc,   &rows,   &vec4};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(kGridThreads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = s;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelExC(&cfg, fn, args);
  } else if (cluster) {
    void* args[] = {&x,      &y,      &w, &coeffs, &partials, &start64,
                    &lb64,   &clip64, &d, &dc,     &rows,     &vec4};
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(blocks, cluster, smem, s, &attr);
    e = cudaLaunchKernelExC(&cfg, fn, args);
  } else {
    void* args[] = {&x,      &y,      &w, &coeffs, &partials, &start64,
                    &lb64,   &clip64, &d, &rows,   &vec4};
    e = cudaLaunchKernel(fn, dim3(blocks), dim3(kThreads), args,
                         (size_t)smem, s);
  }
  if (e != cudaSuccess || !combine || one_row) return (int)e;
  sgd_combine_kernel<<<(width + kCombCols - 1) / kCombCols, kCombThreads, 0,
                       s>>>(ws, ws + (int64_t)blocks * width, blocks, width,
                            (blocks + kCombSlices - 1) / kCombSlices);
  return (int)cudaGetLastError();
}

#ifdef SGD_PHASE_CLOCKS
int sgd_phase_cycles_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, sgd_phase_cycles,
                                   sizeof(sgd_phase_cycles));
}

int sgd_grid_phase_cycles_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, sgd_grid_phase_cycles,
                                   sizeof(sgd_grid_phase_cycles));
}
#endif

}  // extern "C"
