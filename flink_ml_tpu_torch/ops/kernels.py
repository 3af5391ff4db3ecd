"""The port's kernels: wrappers, plain versions, launch counts, launch plans.

The Pallas kernels of ``flink_ml_tpu/ops/pallas_kernels.py`` that the ported
slices run, written by hand in CUDA C++ for Hopper and built by ``_build.py``
at first use, one library per source:

- :func:`assign_nearest` (``csrc/kmeans_kernels.cu``): nearest centroid per
  row, ``argmin_j(‖c_j‖² − 2·x·c_j)``, first minimum; only the argmin is
  written.
- :func:`lloyd_partial_sums` (same source): the same assignment, then the
  weighted ``[one_hotᵀ·x | Σ one_hot]`` of one Lloyd round.
- Both run at every ``(k, d)``, by the route :func:`kmeans_plan` picks:
  the fused kernels where k·d is small and their 128-row tile fits a
  block's shared memory (the main path among those shapes; Lloyd in two
  fixed-order stages, per-block partials, then :func:`reduce_partials`),
  else the tiled route (the tile engine of ``csrc/tile_engine.cuh`` for
  the labels; for Lloyd
  then a stable counting sort of the rows by label and fixed pieces of the
  sorted rows, all from one C call; its stages' plain twins are
  :func:`assign_nearest_plain`, :func:`sort_by_label_plain` and
  :func:`piece_sums_plain`).
- :func:`sgd_batch_terms` (``csrc/sgd_kernels.cu``): one SGD round's
  ``[Σ mult·x | Σ w | Σ loss]`` over the minibatch window, forward dots and
  loss terms fused into the gradient pass, for any feature width, in two
  fixed-order stages launched by one C entry (per-block or per-cluster
  partials, then their sum in :func:`reduce_partials`' order;
  :func:`_sgd_plan` and :func:`sgd_runs` mirror the launch).
- :func:`segment_reduce_sum` (``csrc/segment_kernels.cu``): per-segment sums
  of 1-D or 2-D values, ids outside the domain dropped, in three stages
  launched by one C entry: each row chunk's id range, per-item partials of
  only the segment tiles a chunk meets, then a fixed-order combine of them
  (:func:`segment_plan_plain` mirrors the plan).
- :func:`knn_topk_indices` (``csrc/knn_kernels.cu``): the k nearest train
  rows of every test row, ties to the lowest index: fused distance and
  top-k over the streamed train set up to k = 80; past it the radix route
  (distance keys written by the tile engine, then per test row a radix
  select, a compaction and a stable radix sort; its stages' plain twins
  are :func:`knn_distance_keys_plain`, :func:`knn_radix_select_plain`,
  :func:`knn_compact_plain` and :func:`knn_radix_sort_plain`).

No float passes through an atomic (the one atomic is the SGD grid
instance's integer barrier counter), so a call gives the same bits every
time.

Each wrapper checks device, dtype, shape and contiguity and raises on
anything else. For a CUDA tensor it launches its kernel on the current
stream and adds one to its entry of :data:`launch_counts`, or raises: there
is no fallback. Inside a traced call (``FLINK_ML_TPU_TRACE_DIR``: a span
open on the thread) a launch also records the bytes and operations
:func:`launch_cost` gives for it (``observability/compilestats.py`` ``capture_cost``), which the
in-program profile holds its device time against; :data:`KERNEL_SYMBOLS`
names the kernel each CUDA symbol serves there. The ``*_plain`` versions compute the same functions in plain
PyTorch; a wrapper runs its plain version only for CPU tensors, and the
tests and ``chip_smoke.py`` hold the kernels against them.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from flink_ml_tpu_torch.observability import compilestats
from flink_ml_tpu_torch.observability.tracing import tracer as _tracer
from flink_ml_tpu_torch.ops import _build
from flink_ml_tpu_torch.ops.losses import LossFunc
from flink_ml_tpu_torch.resilience.policy import KernelLaunchError

KMEANS_SOURCE = "kmeans_kernels"
SGD_SOURCE = "sgd_kernels"
SEGMENT_SOURCE = "segment_kernels"
KNN_SOURCE = "knn_kernels"

#: what each kernel is and replaces, for reports (chip_smoke.py, PERF.md)
KERNELS = {
    "assign_nearest": {
        "route": "cuda", "source": "flink_ml_tpu_torch/csrc/kmeans_kernels.cu",
        "replaces": "flink_ml_tpu/ops/pallas_kernels.py:26"},
    "lloyd_partial_sums": {
        "route": "cuda", "source": "flink_ml_tpu_torch/csrc/kmeans_kernels.cu",
        "replaces": "flink_ml_tpu/ops/pallas_kernels.py:132"},
    # Lloyd's second stage (SGD's has its own copy in sgd_kernels.cu)
    "reduce_partials": {
        "route": "cuda", "source": "flink_ml_tpu_torch/csrc/kmeans_kernels.cu",
        "replaces": "flink_ml_tpu/ops/pallas_kernels.py:141"},
    "sgd_batch_terms": {
        "route": "cuda", "source": "flink_ml_tpu_torch/csrc/sgd_kernels.cu",
        "replaces": "flink_ml_tpu/ops/pallas_kernels.py:206"},
    "segment_reduce_sum": {
        "route": "cuda", "source": "flink_ml_tpu_torch/csrc/segment_kernels.cu",
        "replaces": "flink_ml_tpu/ops/pallas_kernels.py:332"},
    "knn_topk_indices": {
        "route": "cuda", "source": "flink_ml_tpu_torch/csrc/knn_kernels.cu",
        "replaces": "flink_ml_tpu/ops/pallas_kernels.py:421"},
}

#: each ``__global__`` function of the sources → the wrapper it serves
#: (device-time attribution of a profile, observability/profiling.py)
KERNEL_SYMBOLS = {
    "assign_kernel": "assign_nearest",
    "assign_tile_kernel": "assign_nearest",
    "lloyd_partials_kernel": "lloyd_partial_sums",
    "lloyd_label_kernel": "lloyd_partial_sums",
    "label_sort_kernel": "lloyd_partial_sums",
    "scan_reduce_kernel": "lloyd_partial_sums",
    "scan_top_kernel": "lloyd_partial_sums",
    "scan_down_kernel": "lloyd_partial_sums",
    "piece_sums_kernel": "lloyd_partial_sums",
    "piece_combine_kernel": "lloyd_partial_sums",
    "reduce_rows_kernel": "reduce_partials",
    "reduce_tile_kernel": "reduce_partials",
    "sgd_rows_kernel": "sgd_batch_terms",
    "sgd_staged_kernel": "sgd_batch_terms",
    "sgd_cluster_kernel": "sgd_batch_terms",
    "sgd_grid_kernel": "sgd_batch_terms",
    "sgd_twopass_dots_kernel": "sgd_batch_terms",
    "sgd_twopass_mult_kernel": "sgd_batch_terms",
    "sgd_twopass_axpy_kernel": "sgd_batch_terms",
    "sgd_combine_kernel": "sgd_batch_terms",
    "segment_ranges_kernel": "segment_reduce_sum",
    "segment_tiles_kernel": "segment_reduce_sum",
    "segment_combine_kernel": "segment_reduce_sum",
    "knn_tile_kernel": "knn_topk_indices",
    "knn_merge_kernel": "knn_topk_indices",
    "knn_long_kernel": "knn_topk_indices",
    "knn_long_merge_kernel": "knn_topk_indices",
    "knn_key_tile_kernel": "knn_topk_indices",
    "knn_select_kernel": "knn_topk_indices",
}

#: kernel launches by wrapper since the last :func:`reset_launch_counts`
launch_counts = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def launch_cost(name: str, **dims: int) -> Tuple[int, int]:
    """``(bytes, operations)`` of one call of the kernel ``name``: the bytes
    the function must move (each float32 input read once, each output
    written once) and the operations it does on its inputs, for the shapes
    in ``dims``. The one count of a kernel's work: the least time the card
    could take (``chip_smoke.py``'s ``bound_ms``) and the roofline share of
    a profile (``observability/profiling.py``) both read it.

    - ``assign_nearest``, ``lloyd_partial_sums``: ``n``, ``k``, ``d``;
    - ``reduce_partials``: ``blocks`` partials of ``inner`` floats each;
    - ``sgd_batch_terms``: a window of ``lb`` rows of ``d`` features;
    - ``segment_reduce_sum``: ``n`` rows of ``c`` values into ``u``
      segments;
    - ``knn_topk_indices``: ``n`` test rows, ``nt`` train rows, ``d``
      features, ``k`` neighbours.
    """
    g = dims.get
    if name == "assign_nearest":
        n, k, d = g("n"), g("k"), g("d")
        return 4 * (n * d + k * d + k + n), 2 * n * k * d
    if name == "lloyd_partial_sums":
        n, k, d = g("n"), g("k"), g("d")
        return (4 * (n * d + n + k * d + k + k * (d + 1)),
                2 * n * k * d + 2 * n * (d + 1))
    if name == "reduce_partials":
        blocks, inner = g("blocks"), g("inner")
        return 4 * (blocks + 1) * inner, blocks * inner
    if name == "sgd_batch_terms":
        lb, d = g("lb"), g("d")
        return 4 * (lb * d + 2 * lb + d + d + 2), 4 * lb * d
    if name == "segment_reduce_sum":
        n, c, u = g("n"), g("c"), g("u")
        return 4 * (n * c + n + u * c), n * c
    if name == "knn_topk_indices":
        n, nt, d, k = g("n"), g("nt"), g("d"), g("k")
        return 4 * (n * d + nt * d + n * k), 2 * n * nt * d
    raise KeyError(f"launch_cost: unknown kernel {name!r}")


def _capture_cost(name: str, **dims: int) -> None:
    """Record one launch's :func:`launch_cost`. A wrapper calls it inside a
    traced call only (a span open on this thread: the tracer is armed),
    after counting the launch; the open-span check is a thread-local read,
    cheaper than the tracer's env lookup, on the path of every launch."""
    compilestats.capture_cost(name, *launch_cost(name, **dims))


# -- KMeans launch plans ------------------------------------------------------

#: dynamic shared memory one block may use on Hopper (227 KB of the SM's 228)
SMEM_BLOCK_BYTES = 232448
#: shared memory for one staged chunk of centroids of the fused kernels;
#: more centroids than fit are scored chunk by chunk
CENTROID_CHUNK_BYTES = 64 << 10
#: centroids the fused kernels score together in registers; chunks are
#: multiples
_KG = 16
#: rows of a fused tile (= threads per block): the fused kernels run where
#: a tile of this many rows fits a block's shared memory
FUSED_TILE_ROWS = 128
#: most k·d the fused kernels take: their thread scores its row against
#: every centroid from shared memory, 16 FMAs for each 5 loads, where a
#: tiled thread does 64 (32 with the 64-centroid tile) for 4 but pads k
#: to 64 or 128 and d to 32. At 1,000,000 rows on an H100 (chip_smoke.py
#: phase 2's hand-over lines, PERF.md) the fused kernels were faster at
#: every timed k·d up to 6,400 (d = 100 with k up to 64, d = 375 with
#: k = 10); from 8,000 the tiled Lloyd was faster at all six timed shapes
#: and the tiled assign at four of six (the fused one by 7% at d = 16,
#: k = 500 and 13% at d = 128, k = 64)
FUSED_MAX_KD = 6_400
#: bits of a fused Lloyd block's offsets into its accumulator and x tile
#: (``kOffBits``)
FUSED_OFF_BITS = 16
#: rows of x of a tiled block and centroids of one of its tiles (``kTM``,
#: ``kTN`` of ``tile_engine.cuh``); columns of one of its steps (``kDK``)
TILE_ROWS, TILE_CENTROIDS, TILE_COLS = 128, 128, 32
#: widest padded row whose x tile stays in shared memory (``kXResMax``)
TILE_X_RESIDENT = 128
#: centroids of the label body's small tile, which k <= 64 takes (its other
#: instance scores TILE_CENTROIDS a tile)
TILE_CENTROIDS_SMALL = 64
#: warps of a label-sort block (``kSortWarps``); a chunk of rows is a
#: multiple of their 32-row batches, and at least the larger of
#: SORT_MIN_CHUNK_ROWS and k (so the offsets hold at most n + k ints)
SORT_WARPS = 8
SORT_MIN_CHUNK_ROWS = 2048
#: labels a sort block counts at once (8 warps' counters: 64 KB)
SORT_LABEL_TILE = 2048
#: threads of a scan block (``kScanThreads``), scan blocks at most
#: (``kScanMaxBlocks``), and offsets a scan block takes at least
SCAN_THREADS = 256
SCAN_MAX_BLOCKS = 1024
SCAN_MIN_SPAN = 1024
#: sorted rows of a piece at least, and columns of [x | 1] a piece block
#: adds at most (one a thread)
PIECE_MIN_ROWS = 256
PIECE_MAX_COLS = 256
#: signed 32-bit fields: row ids, places and label offsets of the tiled
#: route; TMA coordinates
INT32_MAX = 2 ** 31 - 1


def _fused_layout(k: int, d: int,
                  lloyd: bool) -> Optional[Tuple[int, int, int]]:
    """``(rows, kchunk, smem_bytes)`` of a fused launch with a
    :data:`FUSED_TILE_ROWS`-row tile, or None where none fits one block's
    shared memory. The sizes are the ones the layout comment in
    ``kmeans_kernels.cu`` lists: a transposed chunk of ``kchunk`` centroids
    and their norms, a ``rows`` × ``(d | 1)`` x tile and, for Lloyd, the
    tile's ``rows`` (label and row, weight) pairs in label order and the
    ``k`` × ``(d + 1)`` accumulator. Where it fits, both the accumulator
    and the x tile hold fewer than 2^16 floats, as the 16-bit offsets ask."""
    cap = max(_KG, CENTROID_CHUNK_BYTES // (4 * (d + 1)) // _KG * _KG)
    want = min(-(-k // _KG) * _KG, cap)
    rows = FUSED_TILE_ROWS
    for kchunk in dict.fromkeys((want, _KG)):
        floats = kchunk * d + kchunk + rows * (d | 1)
        if lloyd:
            floats += k * (d + 1) + 2 * rows
        if 4 * floats <= SMEM_BLOCK_BYTES:
            return rows, kchunk, 4 * floats
    return None


def label_stages(tn: int) -> int:
    """Stages of the label body's ring of copies (``label_stages`` of
    ``kmeans_kernels.cu``): four with 64-centroid tiles, three with 128,
    so that two blocks share an SM."""
    return 4 if tn == TILE_CENTROIDS_SMALL else 3


def label_smem_bytes(tn: int, dpad: int) -> int:
    """Shared memory of a tiled label block whose tiles hold ``tn``
    centroids, at padded width ``dpad`` (``label_smem_bytes`` of
    ``kmeans_kernels.cu``): up to :data:`TILE_X_RESIDENT` columns the x
    tile stays resident beside the ring's centroid boxes of TILE_COLS × tn
    (128 bytes to align); wider rows stream a TILE_ROWS × TILE_COLS x box
    in each stage too (1 KB to align the first for the copy's swizzle);
    two mbarriers a stage."""
    stages = label_stages(tn)
    if dpad <= TILE_X_RESIDENT:
        return (128 + 4 * (dpad * TILE_ROWS + stages * TILE_COLS * tn)
                + 16 * stages)
    return (1024 + 4 * stages * (TILE_ROWS * TILE_COLS + TILE_COLS * tn)
            + 16 * stages)


class KMeansPlan(NamedTuple):
    """How :func:`assign_nearest` or :func:`lloyd_partial_sums` launches
    (the C entries check it). ``route`` "fused": ``assign_kernel`` /
    ``lloyd_partials_kernel`` with a ``rows``-row tile and ``kchunk``
    centroids staged at once in ``smem`` bytes. ``route`` "tiled": the
    labels by the tile engine over the centroids transposed and padded to
    (``dpad``, ``kp``; kp = 64 takes the 64-centroid tile), in ``smem`` bytes at most a block; for Lloyd then
    the stable counting sort of the rows by label over ``nchunks`` chunks
    of ``chunk_rows`` rows and label tiles of ``label_tile``, the
    exclusive scan of its ``k · nchunks`` offsets by ``scan_blocks`` blocks
    of ``scan_span``, and the sums over ``pieces`` pieces of
    ``piece_rows`` sorted rows, ``col_threads`` columns a block."""
    route: str
    rows: int = 0
    kchunk: int = 0
    smem: int = 0
    dpad: int = 0
    kp: int = 0
    chunk_rows: int = 0
    nchunks: int = 0
    label_tile: int = 0
    scan_span: int = 0
    scan_blocks: int = 0
    piece_rows: int = 0
    pieces: int = 0
    col_threads: int = 0


@functools.lru_cache(maxsize=256)
def kmeans_plan(n: int, k: int, d: int, lloyd: bool) -> KMeansPlan:
    """The launch of a KMeans kernel over ``n`` >= 1 rows of width ``d``
    and ``k`` centroids. The fused route where k·d <= :data:`FUSED_MAX_KD`
    and its 128-row tile fits (:func:`_fused_layout`; the main path,
    1,000,000 × 100 and k = 10, among them; rows up to 403 wide for assign
    and 375 for Lloyd at k = 10); the tiled route everywhere else, any k
    and d:

    - the sort's chunks hold max(:data:`SORT_MIN_CHUNK_ROWS`, k) rows
      (rounded up to the 256-row batches of its 8 warps), so its k·nchunks
      offsets are at most n + k ints;
    - pieces hold ⌈n / (k + ⌈n / (d + 1)⌉)⌉ sorted rows, at least
      :data:`PIECE_MIN_ROWS` and a multiple of 32, so there are at most
      k + n / (d + 1) + 1 of them, and their scratch of 2(d + 1) floats a
      piece at most 2(n + (k + 1)(d + 1)) floats: device memory stays
      O(n + k·d) whatever the shape."""
    fused = _fused_layout(k, d, lloyd) if k * d <= FUSED_MAX_KD else None
    if fused is not None:
        return KMeansPlan("fused", *fused)
    return tiled_plan(n, k, d, lloyd)


def tiled_plan(n: int, k: int, d: int, lloyd: bool) -> KMeansPlan:
    """The tiled route's launch at any shape (:func:`kmeans_plan` past the
    fused tile; the card check also runs it where the fused one fits, to
    time the hand-over). Up to :data:`TILE_CENTROIDS_SMALL` centroids take
    the label body's 64-centroid tile (kp = 64), so small k pads no
    centroid to 128; more pad to a multiple of 128."""
    dpad = -(-d // TILE_COLS) * TILE_COLS
    if k <= TILE_CENTROIDS_SMALL:
        kp = TILE_CENTROIDS_SMALL
    else:
        kp = -(-k // TILE_CENTROIDS) * TILE_CENTROIDS
    smem = label_smem_bytes(min(kp, TILE_CENTROIDS), dpad)
    if not lloyd:
        return KMeansPlan("tiled", smem=smem, dpad=dpad, kp=kp)
    batch = 32 * SORT_WARPS
    chunk_rows = max(SORT_MIN_CHUNK_ROWS, -(-k // batch) * batch)
    nchunks = -(-n // chunk_rows)
    label_tile = min(SORT_LABEL_TILE, -(-k // 32) * 32)
    m = k * nchunks
    span = max(SCAN_MIN_SPAN,
               -(-(-(-m // SCAN_MAX_BLOCKS)) // SCAN_THREADS) * SCAN_THREADS)
    piece_rows = max(PIECE_MIN_ROWS, -(-n // (k + -(-n // (d + 1)))))
    piece_rows = -(-piece_rows // 32) * 32
    return KMeansPlan(
        "tiled", smem=max(smem, 4 * SORT_WARPS * label_tile), dpad=dpad,
        kp=kp, chunk_rows=chunk_rows, nchunks=nchunks, label_tile=label_tile,
        scan_span=span, scan_blocks=-(-m // span), piece_rows=piece_rows,
        pieces=-(-n // piece_rows),
        col_threads=min(PIECE_MAX_COLS, -(-(d + 1) // 32) * 32))


#: most slices of the :func:`reduce_partials` order (``kRedSlices`` of
#: ``kmeans_kernels.cu``, whose launches choose their own tiling)
REDUCE_SLICES = 32


def reduce_slices(blocks: int) -> Tuple[int, int]:
    """``(slice_rows, slices)``: how :func:`reduce_partials` cuts B = blocks
    rows into contiguous slices, ⌈B / 32⌉ rows each, the last one shorter."""
    slice_rows = -(-blocks // REDUCE_SLICES)
    return slice_rows, -(-blocks // slice_rows)


#: loss name → the sgd kernels' template instance (``enum Loss`` of
#: ``sgd_kernels.cu``)
SGD_LOSSES = {"logistic": 0, "hinge": 1, "least_square": 2}
#: warps of an sgd stage-1 block (``kWarps`` of ``sgd_kernels.cu``)
SGD_WARPS = 8
#: widest row the register instance of stage 1 takes (``kRegCols``): a lane
#: holds V = ⌈d / 128⌉ ≤ 4 float4s of a row; wider rows take the staged
#: instance, past what its ring holds the cluster one, past what a cluster
#: of 8 holds the grid one, and past what a grid of one CTA an SM holds the
#: two-pass set
SGD_REG_COLS = 512
#: rows a warp of the register instance takes at least before the grid
#: grows (up to the blocks the card holds at once): its double-buffered
#: loads need a run to fill
SGD_WARP_ROWS = 16
#: threads of an sgd stage-1 block (``kThreads``); a staged block's thread t
#: owns columns t + 256·j
SGD_THREADS = 256
#: stages of a staged block's ring (``kRing``), floats of x a stage holds at
#: most (32 KB; a row wider than that is a stage alone) and its rows at most
#: (``kStageMaxRows``)
SGD_RING = 3
SGD_STAGE_FLOATS = 8192
SGD_STAGE_MAX_ROWS = 16
#: stages a staged block (a cluster of the cluster instance) takes at least
#: before the grid grows (up to what the card holds at once)
SGD_BLOCK_STAGES = 4
#: CTAs of a cluster of the cluster instance: Hopper's portable sizes
#: (``kClusterMax`` the largest)
SGD_CLUSTER_SIZES = (2, 4, 8)
#: dynamic shared memory of a CTA at most for two to share an SM: the
#: SM's 228 KB less 1 KB the runtime keeps a block, halved
SGD_TWO_PER_SM_BYTES = (233_472 - 2 * 1_024) // 2
#: threads of a CTA of the grid instance (``kGridThreads``: 16 warps); its
#: thread t owns columns t + 512·j of the CTA's slice
SGD_GRID_THREADS = 512
SGD_GRID_WARPS = SGD_GRID_THREADS // 32
#: rows of a stage of the grid instance at most (``kGridMaxRows``)
SGD_GRID_MAX_ROWS = 32
#: widest slice of the grid instance whose columns are kept by warps that
#: own rows (``kGridRowCols``: 32 columns a lane); wider slices are split
#: over the CTA's threads
SGD_GRID_ROW_COLS = 1_024
#: the two-pass set (``sgd_twopass_*_kernel``): columns of a row segment a
#: CTA of the partial dots reads (``kTwoSegCols``: its 256 threads' four
#: float4s each, 1,024 float4s), window rows of its band
#: (``kTwoBandRows``) and its bands at most (``kTwoMaxBands``, CUDA's grid
#: height)
SGD_TWOPASS_SEG_COLS = 4_096
SGD_TWOPASS_BAND_ROWS = 32
SGD_TWOPASS_MAX_BANDS = 65_535
#: window rows of a terms CTA of the two-pass set (``kTermsRows``: a row a
#: warp)
SGD_TWOPASS_TERMS_ROWS = 8


def _sgd_nreg(d: int) -> int:
    """Columns of a row a thread of the staged instance keeps in registers
    (``staged_nreg``): 4, 8 or 16, the fewest that hold all its columns up
    to d = 4,096; past that the rest sit in shared memory."""
    for nreg in (4, 8):
        if d <= nreg * SGD_THREADS:
            return nreg
    return 16


def _sgd_staged_layout(d: int) -> Optional[Tuple[int, int]]:
    """``(rows, smem_bytes)`` of a staged :func:`sgd_batch_terms` block at
    width ``d``, or None where its ring does not fit a block's shared
    memory (past about 13,200 columns: the cluster instance). The sizes are
    the ones the layout comment in ``sgd_kernels.cu`` lists
    (``staged_smem_floats``): ``SGD_RING`` stages of ``rows`` whole rows
    (up to 3 floats before the first, rounded up to 4 floats), each
    stage's labels and weights, the warps' dot sums (rows rounded up to 4),
    the multipliers, the row slots' sums, and the sums and coefficients of
    the columns past the registers."""
    rows = max(1, min(SGD_STAGE_MAX_ROWS, SGD_STAGE_FLOATS // d))
    stage = (rows * d + 6) // 4 * 4
    over = max(0, -(-d // SGD_THREADS) * SGD_THREADS - SGD_THREADS * _sgd_nreg(d))
    floats = (SGD_RING * stage + 2 * SGD_RING * rows
              + -(-rows // 4) * 4 * SGD_WARPS + 3 * rows + 2 * over)
    return (rows, 4 * floats) if 4 * floats <= SMEM_BLOCK_BYTES else None


def _sgd_cluster_slice(d: int, c: int) -> int:
    """Columns of a cluster CTA's slice at width ``d`` in clusters of ``c``
    (``cluster_slice``): ⌈d / c⌉ rounded up to a multiple of 4; the last
    CTA takes the rest."""
    return (-(-d // c) + 3) // 4 * 4


def _sgd_cluster_layout(ds: int) -> Optional[Tuple[int, int]]:
    """``(rows, smem_bytes)`` of a CTA of the cluster instance whose slice
    is ``ds`` columns wide, or None where its ring does not fit a block's
    shared memory (past 13,196 columns). The sizes are the ones the layout
    comment in ``sgd_kernels.cu`` lists (``cluster_smem_floats``): the
    staged instance's rows a stage at width ``ds``, ``SGD_RING`` stages of
    them, each row's slice in a pitch of ⌈(ds + 3) / 4⌉·4 floats (up to 3
    before it), the stages' mbarriers, each stage's labels and weights,
    the warps' dot sums of two stages, the multipliers, the row slots'
    sums, and the sums and coefficients of the slice's columns past the
    registers."""
    rows = max(1, min(SGD_STAGE_MAX_ROWS, SGD_STAGE_FLOATS // ds))
    pitch = (ds + 6) // 4 * 4
    over = max(0, -(-ds // SGD_THREADS) * SGD_THREADS
               - SGD_THREADS * _sgd_nreg(ds))
    floats = (SGD_RING * rows * pitch + 2 * SGD_RING + 2 * SGD_RING * rows
              + 2 * -(-rows // 4) * 4 * SGD_WARPS + 3 * rows + 2 * over)
    return (rows, 4 * floats) if 4 * floats <= SMEM_BLOCK_BYTES else None


def _sgd_cluster_size(d: int) -> Optional[int]:
    """CTAs of a cluster of the cluster instance at width ``d``: the
    smallest of :data:`SGD_CLUSTER_SIZES` whose CTAs fit two an SM
    (:data:`SGD_TWO_PER_SM_BYTES`; up to 59,136 columns), else the
    smallest whose slice fits :func:`_sgd_cluster_layout` at all, or None
    past what a cluster of 8 holds (d > 105,568: the grid instance).
    Two an SM hide one CTA's cluster barrier behind the other's work: at d
    = 16,000 on an H100 clusters of 4 (two an SM) took 0.545 ms where
    clusters of 2 (one an SM) took 0.818 (scripts/port_sgd_cluster.py,
    PERF.md)."""
    layouts = {c: _sgd_cluster_layout(_sgd_cluster_slice(d, c))
               for c in SGD_CLUSTER_SIZES}
    fits = [c for c, layout in layouts.items() if layout is not None]
    two = [c for c in fits if layouts[c][1] <= SGD_TWO_PER_SM_BYTES]
    return (two or fits or [None])[0]


def _sgd_grid_nreg(ds: int) -> int:
    """Columns of a row a thread of the grid instance keeps in registers
    (``grid_nreg``): 4, 8 or 16, the fewest that hold all its columns up to
    a slice of 8,192; past that the rest sit in shared memory."""
    for nreg in (4, 8):
        if ds <= nreg * SGD_GRID_THREADS:
            return nreg
    return 16


def _sgd_grid_layout(d: int, ctas: int) -> Optional[Tuple[int, int]]:
    """``(rows, smem_bytes)`` of a CTA of the grid instance at width ``d``
    over ``ctas`` CTAs, or None where one row's slice does not fit a
    block's shared memory or some CTA would get no columns (past 1,959,936
    columns over 132 CTAs: the two-pass set). The sizes are the ones
    the layout comment in ``sgd_kernels.cu`` lists (``grid_smem_floats``):
    ``SGD_RING`` stages of ``rows`` rows' slices (:func:`_sgd_cluster_slice`
    of ``ctas``, each in a pitch of ⌈(ds + 3) / 4⌉·4 floats), the stages'
    mbarriers, each stage's labels and weights, the 16 warps' dot sums,
    the multipliers, the row slots' sums, and the sums and coefficients of
    the slice's columns past the registers; ``rows`` is the most, up to
    :data:`SGD_GRID_MAX_ROWS`, that fit the block's shared memory (a stage
    of about 74 KB, a wave of 132 stages about 9.8 MB: the fewer stages,
    the fewer grid barriers). At every width it takes over 132 CTAs the
    layout takes more than half an SM's shared memory, so an H100 holds
    one CTA an SM."""
    ds = _sgd_cluster_slice(d, ctas)
    if (ctas - 1) * ds >= d:
        return None
    pitch = (ds + 6) // 4 * 4
    over = max(0, -(-ds // SGD_GRID_THREADS) * SGD_GRID_THREADS
               - SGD_GRID_THREADS * _sgd_grid_nreg(ds))

    def nbytes(rows):
        return 4 * (SGD_RING * rows * pitch + 2 * SGD_RING
                    + 2 * SGD_RING * rows + -(-rows // 4) * 4 * SGD_GRID_WARPS
                    + 3 * rows + 2 * over)

    fit = [rows for rows in range(1, SGD_GRID_MAX_ROWS + 1)
           if nbytes(rows) <= SMEM_BLOCK_BYTES]
    return (fit[-1], nbytes(fit[-1])) if fit else None


def _sgd_twopass_segments(d: int, vec4: int) -> int:
    """Segments of a row of width ``d`` in the two-pass set's partial dots
    (``twopass_segments``): where ``vec4`` a row is read by 16 bytes from
    the aligned address at or before its first float, so its float4s are
    ⌈d / 4⌉, or ⌊(d + 6) / 4⌋ where d % 4 ≠ 0 (up to 3 floats of the rows
    beside it), else its columns go in fours; either in runs of
    :data:`SGD_TWOPASS_SEG_COLS` / 4 float4s."""
    f4 = (d + 6) // 4 if vec4 and d % 4 else -(-d // 4)
    return -(-f4 // (SGD_TWOPASS_SEG_COLS // 4))


def _sgd_width_class(d: int) -> int:
    """V, the float4s of a row a lane of the register instance holds
    (⌈d / 128⌉), or 0 for rows wider than :data:`SGD_REG_COLS`, which the
    staged, the cluster, the grid or the two-pass instance takes."""
    return -(-d // 128) if d <= SGD_REG_COLS else 0


class SgdPlan(NamedTuple):
    """How :func:`sgd_batch_terms` launches stage 1 (the C entry checks it):
    ``instance`` "registers" (``sgd_rows_kernel<loss, v, vec4>``, d ≤
    :data:`SGD_REG_COLS`: each warp a contiguous run of rows, one row in
    registers), "staged" (``sgd_staged_kernel<loss, nreg>``, wider rows
    while :func:`_sgd_staged_layout` fits: each block a contiguous run of
    rows, streamed ``rows`` whole rows a stage, ``dc`` = d, through a ring
    in ``smem`` bytes), "cluster" (``sgd_cluster_kernel<loss, nreg>``,
    wider rows while a cluster of 8 holds them: ``blocks`` clusters of
    ``cluster`` CTAs, each cluster a contiguous run of rows, CTA r the
    columns [r·dc, (r + 1)·dc) of them, streamed ``rows`` rows a stage
    through a ring in ``smem`` bytes; ``resident`` counts clusters),
    "grid" (``sgd_grid_kernel<loss, nreg, rows>``, wider rows while a grid of
    one CTA an SM holds them: ``grid`` CTAs, every CTA the card holds at
    once (= ``resident``), CTA g the columns [g·dc, (g + 1)·dc) of every
    window row, streamed ``rows`` rows a stage through a ring in ``smem``
    bytes; one partial row, ``blocks`` = 1) or "twopass" (the
    ``sgd_twopass_*_kernel`` set, wider still: the partial dots of
    ``segments`` segments of ``dc`` columns of each row, CTAs of bands of
    ``rows`` rows, then the rows' terms, then mult · x by CTAs of ``owner``
    threads owning four columns a thread
    (:func:`_sgd_twopass_owner_threads`); one partial row, ``blocks`` =
    1); ``blocks`` of the grid (partial rows), of the
    ``resident`` the card holds at once; ``vec4`` where rows are read by 16
    bytes (the staged, cluster, grid and two-pass instances: where x is
    16-byte aligned)."""
    instance: str
    v: int
    vec4: int
    blocks: int
    resident: int
    rows: int
    dc: int
    smem: int
    segments: int
    cluster: int = 0
    grid: int = 0
    owner: int = 0


def _sgd_plan(lb: int, d: int, resident: int, vec4: int = 0, *,
              sms: int) -> SgdPlan:
    """The launch of :func:`sgd_batch_terms` for a window of ``lb`` ≥ 1 rows
    of width ``d`` on a card of ``sms`` SMs that holds ``resident`` blocks
    of the instance at once (the instance is :func:`_sgd_instance` of
    ``sms``). The register instance runs a
    persistent grid: enough blocks that every warp has
    :data:`SGD_WARP_ROWS` rows, up to ``resident`` (lb = 100,000 fills the
    card: about 30 rows a warp on an H100). The staged one runs a
    persistent grid too: enough blocks that every block has
    :data:`SGD_BLOCK_STAGES` stages, up to ``resident``; the cluster one
    likewise with clusters (``resident`` clusters, in clusters of
    :func:`_sgd_cluster_size`). The grid one runs one CTA on each of the
    ``sms`` SMs at any window (its layout takes more than half an SM's
    shared memory, so the card holds no more). The two-pass set runs its
    three kernels at any window (:func:`sgd_twopass_grids`)."""
    v = _sgd_width_class(d)
    if v:
        blocks = max(1, min(resident, -(-lb // (SGD_WARPS * SGD_WARP_ROWS))))
        return SgdPlan("registers", v, vec4, blocks, resident, 0, 0, 0, 0)
    staged = _sgd_staged_layout(d)
    if staged is not None:
        rows, smem = staged
        blocks = max(1, min(resident, -(-lb // (SGD_BLOCK_STAGES * rows))))
        return SgdPlan("staged", 0, vec4, blocks, resident, rows, d, smem, 0)
    c = _sgd_cluster_size(d)
    if c is not None:
        return _sgd_cluster_plan(lb, d, resident, vec4, c)
    if _sgd_grid_layout(d, sms) is not None:
        return _sgd_grid_plan(d, sms, vec4)
    return _sgd_twopass_plan(d, resident, vec4)


def _sgd_cluster_plan(lb: int, d: int, resident: int, vec4: int,
                      c: int) -> SgdPlan:
    """The cluster instance's launch in clusters of ``c`` CTAs
    (:func:`_sgd_plan` past the staged widths with c =
    :func:`_sgd_cluster_size`; the card check and the sweep also run other
    sizes, with ``resident`` their own clusters): enough clusters that each
    has :data:`SGD_BLOCK_STAGES` stages, up to ``resident``."""
    ds = _sgd_cluster_slice(d, c)
    layout = _sgd_cluster_layout(ds)
    if layout is None or c not in SGD_CLUSTER_SIZES:
        raise ValueError(f"sgd_batch_terms: no cluster of {c} CTAs holds "
                         f"rows of {d} columns")
    rows, smem = layout
    blocks = max(1, min(resident, -(-lb // (SGD_BLOCK_STAGES * rows))))
    return SgdPlan("cluster", 0, vec4, blocks, resident, rows, ds, smem, 0, c)


def _sgd_grid_plan(d: int, sms: int, vec4: int = 0) -> SgdPlan:
    """The grid instance's launch: one CTA on each of the card's ``sms``
    SMs (all it holds at once), one partial row, whatever the window."""
    layout = _sgd_grid_layout(d, sms)
    if layout is None:
        raise ValueError(f"sgd_batch_terms: no grid of {sms} CTAs holds "
                         f"rows of {d} columns")
    rows, smem = layout
    return SgdPlan("grid", 0, vec4, 1, sms, rows,
                   _sgd_cluster_slice(d, sms), smem, 0, 0, sms)


def _sgd_twopass_owner_threads(d: int) -> int:
    """Threads of an owner CTA of the two-pass set's mult · x at width
    ``d``, four columns each (``twopass_owner_threads``, which the C entry
    holds the plan to): 128 from 262,144 columns, 64 from 131,072, 32
    below, so that narrower rows still give at least 512 owner CTAs (down
    to 65,536 columns)."""
    return 128 if d >= 262_144 else 64 if d >= 131_072 else 32


def _sgd_twopass_plan(d: int, resident: int, vec4: int = 0) -> SgdPlan:
    """The two-pass set's launch (:func:`_sgd_plan` past the grid
    instance's widths; the card check also runs it by hand at the grid's):
    whatever the window, one partial row."""
    return SgdPlan("twopass", 0, vec4, 1, resident, SGD_TWOPASS_BAND_ROWS,
                   SGD_TWOPASS_SEG_COLS, 0, _sgd_twopass_segments(d, vec4),
                   owner=_sgd_twopass_owner_threads(d))


def sgd_twopass_grids(plan: SgdPlan, lb: int, d: int) -> dict:
    """The two-pass set's launches for a window of ``lb`` rows of width
    ``d``: ``dots`` (segments, bands) CTAs of the partial dots, each
    segment ``dc`` columns (by 16 bytes, ``dc`` / 4 float4s from the aligned
    address at or before the row) of a band of ``rows`` rows; ``terms``
    CTAs of the terms, a row a warp, 8 rows a CTA; ``owners``, (CTAs,
    columns a CTA) of mult · x, CTA b the columns from b·columns, the last
    the rest; and ``scratch``, its floats: lb × segments partial dots, lb
    multipliers, then each terms CTA's weight and loss sums. The C entry
    launches these from the plan's ``segments``, ``rows`` and ``owner``,
    which it checks, and refuses a smaller scratch. Counted, not listed: a
    wrapper call asks for it at every launch."""
    bands = -(-lb // plan.rows)
    if bands > SGD_TWOPASS_MAX_BANDS:
        raise ValueError(f"sgd_batch_terms: a window of {lb} rows takes "
                         f"{bands} bands of the two-pass set, past "
                         f"{SGD_TWOPASS_MAX_BANDS}")
    cols, terms = 4 * plan.owner, -(-lb // SGD_TWOPASS_TERMS_ROWS)
    return {"dots": (plan.segments, bands), "terms": terms,
            "owners": (-(-d // cols), cols),
            "scratch": lb * plan.segments + lb + 2 * terms}


def sgd_runs(plan: SgdPlan, lb: int) -> list:
    """The window rows ``(r0, r1)`` each worker of a plan's stage 1 takes,
    in order: every warp of the register instance (``sgd_rows_kernel``: W
    warps in all, warp g the ⌊lb / W⌋ rows from g·⌊lb / W⌋ + min(g, lb mod
    W), one more for the first lb mod W warps), every block of the staged
    one (``sgd_staged_kernel``: the same rule over its blocks), every
    cluster of the cluster one (``sgd_cluster_kernel``: the same rule over
    its clusters), or the grid one or the two-pass set as one worker
    (``sgd_grid_kernel``: every CTA takes every row, a slice of its
    columns; the two-pass set writes one row from all of them)."""
    if plan.instance in ("grid", "twopass"):
        return [(0, lb)]
    workers = plan.blocks * (SGD_WARPS if plan.instance == "registers"
                             else 1)
    q, rem = divmod(lb, workers)
    return [(g * q + min(g, rem), g * q + min(g, rem) + q + (g < rem))
            for g in range(workers)]


#: warps of a segment block (``kWarps`` of ``segment_kernels.cu``)
SEG_WARPS = 4
#: floats of one warp's (ut, cg) accumulator in the segment kernel (16 KB;
#: the block's four warps take 64 KB and 512 bytes of scratch, so three
#: blocks share an SM)
SEG_TILE_FLOATS = 4096
#: rows a segment chunk holds at least (256 rows, 8 steps, per warp)
SEG_MIN_CHUNK_ROWS = 1024
#: row chunks of a segment call at most (``kMaxChunks``)
SEG_MAX_CHUNKS = 1024
#: mean rows of a run of equal ids over an item's chunks at least, for its
#: steps to sum runs by segmented scans (``kScanRunRows``)
SEG_SCAN_RUN_ROWS = 4


def _seg_smem(ut: int, cg: int) -> int:
    """Dynamic shared memory of a segment tile block: the warps' (ut, cg)
    accumulators and 32-float scratches (``smem_bytes`` of the source)."""
    return 4 * SEG_WARPS * (ut * cg + 32)


def _segment_chunks(n: int, blocks: int, resident: int) -> Tuple[int, int, int]:
    """``(chunks, rows_per_chunk, slots)`` of a segment call over n rows
    with ``blocks`` tile-groups (tiles × column groups), on a card that
    holds ``resident`` tile blocks at once: chunks of at least
    :data:`SEG_MIN_CHUNK_ROWS` rows, at most :data:`SEG_MAX_CHUNKS` of
    them, and ``slots`` items a tile-group at most, so that a domain that
    every chunk meets runs about two waves of blocks (the partial scratch
    is ``blocks × slots`` tile slabs; only the slabs of real items are
    written)."""
    want = max(1, min(n // SEG_MIN_CHUNK_ROWS, SEG_MAX_CHUNKS))
    rows = -(-n // want)
    chunks = -(-n // rows)
    return chunks, rows, max(1, min(chunks, -(-2 * resident // blocks)))


class SegmentPlan(NamedTuple):
    """How a :func:`segment_reduce_sum` call spreads its work, as the
    kernels compute it on the card. ``ranges``: each row chunk's lowest and
    highest in-range id, (2^31 − 1, −1) for a chunk with none, and its runs
    (rows whose id differs from the row before), (chunks, 3) int64; None
    when there is one tile, which every chunk meets. ``items``: for every
    tile, its items in slot order, each ``(chunk indices, a, e, scan)``
    with the tile-local segment range [a, e) that the item zeroes, fills
    and writes, and whether its steps may sum runs by segmented scans
    (runs of :data:`SEG_SCAN_RUN_ROWS` rows or more on average)."""
    ut: int
    tiles: int
    cg: int
    groups: int
    chunks: int
    rows_per_chunk: int
    slots: int
    ranges: Optional[torch.Tensor]
    items: list


def segment_plan_plain(segment_ids: torch.Tensor, num_segments: int, c: int,
                       resident: int) -> SegmentPlan:
    """Plain mirror of the segment kernels' plan for ids (n,) int32, n >= 1,
    on a card that holds ``resident`` tile blocks: ``segment_ranges_kernel``
    gives each chunk's range; in ``segment_tiles_kernel`` a chunk meets a
    tile when its range overlaps the tile's segments, the m chunks that
    meet tile t are cut in chunk order into q = min(m, slots) items of
    ranks [i·m // q, (i + 1)·m // q), an item's range is the union of its
    chunks' ranges within the tile, and it scans where its chunks' runs are
    :data:`SEG_SCAN_RUN_ROWS` rows long or more on average."""
    u, n = int(num_segments), segment_ids.shape[0]
    ut, tiles, cg, groups = _seg_layout(u, c)
    chunks, rows, slots = _segment_chunks(n, tiles * groups, resident)
    ranges = None
    if tiles > 1:
        ranges = torch.empty((chunks, 3), dtype=torch.int64)
        for b in range(chunks):
            ids = segment_ids[b * rows:(b + 1) * rows].long()
            runs = 1 + int((ids[1:] != ids[:-1]).sum())
            ids = ids[(ids >= 0) & (ids < u)]
            ranges[b] = (torch.stack([ids.min(), ids.max(), torch.tensor(runs)])
                         if ids.numel() else torch.tensor([2 ** 31 - 1, -1, runs]))
    spans = None if ranges is None else ranges.tolist()
    items = []
    for t in range(tiles):
        s0 = t * ut
        us = min(ut, u - s0)
        if spans is None:
            met = list(range(chunks))
        else:
            met = [b for b, (lo, hi, _) in enumerate(spans)
                   if lo < s0 + us and hi >= s0]
        m, tile_items = len(met), []
        q = min(m, slots)
        for i in range(q):
            part = tuple(met[i * m // q:(i + 1) * m // q])
            a, e, scan = 0, us, False
            if spans is not None:
                a = max(min(spans[b][0] for b in part), s0) - s0
                e = min(max(spans[b][1] for b in part) + 1, s0 + us) - s0
                rows_in = sum(min(n, (b + 1) * rows) - b * rows for b in part)
                scan = (SEG_SCAN_RUN_ROWS * sum(spans[b][2] for b in part)
                        <= rows_in)
            tile_items.append((part, a, e, scan))
        items.append(tile_items)
    return SegmentPlan(ut, tiles, cg, groups, chunks, rows, slots, ranges,
                       items)


def _seg_layout(num_segments: int, c: int) -> Tuple[int, int, int, int]:
    """``(ut, tiles, cg, groups)`` of a :func:`segment_reduce_sum` launch:
    each warp of a block keeps a private (ut, cg) accumulator in shared
    memory, ut·cg ≤ :data:`SEG_TILE_FLOATS` (16 KB; four warps take 64 KB
    of the 227 KB a block may use). The value columns are split into groups
    of cg = min(c, 4,096) and the segment domain into tiles of ut segments,
    so every u and c has a layout; a row chunk is read once for every tile
    it meets (:func:`segment_plan_plain`). FTRL's per-row dots at 131,072
    rows take 32 tiles, its per-coordinate (d, 2) sums at d = 100 one, a
    hashed 2^18 domain with two value columns 128."""
    cg = min(c, SEG_TILE_FLOATS)
    ut = min(num_segments, SEG_TILE_FLOATS // cg)
    return ut, -(-num_segments // ut), cg, -(-c // cg)


#: test rows of a tiled KNN block, and train rows of one of its tiles
#: (``kTM``, ``kTN`` of ``knn_kernels.cu``): the train set's padding
KNN_TILE_ROWS = 128
#: columns a tiled KNN step stages (``kDK``); d is padded to a multiple
KNN_CHUNK_COLS = 32
#: list capacities of the tiled instances (``knn_tile_kernel<KCAP>``);
#: longer lists take the long-list instances
KNN_KCAPS = (16, 32)
#: list capacities of the long-list instances (``knn_long_kernel<KCAP>``,
#: lists in shared memory), and the longest list they take: past it the
#: radix route was faster on the 16,384 × 50,000 × 32 block of an H100
#: (``chip_smoke.py`` phase 6's hand-over lines: the two tie at k = 80, the
#: radix route 4.22 against 4.46 ms at k = 96), and at 1,000 and 4,096 test
#: rows from k = 64
KNN_LONG_KCAPS = (64, 128)
KNN_LONG_MAX_K = 80
#: the radix route's scratch of one chunk of test rows (their keys, and
#: their pairs where those leave shared memory) stays under this many
#: bytes; the test rows are cut into chunks to keep it so
KNN_KEY_CAP_BYTES = 1 << 30
#: train tiles a distance-key block walks (its grid's train ranges)
KNN_KEY_TILES_PER_BLOCK = 8
#: warps of a select block, bins of its radix digit, and the ints of its
#: shared head (``kSelWarps``, ``kRadixBins``, ``kSelHead``)
KNN_SELECT_WARPS, KNN_RADIX_BINS = 16, 256
KNN_SELECT_HEAD = KNN_SELECT_WARPS * KNN_RADIX_BINS + 64
#: keys of a select block's sample (``kSample``: 64 runs of 32)
KNN_SAMPLE = 2048


def knn_test_rows(kcap: int) -> int:
    """Test rows of a tiled or long-list KNN block (``long_tile_rows``):
    :data:`KNN_TILE_ROWS`, but 64 for lists of 128 entries, whose
    128 rows' lists and buffers would not fit a block's shared memory."""
    return KNN_TILE_ROWS if kcap <= 64 else KNN_TILE_ROWS // 2


class KnnPlan(NamedTuple):
    """How :func:`knn_topk_indices` launches: ``route`` "tiled"
    (``knn_tile_kernel<kcap>``, then ``knn_merge_kernel`` when ``splits``
    > 1; k ≤ 32), "long" (``knn_long_kernel<kcap>``, then
    ``knn_long_merge_kernel`` when ``splits`` > 1; 32 < k ≤ 80) or
    "radix" (k > 80: ``knn_key_tile_kernel`` over ``splits`` train
    ranges, then ``knn_select_kernel``, for each chunk of ``chunk_rows``
    test rows, with candidate regions of ``cap_w`` pairs a warp (0: the
    whole row) and the pairs in shared memory where ``pairs_smem``); the
    train set transposed to
    (``dpad``, ``ntp``), ``tiles`` train tiles cut into ``splits``
    contiguous ranges; the scratch the wrapper allocates, in bytes. The
    kernels size their own shared memory (``knn_tile_smem_bytes``,
    ``knn_long_smem_bytes`` and ``knn_select_smem_bytes`` of
    ``knn_kernels.cu``; :func:`knn_select_layout` mirrors the last)."""
    route: str
    kcap: int
    dpad: int
    ntp: int
    tiles: int
    splits: int
    scratch_bytes: int
    chunk_rows: int = 0
    cap_w: int = 0
    pairs_smem: int = 0


def _knn_splits(test_tiles: int, tiles: int, resident: int) -> int:
    """Train splits S of a tiled launch: the S that minimises the kernel's
    time, which goes as its waves of blocks over S, ⌈test_tiles·S /
    resident⌉ / S, the smallest S among equals, and never more than the
    train tiles (no empty split). S = 1 whenever the test tiles fill the
    card (or there are none)."""
    if test_tiles < 1 or test_tiles >= resident:
        return 1
    top = min(tiles, 65535, 2 * -(-resident // test_tiles))
    return min(range(1, top + 1),
               key=lambda s: (-(-test_tiles * s // resident) / s, s))


def knn_sample_rank(nt: int, k: int) -> int:
    """The rank in a select block's sample of its candidates' threshold
    (``sel_sample_rank``): k where the sample is the whole row, else twice
    the sample's share of k and 32 more, so that about 2k + 32·nt /
    KNN_SAMPLE keys of the row lie at or below it."""
    if nt <= KNN_SAMPLE:
        return k
    return min(KNN_SAMPLE, 2 * -(-k * KNN_SAMPLE // nt) + 32)


def knn_candidate_cap(nt: int, k: int) -> int:
    """Pairs a select block's warp keeps of its candidates: twice the
    expected share of a warp, and 64 more, in whole batches of 32, but no
    more than the warp's segment of the row (which then cannot overflow)
    and no fewer than 64 (the regions hold the sample)."""
    ns = min(nt, KNN_SAMPLE)
    expect = -(-knn_sample_rank(nt, k) * nt // ns)
    per_warp = -(-expect // KNN_SELECT_WARPS)
    seg = -(-nt // (32 * KNN_SELECT_WARPS)) * 32
    cap = min(seg, -(-(2 * per_warp + 64) // 32) * 32)
    return max(KNN_SAMPLE // (2 * KNN_SELECT_WARPS), cap)


def knn_select_smem_bytes(k: int, cap_w: int, pairs: int) -> int:
    """Shared memory of a select block (``sel_smem_bytes`` of
    ``knn_kernels.cu``): its head of counters, then with candidate regions
    of ``cap_w`` pairs a warp those (at least 2k ints: the sort's second
    buffer takes their place) and one buffer of k (key, index) pairs;
    without, both buffers where ``pairs``, else none."""
    if cap_w:
        return 4 * (KNN_SELECT_HEAD
                    + max(2 * KNN_SELECT_WARPS * cap_w, 2 * k) + 2 * k)
    return 4 * (KNN_SELECT_HEAD + (4 * k if pairs else 0))


def knn_select_layout(nt: int, k: int) -> Tuple[int, int, int]:
    """``(cap_w, pairs_smem, smem_bytes)`` of a select block: candidate
    regions (:func:`knn_candidate_cap`) and the pairs in shared memory
    where they fit a block; else the pairs alone there, the selection
    running over the whole row; else neither."""
    for cap_w, pairs in ((knn_candidate_cap(nt, k), 1), (0, 1), (0, 0)):
        smem = knn_select_smem_bytes(k, cap_w, pairs)
        if smem <= SMEM_BLOCK_BYTES:
            return cap_w, pairs, smem
    raise AssertionError("the select block's head always fits")


def knn_radix_plan(n: int, nt: int, d: int, k: int,
                   cap: int = KNN_KEY_CAP_BYTES) -> KnnPlan:
    """The radix route's launch at any k ≤ nt (:func:`_knn_plan` past
    :data:`KNN_LONG_MAX_K`; the card check also runs it below, to time the
    hand-over, and under a small ``cap``, to run several chunks): the test
    rows go in chunks whose scratch (4·ntp bytes of keys a row, and 16·k of
    pairs where those do not fit the select block's shared memory) stays
    under ``cap`` bytes (a multiple of 128 rows where the cap allows more
    than one tile, at least one row), the key blocks walking
    :data:`KNN_KEY_TILES_PER_BLOCK` train tiles each."""
    dpad = -(-d // KNN_CHUNK_COLS) * KNN_CHUNK_COLS
    tiles = -(-nt // KNN_TILE_ROWS)
    ntp = tiles * KNN_TILE_ROWS
    cap_w, pairs, _ = knn_select_layout(nt, k)
    per_row = 4 * ntp + (0 if pairs else 16 * k)
    chunk = max(1, cap // per_row)
    if chunk >= KNN_TILE_ROWS:
        chunk -= chunk % KNN_TILE_ROWS
    chunk = min(chunk, max(n, 1))
    return KnnPlan("radix", 0, dpad, ntp, tiles,
                   -(-tiles // KNN_KEY_TILES_PER_BLOCK), chunk * per_row,
                   chunk, cap_w, pairs)


def _knn_plan(n: int, nt: int, d: int, k: int, resident: int) -> KnnPlan:
    """The launch of :func:`knn_topk_indices` for ``k`` neighbours among
    ``nt`` train rows of ``n`` test rows of width ``d``, on a card that
    holds ``resident`` blocks of the chosen instance at once (132 on an
    H100: one block per SM, bound by registers or by the lists' shared
    memory).

    Lists up to 32 long take the tiled kernel, lists of 33 to
    :data:`KNN_LONG_MAX_K` the long-list kernel (capacity 64 or 128, the
    smallest that holds k),
    any d. Their blocks are (test tile, train split), the splits chosen by
    :func:`_knn_splits`: the 10,000,000-row benchmark and a 16,384-row
    block (128 test tiles) take S = 1, 1,000 rows S = 33 on an H100. With
    S > 1 each split writes its (n, k) distances and indices to a scratch
    of 8·S·n·k bytes that the merge stage reads. Longer lists take the
    radix route (:func:`knn_radix_plan`)."""
    if k > KNN_LONG_MAX_K:
        return knn_radix_plan(n, nt, d, k)
    dpad = -(-d // KNN_CHUNK_COLS) * KNN_CHUNK_COLS
    tiles = -(-nt // KNN_TILE_ROWS)
    ntp = tiles * KNN_TILE_ROWS
    route = "tiled" if k <= KNN_KCAPS[-1] else "long"
    kcap = next(c for c in KNN_KCAPS + KNN_LONG_KCAPS if k <= c)
    splits = _knn_splits(-(-n // knn_test_rows(kcap)), tiles, resident)
    scratch = 8 * splits * n * k if splits > 1 else 0
    return KnnPlan(route, kcap, dpad, ntp, tiles, splits, scratch)


def knn_split_bounds(nt: int, splits: int) -> list:
    """The ``(lo, hi)`` train rows of each split of the tiled kernel:
    contiguous runs of whole train tiles (``tile0``/``tile1`` of
    ``knn_tile_kernel``), the last one ragged."""
    tiles = -(-nt // KNN_TILE_ROWS)
    return [(s * tiles // splits * KNN_TILE_ROWS,
             min(nt, (s + 1) * tiles // splits * KNN_TILE_ROWS))
            for s in range(splits)]


# -- plain versions ------------------------------------------------------------

def assign_nearest_plain(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`assign_nearest`: (n,) int32."""
    csq = torch.sum(centroids * centroids, dim=1)
    d2 = csq[None, :] - 2.0 * (x @ centroids.T)
    return torch.argmin(d2, dim=1).to(torch.int32)


def lloyd_partial_sums_plain(x: torch.Tensor, v: torch.Tensor,
                             centroids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`lloyd_partial_sums`: (k, d+1) float32."""
    k, d = centroids.shape
    if x.shape[0] == 0:
        return torch.zeros((k, d + 1), dtype=torch.float32, device=x.device)
    a = assign_nearest_plain(x, centroids).long()
    one_hot = F.one_hot(a, k).to(x.dtype) * v[:, None]
    return torch.cat([one_hot.T @ x, one_hot.sum(0)[:, None]], dim=1)


def sort_by_label_plain(labels: torch.Tensor, k: int,
                        chunk_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the tiled route's label sort
    (``label_sort_kernel`` and the scan): ``(offs, order)``, int32. offs
    (k·nchunks,) is the exclusive prefix sum, in (label, chunk) order, of
    the rows of each label in each chunk of ``chunk_rows`` rows, so
    ``offs[l·nchunks]`` is where label l begins; order (n,) holds the row
    ids by label, ascending within a label (a stable sort)."""
    n = labels.shape[0]
    nchunks = -(-n // chunk_rows)
    lab = labels.long()
    chunk = torch.arange(n, device=labels.device) // chunk_rows
    counts = torch.bincount(lab * nchunks + chunk, minlength=k * nchunks)
    offs = (torch.cumsum(counts, 0) - counts).to(torch.int32)
    order = torch.sort(lab, stable=True).indices.to(torch.int32)
    return offs, order


def piece_sums_plain(x: torch.Tensor, v: torch.Tensor, labels: torch.Tensor,
                     order: torch.Tensor, offs: torch.Tensor, nchunks: int,
                     piece_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the tiled route's sums (``piece_sums_kernel``
    and ``piece_combine_kernel``) given the sort's ``order`` and ``offs``:
    ``(out, scratch)``. out (k, d+1) = ``[Σ v·x | Σ v]`` by label; scratch
    (pieces, 2, d+1) holds, for each label whose sorted rows lie in more
    than one piece of ``piece_rows``, its part in each piece, in slot 0 of
    that piece if the part begins it, else slot 1; slots no label takes are
    NaN (the kernel leaves them unwritten)."""
    n, d = x.shape
    k = offs.shape[0] // nchunks
    o = order.long()
    vals = torch.cat([x[o], torch.ones((n, 1), dtype=x.dtype,
                                       device=x.device)], 1) * v[o][:, None]
    lab = labels.long()[o]
    pos = torch.arange(n, device=x.device)
    piece = pos // piece_rows
    begins = torch.ones(n, dtype=torch.bool, device=x.device)
    begins[1:] = (lab[1:] != lab[:-1]) | (piece[1:] != piece[:-1])
    run = torch.cumsum(begins, 0) - 1
    sums = torch.zeros((int(run[-1]) + 1 if n else 0, d + 1), dtype=x.dtype,
                       device=x.device).index_add_(0, run, vals)
    first = pos[begins]
    run_lab = lab[first]
    starts = offs.view(k, nchunks)[:, 0].long()
    ends = torch.cat([starts[1:], torch.tensor([n], device=x.device)])
    long_label = (ends > starts) & (
        starts // piece_rows != (ends - 1).clamp_min(0) // piece_rows)
    out = torch.zeros((k, d + 1), dtype=x.dtype, device=x.device)
    out.index_add_(0, run_lab, sums)
    scratch = torch.full((-(-n // piece_rows), 2, d + 1), float("nan"),
                         dtype=x.dtype, device=x.device)
    part = long_label[run_lab]
    scratch[piece[first][part], (first[part] % piece_rows != 0).long()] = (
        sums[part])
    return out, scratch


def reduce_partials_plain(partials: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch :func:`reduce_partials`: the sum over the first axis in
    the kernel's fixed two-level order. The B rows are cut into contiguous
    slices (:func:`reduce_slices`), each added in row order from 0; then
    the slice sums are added by a fixed pairwise tree (pairs (0, 1), (2,
    3), ..., an odd last one carried to the next level) until one is
    left."""
    blocks = partials.shape[0]
    flat = partials.reshape(blocks, -1)
    rows, slices = reduce_slices(blocks)
    sums = torch.zeros((slices, flat.shape[1]), dtype=partials.dtype,
                       device=partials.device)
    for i in range(rows):
        step = flat[i::rows]  # row i of every slice that has one
        sums[:step.shape[0]] += step
    while sums.shape[0] > 1:
        half = sums.shape[0] // 2
        pairs = sums[0:2 * half:2] + sums[1:2 * half:2]
        sums = torch.cat([pairs, sums[2 * half:]])
    return sums[0].reshape(partials.shape[1:])


def sgd_batch_terms_plain(xl: torch.Tensor, yl: torch.Tensor,
                          wl: torch.Tensor, coeffs: torch.Tensor, start: int,
                          clip: int, lb: int, loss_name: str) -> torch.Tensor:
    """Plain PyTorch :func:`sgd_batch_terms`: (d+2,) float32."""
    xb, yb = xl[start:start + lb], yl[start:start + lb]
    wb = wl[start:start + lb]
    if clip:
        wb = torch.where(torch.arange(lb, device=wb.device) >= clip, wb, 0.0)
    loss_sum, mult = LossFunc.by_name(loss_name).terms(xb @ coeffs, yb, wb)
    return torch.cat([xb.T @ mult, wb.sum()[None], loss_sum[None]])


def segment_reduce_sum_plain(values: torch.Tensor, segment_ids: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """Plain PyTorch :func:`segment_reduce_sum`. Deterministic on the card
    too (``index_add_`` there is not): the kept rows are sorted by id
    (stable), summed by a float64 prefix sum and differenced at the segment
    ends, then rounded to float32."""
    u = int(num_segments)
    squeeze = values.ndim == 1
    v = values[:, None] if squeeze else values
    keep = (segment_ids >= 0) & (segment_ids < u)
    ids, order = torch.sort(segment_ids[keep].long(), stable=True)
    csum = torch.cumsum(v[keep][order].double(), dim=0)
    counts = torch.bincount(ids, minlength=u)
    out = torch.zeros((u, v.shape[1]), dtype=torch.float64, device=v.device)
    hit = counts > 0
    ends = torch.cumsum(counts, 0)[hit] - 1
    starts = ends - counts[hit]
    before = torch.where((starts >= 0)[:, None], csum[starts.clamp_min(0)], 0.0)
    out[hit] = csum[ends] - before
    out = out.float()
    return out[:, 0] if squeeze else out


def _topk_lowest_index(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Column indices of the k smallest entries of each row of ``d2``, in
    ascending order, ties to the lowest column: the order of
    ``lax.top_k(-d2, k)``, which ``torch.topk`` does not promise. The ties
    at the k-th value are resolved explicitly, lowest column first."""
    n = d2.shape[0]
    kth = torch.kthvalue(d2, k, dim=1).values[:, None]
    below = d2 < kth
    at = d2 == kth
    need = k - below.sum(1, keepdim=True)
    keep = below | (at & (torch.cumsum(at, 1, dtype=torch.int32) <= need))
    cols = torch.nonzero(keep)[:, 1].view(n, k)  # ascending per row
    order = torch.sort(d2.gather(1, cols), dim=1, stable=True).indices
    return cols.gather(1, order).to(torch.int32)


def knn_topk_indices_plain(x: torch.Tensor, train: torch.Tensor,
                           k: int) -> torch.Tensor:
    """Plain PyTorch :func:`knn_topk_indices`: (n, min(k, n_train)) int32.
    Holds the whole (n, n_train) distance block: callers chunk x."""
    k = min(int(k), train.shape[0])
    if x.shape[0] == 0:
        return torch.empty((0, k), dtype=torch.int32, device=x.device)
    tsq = torch.sum(train * train, dim=1)
    return _topk_lowest_index(tsq[None, :] - 2.0 * (x @ train.T), k)


def knn_split_topk_plain(x: torch.Tensor, train: torch.Tensor, k: int,
                         bounds) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch first stage of a split :func:`knn_topk_indices`: for
    each contiguous train range ``(lo, hi)`` of ``bounds``, each test row's
    sorted top-k of that range, as (S, n, k) float32 distances and int32
    train indices; a range of fewer than k rows is padded with (+inf, 0),
    as the kernel leaves its list. One (n, n_train) distance block serves
    every range, so the ranges see the same distances as one pass."""
    tsq = torch.sum(train * train, dim=1)
    d2 = tsq[None, :] - 2.0 * (x @ train.T)
    n = x.shape[0]
    dists = torch.full((len(bounds), n, k), float("inf"), device=x.device)
    idx = torch.zeros((len(bounds), n, k), dtype=torch.int32, device=x.device)
    for s, (lo, hi) in enumerate(bounds):
        kk = min(k, hi - lo)
        cols = _topk_lowest_index(d2[:, lo:hi], kk).long()
        dists[s, :, :kk] = d2[:, lo:hi].gather(1, cols)
        idx[s, :, :kk] = (cols + lo).to(torch.int32)
    return dists, idx


def knn_merge_topk_plain(dists: torch.Tensor, idx: torch.Tensor,
                         k: int) -> torch.Tensor:
    """Plain PyTorch merge stage of a split :func:`knn_topk_indices` (the
    kernel's ``knn_merge_kernel``): (S, n, k) sorted per-split lists, in
    split order, → (n, k) int32. A stable sort of the lists laid end to end
    keeps equal distances in split order, then list order: ascending train
    index, as the kernel's strict-less insertion does."""
    s, n, kk = dists.shape
    flat_d = dists.permute(1, 0, 2).reshape(n, s * kk)
    flat_i = idx.permute(1, 0, 2).reshape(n, s * kk)
    order = torch.sort(flat_d, dim=1, stable=True).indices[:, :k]
    return flat_i.gather(1, order)


def knn_distance_keys_plain(d2: torch.Tensor) -> torch.Tensor:
    """Plain twin of the radix route's keys (``dist_key`` of
    ``knn_kernels.cu``): each float32 distance of ``d2`` as an
    order-preserving uint32 key, held in int64. -0 is made +0 first, so
    that the two tie as the float compare does."""
    u = d2.contiguous().view(torch.int32).long() & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, torch.zeros_like(u), u)
    return torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)


def knn_radix_select_plain(keys: torch.Tensor, k: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the select block's radix passes: for each row of
    ``keys`` (n, nt), ``(kth, need)``: its k-th smallest key, found by four
    8-bit digits from the most significant, each the bin of a histogram
    over the keys that share the prefix so far; and how many of the keys
    equal to it belong to the k smallest."""
    n = keys.shape[0]
    prefix = torch.zeros(n, dtype=torch.int64, device=keys.device)
    want = torch.full((n,), int(k), dtype=torch.int64, device=keys.device)
    mask = 0
    for shift in (24, 16, 8, 0):
        match = (keys & mask) == prefix[:, None]
        digit = (keys >> shift) & 0xFF
        counts = torch.zeros((n, KNN_RADIX_BINS), dtype=torch.int64,
                             device=keys.device)
        counts.scatter_add_(1, digit, match.long())
        upto = torch.cumsum(counts, 1)
        bin_ = (upto < want[:, None]).sum(1)
        before = upto.gather(1, bin_[:, None])[:, 0] - counts.gather(
            1, bin_[:, None])[:, 0]
        want = want - before
        prefix = prefix | (bin_ << shift)
        mask |= 0xFF << shift
    return prefix, want


def knn_compact_plain(keys: torch.Tensor, kth: torch.Tensor,
                      need: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the select block's compaction: for each row, the keys
    below its ``kth`` and the first ``need`` keys equal to it, in ascending
    train index → (n, k) keys and (n, k) int64 indices."""
    n = keys.shape[0]
    below = keys < kth[:, None]
    at = keys == kth[:, None]
    before = torch.cumsum(at.long(), 1) - at.long()
    keep = below | (at & (before < need[:, None]))
    cols = torch.nonzero(keep)[:, 1].view(n, k)
    return keys.gather(1, cols), cols


def knn_radix_sort_plain(keys: torch.Tensor, idx: torch.Tensor
                         ) -> torch.Tensor:
    """Plain twin of the select block's stable LSD radix sort: the pairs
    of each row ordered by key, 8 bits a pass from the least significant,
    each pass stable, so equal keys keep their order (ascending index) →
    the indices, int32."""
    for shift in (0, 8, 16, 24):
        order = torch.sort((keys >> shift) & 0xFF, dim=1, stable=True).indices
        keys, idx = keys.gather(1, order), idx.gather(1, order)
    return idx.to(torch.int32)


def knn_topk_radix_plain(x: torch.Tensor, train: torch.Tensor, k: int,
                         cap: int = KNN_KEY_CAP_BYTES) -> torch.Tensor:
    """The radix route's stages composed in plain PyTorch, over the test
    rows in the chunks :func:`knn_radix_plan` cuts under ``cap`` bytes:
    each chunk's distances as keys (the same ‖t‖² − 2·x·t as
    :func:`knn_topk_indices_plain`), the k-th key, the compaction and the
    sort → (n, k) int32, 1 ≤ k ≤ n_train."""
    n, d = x.shape
    nt = train.shape[0]
    chunk = knn_radix_plan(n, nt, d, k, cap).chunk_rows
    tsq = torch.sum(train * train, dim=1)
    parts = []
    for r0 in range(0, n, chunk):
        keys = knn_distance_keys_plain(
            tsq[None, :] - 2.0 * (x[r0:r0 + chunk] @ train.T))
        kth, need = knn_radix_select_plain(keys, k)
        parts.append(knn_radix_sort_plain(*knn_compact_plain(keys, kth,
                                                             need, k)))
    if not parts:
        return torch.empty((0, k), dtype=torch.int32, device=x.device)
    return torch.cat(parts)


# -- wrappers ------------------------------------------------------------------

def _is_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _check(name: str, **tensors: torch.Tensor) -> None:
    first = None
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a torch.Tensor, "
                            f"got {type(t).__name__}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if not (t.is_cuda or t.is_cpu):
            raise ValueError(f"{name}: {arg} is on {t.device}; the kernels "
                             "run on CUDA and their plain versions on the CPU")
        # get_device() is the card's index, or -1 on the CPU: cheaper to
        # compare than torch.device objects, on the path of every launch
        if first is None:
            first = t
        elif t.get_device() != first.get_device():
            raise ValueError(f"{name}: inputs are on {first.device} and "
                             f"{t.device}")


def _check_points(name: str, x, centroids, v=None) -> None:
    tensors = {"x": x, "centroids": centroids}
    if v is not None:
        tensors["v"] = v
    _check(name, **tensors)
    if x.ndim != 2 or centroids.ndim != 2 or x.shape[1] != centroids.shape[1]:
        raise ValueError(f"{name}: x must be (n, d) and centroids (k, d), got "
                         f"{tuple(x.shape)} and {tuple(centroids.shape)}")
    if centroids.shape[0] < 1:
        raise ValueError(f"{name}: needs at least one centroid")
    if v is not None and tuple(v.shape) != (x.shape[0],):
        raise ValueError(f"{name}: v must be ({x.shape[0]},), got {tuple(v.shape)}")


def assign_nearest(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid index per row of x, fused distance + argmin.

    x: (n, d) float32; centroids: (k, d) float32, on one device → (n,) int32.
    Ties go to the lowest index. Replaces ``assign_nearest`` of
    ``flink_ml_tpu/ops/pallas_kernels.py``; every k and d runs a kernel
    (:func:`kmeans_plan` picks the route).
    """
    _check_points("assign_nearest", x, centroids)
    if not _is_cuda(x):
        return assign_nearest_plain(x, centroids)
    n, d = x.shape
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=x.device)
    plan = kmeans_plan(n, centroids.shape[0], d, False)
    out = (_launch_assign(x, centroids) if plan.route == "fused"
           else _launch_assign_tiled(x, centroids, plan))
    launch_counts["assign_nearest"] += 1
    if _tracer.current() is not None:
        _capture_cost("assign_nearest", n=x.shape[0],
                      k=centroids.shape[0], d=x.shape[1])
    return out


def lloyd_partial_sums(x: torch.Tensor, v: torch.Tensor,
                       centroids: torch.Tensor) -> torch.Tensor:
    """One Lloyd round's weighted partials, one pass over x.

    x: (n, d) float32; v: (n,) float32 row weights (0 adds nothing);
    centroids: (k, d) float32 → (k, d+1) float32 = [weighted sums | counts],
    assigned by the same rule as :func:`assign_nearest`. n == 0 gives zeros.
    Replaces ``lloyd_partial_sums`` of ``flink_ml_tpu/ops/pallas_kernels.py``;
    every k and d runs the kernels (:func:`kmeans_plan` picks the route:
    the fused one ends in :func:`reduce_partials`, the tiled one launches
    every stage from one C call).
    """
    _check_points("lloyd_partial_sums", x, centroids, v)
    if not _is_cuda(x):
        return lloyd_partial_sums_plain(x, v, centroids)
    k, d = centroids.shape
    n = x.shape[0]
    if n == 0:
        return torch.zeros((k, d + 1), dtype=torch.float32, device=x.device)
    plan = kmeans_plan(n, k, d, True)
    fused = plan.route == "fused"
    out = (_launch_lloyd_partials(x, v, centroids) if fused
           else _launch_lloyd_sorted(x, v, centroids, plan)[0])
    launch_counts["lloyd_partial_sums"] += 1
    if _tracer.current() is not None:
        _capture_cost("lloyd_partial_sums", n=n, k=k, d=d)
    # the fused route's per-block partials end in their fixed-order sum
    return reduce_partials(out) if fused else out


def reduce_partials(partials: torch.Tensor) -> torch.Tensor:
    """(B, ...) per-block partials → (...), summed over B in a fixed
    two-level order (:func:`reduce_partials_plain`): the second stage of
    :func:`lloyd_partial_sums` ((B, k, d+1)), and the order of
    :func:`sgd_batch_terms`' own."""
    _check("reduce_partials", partials=partials)
    if partials.ndim < 2 or partials.shape[0] < 1:
        raise ValueError("reduce_partials: partials must be (B, ...) with "
                         f"B >= 1, got {tuple(partials.shape)}")
    if not _is_cuda(partials):
        return reduce_partials_plain(partials)
    if partials.numel() == 0:
        return partials.new_zeros(partials.shape[1:])
    out = _launch_reduce(partials)
    launch_counts["reduce_partials"] += 1
    if _tracer.current() is not None:
        _capture_cost("reduce_partials", blocks=partials.shape[0],
                      inner=partials.numel() // partials.shape[0])
    return out


def sgd_batch_terms(xl: torch.Tensor, yl: torch.Tensor, wl: torch.Tensor,
                    coeffs: torch.Tensor, start: int, clip: int, lb: int,
                    loss_name: str) -> torch.Tensor:
    """One SGD round's packed terms, one pass over the minibatch window.

    xl: (n, d), yl and wl: (n,), coeffs: (d,), all float32 on one device;
    the window is rows [start, start + lb) of them, and rows whose window
    index is below ``clip`` weigh 0. Returns (d+2,) float32 =
    ``[Σ mult·x | Σ w | Σ loss]`` with the per-row terms of the loss named
    ``loss_name`` (``ops/losses.py``). lb == 0 gives zeros. Replaces
    ``sgd_batch_terms`` of ``flink_ml_tpu/ops/pallas_kernels.py``; every
    window and every ``d`` runs the kernels, both stages from one C call,
    with no tile alignment asked of ``start``.
    """
    _check("sgd_batch_terms", xl=xl, yl=yl, wl=wl, coeffs=coeffs)
    n = xl.shape[0]
    if (xl.ndim != 2 or tuple(coeffs.shape) != (xl.shape[1],)
            or tuple(yl.shape) != (n,) or tuple(wl.shape) != (n,)):
        raise ValueError(
            "sgd_batch_terms: xl must be (n, d), yl and wl (n,), coeffs "
            f"(d,); got {tuple(xl.shape)}, {tuple(yl.shape)}, "
            f"{tuple(wl.shape)}, {tuple(coeffs.shape)}")
    start, clip, lb = int(start), int(clip), int(lb)
    if start < 0 or lb < 0 or start + lb > n or not 0 <= clip <= lb:
        raise ValueError(f"sgd_batch_terms: window start={start}, lb={lb}, "
                         f"clip={clip} does not lie in {n} rows")
    if loss_name not in SGD_LOSSES:
        raise ValueError(f"sgd_batch_terms: unknown loss {loss_name!r}; "
                         f"known: {sorted(SGD_LOSSES)}")
    if not _is_cuda(xl):
        return sgd_batch_terms_plain(xl, yl, wl, coeffs, start, clip, lb,
                                     loss_name)
    if lb == 0:
        return torch.zeros(xl.shape[1] + 2, dtype=torch.float32,
                           device=xl.device)
    ws = _launch_sgd_terms(xl, yl, wl, coeffs, start, clip, lb, loss_name)
    launch_counts["sgd_batch_terms"] += 1
    if _tracer.current() is not None:
        _capture_cost("sgd_batch_terms", lb=lb, d=xl.shape[1])
    return ws[ws.shape[0] - 1]  # a positive index takes less host time


def segment_reduce_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Per-segment sums: ``out[s] = Σ values[i]`` over ``segment_ids[i] ==
    s``.

    values: (n,) or (n, c) float32; segment_ids: (n,) int32 on the same
    device → (u,) or (u, c) float32 with u = ``num_segments``. Rows whose id
    lies outside [0, u), the −1 padding included, add nothing; n == 0 gives
    zeros. Replaces ``segment_reduce_sum`` of
    ``flink_ml_tpu/ops/pallas_kernels.py``; every u and c runs the kernels,
    all three stages from one C call.
    """
    _check("segment_reduce_sum", values=values)
    u = int(num_segments)
    n = values.shape[0] if values.ndim else 0
    if (values.ndim not in (1, 2) or not isinstance(segment_ids, torch.Tensor)
            or segment_ids.dtype != torch.int32
            or tuple(segment_ids.shape) != (n,)
            or not segment_ids.is_contiguous()
            or segment_ids.device != values.device or u < 1):
        raise ValueError(
            "segment_reduce_sum: values must be (n,) or (n, c) and "
            "segment_ids a contiguous (n,) int32 tensor on the same device, "
            f"with num_segments >= 1; got {tuple(values.shape)}, "
            f"{getattr(segment_ids, 'dtype', type(segment_ids).__name__)} "
            f"{tuple(getattr(segment_ids, 'shape', ()))}, {u}")
    if not _is_cuda(values):
        return segment_reduce_sum_plain(values, segment_ids, u)
    c = 1 if values.ndim == 1 else values.shape[1]
    shape = (u,) if values.ndim == 1 else (u, c)
    if n == 0 or c == 0:
        return torch.zeros(shape, dtype=torch.float32, device=values.device)
    out = _launch_segment(values, segment_ids, u, c, shape)
    launch_counts["segment_reduce_sum"] += 1
    if _tracer.current() is not None:
        _capture_cost("segment_reduce_sum", n=n, c=c, u=u)
    return out


def knn_topk_indices(x: torch.Tensor, train: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Indices of the k nearest train rows of every test row, fused
    distance and top-k: the (n, n_train) distances never exist.

    x: (n, d), train: (n_train, d) float32 on one device →
    (n, min(k, n_train)) int32 in ascending order of ‖t‖² − 2·x·t, ties to
    the lowest train index (``lax.top_k`` parity). Replaces
    ``knn_topk_indices`` of ``flink_ml_tpu/ops/pallas_kernels.py``; every
    d and k runs the kernel.
    """
    _check("knn_topk_indices", x=x, train=train)
    if x.ndim != 2 or train.ndim != 2 or x.shape[1] != train.shape[1]:
        raise ValueError("knn_topk_indices: x must be (n, d) and train "
                         f"(n_train, d), got {tuple(x.shape)} and "
                         f"{tuple(train.shape)}")
    if train.shape[0] < 1 or int(k) < 1:
        raise ValueError("knn_topk_indices: needs at least one train row "
                         f"and k >= 1, got {train.shape[0]} and {k}")
    if not _is_cuda(x):
        return knn_topk_indices_plain(x, train, k)
    k = min(int(k), train.shape[0])
    if x.shape[0] == 0:
        return torch.empty((0, k), dtype=torch.int32, device=x.device)
    out = _launch_knn(x, train, k)
    launch_counts["knn_topk_indices"] += 1
    if _tracer.current() is not None:
        _capture_cost("knn_topk_indices", n=x.shape[0],
                      nt=train.shape[0], d=x.shape[1], k=k)
    return out


# -- launches (CUDA only) --------------------------------------------------------

def build_kernels() -> dict:
    """Builds and loads every source's library now instead of at first use,
    the sources compiling at once; returns ptxas' report by source (empty
    for libraries built earlier)."""
    _build.build_all(_SIGNATURES)
    for source in _SIGNATURES:
        _lib(source)
    return dict(_build.BUILD_LOGS)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: each source's C functions: name → (argtypes, restype)
_SIGNATURES = {
    KMEANS_SOURCE: {
        "kmeans_error_string": ([_I], ctypes.c_char_p),
        "kmeans_blocks_per_sm": ([_I, _I, _I, ctypes.POINTER(_I)], _I),
        "kmeans_assign_nearest": ([_P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                                   _I, _I, _P], _I),
        "kmeans_lloyd_partials": ([_P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                                   _I, _I, _I, _L, _P], _I),
        "kmeans_reduce_partials": ([_P, _P, _I, _I, _P], _I),
        "kmeans_assign_tiled": ([_P, _P, _P, _P, _L, _I, _I, _I, _I, _P], _I),
        "kmeans_label_blocks_per_sm": ([_I, _I, ctypes.POINTER(_I)], _I),
        "kmeans_label_smem_bytes": ([_I, _I], _L),
        "kmeans_lloyd_sorted": ([_P] * 10 + [_L] + [_I] * 11 + [_P], _I),
    },
    SGD_SOURCE: {
        "sgd_error_string": ([_I], ctypes.c_char_p),
        "sgd_blocks_per_sm": ([_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I)],
                              _I),
        "sgd_clusters_on_card": ([_I, _I, _I, _I, _I, ctypes.POINTER(_I)],
                                 _I),
        "sgd_grid_ctas_on_card": ([_I, _I, _I, _I, ctypes.POINTER(_I)], _I),
        "sgd_batch_terms": ([_P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _P, _L, _I, _I, _P],
                            _I),
    },
    SEGMENT_SOURCE: {
        "segment_error_string": ([_I], ctypes.c_char_p),
        "segment_blocks_per_sm": ([_I, _I, ctypes.POINTER(_I)], _I),
        "segment_reduce_sum": ([_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _L,
                                _I, _I, _P], _I),
    },
    KNN_SOURCE: {
        "knn_error_string": ([_I], ctypes.c_char_p),
        "knn_tile_smem_bytes": ([_I], _L),
        "knn_tile_blocks_per_sm": ([_I, _I, ctypes.POINTER(_I)], _I),
        "knn_topk_tiled": ([_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I,
                            _P], _I),
        "knn_long_smem_bytes": ([_I, _I], _L),
        "knn_long_blocks_per_sm": ([_I, _I, ctypes.POINTER(_I)], _I),
        "knn_topk_long": ([_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                           _P], _I),
        "knn_select_smem_bytes": ([_I, _I, _I], _L),
        "knn_sample_rank": ([_I, _I], _I),
        "knn_topk_radix": ([_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I,
                            _L, _I, _I, _P], _I),
    },
}
#: the C function that names a CUDA error code, by source
_ERROR_STRING = {KMEANS_SOURCE: "kmeans_error_string",
                 SGD_SOURCE: "sgd_error_string",
                 SEGMENT_SOURCE: "segment_error_string",
                 KNN_SOURCE: "knn_error_string"}


@functools.lru_cache(maxsize=None)
def _lib(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>.cu``, its functions typed."""
    lib = _build.load(source)
    for name, (argtypes, restype) in _SIGNATURES[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _raise_on_error(source: str, rc: int, what: str) -> None:
    if rc != 0:
        msg = getattr(_lib(source), _ERROR_STRING[source])(rc).decode()
        raise KernelLaunchError(f"{what}: CUDA error {rc} ({msg})")


def _blocks_on_card(device_index: int, per_sm: int, what: str) -> int:
    """Blocks the whole card holds at once, given one SM's count."""
    if per_sm < 1:
        raise KernelLaunchError(f"no block of {what} fits an SM of this card")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return per_sm * sms


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index: int, lloyd: bool, rows: int, smem: int) -> int:
    """Blocks of this KMeans configuration the whole card holds at once."""
    per_sm = ctypes.c_int(0)
    _raise_on_error(KMEANS_SOURCE, _lib(KMEANS_SOURCE).kmeans_blocks_per_sm(
        int(lloyd), rows, smem, ctypes.byref(per_sm)), "occupancy query")
    return _blocks_on_card(device_index, per_sm.value,
                           f"{rows} threads and {smem} bytes of shared memory")


@functools.lru_cache(maxsize=None)
def _sgd_resident_blocks(device_index: int, loss: int, v: int, vec4: int,
                         d: int, dc: int, smem: int) -> int:
    """Blocks of an sgd stage-1 instance the card holds at once: the
    register instance ``v`` (sized for its widest rows, d = 128·v), or for
    v = 0 the staged one (dc = d), at ``smem`` bytes.
    The query also lets the instance use its dynamic shared memory, once
    per process."""
    per_sm = ctypes.c_int(0)
    _raise_on_error(SGD_SOURCE, _lib(SGD_SOURCE).sgd_blocks_per_sm(
        loss, v, vec4, d, dc, smem, ctypes.byref(per_sm)),
        "occupancy query")
    return _blocks_on_card(device_index, per_sm.value,
                           f"sgd stage 1 (v={v}, d={d}, {smem} bytes)")


@functools.lru_cache(maxsize=None)
def _sgd_resident_clusters(device_index: int, loss: int, d: int, c: int,
                           smem: int) -> int:
    """Clusters of ``c`` CTAs of the sgd cluster instance at width ``d``
    (``smem`` bytes a CTA) the card holds at once
    (``cudaOccupancyMaxActiveClusters``). The query also lets the instance
    use its dynamic shared memory, once per process."""
    count = ctypes.c_int(0)
    _raise_on_error(SGD_SOURCE, _lib(SGD_SOURCE).sgd_clusters_on_card(
        loss, d, _sgd_cluster_slice(d, c), c, smem, ctypes.byref(count)),
        "occupancy query")
    if count.value < 1:
        raise KernelLaunchError(
            f"no cluster of {c} CTAs of sgd stage 1 ({smem} bytes each) "
            "fits this card")
    return count.value


@functools.lru_cache(maxsize=None)
def _sgd_resident_grid(device_index: int, loss: int, d: int, smem: int) -> int:
    """CTAs of the sgd grid instance at width ``d`` (``smem`` bytes a CTA)
    the card holds at once (SMs × CTAs an SM). The query also lets the
    instance use its dynamic shared memory, once per process."""
    count = ctypes.c_int(0)
    _raise_on_error(SGD_SOURCE, _lib(SGD_SOURCE).sgd_grid_ctas_on_card(
        loss, d, _sgd_cluster_slice(d, _card_sms(device_index)), smem,
        ctypes.byref(count)), "occupancy query")
    if count.value < 1:
        raise KernelLaunchError(
            f"no CTA of sgd stage 1's grid instance ({smem} bytes) fits an SM "
            "of this card")
    return count.value


@functools.lru_cache(maxsize=None)
@functools.lru_cache(maxsize=None)
def _card_sms(device_index: int) -> int:
    """The SMs of the card: the CTAs the grid instance's layout is sized
    for (one an SM)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


#: the context of a launch on the card that is already current
_CURRENT_CARD = contextlib.nullcontext()


def _on_card(t: torch.Tensor):
    """A context in which ``t``'s card is the current one, where the C side
    launches: a no-op when it already is, as in a one-card process, so that a
    launch does not pay the host time of a device switch and its undo."""
    index = _device_index(t)
    if index == torch.cuda.current_device():
        return _CURRENT_CARD
    return torch.cuda.device(index)


def _stream(t: torch.Tensor) -> int:
    """The handle of the current stream of ``t``'s card (the raw handle, not
    a ``torch.cuda.Stream`` object, which takes longer to make than a short
    kernel takes to run)."""
    return torch._C._cuda_getCurrentRawStream(_device_index(t))


def _launch_setup(x: torch.Tensor, k: int, d: int, lloyd: bool):
    what = "lloyd_partial_sums" if lloyd else "assign_nearest"
    layout = _fused_layout(k, d, lloyd)
    if layout is None:
        raise ValueError(f"{what}: the fused kernel has no "
                         f"{FUSED_TILE_ROWS}-row tile for k={k}, d={d}; "
                         "kmeans_plan takes the tiled route there")
    vec4 = int(d % 4 == 0 and x.data_ptr() % 16 == 0)
    stream = _stream(x)
    return layout, _device_index(x), vec4, stream


def _launch_assign(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    n, d = x.shape
    k = centroids.shape[0]
    with _on_card(x):
        (rows, kchunk, smem), dev, vec4, stream = _launch_setup(x, k, d, False)
        csq = torch.sum(centroids * centroids, dim=1)
        out = torch.empty(n, dtype=torch.int32, device=x.device)
        grid = min(-(-n // rows), _resident_blocks(dev, False, rows, smem))
        _raise_on_error(KMEANS_SOURCE, _lib(KMEANS_SOURCE).kmeans_assign_nearest(
            x.data_ptr(), centroids.data_ptr(), csq.data_ptr(), out.data_ptr(),
            n, k, d, rows, kchunk, smem, vec4, grid, stream), "assign_nearest")
    return out


def _launch_lloyd_partials(x: torch.Tensor, v: torch.Tensor,
                           centroids: torch.Tensor) -> torch.Tensor:
    n, d = x.shape
    k = centroids.shape[0]
    with _on_card(x):
        (rows, kchunk, smem), dev, vec4, stream = _launch_setup(x, k, d, True)
        csq = torch.sum(centroids * centroids, dim=1)
        ntiles = -(-n // rows)
        blocks = min(ntiles, _resident_blocks(dev, True, rows, smem))
        tiles_per_block = -(-ntiles // blocks)
        blocks = -(-ntiles // tiles_per_block)  # no block without rows
        partials = torch.empty((blocks, k, d + 1), dtype=torch.float32,
                               device=x.device)
        _raise_on_error(KMEANS_SOURCE, _lib(KMEANS_SOURCE).kmeans_lloyd_partials(
            x.data_ptr(), v.data_ptr(), centroids.data_ptr(), csq.data_ptr(),
            partials.data_ptr(), n, k, d, rows, kchunk, smem, vec4, blocks,
            tiles_per_block, stream), "lloyd_partial_sums")
    return partials


def _tiled_centroids(centroids: torch.Tensor, plan: KMeansPlan
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tile engine's operand: the centroids transposed and zero-padded
    to (dpad, kp), and their norms (one torch op, as the fused launch
    computes them), +inf past k, so the padded centroids never win."""
    k, d = centroids.shape
    c_t = torch.zeros((plan.dpad, plan.kp), dtype=torch.float32,
                      device=centroids.device)
    c_t[:d, :k] = centroids.T
    csq = torch.full((plan.kp,), float("inf"), device=centroids.device)
    csq[:k] = torch.sum(centroids * centroids, dim=1)
    return c_t, csq


def _launch_assign_tiled(x: torch.Tensor, centroids: torch.Tensor,
                         plan: KMeansPlan) -> torch.Tensor:
    n, d = x.shape
    with _on_card(x):
        c_t, csq = _tiled_centroids(centroids, plan)
        out = torch.empty(n, dtype=torch.int32, device=x.device)
        _raise_on_error(KMEANS_SOURCE, _lib(KMEANS_SOURCE).kmeans_assign_tiled(
            x.data_ptr(), c_t.data_ptr(), csq.data_ptr(), out.data_ptr(), n,
            centroids.shape[0], d, plan.dpad, plan.kp, _stream(x)),
            "assign_nearest")
    return out


def _launch_lloyd_sorted(x: torch.Tensor, v: torch.Tensor,
                         centroids: torch.Tensor, plan: KMeansPlan
                         ) -> Tuple[torch.Tensor, dict]:
    """The tiled Lloyd route, one C call: ``(out, workspace)``, the (k, d+1)
    sums and the stages' outputs as they left them: ``labels`` (n,),
    ``offs`` (k·nchunks,) and ``order`` (n,) int32, and the pieces'
    ``scratch`` (pieces, 2, d+1) float32 (unwritten slots hold whatever
    the allocator gave)."""
    n, d = x.shape
    k = centroids.shape[0]
    dev = x.device
    with _on_card(x):
        c_t, csq = _tiled_centroids(centroids, plan)
        ws = {"labels": torch.empty(n, dtype=torch.int32, device=dev),
              "offs": torch.empty(k * plan.nchunks, dtype=torch.int32,
                                  device=dev),
              "order": torch.empty(n, dtype=torch.int32, device=dev),
              "scratch": torch.empty((plan.pieces, 2, d + 1),
                                     dtype=torch.float32, device=dev)}
        bsum = torch.empty(plan.scan_blocks, dtype=torch.int32, device=dev)
        out = torch.empty((k, d + 1), dtype=torch.float32, device=dev)
        _raise_on_error(KMEANS_SOURCE, _lib(KMEANS_SOURCE).kmeans_lloyd_sorted(
            x.data_ptr(), v.data_ptr(), c_t.data_ptr(), csq.data_ptr(),
            ws["labels"].data_ptr(), ws["offs"].data_ptr(), bsum.data_ptr(),
            ws["order"].data_ptr(), ws["scratch"].data_ptr(), out.data_ptr(),
            n, k, d, plan.dpad, plan.kp, plan.chunk_rows, plan.nchunks,
            plan.label_tile, plan.scan_span, plan.scan_blocks,
            plan.piece_rows, plan.col_threads, _stream(x)),
            "lloyd_partial_sums")
    return out, ws


def _launch_reduce(partials: torch.Tensor) -> torch.Tensor:
    out = torch.empty(partials.shape[1:], dtype=torch.float32,
                      device=partials.device)
    with _on_card(partials):
        _raise_on_error(KMEANS_SOURCE, _lib(KMEANS_SOURCE).kmeans_reduce_partials(
            partials.data_ptr(), out.data_ptr(), partials.shape[0],
            out.numel(), _stream(partials)), "reduce_partials")
    return out


@functools.lru_cache(maxsize=256)
def _sgd_plan_on(device_index: int, loss: int, d: int, lb: int,
                 vec4: int) -> SgdPlan:
    """:func:`_sgd_plan` on one card, cached: a fit asks for the same
    window shape every round."""
    instance, sms = _sgd_card_instance(device_index, d)
    if instance == "twopass":  # ordinary launches: no occupancy to ask
        return _sgd_plan(lb, d, sms, vec4, sms=sms)
    if instance == "grid":
        # raises where no CTA of the layout fits an SM
        _sgd_resident_grid(device_index, loss, d, _sgd_grid_layout(d, sms)[1])
        return _sgd_plan(lb, d, sms, vec4, sms=sms)
    if instance == "cluster":
        c = _sgd_cluster_size(d)
        resident = _sgd_resident_clusters(
            device_index, loss, d, c,
            _sgd_cluster_layout(_sgd_cluster_slice(d, c))[1])
        return _sgd_plan(lb, d, resident, vec4, sms=sms)
    v = _sgd_width_class(d)
    shape = ((128 * v, 0, 0) if v else
             (d, d, _sgd_staged_layout(d)[1]))
    resident = _sgd_resident_blocks(device_index, loss, v, vec4, *shape)
    return _sgd_plan(lb, d, resident, vec4, sms=sms)


def _sgd_instance(d: int, sms: int) -> str:
    """The stage-1 instance :func:`_sgd_plan` takes at width ``d`` on a card
    of ``sms`` SMs (the grid instance runs one CTA an SM)."""
    if d <= SGD_REG_COLS:
        return "registers"
    if _sgd_staged_layout(d) is not None:
        return "staged"
    if _sgd_cluster_size(d) is not None:
        return "cluster"
    return "grid" if _sgd_grid_layout(d, sms) is not None else "twopass"


def _sgd_card_instance(device_index: int, d: int) -> Tuple[str, int]:
    """:func:`_sgd_instance` on one card, and the card's SMs."""
    sms = _card_sms(device_index)
    return _sgd_instance(d, sms), sms


def _sgd_card_plan(xl: torch.Tensor, lb: int, loss_name: str) -> SgdPlan:
    """:func:`_sgd_plan` for ``xl``'s card and alignment: rows are read by
    16 bytes from an aligned x at a width that is a multiple of 4, or at
    any width by the staged, cluster, grid and two-pass instances, which
    read each stage (each row's slice, segment or float4s) from the
    aligned address at or before it."""
    d = xl.shape[1]
    any_width = _sgd_card_instance(_device_index(xl), d)[0] != "registers"
    return _sgd_plan_on(_device_index(xl), SGD_LOSSES[loss_name], d, lb,
                        int((d % 4 == 0 or any_width)
                            and xl.data_ptr() % 16 == 0))


def _launch_sgd_terms(xl: torch.Tensor, yl: torch.Tensor, wl: torch.Tensor,
                      coeffs: torch.Tensor, start: int, clip: int, lb: int,
                      loss_name: str, combine: bool = True,
                      plan: Optional[SgdPlan] = None) -> torch.Tensor:
    """One C call: the (blocks + 1, d + 2) workspace, stage 1's per-block
    (per-cluster; the grid's or two-pass set's one) partials in its first
    rows and (where ``combine``, else left unwritten) their fixed-order sum
    in the last; where ``combine`` and blocks = 1, stage 1 writes its one
    row into the last itself and the first is left unwritten. The grid
    instance also gets its scratch: two stages' partial dots (2 × rows ×
    grid floats) and dots (2 × rows), then its two barriers' counters,
    which the C entry zeroes; the two-pass set its partial dots and
    multipliers (:func:`sgd_twopass_grids`). ``plan`` overrides the card's
    plan (the card check runs the cluster instance in other sizes, the grid
    one at the cluster's widths and the two-pass set at the grid's with it;
    the C entry refuses a plan its kernels were not written for)."""
    d = xl.shape[1]
    with _on_card(xl):
        plan = plan or _sgd_card_plan(xl, lb, loss_name)
        ws = torch.empty((plan.blocks + 1, d + 2), dtype=torch.float32,
                         device=xl.device)
        floats = (2 * plan.rows * (plan.grid + 1) + 2 if plan.grid else
                  sgd_twopass_grids(plan, lb, d)["scratch"] if plan.segments
                  else 0)
        scratch = (torch.empty(floats, dtype=torch.float32, device=xl.device)
                   if floats else None)
        _raise_on_error(SGD_SOURCE, _lib(SGD_SOURCE).sgd_batch_terms(
            xl.data_ptr(), yl.data_ptr(), wl.data_ptr(), coeffs.data_ptr(),
            ws.data_ptr(), start, lb, clip, d, plan.v, plan.vec4, plan.blocks,
            plan.rows, plan.dc, plan.smem, plan.segments, plan.owner,
            plan.cluster, plan.grid, scratch.data_ptr() if floats else None,
            floats, SGD_LOSSES[loss_name], int(combine), _stream(xl)),
            "sgd_batch_terms")
    return ws


@functools.lru_cache(maxsize=None)
def _segment_resident_blocks(device_index: int, one_tile: bool,
                             smem: int) -> int:
    """Blocks of the segment tile kernel (its one-tile instance or the
    other) the card holds at once."""
    per_sm = ctypes.c_int(0)
    _raise_on_error(SEGMENT_SOURCE, _lib(SEGMENT_SOURCE).segment_blocks_per_sm(
        int(one_tile), smem, ctypes.byref(per_sm)), "occupancy query")
    return _blocks_on_card(device_index, per_sm.value,
                           f"{smem} bytes of shared memory")


def _launch_segment(values: torch.Tensor, ids: torch.Tensor, u: int, c: int,
                    shape: Tuple[int, ...]) -> torch.Tensor:
    n = values.shape[0]
    ut, tiles, cg, groups = _seg_layout(u, c)
    blocks = tiles * groups
    with _on_card(values):
        chunks, rows_per_chunk, slots = _segment_chunks(
            n, blocks, _segment_resident_blocks(
                _device_index(values), tiles == 1, _seg_smem(ut, cg)))
        out = torch.empty(shape, dtype=torch.float32, device=values.device)
        # scratch, written by the kernels before they read it: the items'
        # tile slabs; the chunks' ranges and runs (int4), the items' ranges
        # (int2), the item counts
        partials = torch.empty(blocks * slots * ut * cg, dtype=torch.float32,
                               device=values.device)
        meta = torch.empty(4 * chunks + 2 * blocks * slots + blocks,
                           dtype=torch.int32, device=values.device)
        _raise_on_error(SEGMENT_SOURCE, _lib(SEGMENT_SOURCE).segment_reduce_sum(
            values.data_ptr(), ids.data_ptr(), out.data_ptr(),
            partials.data_ptr(), meta.data_ptr(), n, u, c, ut, cg,
            rows_per_chunk, chunks, slots, _stream(values)),
            "segment_reduce_sum")
    return out


@functools.lru_cache(maxsize=None)
def _knn_resident_blocks(device_index: int, kcap: int, dpad: int) -> int:
    """Blocks of the tiled (kcap ≤ 32) or long-list KNN kernel the whole
    card holds at once."""
    per_sm = ctypes.c_int(0)
    lib = _lib(KNN_SOURCE)
    query = (lib.knn_tile_blocks_per_sm if kcap <= KNN_KCAPS[-1]
             else lib.knn_long_blocks_per_sm)
    _raise_on_error(KNN_SOURCE, query(kcap, dpad, ctypes.byref(per_sm)),
                    "occupancy query")
    kind = "tile" if kcap <= KNN_KCAPS[-1] else "long"
    return _blocks_on_card(device_index, per_sm.value,
                           f"knn_{kind}_kernel<{kcap}> at dpad={dpad}")


def knn_tile_smem_bytes(dpad: int) -> int:
    """Shared memory of a tiled KNN block at padded width ``dpad``, as the
    kernel sizes it (CUDA only: it asks the built library)."""
    return _lib(KNN_SOURCE).knn_tile_smem_bytes(dpad)


def knn_long_smem_bytes(kcap: int, dpad: int) -> int:
    """Shared memory of a long-list KNN block of capacity ``kcap`` at
    padded width ``dpad``, as the kernel sizes it (CUDA only)."""
    return _lib(KNN_SOURCE).knn_long_smem_bytes(kcap, dpad)


def _knn_card_plan(x: torch.Tensor, nt: int, k: int) -> KnnPlan:
    """:func:`_knn_plan` for this card."""
    n, d = x.shape
    plan = _knn_plan(n, nt, d, k, 1)
    if plan.route == "radix":
        return plan
    resident = _knn_resident_blocks(_device_index(x), plan.kcap, plan.dpad)
    return _knn_plan(n, nt, d, k, resident)


def _launch_knn(x: torch.Tensor, train: torch.Tensor, k: int,
                splits: Optional[int] = None,
                cap: Optional[int] = None) -> torch.Tensor:
    """Launches the KNN kernels as :func:`_knn_plan` says; ``splits``
    overrides the plan's train split (1 to its train tiles) of the tiled
    and long-list kernels, which the card check uses to hold split and
    unsplit runs against each other, and ``cap`` takes the radix route at
    any k with that scratch cap (the card check runs several chunks with a
    small one, and times the hand-over from the long-list kernel)."""
    n, d = x.shape
    nt = train.shape[0]
    with _on_card(x):
        plan = (_knn_card_plan(x, nt, k) if cap is None
                else knn_radix_plan(n, nt, d, k, cap))
        tsq = torch.sum(train * train, dim=1)
        out = torch.empty((n, k), dtype=torch.int32, device=x.device)
        stream = _stream(x)
        lib = _lib(KNN_SOURCE)
        if splits is not None:
            if plan.route == "radix" or not 1 <= splits <= plan.tiles:
                raise ValueError(f"knn_topk_indices: splits={splits} outside "
                                 f"[1, {plan.tiles}] or on the radix route")
            plan = plan._replace(
                splits=splits, scratch_bytes=8 * splits * n * k if splits > 1
                else 0)
        # the train set transposed and padded: zero columns past d and
        # train rows past nt, whose norms are +inf, so they never enter a list
        train_t = torch.zeros((plan.dpad, plan.ntp), dtype=torch.float32,
                              device=x.device)
        train_t[:d, :nt] = train.T
        tsq_p = torch.full((plan.ntp,), float("inf"), device=x.device)
        tsq_p[:nt] = tsq
        scratch = (torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                               device=x.device) if plan.scratch_bytes else None)
        args = (x.data_ptr(), train_t.data_ptr(), tsq_p.data_ptr(),
                out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
                n, d, plan.dpad, plan.ntp)
        if plan.route == "radix":
            rc = lib.knn_topk_radix(*args, nt, k, plan.splits,
                                    plan.chunk_rows, plan.cap_w,
                                    plan.pairs_smem, stream)
        elif plan.route == "long":
            rc = lib.knn_topk_long(*args, nt, k, plan.kcap, plan.splits,
                                   stream)
        else:
            rc = lib.knn_topk_tiled(*args, k, plan.kcap, plan.splits, stream)
        _raise_on_error(KNN_SOURCE, rc, "knn_topk_indices")
    return out
