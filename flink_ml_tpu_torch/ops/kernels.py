"""The port's kernels: wrappers, plain versions, launch counts, shape gates.

The Pallas kernels of ``flink_ml_tpu/ops/pallas_kernels.py`` that the ported
slices run, written by hand in CUDA C++ for Hopper and built by ``_build.py``
at first use, one library per source:

- :func:`assign_nearest` (``csrc/kmeans_kernels.cu``): nearest centroid per
  row, ``argmin_j(‖c_j‖² − 2·x·c_j)``, first minimum; only the argmin is
  written.
- :func:`lloyd_partial_sums` (same source): the same assignment, then the
  weighted ``[one_hotᵀ·x | Σ one_hot]`` of one Lloyd round, in two stages
  in a fixed order (per-block partials, then :func:`reduce_partials`).
- :func:`sgd_batch_terms` (``csrc/sgd_kernels.cu``): one SGD round's
  ``[Σ mult·x | Σ w | Σ loss]`` over the minibatch window, forward dots and
  loss terms fused into the gradient pass, for any feature width, in two
  fixed-order stages launched by one C entry (per-block partials, then
  their sum in :func:`reduce_partials`' order; :func:`_sgd_plan` and
  :func:`sgd_runs` mirror the launch).
- :func:`segment_reduce_sum` (``csrc/segment_kernels.cu``): per-segment sums
  of 1-D or 2-D values, ids outside the domain dropped, in three stages
  launched by one C entry: each row chunk's id range, per-item partials of
  only the segment tiles a chunk meets, then a fixed-order combine of them
  (:func:`segment_plan_plain` mirrors the plan).
- :func:`knn_topk_indices` (``csrc/knn_kernels.cu``): the k nearest train
  rows of every test row, fused distance and top-k over the streamed train
  set, ties to the lowest index.

No kernel uses atomics, so a call gives the same bits every time.

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
    "lloyd_partials_kernel": "lloyd_partial_sums",
    "reduce_rows_kernel": "reduce_partials",
    "reduce_tile_kernel": "reduce_partials",
    "sgd_rows_kernel": "sgd_batch_terms",
    "sgd_terms_kernel": "sgd_batch_terms",
    "sgd_combine_kernel": "sgd_batch_terms",
    "segment_ranges_kernel": "segment_reduce_sum",
    "segment_tiles_kernel": "segment_reduce_sum",
    "segment_combine_kernel": "segment_reduce_sum",
    "knn_tile_kernel": "knn_topk_indices",
    "knn_merge_kernel": "knn_topk_indices",
    "knn_topk_wide_kernel": "knn_topk_indices",
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


# -- shape gates -------------------------------------------------------------

#: dynamic shared memory one block may use on Hopper (227 KB of the SM's 228)
SMEM_BLOCK_BYTES = 232448
#: shared memory for one staged chunk of centroids; more centroids than
#: fit are scored chunk by chunk
CENTROID_CHUNK_BYTES = 64 << 10
#: centroids the kernel scores together in registers; chunks are multiples
_KG = 16
#: row tiles (= threads per block) to try, largest first
_TILE_ROWS = (128, 64, 32)


def _layout(k: int, d: int, lloyd: bool) -> Optional[Tuple[int, int, int]]:
    """``(rows, kchunk, smem_bytes)`` of a launch, or None when no tile fits
    one block's shared memory. The sizes are the ones the layout comment
    in ``kmeans_kernels.cu`` lists: a transposed chunk of ``kchunk``
    centroids and their norms, a ``rows`` × ``(d | 1)`` x tile and, for
    Lloyd, the tile's ``rows`` (label and row, weight) pairs in label
    order and the ``k`` × ``(d + 1)`` accumulator."""
    cap = max(_KG, CENTROID_CHUNK_BYTES // (4 * (d + 1)) // _KG * _KG)
    want = min(-(-k // _KG) * _KG, cap)
    for rows in _TILE_ROWS:
        for kchunk in dict.fromkeys((want, _KG)):
            floats = kchunk * d + kchunk + rows * (d | 1)
            if lloyd:
                floats += k * (d + 1) + 2 * rows
            if 4 * floats <= SMEM_BLOCK_BYTES:
                return rows, kchunk, 4 * floats
    return None


def assign_kernel_fits(k: int, d: int) -> bool:
    """True when :func:`assign_nearest` has a tile for these shapes on
    Hopper: any k (centroids are chunked); d up to about 1,400."""
    return _layout(k, d, lloyd=False) is not None


def lloyd_kernel_fits(k: int, d: int) -> bool:
    """True when :func:`lloyd_partial_sums` has a tile for these shapes on
    Hopper: the block's (k, d+1) accumulator must fit in shared memory
    beside the x tile — the gate ``KMeans.fit`` applies."""
    return _layout(k, d, lloyd=True) is not None


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
#: holds V = ⌈d / 128⌉ ≤ 4 float4s of a row; wider rows take the chunked
#: instance
SGD_REG_COLS = 512
#: rows a warp of the register instance takes at least before the grid
#: grows (up to the blocks the card holds at once): its double-buffered
#: loads need a run to fill
SGD_WARP_ROWS = 16
#: columns of the row tile a chunked block stages at once; wider rows are
#: staged in chunks of this many. A multiple of the kernel's 256 threads, so
#: a column keeps its thread across chunks
SGD_CHUNK_COLS = 512
#: floats of x a chunked block stages at once (32 KB), so that about six
#: blocks share an SM: the fastest tiles from d = 100 to 2,000 on an H100
#: (scripts/port_sgd_layout_sweep.py, PERF.md)
SGD_TILE_FLOATS = 8192
#: window rows of a chunked tile at most
SGD_MAX_ROWS = 64


def _sgd_layout(d: int) -> Tuple[int, int, int]:
    """``(rows, dc, smem_bytes)`` of a chunked :func:`sgd_batch_terms`
    block at feature width ``d``: ``dc`` columns staged at once (d itself up
    to :data:`SGD_CHUNK_COLS`) of ``rows`` rows, the power of two that
    brings the staged floats nearest :data:`SGD_TILE_FLOATS` from below (16
    to 64 rows). The sizes are the ones the layout comment in
    ``sgd_kernels.cu`` lists: a ``rows`` × ``dc`` x chunk, the same columns
    of the coefficients and three ``rows`` vectors of per-row terms."""
    dc = min(d, SGD_CHUNK_COLS)
    rows = min(SGD_MAX_ROWS, 1 << ((SGD_TILE_FLOATS // dc).bit_length() - 1))
    return rows, dc, 4 * (rows * dc + dc + 3 * rows)


def _sgd_width_class(d: int) -> int:
    """V, the float4s of a row a lane of the register instance holds
    (⌈d / 128⌉), or 0 for rows wider than :data:`SGD_REG_COLS`, which the
    chunked instance takes."""
    return -(-d // 128) if d <= SGD_REG_COLS else 0


class SgdPlan(NamedTuple):
    """How :func:`sgd_batch_terms` launches stage 1 (the C entry checks it):
    ``instance`` "registers" (``sgd_rows_kernel<loss, v, vec4>``, d ≤
    :data:`SGD_REG_COLS`: each warp a contiguous run of rows, one row in
    registers) or "chunked" (``sgd_terms_kernel<loss>``: each block
    ``tiles_per_block`` tiles of ``rows`` rows, staged ``dc`` columns at a
    time in ``smem`` bytes); ``blocks`` of the grid, of the ``resident``
    the card holds at once; ``vec4`` where rows are read as float4s."""
    instance: str
    v: int
    vec4: int
    blocks: int
    resident: int
    rows: int
    dc: int
    smem: int
    tiles_per_block: int


def _sgd_plan(lb: int, d: int, resident: int, vec4: int = 0) -> SgdPlan:
    """The launch of :func:`sgd_batch_terms` for a window of ``lb`` ≥ 1 rows
    of width ``d`` on a card that holds ``resident`` blocks of the instance
    at once. The register instance runs a persistent grid: enough blocks
    that every warp has :data:`SGD_WARP_ROWS` rows, up to ``resident``
    (lb = 100,000 fills the card: about 30 rows a warp on an H100). The
    chunked one cuts the window into tiles, at most ``resident`` blocks of
    them, and no block without rows."""
    v = _sgd_width_class(d)
    if v:
        blocks = max(1, min(resident, -(-lb // (SGD_WARPS * SGD_WARP_ROWS))))
        return SgdPlan("registers", v, vec4, blocks, resident, 0, 0, 0, 0)
    rows, dc, smem = _sgd_layout(d)
    ntiles = -(-lb // rows)
    tiles_per_block = -(-ntiles // min(ntiles, resident))
    return SgdPlan("chunked", 0, vec4, -(-ntiles // tiles_per_block), resident,
                   rows, dc, smem, tiles_per_block)


def sgd_runs(plan: SgdPlan, lb: int) -> list:
    """The window rows ``(r0, r1)`` each worker of a plan's stage 1 takes,
    in order: every warp of the register instance (``sgd_rows_kernel``: W
    warps in all, warp g the ⌊lb / W⌋ rows from g·⌊lb / W⌋ + min(g, lb mod
    W), one more for the first lb mod W warps), or every block of the
    chunked one (``tiles_per_block`` contiguous tiles, the last ragged)."""
    if plan.instance == "registers":
        warps = plan.blocks * SGD_WARPS
        q, rem = divmod(lb, warps)
        return [(g * q + min(g, rem), g * q + min(g, rem) + q + (g < rem))
                for g in range(warps)]
    span = plan.tiles_per_block * plan.rows
    return [(b * span, min(lb, (b + 1) * span)) for b in range(plan.blocks)]


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
#: longer lists take the wide instance
KNN_KCAPS = (16, 32)


class KnnPlan(NamedTuple):
    """How :func:`knn_topk_indices` launches: ``route`` "tiled"
    (``knn_tile_kernel<kcap>``, then ``knn_merge_kernel`` when ``splits``
    > 1) or "wide" (``knn_topk_wide_kernel``, k > 32); the train set
    transposed to (``dpad``, ``ntp``), ``tiles`` train tiles cut into
    ``splits`` contiguous ranges; the scratch the wrapper allocates, in
    bytes. The kernel sizes its own shared memory (``knn_tile_smem_bytes``
    of ``knn_kernels.cu``)."""
    route: str
    kcap: int
    dpad: int
    ntp: int
    tiles: int
    splits: int
    scratch_bytes: int


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


def _knn_plan(n: int, nt: int, d: int, k: int, resident: int) -> KnnPlan:
    """The launch of :func:`knn_topk_indices` for ``k`` neighbours among
    ``nt`` train rows of ``n`` test rows of width ``d``, on a card that
    holds ``resident`` tiled blocks at once (132 on an H100: one block per
    SM, bound by registers).

    Lists up to 32 long take the tiled kernel, any d. Its blocks are (test
    tile, train split), the splits chosen by :func:`_knn_splits`: the
    10,000,000-row benchmark and a 16,384-row block (128 test tiles) take
    S = 1, 1,000 rows S = 33 on an H100. With S > 1 each split writes its
    (n, k) distances and indices to a scratch of 8·S·n·k bytes that the
    merge stage reads. Longer lists take the wide instance, whose (k, n)
    list scratch is 8·k·n bytes."""
    if k > KNN_KCAPS[-1]:  # its shared memory is the kernel's own affair
        return KnnPlan("wide", 0, d, nt, 0, 1, 8 * k * n)
    kcap = next(c for c in KNN_KCAPS if k <= c)
    dpad = -(-d // KNN_CHUNK_COLS) * KNN_CHUNK_COLS
    tiles = -(-nt // KNN_TILE_ROWS)
    splits = _knn_splits(-(-n // KNN_TILE_ROWS), tiles, resident)
    scratch = 8 * splits * n * k if splits > 1 else 0
    return KnnPlan("tiled", kcap, dpad, tiles * KNN_TILE_ROWS, tiles, splits,
                   scratch)


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
    ``flink_ml_tpu/ops/pallas_kernels.py``; no host padding is needed.
    """
    _check_points("assign_nearest", x, centroids)
    if not _is_cuda(x):
        return assign_nearest_plain(x, centroids)
    if x.shape[0] == 0:
        return torch.empty(0, dtype=torch.int32, device=x.device)
    out = _launch_assign(x, centroids)
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
    Replaces ``lloyd_partial_sums`` of ``flink_ml_tpu/ops/pallas_kernels.py``.
    """
    _check_points("lloyd_partial_sums", x, centroids, v)
    if not _is_cuda(x):
        return lloyd_partial_sums_plain(x, v, centroids)
    k, d = centroids.shape
    if x.shape[0] == 0:
        return torch.zeros((k, d + 1), dtype=torch.float32, device=x.device)
    partials = _launch_lloyd_partials(x, v, centroids)
    launch_counts["lloyd_partial_sums"] += 1
    if _tracer.current() is not None:
        _capture_cost("lloyd_partial_sums", n=x.shape[0], k=k, d=d)
    return reduce_partials(partials)


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
    },
    SGD_SOURCE: {
        "sgd_error_string": ([_I], ctypes.c_char_p),
        "sgd_blocks_per_sm": ([_I, _I, _I, _I, _I, ctypes.POINTER(_I)], _I),
        "sgd_batch_terms": ([_P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _I, _I,
                             _I, _I, _I, _L, _I, _I, _P], _I),
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
        "knn_topk_wide": ([_P, _P, _P, _P, _P, _L, _L, _I, _I, _P], _I),
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
                         smem: int) -> int:
    """Blocks of an sgd stage-1 instance the card holds at once: the
    register instance ``v`` (sized for its widest rows, 128·v columns) or
    the chunked one (v = 0) at ``smem`` bytes. The query also lets the
    instance use its dynamic shared memory, once per process."""
    per_sm = ctypes.c_int(0)
    _raise_on_error(SGD_SOURCE, _lib(SGD_SOURCE).sgd_blocks_per_sm(
        loss, v, vec4, 128 * v or 1, smem, ctypes.byref(per_sm)),
        "occupancy query")
    return _blocks_on_card(device_index, per_sm.value,
                           f"sgd stage 1 (v={v}, {smem} bytes)")


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
    layout = _layout(k, d, lloyd)
    if layout is None:
        raise ValueError(f"{what}: no tile for k={k}, d={d} fits a block's "
                         "shared memory; check the shape gate first")
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
    v = _sgd_width_class(d)
    resident = _sgd_resident_blocks(device_index, loss, v, vec4,
                                    0 if v else _sgd_layout(d)[2])
    return _sgd_plan(lb, d, resident, vec4)


def _sgd_card_plan(xl: torch.Tensor, lb: int, loss_name: str) -> SgdPlan:
    """:func:`_sgd_plan` for ``xl``'s card and alignment."""
    d = xl.shape[1]
    return _sgd_plan_on(_device_index(xl), SGD_LOSSES[loss_name], d, lb,
                        int(d % 4 == 0 and xl.data_ptr() % 16 == 0))


def _launch_sgd_terms(xl: torch.Tensor, yl: torch.Tensor, wl: torch.Tensor,
                      coeffs: torch.Tensor, start: int, clip: int, lb: int,
                      loss_name: str, combine: bool = True) -> torch.Tensor:
    """One C call: the (blocks + 1, d + 2) workspace, stage 1's per-block
    partials in its first rows and (where ``combine``, else left unwritten)
    their fixed-order sum in the last."""
    d = xl.shape[1]
    with _on_card(xl):
        plan = _sgd_card_plan(xl, lb, loss_name)
        ws = torch.empty((plan.blocks + 1, d + 2), dtype=torch.float32,
                         device=xl.device)
        _raise_on_error(SGD_SOURCE, _lib(SGD_SOURCE).sgd_batch_terms(
            xl.data_ptr(), yl.data_ptr(), wl.data_ptr(), coeffs.data_ptr(),
            ws.data_ptr(), start, lb, clip, d, plan.v, plan.vec4, plan.blocks,
            plan.rows, plan.dc, plan.smem, plan.tiles_per_block,
            SGD_LOSSES[loss_name], int(combine), _stream(xl)),
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
    """Blocks of the tiled KNN kernel the whole card holds at once."""
    per_sm = ctypes.c_int(0)
    _raise_on_error(KNN_SOURCE, _lib(KNN_SOURCE).knn_tile_blocks_per_sm(
        kcap, dpad, ctypes.byref(per_sm)), "occupancy query")
    return _blocks_on_card(device_index, per_sm.value,
                           f"knn_tile_kernel<{kcap}> at dpad={dpad}")


def knn_tile_smem_bytes(dpad: int) -> int:
    """Shared memory of a tiled KNN block at padded width ``dpad``, as the
    kernel sizes it (CUDA only: it asks the built library)."""
    return _lib(KNN_SOURCE).knn_tile_smem_bytes(dpad)


def _knn_card_plan(x: torch.Tensor, nt: int, k: int) -> KnnPlan:
    """:func:`_knn_plan` for this card."""
    n, d = x.shape
    plan = _knn_plan(n, nt, d, k, 1)
    if plan.route == "wide":
        return plan
    resident = _knn_resident_blocks(_device_index(x), plan.kcap, plan.dpad)
    return _knn_plan(n, nt, d, k, resident)


def _launch_knn(x: torch.Tensor, train: torch.Tensor, k: int,
                splits: Optional[int] = None) -> torch.Tensor:
    """Launches the KNN kernels as :func:`_knn_plan` says; ``splits``
    overrides the plan's train split (1 to its train tiles), which the card
    check uses to hold split and unsplit runs against each other."""
    n, d = x.shape
    nt = train.shape[0]
    with _on_card(x):
        plan = _knn_card_plan(x, nt, k)
        tsq = torch.sum(train * train, dim=1)
        out = torch.empty((n, k), dtype=torch.int32, device=x.device)
        stream = _stream(x)
        lib = _lib(KNN_SOURCE)
        if plan.route == "wide":
            # the wide instance's top-k lists: (k, n) distances and indices
            scratch = torch.empty((2, k, n), dtype=torch.float32,
                                  device=x.device)
            _raise_on_error(KNN_SOURCE, lib.knn_topk_wide(
                x.data_ptr(), train.data_ptr(), tsq.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), n, nt, d, k, stream), "knn_topk_indices")
            return out
        if splits is not None:
            if not 1 <= splits <= plan.tiles:
                raise ValueError(f"knn_topk_indices: splits={splits} outside "
                                 f"[1, {plan.tiles}]")
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
                               device=x.device) if plan.splits > 1 else None)
        _raise_on_error(KNN_SOURCE, lib.knn_topk_tiled(
            x.data_ptr(), train_t.data_ptr(), tsq_p.data_ptr(), out.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), n, d, plan.dpad,
            plan.ntp, k, plan.kcap, plan.splits, stream),
            "knn_topk_indices")
    return out
