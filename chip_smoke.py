#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``flink_ml_tpu_torch``).

Run from the repository root on a machine with one CUDA card (Hopper):

    python3 chip_smoke.py

Phases, each of which fails the run (no result line, nonzero exit):

1. build the port's CUDA kernels from ``flink_ml_tpu_torch/csrc/`` with nvcc
   (one process per source, all at once) and print the card's name and
   power limit;
2. hold every KMeans kernel against its plain PyTorch version on the card,
   at the main-path shape (1,000,000 x 100, k = 10), a ragged n, n = 0,
   zero-weight rows, a wide k that makes the kernels stage centroids in
   chunks, and an odd width; reruns must be bit-identical; time kernel,
   plain version and a one-call PyTorch yardstick, and Lloyd's first stage
   alone, eagerly and as device time (``stage1_device_ms`` of its row in
   the kernels line); then hold
   ``reduce_partials`` bit for bit against its plain version at four
   partials shapes (Lloyd's, made by its path's first stage, and, from
   seeded tensors, SGD's (blocks, 102) and the (1024, 100, 2) and (25,
   131072, 1) shapes the segment sums gave it, the shapes of the second
   stages that SGD and the segment sums since took into their own C
   entries) and time it and
   ``torch.sum`` there, eagerly (what a fit's loop pays, host enqueue
   included) and as device times (calls captured in a CUDA graph and
   replayed: the host takes longer to enqueue one call than the card to run
   it);
3. the same for the SGD kernel, for each loss: the main-path window (the
   first 100,000 rows of a 10,000,000 x 100 table), a window in the middle,
   the clipped window at the end, a ragged window, a one-row window,
   zero-weight rows, an odd width, rows so wide that the kernel stages
   them in column chunks (d = 1,500, and an odd d = 6,001), and margins
   that overflow exp for the logistic loss, printing each case's launch
   plan (register or chunked instance, grid); the C entry's output must
   equal ``reduce_partials_plain`` of the partials the same call wrote, bit
   for bit; time the whole call and its first stage alone, eagerly and as
   device times (``device_ms``, ``stage1_device_ms`` and
   ``library_device_ms`` of its row in the kernels line); the timed calls
   move their window on by lb each call, so none finds its rows in L2;
4. drive the KMeans main path as a user would: the benchmark runner on
   ``flink_ml_tpu/benchmark/configs/kmeans-benchmark.json`` (KMeans fit at
   full size), then transform of the same table, save, load and transform
   again; hold the fit against a plain PyTorch fit on the card and a small
   fit against the CPU;
5. drive the linear-model main path: the runner on
   ``logisticregression-benchmark.json`` at full size (10,000,000 x 100,
   20 rounds of 100,000 rows), one run each of ``linearsvc-benchmark.json``
   and ``linearregression-benchmark.json``, then LR transform of the same
   table, save, load and transform again; hold the LR fit against a plain
   PyTorch fit on the card, and small fits of all three models against the
   CPU;
6. hold the KNN kernels against their plain version on the card, printing
   each case's launch plan and the tiled kernel's blocks per SM: a ragged
   n, a ragged n_train, k > n_train, k = 1, duplicate train rows, n = 0, an
   odd d, d = 64, d = 128 with k = 32, d = 256 and an odd d = 769 (x
   streamed in chunks), and the wide instance (k > 32): k = 50 and k = 300,
   k > n_train and duplicate train rows; then the train split: 1,000 and
   16,384 rows against 50,000 train rows (the 16,384 block also forced to 2
   and 3 splits), duplicate train rows on both sides of a split boundary,
   and k larger than a split's rows; reruns must be bit-identical, and a
   split run identical to the same rows in one split; time kernel, plain
   version and the library's ``torch.topk(torch.addmm(...))`` on a 16,384
   x 50,000 x 32 block, the wide instance on the same block (k = 33), and
   the kernel a few times at the main path's 10,000,000 rows;
7. the same for the segment-sum kernels: 1-D and 2-D values, -1 and
   out-of-range ids, n = 0, a ragged n, one chunk, hashed 2^18 domains
   (c = 1 and c = 2), a domain of more than 65,535 segment tiles, values of
   5,000 columns (column groups), and the sparse FTRL path's shapes: the
   per-row dots as the path packs them (1,000,000 ascending row ids, ten
   a row, then 48,576 padding slots with id 0 and value 0), the same over
   sorted random row ids without padding, and the per-coordinate gradient
   and weight sums; timed eagerly and as device times (a replayed CUDA
   graph) against ``index_add_`` at the gradient shape (n = 1,048,576, c =
   2, u = 100) and at both dots layouts (u = 131,072), with their byte
   bounds, and as device times on the hashed domains;
8. drive the KNN main path: the runner on ``knn-benchmark.json`` at full
   size (10,000,000 x 32 against 50,000 train rows, k = 10), then transform
   of the same table, save, load and transform again; hold 113,333 of its
   predictions (first, middle and ragged last rows) against the plain
   version's neighbours, and small models on the card against the CPU (one
   of them 300 wide with k = 40, through the wide instance);
9. drive the FTRL main path: the runner on
   ``onlinelogisticregression-benchmark.json`` at full size (10,000,000 x
   100, 100 dense batches), then a sparse stream of the same widths and
   params (2,000,000 rows, 10 stored values each, 20 batches) through the
   device CSR engine; hold the sparse fit against a rerun (identical bits)
   and the float64 host engine, a sparse fit over a hashed 2^18 domain
   against the host engine, the dense engine on hyperplane labels over
   the full table against the CPU, transform, save and load, and small
   dense fits on the card against the CPU;
10. drive the iteration runtime's modes on the LR and KMeans configs at
    full size (phases 5 and 4's tables): K-round segments between
    checkpoints (K = 5 for LR, 3 for KMeans; a timed CheckpointManager in a
    temporary directory), host rounds with a listener that records the
    epochs, and a supervised fit (``set_retry_policy(RetryPolicy(
    backoff_s=0))``) under ``faults.chaos(at={"epoch-boundary": [2]})``,
    which fails at its second boundary and resumes from the first one's
    checkpoint; each fit must equal the all-device fit of the same table
    bit for bit (KMeans transform too), each segment boundary must cost one
    ``read_boundary`` fetch, and the chaos run one restart; print each
    mode's fit ms beside the all-device fit's, the boundaries and fetches,
    the checkpoint save and restore ms and bytes, and, on one more segment
    fit, the host-clock split of its boundaries (fetch, save with its
    fsyncs, npz write and gc, restore, clear, the rest); then phase 9's
    sparse FTRL stream with a checkpoint every 5 batches, clean and with a
    fault at its third save resumed from the second on the rest of the
    stream, both equal to the stream without checkpoints bit for bit
    (coefficients, version, history) and launching the segment kernel;
11. drive the data-parallel layer (``flink_ml_tpu_torch/parallel/``) at
    full size: the LR config (10,000,000 x 100, global batch 100,000, 20
    rounds) with no mesh, on one shard (bit for bit the fit with no mesh,
    20 launches) and on eight virtual shards of the card with the
    replicated and the sharded update (each 8 x 20 ``sgd_batch_terms``
    launches, 12,500 rows a shard; sharded against replicated rtol 1e-5;
    the eight-shard fit against its plain rounds); the eight-shard fit in
    segments of K = 5 with a fault at the second boundary, resumed by the
    supervisor, bit for bit the all-device fit (replicated sgd, and
    sharded adam, whose moments are sharded checkpoint leaves); the same
    fit through torch.distributed (NCCL at world size 1), bit for bit the
    one-shard fit; the KMeans config on one and eight shards (8 x 10 Lloyd
    launches; eight against one shard within the main path's KMeans
    tolerance, below); phase 9's dense FTRL table on hyperplane labels and
    its sparse stream on one and eight shards (the segment kernel on every
    shard; eight against one within BIG_FIT_RTOL/ATOL); and a 4,003 x 20 LR
    table with a global batch of 801 (uneven local batches, a padded last
    shard) on eight shards, on the card against the CPU; print each fit's
    ms on one shard against eight, and the launches;
12. observability on the card (``flink_ml_tpu_torch/observability/``): the
    LR and KMeans configs at full size (phase 10's tables) in segment fits
    (K = 5 and 3), supervised, with a fault at the second boundary, with
    tracing and health armed (``FLINK_ML_TPU_TRACE_DIR`` and
    ``FLINK_ML_TPU_HEALTH=1``): the trace must nest fit → segment →
    ``checkpoint.save``, hold one resumed ``checkpoint.restore`` and one
    ``supervisor.restart``, count ``boundaryFetches`` equal to
    ``boundaries`` and 20 and 10 ``rounds``, and record a finite health
    series over every round of the resumed attempt (the ``epochs`` gauge at
    20 and 10); each model must equal the same fit unarmed bit for bit.
    Then one profiled LR fit, one profiled KMeans fit and one profiled
    KMeans transform (``FLINK_ML_TPU_PROFILE_CAPTURE=1``, each into its own
    trace dir): each ``profile.json`` must read ``source: "device"``, with
    device rows for ``sgd_batch_terms``, ``lloyd_partial_sums``,
    ``reduce_partials`` and ``assign_nearest``, and every roofline share
    of the efficiency report at most 100%. Prints the profiled device ms
    per launch, the shares, the kernel builds phase 1 recorded, and the
    armed and unarmed fit ms (host clock, best of two);
13. print one ``{"kernels": [...]}`` line with every kernel's launches in
    its main-path runs, error, times and bound, then the result line.

Tolerances (float32 throughout, TF32 off):
- labels: identical, except rows whose two nearest centroids are closer than
  TIE_RTOL (relative, in float64) — summation order decides those;
- partial sums (Lloyd and SGD): |kernel - plain| <= SUM_RTOL * |plain| +
  SUM_ATOL: sums over up to 1e5 rows of float32 terms, added in another
  order (per block, then across blocks) than the plain version adds them;
  counts exact wherever the labels agree;
- the KMeans main-path fit: centroids within CENTROID_ATOL of the plain
  fit's, and at least LABEL_AGREEMENT of its labels equal to the plain
  fit's. The benchmark's rows are uniform in [0, 1)^100 and have no cluster
  structure, so many rows sit near a boundary between clusters: the
  centroid drift that summation order causes over 10 rounds (about 3e-4)
  moves some tenths of a percent of the labels. The transform itself is
  held exactly (up to ties) against the plain assignment on the same
  centroids;
- the LR main-path fit: coefficients within COEFF_RTOL * |plain| +
  COEFF_ATOL of the plain fit's on the same table, and the final loss
  within COEFF_RTOL: 20 rounds whose gradient sums differ by float32
  reassociation only;
- small linear and FTRL fits on the card against the CPU: coefficients
  rtol SMALL_RTOL, atol SMALL_ATOL (a few hundred rows, sums in another
  order);
- KNN neighbours: identical, except rows where the two lists differ, and
  there, position by position, the float64 distances of the two train rows
  are within TIE_RTOL (relative): a swap at the k-th place or inside the
  list, which summation order decides. ``max_abs_err`` of the kernels line
  is the largest such float64 distance gap. Predictions equal the vote of
  the kernel's neighbours exactly, and differ from the plain vote only on
  such rows; small models predict identically on the card and the CPU;
- segment sums: within SUM_RTOL/SUM_ATOL of the plain version (float32
  sums of up to a million terms in another order; the plain version sums
  in float64);
- the sparse FTRL fit: identical coefficients on a rerun, and within
  CSR_RTOL/CSR_ATOL of the float64 host engine (the JAX package's own bound
  for its device-CSR engine, tests/test_sparse_training.py); its model
  scores its own stream above 85% accurate;
- the full-size dense FTRL fit on hyperplane labels: within BIG_FIT_RTOL,
  BIG_FIT_ATOL of the CPU's (100 batches whose 100,000-row sums are added
  in another order);
- phase 11: a fit on eight shards differs from the one-shard fit only in
  the order its sums are added (per shard, then across the shards), so
  it is held as the fits that add in another order are: the KMeans fit
  by CENTROID_ATOL and LABEL_AGREEMENT (the labels of both fits' centroids
  under the plain assignment), the FTRL fits by BIG_FIT_RTOL/ATOL; the LR
  fit on eight shards takes other batches than on one (each shard its
  own local batch), so it is held against its own plain rounds by
  COEFF_RTOL/ATOL; the sharded update against the replicated one by rtol
  1e-5 (virtual shards add in the same order, so both are expected bit
  for bit, and the line says whether they were).
"""

import itertools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CONFIGS = REPO / "flink_ml_tpu" / "benchmark" / "configs"
CONFIG = CONFIGS / "kmeans-benchmark.json"
LINEAR_CONFIGS = {
    "logisticregression": CONFIGS / "logisticregression-benchmark.json",
    "linearsvc": CONFIGS / "linearsvc-benchmark.json",
    "linearregression": CONFIGS / "linearregression-benchmark.json",
}
KNN_CONFIG = CONFIGS / "knn-benchmark.json"
FTRL_CONFIG = CONFIGS / "onlinelogisticregression-benchmark.json"
# each path's own kernels; reduce_partials is Lloyd's second stage alone
# (SGD and the segment sums launch their own from their C entries)
PATH_KERNELS = {
    "kmeans": ("assign_nearest", "lloyd_partial_sums", "reduce_partials"),
    "linear": ("sgd_batch_terms",),
    "knn": ("knn_topk_indices",),
    "ftrl": ("segment_reduce_sum",),
    # the LR and KMeans fits in the iteration runtime's modes, KMeans
    # transform after each, and FTRL's sparse stream with a checkpoint
    # interval
    "iteration": ("sgd_batch_terms", "assign_nearest", "lloyd_partial_sums",
                  "reduce_partials", "segment_reduce_sum"),
    # the LR, KMeans and FTRL fits on one and eight shards: a launch per
    # shard, and reduce_partials for the cross-shard sums
    "parallel": ("sgd_batch_terms", "lloyd_partial_sums", "reduce_partials",
                 "segment_reduce_sum"),
    # the traced, health-armed and profiled LR and KMeans fits, and a
    # profiled KMeans transform
    "observability": ("sgd_batch_terms", "assign_nearest",
                      "lloyd_partial_sums", "reduce_partials"),
}
LOSSES = ("logistic", "hinge", "least_square")

TIE_RTOL = 1e-5
SUM_RTOL, SUM_ATOL = 1e-4, 1e-3
CENTROID_ATOL = 1e-3
LABEL_AGREEMENT = 0.99
COEFF_RTOL, COEFF_ATOL = 1e-4, 1e-6
SMALL_RTOL, SMALL_ATOL = 1e-5, 1e-6
CSR_RTOL, CSR_ATOL = 1e-3, 1e-5
BIG_FIT_RTOL, BIG_FIT_ATOL = 1e-4, 1e-5

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W): device
# memory bytes per second and fp32 (non-tensor-core) operations per second
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def log(*parts):
    print(*parts, flush=True)


def time_ms(fn, batches=7, per_batch=10, warmup=3):
    """Median per-call device time over batches of back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def graph_ms(fn, reps=20):
    """Device time per call of a short kernel: ``reps`` calls captured in a
    CUDA graph and replayed, so that the host's enqueue time does not hide
    the card's."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, batches=5, per_batch=5, warmup=1) / reps


def rolling_starts(n, lb):
    """A function giving window starts that move on by lb at every call and
    wrap at the end of n rows: a timed call reads rows that the calls just
    before it did not leave in L2, as every round of a fit does."""
    starts = itertools.cycle(range(0, n - lb + 1, lb))
    return lambda: next(starts)


def bound_ms(nbytes, ops):
    """The least time the card could take for work of ``nbytes`` bytes and
    ``ops`` fp32 operations (``ops/kernels.py`` ``launch_cost`` counts
    both), and which of the two bounds it."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FP32_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def tie_rows_ok(x, c, got, want):
    """Rows where two label vectors differ must be near ties."""
    rows = torch.nonzero(got != want).flatten()
    if rows.numel() == 0:
        return 0
    xd, cd = x[rows].double(), c.double()
    d_got = ((xd - cd[got[rows].long()]) ** 2).sum(1)
    d_want = ((xd - cd[want[rows].long()]) ** 2).sum(1)
    gap = (d_got - d_want).abs() / torch.maximum(d_got, d_want).clamp_min(1e-30)
    worst = float(gap.max())
    assert worst <= TIE_RTOL, (
        f"{rows.numel()} labels differ and not at ties: relative gap {worst}")
    return rows.numel()


def check_assign(K, x, c, tag):
    got = K.assign_nearest(x, c)
    want = K.assign_nearest_plain(x, c)
    assert got.dtype == torch.int32 and got.shape == (x.shape[0],), tag
    assert torch.equal(got, K.assign_nearest(x, c)), f"{tag}: rerun differs"
    ties = tie_rows_ok(x, c, got, want)
    log(f"  assign_nearest {tag}: n={x.shape[0]} d={x.shape[1]} "
        f"k={c.shape[0]} tie-flips={ties}")
    return got, want


def check_lloyd(K, x, v, c, tag):
    got = K.lloyd_partial_sums(x, v, c)
    want = K.lloyd_partial_sums_plain(x, v, c)
    assert got.shape == (c.shape[0], c.shape[1] + 1), tag
    assert torch.equal(got, K.lloyd_partial_sums(x, v, c)), (
        f"{tag}: rerun not bit-identical")
    excess = ((got - want).abs() - SUM_RTOL * want.abs() - SUM_ATOL).max()
    ties = 0
    if x.shape[0]:
        ties = tie_rows_ok(x, c, K.assign_nearest(x, c),
                           K.assign_nearest_plain(x, c))
    if ties == 0:
        assert torch.equal(got[:, -1], want[:, -1]), f"{tag}: counts differ"
    else:
        assert float((got[:, -1] - want[:, -1]).abs().sum()) <= 2 * ties, tag
    assert float(excess) <= 0, f"{tag}: sums off by {float(excess)} over tolerance"
    log(f"  lloyd_partial_sums {tag}: n={x.shape[0]} d={x.shape[1]} "
        f"k={c.shape[0]} max|err|={float((got - want).abs().max()):.3g} "
        f"tie-flips={ties}")
    return got, want


def within_sum_tol(got, want, tag):
    excess = float(((got - want).abs() - SUM_RTOL * want.abs() - SUM_ATOL).max())
    assert excess <= 0, f"{tag}: off by {excess} over tolerance"
    return float((got - want).abs().max())


def phase_build(K):
    start = time.perf_counter()
    logs = K.build_kernels()
    log(f"phase 1: built {sorted(logs) or 'cached library'} in "
        f"{time.perf_counter() - start:.1f} s")
    for text in logs.values():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())


def phase_kernels(K):
    log("phase 2: KMeans kernels against their plain versions on the card")
    g = torch.Generator(device="cuda").manual_seed(7)

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    # ragged n, n = 0, zero-weight rows, wide k (chunked centroids), odd d
    for n, d, k, zero_share, tag in [
            (100_003, 100, 10, 0.0, "ragged-n"),
            (0, 100, 10, 0.0, "n=0"),
            (200_000, 100, 10, 0.3, "zero-weights"),
            (50_000, 100, 300, 0.0, "wide-k"),
            (10_007, 7, 5, 0.0, "odd-d")]:
        x, c = rand(n, d), rand(k, d)
        v = (rand(n) >= zero_share).float()
        check_assign(K, x, c, tag)
        got, _ = check_lloyd(K, x, v, c, tag)
        if tag == "wide-k":
            assert K._layout(k, d, False)[1] < k, "wide-k did not chunk (assign)"
            assert K._layout(k, d, True)[1] < k, "wide-k did not chunk (Lloyd)"
        if tag == "zero-weights":
            keep = v > 0
            alone = K.lloyd_partial_sums(x[keep].contiguous(),
                                         torch.ones(int(keep.sum()), device="cuda"), c)
            assert torch.allclose(got, alone, rtol=SUM_RTOL, atol=SUM_ATOL), (
                "zero-weight rows added something")
        if n == 0:
            assert not got.any(), "n=0 must give zeros"

    # the main-path shape: errors, times, bounds
    n, d, k = 1_000_000, 100, 10
    x, c, v = rand(n, d), rand(k, d), torch.ones(n, device="cuda")
    a_got, a_want = check_assign(K, x, c, "main")
    p_got, p_want = check_lloyd(K, x, v, c, "main")
    partials = K._launch_lloyd_partials(x, v, c)
    r_got = K.reduce_partials(partials)
    r_want = K.reduce_partials_plain(partials)
    assert torch.equal(r_got, r_want), "reduce differs from its plain version"
    blocks = partials.shape[0]

    one_hot = torch.nn.functional.one_hot(a_want.long(), k).float() * v[:, None]
    x_aug = torch.cat([x, torch.ones(n, 1, device="cuda")], dim=1)
    rows = {
        "assign_nearest": dict(
            err=float((a_got - a_want).abs().max()),
            kernel=lambda: K.assign_nearest(x, c),
            plain=lambda: K.assign_nearest_plain(x, c),
            # one PyTorch call for the same labels
            library=lambda: torch.cdist(x, c).argmin(1),
            cost=K.launch_cost("assign_nearest", n=n, k=k, d=d)),
        "lloyd_partial_sums": dict(
            err=float((p_got - p_want).abs().max()),
            kernel=lambda: K.lloyd_partial_sums(x, v, c),
            plain=lambda: K.lloyd_partial_sums_plain(x, v, c),
            # the one-hot product alone, given the labels
            library=lambda: torch.matmul(one_hot.T, x_aug),
            cost=K.launch_cost("lloyd_partial_sums", n=n, k=k, d=d)),
    }
    measured = {}
    for name, r in rows.items():
        b_ms, b_by = bound_ms(*r["cost"])
        measured[name] = {
            "max_abs_err": r["err"], "ms": time_ms(r["kernel"]),
            "plain_ms": time_ms(r["plain"]), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": time_ms(r["library"])}
        log(f"  {name} @ 1M x 100, k=10: {measured[name]}")
    stage1 = time_ms(lambda: K._launch_lloyd_partials(x, v, c))
    stage1_device = graph_ms(lambda: K._launch_lloyd_partials(x, v, c))
    measured["lloyd_partial_sums"]["stage1_device_ms"] = stage1_device
    log(f"  lloyd stage 1 alone: {stage1:.4f} ms over {blocks} blocks; "
        f"device {stage1_device:.4f} ms")

    # the second stage at Lloyd's partials shape, made by its path's first
    # stage, and, from seeded tensors, at the shapes of the second stages
    # SGD and the segment sums took into their own C entries (SGD's block
    # partials at the main window; FTRL's gradient and per-row dots
    # partials); device times
    sgd_blocks = K._sgd_card_plan(x, 100_000, "logistic").blocks
    shapes = {
        "Lloyd": partials,
        "SGD": torch.randn(sgd_blocks, d + 2, generator=g, device="cuda"),
        "FTRL gradient": torch.randn(1024, 100, 2, generator=g, device="cuda"),
        "FTRL per-row dots": torch.randn(25, 1 << 17, 1, generator=g,
                                         device="cuda"),
    }
    for tag, p in shapes.items():
        assert torch.equal(K.reduce_partials(p), K.reduce_partials_plain(p)), (
            f"reduce differs from its plain version at {tag}")
        ms = {"eager": time_ms(lambda: K.reduce_partials(p)),
              "eager sum": time_ms(lambda: torch.sum(p, dim=0)),
              "device": graph_ms(lambda: K.reduce_partials(p)),
              "device sum": graph_ms(lambda: torch.sum(p, dim=0))}
        log(f"  reduce_partials @ {tag} {tuple(p.shape)}: eager "
            f"{ms['eager']:.5f} ms against torch.sum {ms['eager sum']:.5f} "
            f"ms; device {ms['device']:.5f} ms against torch.sum "
            f"{ms['device sum']:.5f} ms; bit-identical to the plain version"
            + "".join(f"; {kind} SLOWER than torch.sum"
                      for kind in ("eager", "device")
                      if ms[kind] > ms[f"{kind} sum"]))
        if tag == "Lloyd":
            b_ms, b_by = bound_ms(*K.launch_cost(
                "reduce_partials", blocks=blocks, inner=k * (d + 1)))
            # eager times, as every row of the kernels line has them; the
            # device times of a replayed CUDA graph beside them
            measured["reduce_partials"] = {
                "max_abs_err": float((r_got - r_want).abs().max()),
                "ms": ms["eager"],
                "plain_ms": time_ms(lambda: K.reduce_partials_plain(p)),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": ms["eager sum"], "device_ms": ms["device"],
                "library_device_ms": ms["device sum"]}
    log(f"  reduce_partials @ Lloyd: {measured['reduce_partials']}")
    del shapes
    return measured


def check_sgd(K, x, y, w, c, start, clip, lb, loss, tag):
    got = K.sgd_batch_terms(x, y, w, c, start, clip, lb, loss)
    want = K.sgd_batch_terms_plain(x, y, w, c, start, clip, lb, loss)
    assert got.shape == (x.shape[1] + 2,) and got.dtype == torch.float32, tag
    assert torch.isfinite(got).all(), f"{tag}: non-finite terms"
    assert torch.equal(got, K.sgd_batch_terms(x, y, w, c, start, clip, lb,
                                              loss)), (
        f"{tag}: rerun not bit-identical")
    err = within_sum_tol(got, want, tag)
    plan = K._sgd_card_plan(x, lb, loss)
    log(f"  sgd_batch_terms {loss} {tag}: start={start} clip={clip} lb={lb} "
        f"d={x.shape[1]} max|err|={err:.3g}; {plan.instance} v={plan.v} "
        f"vec4={plan.vec4} grid={plan.blocks} of {plan.resident} resident")
    return got, want, err


def phase_sgd_kernels(K):
    from flink_ml_tpu_torch.ops.losses import LossFunc

    log("phase 3: the SGD kernel against its plain version on the card")
    g = torch.Generator(device="cuda").manual_seed(11)

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    # the main-path table: 10,000,000 x 100, labels in {0, 1}
    n, d, lb = 10_000_000, 100, 100_000
    x = rand(n, d)
    y = torch.floor(rand(n) * 2)
    w = rand(n)
    c = rand(d) - 0.5
    main_err = 0.0
    for loss in LOSSES:
        for start, clip, this_lb, tag in [
                (0, 0, lb, "main"),
                (n // 2 - 37, 0, lb, "middle"),
                (n - lb, 41_234, lb, "end-clipped"),
                (17, 0, lb + 3, "ragged-lb"),
                (123_457, 0, 1, "lb=1")]:
            _, _, err = check_sgd(K, x, y, w, c, start, clip, this_lb, loss, tag)
            if tag == "main":
                main_err = max(main_err, err)
        # zero-weight rows add nothing: the same sums as the kept rows alone
        xs, ys = x[:200_000], y[:200_000]
        ws = w[:200_000] * (rand(200_000) >= 0.3).float()
        got, _, _ = check_sgd(K, xs, ys, ws, c, 0, 0, 200_000, loss,
                              "zero-weights")
        keep = ws > 0
        alone = K.sgd_batch_terms(xs[keep].contiguous(), ys[keep].contiguous(),
                                  ws[keep].contiguous(), c, 0, 0,
                                  int(keep.sum()), loss)
        within_sum_tol(got, alone, "zero-weights against the kept rows")
        # an odd width, and rows so wide that the kernel stages them in
        # column chunks (one aligned, one odd with a ragged last chunk)
        for dd, rows, tag in [(7, 10_007, "odd-d"), (1_500, 5_000, "chunked-d"),
                              (6_001, 3_000, "chunked-odd-d")]:
            xd = rand(rows, dd)
            cd = (rand(dd) - 0.5) / dd ** 0.5
            check_sgd(K, xd, y[:rows].contiguous(), w[:rows].contiguous(), cd,
                      5, 3, rows - 9, loss, tag)
            wide_row = dd > K.SGD_REG_COLS
            assert K._sgd_card_plan(xd, rows - 9, loss).instance == (
                "chunked" if wide_row else "registers"), tag
    # margins far past exp's float32 range: the multipliers must come out
    # as +-0 or +-w, and the loss finite
    big = c * 1000
    got, want, _ = check_sgd(K, x, y, w, big, 0, 0, lb, "logistic", "overflow")

    # the C entry's second stage against the plain order of its own
    # partials, for every loss
    for loss in LOSSES:
        ws = K._launch_sgd_terms(x, y, w, c, 0, 0, lb, loss)
        assert torch.equal(ws[-1], K.reduce_partials_plain(ws[:-1])), (
            f"{loss}: the combine differs from reduce_partials_plain")
    blocks = ws.shape[0] - 1
    log(f"  sgd combine of ({blocks}, {d + 2}) partials: bit-identical to "
        "reduce_partials_plain for every loss")
    loss = "logistic"

    # times and bounds at the main-path window size, logistic instance; each
    # timed call takes the next window of the table (cold in L2)
    mult = LossFunc.by_name(loss).terms(x @ c, y, w)[1]
    kernel_start, plain_start, library_start = (rolling_starts(n, lb)
                                                for _ in range(3))

    def library():
        s = library_start()
        # the gradient matvec alone, given the multipliers
        return torch.mv(x[s:s + lb].T, mult[s:s + lb])

    rows = {
        "sgd_batch_terms": dict(
            err=main_err,
            kernel=lambda: K.sgd_batch_terms(x, y, w, c, kernel_start(), 0, lb,
                                             loss),
            plain=lambda: K.sgd_batch_terms_plain(x, y, w, c, plain_start(),
                                                  0, lb, loss),
            library=library,
            cost=K.launch_cost("sgd_batch_terms", lb=lb, d=d)),
    }
    measured = {}
    for name, r in rows.items():
        b_ms, b_by = bound_ms(*r["cost"])
        measured[name] = {
            "max_abs_err": r["err"], "ms": time_ms(r["kernel"]),
            "plain_ms": time_ms(r["plain"]), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": time_ms(r["library"]),
            "device_ms": graph_ms(r["kernel"]),
            "library_device_ms": graph_ms(r["library"])}
    stage1_start = rolling_starts(n, lb)

    def stage1_call():
        return K._launch_sgd_terms(x, y, w, c, stage1_start(), 0, lb, loss,
                                   combine=False)

    stage1 = time_ms(stage1_call)
    measured["sgd_batch_terms"]["stage1_device_ms"] = graph_ms(stage1_call)
    log(f"  sgd_batch_terms @ lb=100,000 of 10M x 100: "
        f"{measured['sgd_batch_terms']}")
    log(f"  sgd stage 1 alone: {stage1:.4f} ms over {blocks} blocks; device "
        f"{measured['sgd_batch_terms']['stage1_device_ms']:.4f} ms")
    hot = time_ms(lambda: K.sgd_batch_terms(x, y, w, c, 0, 0, lb, loss))
    log(f"  sgd_batch_terms on one window again and again (warm L2): "
        f"{hot:.4f} ms")
    for other in ("hinge", "least_square"):
        other_start = rolling_starts(n, lb)
        log(f"  sgd_batch_terms {other}: " + "%.4f ms" % time_ms(
            lambda: K.sgd_batch_terms(x, y, w, c, other_start(), 0, lb, other)))
    # a wide row: the chunked kernel against its plain version, timed
    wide_d, wide_rows = 2_000, 100_000
    xw = rand(wide_rows, wide_d)
    cw = (rand(wide_d) - 0.5) / wide_d ** 0.5
    yw, ww = y[:wide_rows].contiguous(), w[:wide_rows].contiguous()
    log(f"  sgd_batch_terms chunked @ {wide_rows} x {wide_d}: "
        + "%.4f ms (plain %.4f ms)" % (
            time_ms(lambda: K.sgd_batch_terms(xw, yw, ww, cw, 0, 0, wide_rows,
                                              loss)),
            time_ms(lambda: K.sgd_batch_terms_plain(xw, yw, ww, cw, 0, 0,
                                                    wide_rows, loss))))
    del x, y, w, mult, ws, xw
    torch.cuda.empty_cache()
    return measured


def phase_main_path(K, runner, kmeans_mod):
    log("phase 4: the KMeans main path through the port's entry points")
    spec = runner.load_config(str(CONFIG))["KMeans"]
    params = spec["stage"]["paramMap"]
    n = spec["inputData"]["paramMap"]["numValues"]
    k, max_iter = params["k"], params["maxIter"]

    K.reset_launch_counts()
    row = runner.best_of("KMeans", spec, runs=2)
    log("  benchmark row:", json.dumps(row, sort_keys=True))
    assert row["executionPath"] == "cuda-lloyd", row["executionPath"]

    table = runner.build_generator(spec).get_data()
    estimator = runner.build_stage(spec)
    model = estimator.fit(table)
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = model.transform(table)[0]
    labels = out[model.prediction_col]
    torch.cuda.synchronize()
    transform_ms = (time.perf_counter() - start) * 1e3
    assert estimator.last_execution_path == "cuda-lloyd"
    assert model.last_execution_path == "cuda-assign"
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = type(model).load(tmp)
        again = loaded.transform(table)[0][loaded.prediction_col]
    assert torch.equal(labels, again), "the loaded model predicts otherwise"
    counts = dict(K.launch_counts)
    log(f"  transform: {transform_ms:.3f} ms for {n} rows; save/load: same labels")
    log(f"  launches in the main-path run: {counts}")

    # is the output right: shapes, finiteness, and the plain fit on the card
    assert labels.dtype == torch.int64 and labels.shape == (n,)
    assert int(labels.min()) >= 0 and int(labels.max()) < k
    x = table.vectors(estimator.features_col)
    fitted = torch.as_tensor(model.centroids, dtype=torch.float32, device="cuda")
    ties = tie_rows_ok(x, fitted, labels, K.assign_nearest_plain(x, fitted).long())
    log(f"  transform against the plain assignment: tie-flips={ties}")
    assert model.centroids.shape == (k, 100) and np.isfinite(model.centroids).all()
    assert model.weights.sum() == n
    centroids = kmeans_mod.initial_centroids(x, k, estimator.get_seed_or_default())
    v = torch.ones(n, device="cuda")
    for _ in range(max_iter):
        centroids, _ = kmeans_mod.lloyd_round(K.lloyd_partial_sums_plain, x, v,
                                              centroids)
    diff = float(np.abs(centroids.cpu().numpy() - model.centroids).max())
    plain_labels = K.assign_nearest_plain(x, centroids).long()
    agree = float((plain_labels == labels).float().mean())
    log(f"  against the plain fit: max|centroid diff|={diff:.3g}, "
        f"label agreement={agree:.6f}")
    assert diff <= CENTROID_ATOL and agree >= LABEL_AGREEMENT

    # small fits give the same model on the card and on the CPU: the blob
    # tables of tests/test_torch_kmeans.py, whose CPU fits match the JAX
    # package's (no row of them sits near a tie)
    Table = type(table)
    for n_small, d_small, k_small, iters in [(300, 8, 3, 5), (250, 16, 4, 10)]:
        rng = np.random.default_rng(n_small + d_small)
        centers = rng.normal(size=(k_small, d_small)) * 10
        small = (centers[rng.integers(0, k_small, n_small)]
                 + rng.normal(size=(n_small, d_small)) * 0.2)
        fits = [kmeans_mod.KMeans(k=k_small, seed=11, max_iter=iters,
                                  device=dev).fit(Table.from_columns(features=small))
                for dev in ("cuda", "cpu")]
        np.testing.assert_allclose(fits[0].centroids, fits[1].centroids,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(fits[0].weights, fits[1].weights)
    log("  small fits: card and CPU agree")

    assert counts["lloyd_partial_sums"] >= max_iter, counts
    assert counts["reduce_partials"] >= max_iter, counts
    assert counts["assign_nearest"] >= 1, counts
    return counts


def _small_linear_table(Table, seed, n, d, regression):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    margin = x @ (rng.normal(size=d) * 2)
    y = margin + 0.1 * rng.normal(size=n) if regression else (margin > 0) * 1.0
    return Table.from_columns(features=x, label=y, weight=rng.random(n) + 0.5)


def phase_linear_main_path(K, runner, optimizer, Table):
    log("phase 5: the linear-model main path through the port's entry points")
    specs = {name: runner.load_config(str(path))[name]
             for name, path in LINEAR_CONFIGS.items()}
    spec = specs["logisticregression"]
    n = spec["inputData"]["paramMap"]["numValues"]
    d = spec["inputData"]["paramMap"]["vectorDim"]
    max_iter = spec["stage"]["paramMap"]["maxIter"]

    K.reset_launch_counts()
    rows = {"logisticregression": runner.best_of("logisticregression", spec,
                                                 runs=2)}
    fits = 3  # warmup + two timed runs
    for name in ("linearsvc", "linearregression"):
        rows[name] = runner.run_benchmark(name, specs[name])
        fits += 1
    for name, row in rows.items():
        log(f"  benchmark row {name}:", json.dumps(row, sort_keys=True))
        assert row["executionPath"] == "cuda-sgd", (name, row["executionPath"])
        assert row["inputRecordNum"] == n and row["outputRecordNum"] == 1

    table = runner.build_generator(spec).get_data()
    estimator = runner.build_stage(spec)
    model = estimator.fit(table)
    fits += 1
    assert estimator.last_execution_path == "cuda-sgd"
    transform_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = model.transform(table)[0]
        torch.cuda.synchronize()
        transform_ms.append((time.perf_counter() - start) * 1e3)
    pred, raw = out[model.prediction_col], out[model.raw_prediction_col]
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = type(model).load(tmp)
        again = loaded.transform(table)[0]
    assert torch.equal(pred, again[loaded.prediction_col]), (
        "the loaded model predicts otherwise")
    assert torch.equal(raw, again[loaded.raw_prediction_col])
    counts = dict(K.launch_counts)
    log(f"  LR transform: {min(transform_ms):.3f} ms (best of 3) for {n} "
        f"rows; save/load: same predictions")
    log(f"  launches in the main-path run: {counts}")

    # is the output right: shapes, finiteness, the plain fit on the card
    assert pred.shape == (n,) and pred.dtype == torch.float32
    assert raw.shape == (n, 2) and bool(torch.isfinite(raw).all())
    assert set(torch.unique(pred).tolist()) <= {0.0, 1.0}
    coeffs = model.coefficients
    assert coeffs.shape == (d,) and np.isfinite(coeffs).all()
    x = table.vectors(estimator.features_col)
    y = table.column(estimator.label_col)
    w = torch.ones(n, device="cuda")
    prm = optimizer.SGDParams(
        learning_rate=estimator.learning_rate,
        global_batch_size=estimator.global_batch_size, max_iter=max_iter,
        tol=estimator.tol, reg=estimator.reg,
        elastic_net=estimator.elastic_net)
    plain, plain_loss, plain_rounds = optimizer.sgd_rounds(
        K.sgd_batch_terms_plain, "logistic", prm, x, y, w,
        torch.zeros(d, device="cuda"))
    kern, kern_loss, kern_rounds = optimizer.sgd_rounds(
        K.sgd_batch_terms, "logistic", prm, x, y, w,
        torch.zeros(d, device="cuda"))
    plain = plain.double().cpu().numpy()
    assert np.array_equal(kern.double().cpu().numpy(), coeffs), (
        "the estimator's fit differs from the same rounds run directly")
    diff = np.abs(coeffs - plain)
    log(f"  against the plain fit: max|coeff diff|={diff.max():.3g} "
        f"(max|coeff|={np.abs(plain).max():.3g}), loss {float(kern_loss):.7g} "
        f"vs {float(plain_loss):.7g}, rounds {int(kern_rounds)}")
    assert np.all(diff <= COEFF_RTOL * np.abs(plain) + COEFF_ATOL)
    assert abs(float(kern_loss) - float(plain_loss)) <= COEFF_RTOL * abs(
        float(plain_loss))
    assert int(kern_rounds) == int(plain_rounds)

    # where a fit's time goes: the rounds alone, on tensors already placed
    torch.cuda.synchronize()
    start = time.perf_counter()
    optimizer.sgd_rounds(K.sgd_batch_terms, "logistic", prm, x, y, w,
                         torch.zeros(d, device="cuda"))
    enqueue_ms = (time.perf_counter() - start) * 1e3
    torch.cuda.synchronize()
    rounds_ms = (time.perf_counter() - start) * 1e3
    log(f"  {max_iter} rounds alone: {rounds_ms:.3f} ms "
        f"({enqueue_ms:.3f} ms of it to enqueue them)")
    del x, y, w, table, out, pred, raw, again
    torch.cuda.empty_cache()

    # small fits give the same model on the card and on the CPU
    from flink_ml_tpu_torch.models import classification, regression
    for i, cls in enumerate((classification.LogisticRegression,
                             classification.LinearSVC,
                             regression.LinearRegression)):
        small = _small_linear_table(Table, 10 + i, 400, 7,
                                    cls.__name__ == "LinearRegression")
        params = dict(max_iter=15, global_batch_size=96, learning_rate=0.05,
                      reg=0.01, elastic_net=0.3, weight_col="weight")
        fitted = {}
        for dev in ("cuda", "cpu"):
            est = cls(device=dev, **params)
            fitted[dev] = est.fit(small).coefficients
            assert est.last_execution_path == (
                "cuda-sgd" if dev == "cuda" else "torch-sgd")
        np.testing.assert_allclose(fitted["cuda"], fitted["cpu"],
                                   rtol=SMALL_RTOL, atol=SMALL_ATOL)
    log("  small fits of the three models: card and CPU agree")

    assert counts["sgd_batch_terms"] >= max_iter * fits, counts
    # one C entry a round launches both stages
    assert counts["reduce_partials"] == 0, counts
    return counts


def knn_tie_check(x, train, got, want, tag):
    """Rows where two (n, k) index lists differ must be near ties: at every
    position the float64 distances of the two train rows are within
    TIE_RTOL (relative). That covers a swap at the k-th place and a swap of
    two neighbours inside the list. Returns (rows that differ, the largest
    absolute float64 distance gap over them)."""
    rows = torch.nonzero((got != want).any(1)).flatten()
    if rows.numel() == 0:
        return 0, 0.0
    xd, td = x[rows].double(), train.double()
    d_got = ((xd[:, None, :] - td[got[rows].long()]) ** 2).sum(-1)
    d_want = ((xd[:, None, :] - td[want[rows].long()]) ** 2).sum(-1)
    gap = (d_got - d_want).abs()
    rel = float((gap / torch.maximum(d_got, d_want).clamp_min(1e-30)).max())
    assert rel <= TIE_RTOL, (
        f"{tag}: {rows.numel()} rows differ and not at ties: relative gap {rel}")
    return rows.numel(), float(gap.max())


def check_knn(K, x, train, k, tag, block=16_384):
    """The kernel against its plain version, block by block (the plain
    version holds a (block, n_train) distance matrix)."""
    got = K.knn_topk_indices(x, train, k)
    kk = min(k, train.shape[0])
    assert got.dtype == torch.int32 and got.shape == (x.shape[0], kk), tag
    assert torch.equal(got, K.knn_topk_indices(x, train, k)), (
        f"{tag}: rerun not bit-identical")
    flips, err = 0, 0.0
    for s in range(0, x.shape[0], block):
        want = K.knn_topk_indices_plain(x[s:s + block], train, k)
        f, e = knn_tie_check(x[s:s + block], train, got[s:s + block], want, tag)
        flips, err = flips + f, max(err, e)
    log(f"  knn_topk_indices {tag}: n={x.shape[0]} n_train={train.shape[0]} "
        f"d={x.shape[1]} k={kk} tie-rows={flips} max|dist gap|={err:.3g}")
    return got, flips, err


def knn_plan_line(K, x, nt, k):
    plan = K._knn_card_plan(x, nt, min(k, nt))
    return plan, (f"{plan.route}" + (
        f" kcap={plan.kcap} dpad={plan.dpad} splits={plan.splits} "
        f"smem={K.knn_tile_smem_bytes(plan.dpad)} B "
        f"scratch={plan.scratch_bytes} B"
        if plan.route == "tiled" else f" scratch={plan.scratch_bytes} B"))


def phase_knn_kernel(K):
    log("phase 6: the KNN kernels against their plain version on the card")
    g = torch.Generator(device="cuda").manual_seed(13)

    def rand(*shape):
        return torch.rand(shape, generator=g, device="cuda")

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kcap in K.KNN_KCAPS:
        for dpad in (32, 128, 256):
            log(f"  knn_tile_kernel<{kcap}> at dpad={dpad}: "
                f"{K._knn_resident_blocks(0, kcap, dpad) // sms} block(s) "
                f"per SM ({K.knn_tile_smem_bytes(dpad)} bytes of shared "
                f"memory)")
    dup = rand(5_000, 32)
    dup[100:200] = dup[4_000:4_100]  # exact ties across train tiles
    dup_wide = rand(5_000, 160)
    dup_wide[100:200] = dup_wide[4_000:4_100]
    for n, train, k, tag in [
            (100_003, rand(5_000, 32), 10, "ragged-n"),
            (20_000, rand(50_001, 32), 10, "ragged-n_train"),
            (3_000, rand(7, 32), 10, "k>n_train"),
            (30_000, rand(20_000, 32), 1, "k=1"),
            (20_000, dup, 10, "duplicates"),
            (0, rand(1_000, 32), 10, "n=0"),
            (10_007, rand(9_999, 7), 10, "odd-d"),
            (4_000, rand(6_000, 64), 17, "d=64"),
            (4_000, rand(6_000, 128), 32, "d=128 k=32"),
            (3_000, rand(6_000, 256), 10, "d=256"),
            (2_000, rand(5_000, 769), 7, "odd d=769"),
            (3_000, rand(6_001, 32), 50, "wide k=50"),
            (1_000, rand(3_000, 200), 300, "wide d=200 k=300"),
            (500, rand(40, 300), 64, "wide k>n_train"),
            (5_000, dup_wide, 40, "wide duplicates"),
    ]:
        x = rand(n, train.shape[1])
        plan, line = knn_plan_line(K, x, train.shape[0], k)
        assert (plan.route == "wide") == tag.startswith("wide"), (tag, line)
        log(f"  plan {tag}: {line}")
        got, _, _ = check_knn(K, x, train, k, tag)
        if tag.endswith("duplicates"):
            # of two identical train rows, the lower index comes first
            rows, pos = torch.nonzero(got == 4_050, as_tuple=True)
            assert rows.numel() and bool((pos > 0).all()), tag
            assert bool((got[rows, pos - 1] == 150).all()), tag

    # the train split: small batches against the main path's train set;
    # a split run must equal the same rows in one split
    nt, d = 50_000, 32
    train = rand(nt, d)
    for n in (1_000, 16_384):
        x = rand(n, d)
        plan, line = knn_plan_line(K, x, nt, 10)
        log(f"  plan {n} x {nt}: {line}")
        got, _, _ = check_knn(K, x, train, 10, f"split n={n}")
        for splits in sorted({1, 2, 3} - {plan.splits}):
            assert torch.equal(got, K._launch_knn(x, train, 10, splits)), (
                f"n={n}: {splits} splits differ from {plan.splits}")
        if n == 1_000:
            assert plan.splits > 1, line
    # duplicate train rows on both sides of a split boundary: test rows
    # next to them take both twins, the lower index first
    x = rand(1_000, d)
    lo = K.knn_split_bounds(nt, K._knn_card_plan(x, nt, 10).splits)[1][0]
    twins = train.clone()
    twins[lo - 50:lo] = twins[lo:lo + 50]
    x[:50] = twins[lo:lo + 50] + 1e-3 * rand(50, d)
    got, _, _ = check_knn(K, x, twins, 10, "duplicates across a split")
    want = torch.stack([torch.arange(lo - 50, lo), torch.arange(lo, lo + 50)],
                       1).to(torch.int32).cuda()
    assert torch.equal(got[:50, :2], want), "twins across a split: order"
    # k larger than a split's rows: 148 train rows are two tiles, the second
    # of 20 rows, and 1,000 test rows split them
    x, small = rand(1_000, d), rand(148, d)
    plan, line = knn_plan_line(K, x, 148, 32)
    log(f"  plan k>split rows: {line}")
    assert plan.splits == 2, line
    check_knn(K, x, small, 32, "k>split rows")

    # times and bounds on a block of test rows the library call can hold,
    # at the main path's widths (50,000 train rows, d = 32, k = 10)
    n, nt, d, k = 16_384, 50_000, 32, 10
    x, train = rand(n, d), rand(nt, d)
    _, _, err = check_knn(K, x, train, k, "timed block")
    tsq = torch.sum(train * train, dim=1)
    b_ms, b_by = bound_ms(*K.launch_cost("knn_topk_indices", n=n, nt=nt, d=d,
                                         k=k))
    measured = {"knn_topk_indices": {
        "max_abs_err": err,
        "ms": time_ms(lambda: K.knn_topk_indices(x, train, k)),
        "plain_ms": time_ms(lambda: K.knn_topk_indices_plain(x, train, k),
                            batches=3, per_batch=3, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by,
        # one PyTorch call's worth: the distance product and torch.topk
        # (no tie order promised)
        "library_ms": time_ms(lambda: torch.topk(
            torch.addmm(tsq, x, train.T, alpha=-2), k, largest=False)),
    }}
    log(f"  knn_topk_indices @ {n} x {nt} x {d}, k={k}: "
        f"{measured['knn_topk_indices']}")
    # the wide instance on the same block: k = 33 is past the tiled lists
    wide_ms = time_ms(lambda: K.knn_topk_indices(x, train, 33), batches=3,
                      per_batch=3, warmup=1)
    log(f"  knn_topk_indices wide instance @ {n} x {nt} x {d}, k=33: "
        f"{wide_ms:.3f} ms")
    # the main path's shape: a few calls, each of them about a second
    big = rand(10_000_000, d)
    main = time_ms(lambda: K.knn_topk_indices(big, train, k), batches=3,
                   per_batch=1, warmup=1)
    main_bound, _ = bound_ms(*K.launch_cost(
        "knn_topk_indices", n=big.shape[0], nt=nt, d=d, k=k))
    log(f"  knn_topk_indices @ 10,000,000 x {nt} x {d}: {main:.3f} ms "
        f"(bound {main_bound:.3f} ms by operations, "
        f"{main_bound / main:.1%} of it)")
    # the split at work: a serving-size batch and the block, planned and
    # forced into another number of splits
    for rows in (1_000, n):
        xs = x[:rows]
        plan = K._knn_card_plan(xs, nt, k)
        for splits in (plan.splits, 1 if plan.splits > 1 else 2):
            log(f"  knn_topk_indices @ {rows} x {nt} x {d}, {splits} "
                f"split(s){' (plan)' if splits == plan.splits else ''}: "
                + "%.4f ms" % time_ms(lambda: K._launch_knn(xs, train, k,
                                                           splits)))
    del big, x, train, dup, dup_wide
    torch.cuda.empty_cache()
    return measured


def check_segment(K, values, ids, u, tag):
    got = K.segment_reduce_sum(values, ids, u)
    want = K.segment_reduce_sum_plain(values, ids, u)
    assert got.shape == want.shape and got.dtype == torch.float32, tag
    assert torch.equal(got, K.segment_reduce_sum(values, ids, u)), (
        f"{tag}: rerun not bit-identical")
    err = within_sum_tol(got, want, tag)
    log(f"  segment_reduce_sum {tag}: n={values.shape[0]} "
        f"c={1 if values.ndim == 1 else values.shape[1]} u={u} "
        f"max|err|={err:.3g}")
    return err


def phase_segment_kernel(K):
    log("phase 7: the segment-sum kernel against its plain version on the card")
    g = torch.Generator(device="cuda").manual_seed(17)

    def ids_in(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=g, device="cuda",
                             dtype=torch.int32)

    def vals(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    past_grid = 65_535 * K.SEG_TILE_FLOATS + 4_097  # 65,537 tiles at c = 1
    hashed = {}
    for n, c, u, lo, hi, tag in [
            (1_000_003, 1, 1000, 0, 1000, "1-d ragged-n"),
            (500_000, 3, 777, 0, 777, "2-d"),
            (300_000, 2, 100, -1, 130, "-1 and out-of-range ids"),
            (0, 2, 100, 0, 100, "n=0"),
            (777, 1, 5, 0, 5, "one chunk"),
            (2_000_000, 1, 1 << 18, -5, (1 << 18) + 5, "hashed u=2^18"),
            (1_000_000, 2, 1 << 18, 0, 1 << 18, "hashed u=2^18 c=2"),
            (100_000, 1, past_grid, -5, past_grid + 5, "65,537 tiles"),
            (20_000, 5_000, 3, -1, 4, "c=5000 column groups"),
    ]:
        v = vals(n) if c == 1 else vals(n, c)
        ids = ids_in(lo, hi, n)
        check_segment(K, v, ids, u, tag)
        if tag.startswith("hashed"):
            hashed[tag] = (v, ids, u)  # timed below
        del v, ids
    torch.cuda.empty_cache()

    # the sparse FTRL path's shapes (one batch of 100,000 rows with 10
    # stored values each, packed to 1,048,576 slots): the per-row dots over
    # the packed row ids (ascending, ten a row, then id-0 padding whose
    # values are 0) and over sorted random row ids without padding, and the
    # per-coordinate gradient and weight sums
    nnz, rows_b, rows_s, d = 1 << 20, 100_000, 1 << 17, 100
    packed = torch.zeros(nnz, dtype=torch.int32, device="cuda")
    packed[:10 * rows_b] = torch.arange(
        rows_b, dtype=torch.int32, device="cuda").repeat_interleave(10)
    packed_v = vals(nnz)
    packed_v[10 * rows_b:] = 0.0
    sorted_ids = torch.sort(ids_in(0, rows_b, nnz)).values
    sorted_v = vals(nnz)
    col_ids, gw = ids_in(0, d, nnz), vals(nnz, 2)
    timed = {}
    for tag, v, ids, u in [("FTRL dots padded", packed_v, packed, rows_s),
                           ("FTRL dots sorted", sorted_v, sorted_ids, rows_s),
                           ("FTRL grad/wsum", gw, col_ids, d)]:
        err = check_segment(K, v, ids, u, tag)
        c = 1 if v.ndim == 1 else v.shape[1]
        library_ids = ids.long()  # every id of these shapes lies in [0, u)
        library_out = torch.zeros((u, c) if c > 1 else (u,), device="cuda")

        def library():
            return library_out.zero_().index_add_(0, library_ids, v)

        b_ms, b_by = bound_ms(*K.launch_cost("segment_reduce_sum",
                                             n=v.shape[0], c=c, u=u))
        timed[tag] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: K.segment_reduce_sum(v, ids, u)),
            "plain_ms": time_ms(lambda: K.segment_reduce_sum_plain(v, ids, u),
                                batches=3, per_batch=3, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(library),
            "device_ms": graph_ms(lambda: K.segment_reduce_sum(v, ids, u)),
            "library_device_ms": graph_ms(library)}
        log(f"  segment_reduce_sum {tag} @ n={nnz}, c={c}, u={u}: "
            f"{timed[tag]}")
    for tag, (v, ids, u) in hashed.items():
        log(f"  segment_reduce_sum {tag}: device "
            + "%.5f ms, eager %.5f ms" % (
                graph_ms(lambda: K.segment_reduce_sum(v, ids, u)),
                time_ms(lambda: K.segment_reduce_sum(v, ids, u))))
    # the kernels line: the per-coordinate shape, the per-row dots beside
    measured = {"segment_reduce_sum": {**timed["FTRL grad/wsum"],
                                       "per_row_dots": timed["FTRL dots padded"]}}
    return measured


def phase_knn_main_path(K, runner, Table):
    from flink_ml_tpu_torch.models.classification import Knn, knn as knn_mod

    log("phase 8: the KNN main path through the port's entry points")
    spec = runner.load_config(str(KNN_CONFIG))["KnnModel-predict"]
    n = spec["inputData"]["paramMap"]["numValues"]
    k = spec["stage"]["paramMap"]["k"]

    K.reset_launch_counts()
    row = runner.best_of("KnnModel-predict", spec, runs=2)
    log("  benchmark row:", json.dumps(row, sort_keys=True))
    assert row["executionPath"] == "cuda-knn", row["executionPath"]
    assert row["inputRecordNum"] == n and row["outputRecordNum"] == n

    table = runner.build_generator(spec).get_data()
    model = runner.build_stage(spec).set_model_data(
        runner.build_generator(spec, key="modelData").get_data())
    torch.cuda.synchronize()
    start = time.perf_counter()
    pred = model.transform(table)[0][model.prediction_col]
    torch.cuda.synchronize()
    transform_ms = (time.perf_counter() - start) * 1e3
    assert model.last_execution_path == "cuda-knn"
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = type(model).load(tmp)
        again = loaded.transform(table)[0][loaded.prediction_col]
    assert torch.equal(pred, again), "the loaded model predicts otherwise"
    counts = dict(K.launch_counts)
    log(f"  transform: {transform_ms:.3f} ms for {n} rows; save/load: same "
        "predictions")
    log(f"  launches in the main-path run: {counts}")

    # is the output right: labels from the model data, and the predictions
    # of the plain version on blocks at the start, middle and ragged end
    labels = torch.as_tensor(np.unique(model.labels), device="cuda")
    assert pred.shape == (n,) and bool(torch.isin(pred, labels).all())
    x = table.vectors(model.features_col)
    train = torch.as_tensor(model.features, dtype=torch.float32, device="cuda")
    _, label_idx = np.unique(model.labels, return_inverse=True)
    label_idx = torch.as_tensor(label_idx, device="cuda")
    checked = flips = 0
    for lo, hi in [(0, 40_000), (n // 2 - 20_000, n // 2 + 20_000),
                   (n - 33_333, n)]:
        got = K.knn_topk_indices(x[lo:hi], train, k)
        want = torch.cat([K.knn_topk_indices_plain(x[s:min(s + 16_384, hi)],
                                                   train, k)
                          for s in range(lo, hi, 16_384)])
        f, _ = knn_tie_check(x[lo:hi], train, got, want, f"rows {lo}:{hi}")
        vote = knn_mod._vote(got, label_idx, len(labels))
        assert torch.equal(pred[lo:hi], labels.double()[vote]), (
            f"rows {lo}:{hi}: transform differs from its kernel's neighbours")
        plain_vote = knn_mod._vote(want, label_idx, len(labels))
        differ = int((vote != plain_vote).sum())
        assert differ <= f, f"rows {lo}:{hi}: {differ} votes off the plain ones"
        checked += hi - lo
        flips += f
    log(f"  {checked} predictions against the plain version: tie-rows={flips}")
    del x, table, pred, again
    torch.cuda.empty_cache()

    # small models give the same predictions on the card and on the CPU
    # (blobs far apart: no row near a tie)
    rng = np.random.default_rng(5)
    for d, k in [(9, 7), (300, 40)]:  # the tiled and the wide instance
        centers = rng.normal(size=(4, d)) * 10
        which = rng.integers(0, 4, 600)
        xs = centers[which] + rng.normal(size=(600, d))
        small = Table.from_columns(features=xs, label=which * 2.5 - 1.0)
        test = Table.from_columns(features=centers[rng.integers(0, 4, 300)]
                                  + rng.normal(size=(300, d)))
        preds = {}
        for dev in ("cuda", "cpu"):
            m = Knn(k=k, device=dev).fit(small)
            preds[dev] = m.transform(test)[0]["prediction"].cpu()
            assert m.last_execution_path == (
                "cuda-knn" if dev == "cuda" else "torch-knn")
        assert torch.equal(preds["cuda"], preds["cpu"]), (d, k)
    log("  small models (d = 9, k = 7; d = 300, k = 40): card and CPU agree")
    assert counts["knn_topk_indices"] >= 3 + 2, counts  # runs + transforms
    return counts


def _sparse_stream(Table, sparse, n, d, nnz_per_row, seed, striped=False):
    """n rows of nnz_per_row stored values at seeded distinct columns of d,
    labels from a seeded hyperplane, weights in [0.5, 1.5). ``striped``
    draws the j-th column of a row from the j-th of nnz_per_row equal
    stripes of d, which keeps a wide domain's draw small."""
    rng = np.random.default_rng(seed)
    if striped:
        stripe = d // nnz_per_row
        cols = (rng.integers(0, stripe, (n, nnz_per_row))
                + np.arange(nnz_per_row) * stripe)
    else:
        cols = np.sort(rng.random((n, d), dtype=np.float32)
                       .argpartition(nnz_per_row, axis=1)[:, :nnz_per_row],
                       axis=1)
    values = rng.normal(size=(n, nnz_per_row))
    truth = rng.normal(size=d)
    y = ((values * truth[cols]).sum(1) > 0).astype(np.float64)
    import scipy.sparse as sp

    x = sp.csr_matrix((values.ravel(), cols.ravel().astype(np.int32),
                       np.arange(0, n * nnz_per_row + 1, nnz_per_row)),
                      shape=(n, d))
    return Table.from_columns(features=sparse.CsrVectorColumn(x), label=y,
                              weight=rng.random(n) + 0.5)


def phase_ftrl_main_path(K, runner, Table):
    from flink_ml_tpu_torch.iteration import streaming
    from flink_ml_tpu_torch.linalg import sparse
    from flink_ml_tpu_torch.models import online

    log("phase 9: the FTRL main path through the port's entry points")
    spec = runner.load_config(str(FTRL_CONFIG))["OnlineLogisticRegression"]
    n = spec["inputData"]["paramMap"]["numValues"]
    d = spec["inputData"]["paramMap"]["vectorDim"]
    batch = spec["stage"]["paramMap"]["globalBatchSize"]

    K.reset_launch_counts()
    row = runner.best_of("OnlineLogisticRegression", spec, runs=2)
    log("  benchmark row:", json.dumps(row, sort_keys=True))
    assert row["executionPath"] == "torch-dense-batches", row["executionPath"]
    assert row["inputRecordNum"] == n and row["outputRecordNum"] == 1

    # the sparse stream: the config's widths and params, 10 stored values a
    # row; every batch runs the segment kernel
    stream = _sparse_stream(Table, sparse, 2_000_000, d, 10, seed=23)

    def sparse_fit():
        est = runner.build_stage(spec).warm_start(np.zeros(d))
        torch.cuda.synchronize()
        start = time.perf_counter()
        model = est.fit(stream)
        torch.cuda.synchronize()
        return model, est.last_execution_path, (time.perf_counter() - start) * 1e3

    sparse_model, path, sparse_ms = sparse_fit()
    counts = dict(K.launch_counts)
    log(f"  sparse stream fit: {sparse_ms:.3f} ms for 2,000,000 rows "
        f"({path}, version {sparse_model.model_version})")
    log(f"  launches in the main-path run: {counts}")
    assert path == "cuda-csr-batches", path
    assert sparse_model.model_version == 2_000_000 // batch
    # where the sparse fit's time goes: the host's batching and packing
    # alone, and the packed batches' copies to the card
    start = time.perf_counter()
    packed = []
    for b in streaming.generate_batches(
            streaming.StreamTable.from_table(stream, batch), batch):
        x = sparse.features_matrix(b, "features")
        packed.append(online._pack_csr_shards(
            x, b.scalars("label", np.float64),
            b.scalars("weight", np.float64), 1))
    pack_ms = (time.perf_counter() - start) * 1e3
    start = time.perf_counter()
    for p in packed:
        [torch.as_tensor(a[0], device="cuda") for a in p]
    torch.cuda.synchronize()
    copy_ms = (time.perf_counter() - start) * 1e3
    log(f"  of which host batching and packing alone: {pack_ms:.3f} ms; "
        f"copies of the packed batches to the card: {copy_ms:.3f} ms")
    del packed

    # is the output right: the sparse fit reruns to the same bits and
    # matches the float64 host engine on the same stream
    again, _, _ = sparse_fit()
    assert np.array_equal(again.coefficients, sparse_model.coefficients), (
        "the sparse fit differs on a rerun")
    threshold = online.FTRL_SPARSE_MIN_NNZ
    online.FTRL_SPARSE_MIN_NNZ = 1 << 62
    try:
        host, host_path, host_ms = sparse_fit()
    finally:
        online.FTRL_SPARSE_MIN_NNZ = threshold
    assert host_path == "host-csr-batches", host_path
    diff = np.abs(sparse_model.coefficients - host.coefficients)
    log(f"  against the host engine ({host_ms:.3f} ms): "
        f"max|coeff diff|={diff.max():.3g} (max|coeff|="
        f"{np.abs(host.coefficients).max():.3g})")
    assert np.all(diff <= CSR_RTOL * np.abs(host.coefficients) + CSR_ATOL)
    for (va, a), (vb, b) in zip(sparse_model.history, host.history):
        assert va == vb
        assert np.all(np.abs(a - b) <= CSR_RTOL * np.abs(b) + CSR_ATOL)
    out = sparse_model.transform(stream)[0]
    assert isinstance(out["prediction"], np.ndarray)
    accuracy = float((out["prediction"] == stream.scalars("label",
                                                          np.float64)).mean())
    log(f"  sparse model accuracy on its stream: {accuracy:.4f}")
    assert accuracy > 0.85, accuracy
    del stream, out

    # a hashed 2^18 domain: the per-coordinate sums take 128 segment tiles
    # on the card, and the fit still matches the host engine
    wide_d = 1 << 18
    wide = _sparse_stream(Table, sparse, 4 * batch, wide_d, 10, seed=31,
                          striped=True)
    wide_fits = {}
    for name, floor in [("card", threshold), ("host", 1 << 62)]:
        online.FTRL_SPARSE_MIN_NNZ = floor
        try:
            e = runner.build_stage(spec).warm_start(np.zeros(wide_d))
            wide_fits[name] = (e.fit(wide).coefficients, e.last_execution_path)
        finally:
            online.FTRL_SPARSE_MIN_NNZ = threshold
    assert wide_fits["card"][1] == "cuda-csr-batches", wide_fits["card"][1]
    assert wide_fits["host"][1] == "host-csr-batches", wide_fits["host"][1]
    card_c, host_c = wide_fits["card"][0], wide_fits["host"][0]
    diff = np.abs(card_c - host_c)
    log(f"  hashed 2^18 domain, {4 * batch} rows: max|coeff diff| against "
        f"the host engine={diff.max():.3g} (max|coeff|="
        f"{np.abs(host_c).max():.3g}, {int((host_c != 0).sum())} nonzero)")
    assert np.all(diff <= CSR_RTOL * np.abs(host_c) + CSR_ATOL)
    del wide

    # the dense fit on the config's table: version, history, transform,
    # save/load. Its labels are independent of its features, so l1 holds
    # every coefficient at 0; the same fit on labels from a hyperplane
    # learns, and is held against the CPU
    table = runner.build_generator(spec).get_data()
    est = runner.build_stage(spec).set_initial_model_data(
        runner.build_generator(spec, key="modelData").get_data())
    model = est.fit(table)
    assert est.last_execution_path == "torch-dense-batches"
    assert model.model_version == n // batch and len(model.history) == n // batch
    assert np.isfinite(model.coefficients).all()
    truth = torch.randn(d, generator=torch.Generator(device="cuda").manual_seed(29),
                        device="cuda")
    x = table.column("features")
    margin = x @ truth
    learnable = table.with_column(
        "label", (margin > margin.median()).to(torch.float32))
    fits = {}
    for dev in ("cuda", "cpu"):
        t = learnable if dev == "cuda" else Table.from_columns(
            **{c: learnable.column(c).cpu() for c in learnable.column_names})
        e = runner.build_stage(spec, device=dev).warm_start(np.zeros(d))
        fits[dev] = e.fit(t).coefficients
        del t
    diff = np.abs(fits["cuda"] - fits["cpu"])
    log(f"  dense fit on hyperplane labels against the CPU: max|coeff diff|="
        f"{diff.max():.3g} (max|coeff|={np.abs(fits['cpu']).max():.3g}, "
        f"{int((fits['cpu'] != 0).sum())} of {d} nonzero)")
    assert np.abs(fits["cpu"]).max() > 0.01
    assert np.all(diff <= BIG_FIT_RTOL * np.abs(fits["cpu"]) + BIG_FIT_ATOL)
    del x, margin, learnable
    torch.cuda.synchronize()
    start = time.perf_counter()
    pred = model.transform(table)[0]
    torch.cuda.synchronize()
    transform_ms = (time.perf_counter() - start) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        model.save(tmp)
        loaded = type(model).load(tmp)
        again = loaded.transform(table)[0]
    assert torch.equal(pred[model.prediction_col], again[loaded.prediction_col])
    assert bool(torch.isfinite(pred[model.raw_prediction_col]).all())
    assert int(pred[model.model_version_col][0]) == n // batch
    log(f"  FTRL transform: {transform_ms:.3f} ms for {n} rows; save/load: "
        "same predictions")
    del table, pred, again
    torch.cuda.empty_cache()

    # small dense fits give the same model on the card and on the CPU
    small = _small_linear_table(Table, 31, 600, 7, False)
    fitted = {}
    for dev in ("cuda", "cpu"):
        e = online.OnlineLogisticRegression(
            device=dev, global_batch_size=100, reg=0.05, elastic_net=0.3,
            weight_col="weight").warm_start(np.zeros(7))
        fitted[dev] = e.fit(small).coefficients
    np.testing.assert_allclose(fitted["cuda"], fitted["cpu"],
                               rtol=SMALL_RTOL, atol=SMALL_ATOL)
    log("  small dense fits: card and CPU agree")
    batches = 2_000_000 // batch
    # two segment calls a batch, each one C entry with its own second stage
    assert counts["segment_reduce_sum"] >= 2 * batches, counts
    assert counts["reduce_partials"] == 0, counts
    return counts


def _checkpoint_stats(CheckpointManager):
    """A CheckpointManager that times its saves and restores and records
    the bytes of the leaves each one moved."""

    class Timed(CheckpointManager):
        def __init__(self, base_dir):
            super().__init__(base_dir)
            self.saves, self.restores = [], []

        def save(self, carry, epoch, extras=None):
            start = time.perf_counter()
            path = super().save(carry, epoch, extras)
            self.saves.append((epoch, (time.perf_counter() - start) * 1e3,
                               _nbytes(carry)))
            return path

        def restore(self, template_carry):
            start = time.perf_counter()
            restored = super().restore(template_carry)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - start) * 1e3
            self.restores.append(
                (None, ms, 0) if restored is None
                else (restored[1], ms, _nbytes(restored[0])))
            return restored

    return Timed


def _nbytes(tree):
    """Bytes of a carry's leaves (tensors and numpy arrays in tuples)."""
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(child) for child in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return np.asarray(tree).nbytes


def _host_split(run, wraps):
    """``run()`` with each named callable of ``wraps`` ([(name, owner,
    attribute)]) wrapped for the run only → (run's result, {name: [host ms,
    calls]})."""
    spent = {name: [0.0, 0] for name, _, _ in wraps}
    undo = []
    for name, owner, attr in wraps:
        real = getattr(owner, attr)

        def timed(*args, _real=real, _name=name, **kwargs):
            start = time.perf_counter()
            try:
                return _real(*args, **kwargs)
            finally:
                spent[_name][0] += (time.perf_counter() - start) * 1e3
                spent[_name][1] += 1

        setattr(owner, attr, timed)
        undo.append((owner, attr, real))
    try:
        return run(), spent
    finally:
        for owner, attr, real in reversed(undo):
            setattr(owner, attr, real)


def phase_iteration_modes(K, runner, Table):
    """Phase 10: the iteration runtime's modes on the card at the LR and
    KMeans benchmark configs' full size, each held bit for bit against the
    all-device fit of the same table."""
    from flink_ml_tpu_torch.iteration import checkpoint, iteration
    from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager
    from flink_ml_tpu_torch.linalg import sparse
    from flink_ml_tpu_torch.resilience import InjectedFault, RetryPolicy, faults

    log("phase 10: iteration modes on the card")
    Timed = _checkpoint_stats(CheckpointManager)
    fetches = []
    real_read_boundary = iteration.read_boundary

    def counting_read_boundary(boundary):
        assert isinstance(boundary, torch.Tensor) and boundary.shape == (2,)
        fetches.append(1)
        return real_read_boundary(boundary)

    class CountingPlan(faults.FaultPlan):
        """A fault plan that also counts every boundary it is asked about."""

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.boundaries = 0

        def decide(self, site):
            self.boundaries += site == "epoch-boundary"
            return super().decide(site)

    class Epochs(iteration.IterationListener):
        def __init__(self):
            self.epochs = []

        def on_epoch_watermark_incremented(self, epoch, carry):
            self.epochs.append(epoch)

    def timed_fit(est, table):
        torch.cuda.synchronize()
        start = time.perf_counter()
        model = est.fit(table)
        torch.cuda.synchronize()
        return model, (time.perf_counter() - start) * 1e3

    iteration.read_boundary = counting_read_boundary
    K.reset_launch_counts()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_iteration_")
    summary = {}
    try:
        cases = [
            ("LR", runner.load_config(str(LINEAR_CONFIGS["logisticregression"]))
             ["logisticregression"], 5, ("sgd_batch_terms",), "cuda-sgd"),
            ("KMeans", runner.load_config(str(CONFIG))["KMeans"], 3,
             ("lloyd_partial_sums", "reduce_partials"), "cuda-lloyd"),
        ]
        for name, spec, k, kernels_of_fit, path in cases:
            table = runner.build_generator(spec).get_data()
            max_iter = spec["stage"]["paramMap"]["maxIter"]
            n = table.num_rows
            boundaries = -(-max_iter // k)

            def result(model):
                return (model.coefficients if name == "LR"
                        else np.concatenate([model.centroids.ravel(),
                                             model.weights]))

            plain_est = runner.build_stage(spec)
            plain, _ = timed_fit(plain_est, table)
            plain_ms = min(timed_fit(runner.build_stage(spec), table)[1]
                           for _ in range(2))
            assert plain_est.last_execution_path == path
            want = result(plain)
            if name == "KMeans":
                want_labels = plain.transform(table)[0][plain.prediction_col]

            def check_mode(tag, model, est, before, plan, fit_ms, expect_path):
                launched = {kern: K.launch_counts[kern] - before[kern]
                            for kern in K.launch_counts}
                assert est.last_execution_path == expect_path, (
                    tag, est.last_execution_path)
                assert np.array_equal(result(model), want), (
                    f"{name} {tag}: differs from the all-device fit")
                for kern in kernels_of_fit:
                    assert launched[kern] >= max_iter, (tag, launched)
                if name == "KMeans":
                    labels = model.transform(table)[0][model.prediction_col]
                    assert torch.equal(labels, want_labels), tag
                log(f"  {name} {tag}: fit {fit_ms:.3f} ms against the "
                    f"all-device fit's {plain_ms:.3f} ms ({n} rows, "
                    f"{max_iter} rounds); boundaries {plan.boundaries}; "
                    f"launches { {k: v for k, v in launched.items() if v} }; "
                    "bit-identical")
                return launched

            # (a) K-round segments between checkpoints
            runs = []
            for attempt in range(2):
                mgr = Timed(f"{workdir}/{name}-segments-{attempt}")
                est = runner.build_stage(spec).set_iteration_config(
                    iteration.IterationConfig(checkpoint_interval=k,
                                              checkpoint_manager=mgr))
                before, seg_fetches = dict(K.launch_counts), len(fetches)
                with faults.chaos(plan=CountingPlan()) as plan:
                    model, fit_ms = timed_fit(est, table)
                runs.append((fit_ms, mgr, len(fetches) - seg_fetches, plan))
                launched = check_mode(f"segments (K={k})", model, est, before,
                                      plan, fit_ms, path + "-segments")
            fit_ms, mgr, seg_fetches, plan = min(runs, key=lambda r: r[0])
            assert plan.boundaries == boundaries and seg_fetches == boundaries, (
                plan.boundaries, seg_fetches)
            saves = mgr.saves
            assert [e for e, _, _ in saves] == [
                k * i for i in range(1, boundaries) if k * i < max_iter], saves
            assert mgr.list_checkpoints() == []
            log(f"  {name} segments: boundary fetches {seg_fetches} for "
                f"{boundaries} boundaries; checkpoint saves {len(saves)}, "
                f"ms {[round(ms, 3) for _, ms, _ in saves]}, "
                f"{saves[0][2]} bytes of leaves each")
            summary[name] = {"segments_ms": fit_ms, "plain_ms": plain_ms,
                             "boundaries": boundaries,
                             "fetches": seg_fetches,
                             "save_ms": statistics.median(
                                 ms for _, ms, _ in saves),
                             "save_bytes": saves[0][2]}

            # where a boundary's time goes: the host clock around each call
            # the segment driver makes there, on one more segment fit
            mgr = Timed(f"{workdir}/{name}-split")
            est = runner.build_stage(spec).set_iteration_config(
                iteration.IterationConfig(checkpoint_interval=k,
                                          checkpoint_manager=mgr))
            (model, split_fit_ms), spent = _host_split(
                lambda: timed_fit(est, table), [
                    ("fetch", iteration, "read_boundary"),
                    ("save", mgr, "save"), ("fsync", checkpoint.os, "fsync"),
                    ("npz", checkpoint.np, "savez"), ("gc", mgr, "_gc"),
                    ("restore", mgr, "restore"), ("clear", mgr, "clear")])
            assert np.array_equal(result(model), want), "split run differs"
            assert spent["fetch"][1] == boundaries, spent
            rest = split_fit_ms - sum(spent[part][0] for part in
                                      ("fetch", "save", "restore", "clear"))
            split = {part: round(ms, 4) for part, (ms, _) in spent.items()}
            split.update(fit=round(split_fit_ms, 4), rest=round(rest, 4))
            log(f"  {name} boundary split (host ms over {boundaries} "
                f"boundaries, {len(mgr.saves)} saves; fsync, npz and gc are "
                f"inside save; rest = fit - fetch - save - restore - clear): "
                f"{json.dumps(split, sort_keys=True)}; fsync calls "
                f"{spent['fsync'][1]}")
            summary[name]["split_ms"] = split

            # (b) host rounds with a listener
            listener = Epochs()
            est = runner.build_stage(spec).set_iteration_config(
                iteration.IterationConfig(mode="host"), listeners=[listener])
            before, host_fetches = dict(K.launch_counts), len(fetches)
            with faults.chaos(plan=CountingPlan()) as plan:
                model, fit_ms = timed_fit(est, table)
            check_mode("host rounds", model, est, before, plan, fit_ms,
                       path + "-rounds")
            assert listener.epochs == list(range(max_iter)), listener.epochs
            assert len(fetches) == host_fetches  # a round's stop, not a segment
            summary[name]["rounds_ms"] = fit_ms

            # (c) supervised: a fault at the second boundary, a restart from
            # the first boundary's checkpoint
            mgr = Timed(f"{workdir}/{name}-chaos")
            est = (runner.build_stage(spec)
                   .set_iteration_config(iteration.IterationConfig(
                       checkpoint_interval=k, checkpoint_manager=mgr))
                   .set_retry_policy(RetryPolicy(backoff_s=0)))
            before = dict(K.launch_counts)
            with faults.chaos(plan=CountingPlan(at={"epoch-boundary": [2]})
                              ) as plan:
                model, fit_ms = timed_fit(est, table)
            check_mode("supervised chaos", model, est, before, plan, fit_ms,
                       path + "-segments")
            restarts = len(mgr.restores) - 1
            resumed = [r for r in mgr.restores if r[0] is not None]
            assert restarts == 1 and len(resumed) == 1, mgr.restores
            assert resumed[0][0] == k, resumed
            assert plan.boundaries == boundaries + 1, plan.boundaries
            log(f"  {name} supervised chaos: restarts {restarts}, resumed "
                f"from epoch {resumed[0][0]}; restore {resumed[0][1]:.3f} ms, "
                f"{resumed[0][2]} bytes of leaves")
            summary[name].update(chaos_ms=fit_ms, restarts=restarts,
                                 restore_ms=resumed[0][1],
                                 restore_bytes=resumed[0][2])
            del table
            torch.cuda.empty_cache()

        # FTRL's sparse stream (phase 9's) with a checkpoint every 5
        # batches: a due save takes the state to the host and the next
        # batch places it again. A fault at the third save ends a fit,
        # which resumes from the second save on the rest of the stream. Both
        # end with the bytes of the stream without checkpoints.
        spec = runner.load_config(str(FTRL_CONFIG))["OnlineLogisticRegression"]
        d = spec["inputData"]["paramMap"]["vectorDim"]
        batch = spec["stage"]["paramMap"]["globalBatchSize"]
        stream = _sparse_stream(Table, sparse, 2_000_000, d, 10, seed=23)
        batches, interval = stream.num_rows // batch, 5

        def ftrl_fit(rows, config=None):
            est = runner.build_stage(spec).warm_start(np.zeros(d))
            if config is not None:
                est.set_iteration_config(config)
            before = K.launch_counts["segment_reduce_sum"]
            model, fit_ms = timed_fit(est, rows)
            assert est.last_execution_path == "cuda-csr-batches", (
                est.last_execution_path)
            launched = K.launch_counts["segment_reduce_sum"] - before
            assert launched >= 2 * (rows.num_rows // batch), launched
            return model, fit_ms

        def assert_same(tag, model, clean):
            assert np.array_equal(model.coefficients, clean.coefficients), tag
            assert model.model_version == clean.model_version == batches, tag
            assert len(model.history) == len(clean.history), tag
            for (va, a), (vb, b) in zip(model.history, clean.history):
                assert va == vb and np.array_equal(a, b), (tag, va, vb)

        clean, clean_ms = ftrl_fit(stream)
        saved_mgr = Timed(f"{workdir}/FTRL")
        saved, saved_ms = ftrl_fit(stream, iteration.IterationConfig(
            checkpoint_interval=interval, checkpoint_manager=saved_mgr))
        assert_same("FTRL checkpointed", saved, clean)
        assert [e for e, _, _ in saved_mgr.saves] == list(
            range(interval, batches + 1, interval)), saved_mgr.saves
        assert saved_mgr.list_checkpoints() == []
        mgr = Timed(f"{workdir}/FTRL-crash")
        config = iteration.IterationConfig(checkpoint_interval=interval,
                                           checkpoint_manager=mgr)
        crashed = runner.build_stage(spec).warm_start(np.zeros(d))
        crashed.set_iteration_config(config)
        with faults.chaos(at={"checkpoint-save": [3]}):
            try:
                crashed.fit(stream)
                raise AssertionError("FTRL: the fault at the third save "
                                     "did not end the fit")
            except InjectedFault:
                pass
        assert mgr.list_checkpoints() == [f"ckpt-{interval:08d}",
                                          f"ckpt-{2 * interval:08d}"]
        resumed, resumed_ms = ftrl_fit(
            stream.take(slice(2 * interval * batch, None)), config)
        assert_same("FTRL resumed", resumed, clean)
        restored = [r for r in mgr.restores if r[0] is not None]
        assert [r[0] for r in restored] == [2 * interval], mgr.restores
        assert mgr.list_checkpoints() == []
        log(f"  FTRL sparse stream ({stream.num_rows} rows, {batches} "
            f"batches): {clean_ms:.3f} ms without checkpoints, "
            f"{saved_ms:.3f} ms with a save every {interval} batches (saves "
            f"ms {[round(ms, 3) for _, ms, _ in saved_mgr.saves]}, bytes "
            f"{[b for _, _, b in saved_mgr.saves]}); resumed from batch "
            f"{restored[0][0]} on the last {batches - 2 * interval} batches "
            f"in {resumed_ms:.3f} ms, restore {restored[0][1]:.3f} ms, "
            f"{restored[0][2]} bytes; both bit-identical")
        summary["FTRL"] = {"plain_ms": clean_ms, "checkpointed_ms": saved_ms,
                           "resumed_ms": resumed_ms,
                           "restore_ms": restored[0][1],
                           "restore_bytes": restored[0][2]}
        del stream
    finally:
        iteration.read_boundary = real_read_boundary
        shutil.rmtree(workdir, ignore_errors=True)
    counts = dict(K.launch_counts)
    log(f"  launches in the iteration-modes run: {counts}")
    log("  iteration modes:", json.dumps(summary, sort_keys=True))
    for kern in PATH_KERNELS["iteration"]:
        assert counts[kern] >= 1, counts
    return counts


def _timed_fit(est, table):
    """(model, ms): host clock around ``est.fit`` ended by a synchronize."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    model = est.fit(table)
    torch.cuda.synchronize()
    return model, (time.perf_counter() - start) * 1e3


def phase_parallel(K, runner, optimizer, Table):
    """Phase 11: the data-parallel layer on the card: the LR, KMeans and
    FTRL fits on one shard and on eight virtual shards of the card, with
    the replicated and the sharded update, a segmented LR fit resumed after
    a fault, and an LR fit through torch.distributed (NCCL, world size
    1)."""
    from flink_ml_tpu_torch.iteration import iteration
    from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager
    from flink_ml_tpu_torch.linalg import sparse
    from flink_ml_tpu_torch.parallel import (create_mesh, init_distributed,
                                             shutdown_distributed)
    from flink_ml_tpu_torch.parallel import update_sharding as upd
    from flink_ml_tpu_torch.resilience import RetryPolicy, faults

    log("phase 11: the data-parallel layer on the card")
    card = torch.device("cuda")
    meshes = {None: None, 1: create_mesh((1,), devices=[card]),
              8: create_mesh((8,), devices=[card] * 8)}
    K.reset_launch_counts()
    summary = {}

    def fit(spec, table, p, sharded=False, reps=2, setup=None):
        """The spec's estimator on ``p`` shards (None: no mesh asked for),
        fitted ``reps`` times → (model, best ms, launches of one fit)."""
        runs = []
        with mock.patch.dict(os.environ, {upd.ENV: str(int(sharded))}):
            for _ in range(reps):
                est = runner.build_stage(spec, mesh=meshes[p])
                if setup is not None:
                    est = setup(est)
                before = dict(K.launch_counts)
                model, ms = _timed_fit(est, table)
                runs.append((ms, model, {k: K.launch_counts[k] - before[k]
                                         for k in K.launch_counts}))
        ms, model, launched = min(runs, key=lambda r: r[0])
        return model, ms, {k: v for k, v in launched.items() if v}

    def same(a, b):
        return bool(np.array_equal(a, b))

    # (a) LR at full size: no mesh, one shard, eight shards replicated and
    # sharded, then the segmented fit resumed after a fault and NCCL
    spec = runner.load_config(str(LINEAR_CONFIGS["logisticregression"]))[
        "logisticregression"]
    max_iter = spec["stage"]["paramMap"]["maxIter"]
    gb = spec["stage"]["paramMap"]["globalBatchSize"]
    table = runner.build_generator(spec).get_data()
    nomesh, nomesh_ms, _ = fit(spec, table, None)
    one, one_ms, one_l = fit(spec, table, 1)
    assert same(one.coefficients, nomesh.coefficients), (
        "LR on one shard differs from the fit with no mesh")
    assert one_l == {"sgd_batch_terms": max_iter}, one_l
    rep, rep_ms, rep_l = fit(spec, table, 8)
    assert rep_l == {"sgd_batch_terms": 8 * max_iter,
                     "reduce_partials": max_iter}, rep_l
    sh, sh_ms, sh_l = fit(spec, table, 8, sharded=True)
    assert sh_l == {"sgd_batch_terms": 8 * max_iter,
                    "reduce_partials": 2 * max_iter}, sh_l
    np.testing.assert_allclose(sh.coefficients, rep.coefficients, rtol=1e-5)
    # the eight-shard fit against its plain rounds on the card (launches of
    # the comparison are not the path's)
    saved = dict(K.launch_counts)
    est = runner.build_stage(spec)
    x, y = table.vectors(est.features_col), table.column(est.label_col)
    prm = optimizer.SGDParams(
        learning_rate=est.learning_rate, global_batch_size=gb,
        max_iter=max_iter, tol=est.tol, reg=est.reg,
        elastic_net=est.elastic_net)
    plain, _, _ = optimizer.sgd_rounds(
        K.sgd_batch_terms_plain, "logistic", prm, x, y,
        torch.ones(table.num_rows, device=card), torch.zeros(
            x.shape[1], device=card), mesh=meshes[8])
    K.launch_counts.update(saved)
    plain = plain.double().cpu().numpy()
    diff = np.abs(rep.coefficients - plain)
    assert np.all(diff <= COEFF_RTOL * np.abs(plain) + COEFF_ATOL), diff.max()
    log(f"  LR ({table.num_rows} x {x.shape[1]}, {max_iter} rounds, global "
        f"batch {gb}, {gb // 8} rows a shard on 8): fit ms no mesh "
        f"{nomesh_ms:.3f}, 1 shard {one_ms:.3f} (bit-identical), 8 shards "
        f"{rep_ms:.3f}, 8 sharded {sh_ms:.3f} (bit-identical to replicated: "
        f"{same(sh.coefficients, rep.coefficients)}); launches 1 shard "
        f"{one_l}, 8 shards {rep_l}, 8 sharded {sh_l}; 8 shards against "
        f"their plain rounds max|diff|={diff.max():.3g}, against 1 shard "
        f"max|diff|={np.abs(rep.coefficients - one.coefficients).max():.3g}")
    summary["LR"] = {"nomesh_ms": nomesh_ms, "p1_ms": one_ms, "p8_ms": rep_ms,
                     "p8_sharded_ms": sh_ms, "p1_launches": one_l,
                     "p8_launches": rep_l, "p8_sharded_launches": sh_l}

    # segments: K = 5 with a fault at the second boundary, resumed by the
    # supervisor from the first boundary's checkpoint, bit for bit the
    # eight-shard all-device fit; replicated sgd, and sharded adam (its
    # moments are Sharded leaves of the checkpoint)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    try:
        for tag, sharded, method in [("replicated", False, "sgd"),
                                     ("sharded adam", True, "adam")]:
            def optimizer_of(est, method=method):
                est.optimizer = method
                return est

            want = rep.coefficients if method == "sgd" else fit(
                spec, table, 8, sharded, 1, optimizer_of)[0].coefficients
            mgr = CheckpointManager(f"{workdir}/{method}")

            def segmented(est, mgr=mgr, method=method):
                est.optimizer = method
                return (est.set_iteration_config(iteration.IterationConfig(
                    checkpoint_interval=5, checkpoint_manager=mgr))
                    .set_retry_policy(RetryPolicy(backoff_s=0)))

            with faults.chaos(at={"epoch-boundary": [2]}):
                got, seg_ms, seg_l = fit(spec, table, 8, sharded, 1,
                                         segmented)
            assert same(got.coefficients, want), f"LR segments {tag} differ"
            assert mgr.list_checkpoints() == []
            log(f"  LR 8-shard segments (K=5, {tag}), a fault at boundary "
                f"2 resumed: {seg_ms:.3f} ms, bit-identical to the "
                f"all-device fit; launches {seg_l}")
            summary["LR"][f"segments_{method}_ms"] = seg_ms
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # torch.distributed: NCCL at world size 1, the default mesh one shard
    # per rank; bit for bit the one-shard in-process fit
    rendezvous = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        init_distributed(init_method=f"file://{rendezvous}/store",
                         world_size=1, rank=0, device=card)
        import torch.distributed as dist

        assert dist.get_backend() == "nccl"
        nccl, nccl_ms, nccl_l = fit(spec, table, None)
    finally:
        shutdown_distributed()
        shutil.rmtree(rendezvous, ignore_errors=True)
    assert same(nccl.coefficients, one.coefficients), (
        "LR through NCCL differs from the one-shard fit")
    log(f"  LR through torch.distributed (NCCL, world size 1): {nccl_ms:.3f} "
        f"ms, bit-identical to 1 shard; launches {nccl_l}")
    summary["LR"]["nccl_ms"] = nccl_ms
    del table, x, y
    torch.cuda.empty_cache()

    # (b) KMeans at full size on 1 and 8 shards
    spec = runner.load_config(str(CONFIG))["KMeans"]
    max_iter = spec["stage"]["paramMap"]["maxIter"]
    table = runner.build_generator(spec).get_data()
    n = table.num_rows
    one, one_ms, one_l = fit(spec, table, 1)
    assert one_l == {"lloyd_partial_sums": max_iter,
                     "reduce_partials": max_iter}, one_l
    rep, rep_ms, rep_l = fit(spec, table, 8)
    # per shard a Lloyd call (two stages), then the cross-shard sum
    assert rep_l == {"lloyd_partial_sums": 8 * max_iter,
                     "reduce_partials": 9 * max_iter}, rep_l
    sh, sh_ms, sh_l = fit(spec, table, 8, sharded=True)
    assert sh_l == rep_l, sh_l
    np.testing.assert_allclose(sh.centroids, rep.centroids, rtol=1e-5)
    assert same(sh.weights, rep.weights)
    x = table.vectors(runner.build_stage(spec).features_col)
    diff = float(np.abs(rep.centroids - one.centroids).max())
    c8 = torch.as_tensor(rep.centroids, dtype=torch.float32, device=card)
    c1 = torch.as_tensor(one.centroids, dtype=torch.float32, device=card)
    agree = float((K.assign_nearest_plain(x, c8)
                   == K.assign_nearest_plain(x, c1)).float().mean())
    moved = int(np.abs(rep.weights - one.weights).sum())
    log(f"  KMeans ({n} x {x.shape[1]}, k = {rep.centroids.shape[0]}, "
        f"{max_iter} rounds): fit ms 1 shard {one_ms:.3f}, 8 shards "
        f"{rep_ms:.3f}, 8 sharded {sh_ms:.3f} (bit-identical to replicated: "
        f"{same(sh.centroids, rep.centroids)}); launches 1 shard {one_l}, 8 "
        f"shards {rep_l}; 8 against 1 shard: max|centroid diff|={diff:.3g}, "
        f"label agreement {agree:.6f}, {moved} of {n} counts moved")
    assert rep.weights.sum() == n
    assert diff <= CENTROID_ATOL and agree >= LABEL_AGREEMENT
    summary["KMeans"] = {"p1_ms": one_ms, "p8_ms": rep_ms,
                         "p8_sharded_ms": sh_ms, "p1_launches": one_l,
                         "p8_launches": rep_l, "centroid_diff": diff}
    del table, x
    torch.cuda.empty_cache()

    # (c) FTRL: the config's dense table on hyperplane labels, and phase 9's
    # sparse stream, on 1 and 8 shards
    spec = runner.load_config(str(FTRL_CONFIG))["OnlineLogisticRegression"]
    d = spec["inputData"]["paramMap"]["vectorDim"]
    batch = spec["stage"]["paramMap"]["globalBatchSize"]
    table = runner.build_generator(spec).get_data()
    truth = torch.randn(d, generator=torch.Generator(device="cuda").manual_seed(
        29), device="cuda")
    margin = table.column("features") @ truth
    table = table.with_column("label",
                              (margin > margin.median()).to(torch.float32))
    batches = table.num_rows // batch

    def warm(est):
        return est.warm_start(np.zeros(d))

    for kind, rows, engine, kernel in [
            ("dense", table, "torch-dense-batches", None),
            ("sparse", _sparse_stream(Table, sparse, 2_000_000, d, 10,
                                      seed=23),
             "cuda-csr-batches", "segment_reduce_sum")]:
        b = rows.num_rows // batch
        fits = {}
        for p, sharded in [(1, False), (8, False), (8, True)]:
            est_box = []

            def setup(est, est_box=est_box):
                est_box.append(est)
                return warm(est)

            model, ms, launched = fit(spec, rows, p, sharded, 2, setup)
            assert est_box[-1].last_execution_path == engine, (
                est_box[-1].last_execution_path)
            fits[p, sharded] = (model, ms, launched)
        (m1, ms1, l1), (m8, ms8, l8), (s8, mss8, ls8) = (
            fits[1, False], fits[8, False], fits[8, True])
        if kernel:
            assert l1 == {kernel: 2 * b}, l1
            assert l8 == {kernel: 2 * 8 * b, "reduce_partials": b}, l8
            assert ls8 == l8, ls8
        else:
            assert l1 == {} and l8 == {"reduce_partials": b} == ls8, (l1, l8)
        np.testing.assert_allclose(s8.coefficients, m8.coefficients,
                                   rtol=1e-5, atol=1e-7)
        diff = np.abs(m8.coefficients - m1.coefficients)
        assert m8.model_version == m1.model_version == b
        assert np.all(diff <= BIG_FIT_RTOL * np.abs(m1.coefficients)
                      + BIG_FIT_ATOL), diff.max()
        log(f"  FTRL {kind} ({rows.num_rows} rows, {b} batches): fit ms 1 "
            f"shard {ms1:.3f}, 8 shards {ms8:.3f}, 8 sharded {mss8:.3f} "
            f"(bit-identical to replicated: "
            f"{same(s8.coefficients, m8.coefficients)}); launches 1 shard "
            f"{l1}, 8 shards {l8}; 8 against 1 shard max|coeff diff|="
            f"{diff.max():.3g} (max|coeff|={np.abs(m1.coefficients).max():.3g})")
        summary[f"FTRL {kind}"] = {"p1_ms": ms1, "p8_ms": ms8,
                                   "p8_sharded_ms": mss8, "p1_launches": l1,
                                   "p8_launches": l8}
        del rows
    del table, margin
    torch.cuda.empty_cache()

    # (d) a small fit with uneven local batches and a padded last shard
    # (4,003 rows of 20, global batch 801) on 8 shards: card against CPU
    from flink_ml_tpu_torch.models.classification import LogisticRegression

    small = _small_linear_table(Table, 41, 4003, 20, False)
    for sharded in (False, True):
        fitted = {}
        with mock.patch.dict(os.environ, {upd.ENV: str(int(sharded))}):
            for dev in ("cuda", "cpu"):
                est = LogisticRegression(
                    device=dev, mesh=create_mesh((8,), devices=[dev] * 8),
                    max_iter=15, global_batch_size=801, learning_rate=0.05,
                    reg=0.01, elastic_net=0.3, weight_col="weight")
                fitted[dev] = est.fit(small).coefficients
        np.testing.assert_allclose(fitted["cuda"], fitted["cpu"],
                                   rtol=SMALL_RTOL, atol=SMALL_ATOL)
    log("  LR on 8 shards, 4,003 x 20, global batch 801 (local batches 101 "
        "and 100, last shard 500 of 501 rows): card and CPU agree, "
        "replicated and sharded")

    counts = dict(K.launch_counts)
    log(f"  launches in the data-parallel run: {counts}")
    log("  data-parallel:", json.dumps(summary, sort_keys=True))
    for kern in PATH_KERNELS["parallel"]:
        assert counts[kern] >= 1, counts
    return counts


def _armed(**env):
    """The environment of ``env`` for a block (names of the
    ``flink_ml_tpu_torch.observability`` switches)."""
    return mock.patch.dict(os.environ, {k: str(v) for k, v in env.items()})


def phase_observability(K, runner):
    """Phase 12: the observability core on the card: traced, health-armed
    supervised segment fits of the LR and KMeans configs at full size, each
    held bit for bit against the same fit unarmed, then profiled fits whose
    device time the in-program profile reads per kernel."""
    from flink_ml_tpu_torch.iteration import iteration
    from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager
    from flink_ml_tpu_torch.observability import (compilestats, exporters,
                                                  health, profiling, tracing)
    from flink_ml_tpu_torch.resilience import RetryPolicy, faults

    log("phase 12: observability on the card")
    builds = compilestats.compile_totals()
    grp = exporters.metrics.group("ml", "compile")
    cached = sum(grp.get_counter("cached", labels={"fn": src})
                 for src in (K.KMEANS_SOURCE, K.SGD_SOURCE, K.SEGMENT_SOURCE,
                             K.KNN_SOURCE))
    log(f"  kernel builds recorded in phase 1: {builds['count']} compiled "
        f"(their nvcc wall times, which overlap, sum to "
        f"{builds['timeMs']:.1f} ms), {cached} cached")
    assert builds["count"] + cached == 4, (builds, cached)
    K.reset_launch_counts()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_observability_")
    tracer = tracing.tracer
    summary = {}
    try:
        cases = [
            ("LR", runner.load_config(str(LINEAR_CONFIGS["logisticregression"]))
             ["logisticregression"], 5, "LogisticRegression"),
            ("KMeans", runner.load_config(str(CONFIG))["KMeans"], 3,
             "KMeans"),
        ]
        for name, spec, k, algo in cases:
            table = runner.build_generator(spec).get_data()
            max_iter = spec["stage"]["paramMap"]["maxIter"]
            runs = {"unarmed": [], "armed": []}

            def result(model):
                return (model.coefficients if name == "LR"
                        else np.concatenate([model.centroids.ravel(),
                                             model.weights]))

            def supervised(tag, trace_dir=None):
                mgr = CheckpointManager(f"{workdir}/{name}-{tag}")
                est = (runner.build_stage(spec)
                       .set_iteration_config(iteration.IterationConfig(
                           checkpoint_interval=k, checkpoint_manager=mgr))
                       .set_retry_policy(RetryPolicy(backoff_s=0)))
                env = ({} if trace_dir is None else
                       {tracing.TRACE_DIR_ENV: trace_dir,
                        health.HEALTH_ENV: 1})
                if trace_dir is not None:
                    # the trace dir's snapshot is the process registry:
                    # start it empty, so it holds this fit's series alone
                    exporters.metrics.clear()
                with _armed(**env), faults.chaos(at={"epoch-boundary": [2]}):
                    model, ms = _timed_fit(est, table)
                tracer.shutdown()
                runs["unarmed" if trace_dir is None else "armed"].append(ms)
                return result(model)

            # unarmed, armed, armed, unarmed: the host's drift falls on both
            want = supervised("unarmed-0")
            trace_dir = f"{workdir}/{name}-trace"
            got = supervised("armed-0", trace_dir)
            supervised("armed-1", f"{workdir}/{name}-trace-1")
            assert np.array_equal(supervised("unarmed-1"), want)
            assert np.array_equal(got, want), f"{name}: armed fit differs"

            spans = exporters.read_spans(trace_dir)
            by_id = {sp["id"]: sp for sp in spans}
            (fit,) = [sp for sp in spans if sp["name"] == f"{algo}.fit"]
            segments = [sp for sp in spans if sp["name"] == "segment"]
            saves = [sp for sp in spans if sp["name"] == "checkpoint.save"]
            restores = [sp for sp in spans
                        if sp["name"] == "checkpoint.restore"]
            resumed = [sp for sp in restores if "checkpoint" in sp["attrs"]]
            restarts = [ev for sp in spans for ev in sp["events"]
                        if ev["name"] == "supervisor.restart"]
            assert fit["parent"] is None
            assert segments and all(sp["parent"] == fit["id"]
                                    for sp in segments)
            assert saves and all(by_id[sp["parent"]]["name"] == "segment"
                                 for sp in saves)
            assert len(resumed) == 1 and resumed[0]["attrs"]["epoch"] == k, (
                restores)
            assert len(restarts) == 1, restarts
            assert fit["attrs"]["hbm_peak_bytes"] > 0
            snap = exporters.read_metrics(trace_dir)
            it = snap["ml.iteration"]["counters"]
            assert it["boundaryFetches"] == it["boundaries"], it
            assert it["rounds"] == max_iter, it
            hgroup = snap["ml.health"]
            series = sorted(
                (ev["attrs"] for sp in spans for ev in sp["events"]
                 if ev["name"] == "ml.convergence"),
                key=lambda a: a["epoch"])
            assert [a["epoch"] for a in series] == list(range(k, max_iter))
            assert all(math.isfinite(v) for a in series
                       for key, v in a.items()
                       if key not in ("algo", "epoch"))
            assert hgroup["gauges"][f'epochs{{algo="{algo}"}}'] == max_iter
            summary[name] = {
                "unarmed_ms": min(runs["unarmed"]),
                "armed_ms": min(runs["armed"]),
                "boundaries": it["boundaries"], "rounds": it["rounds"],
                "spans": len(spans), "health_rows": len(series),
                "peak_bytes": fit["attrs"]["hbm_peak_bytes"]}
            log(f"  {name} supervised segments (K={k}), traced and "
                f"health-armed: {json.dumps(summary[name], sort_keys=True)}; "
                "bit-identical to unarmed")

            # profiled: the next traced fit (and, for KMeans, transform)
            # captures a torch.profiler window
            profiled = {}
            regions = [("fit", lambda: runner.build_stage(spec).fit(table))]
            if name == "KMeans":
                model = runner.build_stage(spec).fit(table)
                regions.append(("transform", lambda: model.transform(table)))
            for region, call in regions:
                pdir = f"{workdir}/{name}-{region}-profile"
                profiling.reset()
                with _armed(**{tracing.TRACE_DIR_ENV: pdir,
                               profiling.CAPTURE_ENV: 1}):
                    call()
                    torch.cuda.synchronize()
                tracer.shutdown()
                report = profiling.read_profile(pdir)
                eff = profiling.efficiency_report(pdir)
                assert report["source"] == "device", report["source"]
                for row in eff["fns"]:
                    if row["fn"] == "torch":
                        continue
                    launches = row["launches"]
                    share = row["utilization"]
                    assert launches, f"no launch cost in the window: {row}"
                    assert share is not None and 0.0 < share <= 1.0, row
                    profiled[row["fn"]] = {
                        "device_ms": row["deviceMs"], "launches": launches,
                        "ms_per_launch": row["deviceMs"] / launches,
                        "bound_ms": row["boundMs"], "share": share,
                        "bound": row["bound"]}
                torch_ms = sum(r["deviceMs"] for r in eff["fns"]
                               if r["fn"] == "torch")
                log(f"  {name} profiled {region}: PyTorch's own kernels "
                    f"{torch_ms:.4f} ms of device time; "
                    f"{len(report['ops'])} distinct kernels")
            for fn, row in sorted(profiled.items()):
                log(f"  {name} profile {fn}: {json.dumps(row, sort_keys=True)}")
            summary[name]["profile"] = profiled
            del table
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    counts = dict(K.launch_counts)
    seen = set(summary["LR"]["profile"]) | set(summary["KMeans"]["profile"])
    missing = set(PATH_KERNELS["observability"]) - seen
    assert not missing, f"no device rows in the profiles for {missing}"
    log(f"  launches in the observability run: {counts}")
    log("  observability:", json.dumps(summary, sort_keys=True))
    for kern in PATH_KERNELS["observability"]:
        assert counts[kern] >= 1, counts
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    started = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.benchmark import runner
    from flink_ml_tpu_torch.models.clustering import kmeans as kmeans_mod
    from flink_ml_tpu_torch.ops import kernels as K
    from flink_ml_tpu_torch.observability import compilestats
    from flink_ml_tpu_torch.ops import optimizer

    # build accounting (ml.compile) sees phase 1's builds; it records
    # builds only, so the unarmed phases 4-11 record nothing
    compilestats.install()
    phase_build(K)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("card:", card)
    measured = phase_kernels(K)
    measured.update(phase_sgd_kernels(K))
    # each path is driven with the counts at 0 and read just after; a
    # path's count of another path's kernels is 0
    counts = {"kmeans": phase_main_path(K, runner, kmeans_mod),
              "linear": phase_linear_main_path(K, runner, optimizer, Table)}
    measured.update(phase_knn_kernel(K))
    measured.update(phase_segment_kernel(K))
    counts["knn"] = phase_knn_main_path(K, runner, Table)
    counts["ftrl"] = phase_ftrl_main_path(K, runner, Table)
    counts["iteration"] = phase_iteration_modes(K, runner, Table)
    counts["parallel"] = phase_parallel(K, runner, optimizer, Table)
    counts["observability"] = phase_observability(K, runner)

    line = {"kernels": [
        {"name": name, **{key: K.KERNELS[name][key]
                          for key in ("route", "source", "replaces")},
         "launches": sum(c[name] for c in counts.values()),
         **measured[name]}
        for name in K.KERNELS]}
    missing = [r["name"] for r in line["kernels"] if r["launches"] < 1]
    assert not missing, f"kernels the main paths never launched: {missing}"
    for path, path_counts in counts.items():
        others = {k for p, ks in PATH_KERNELS.items() if p != path
                  for k in ks} - set(PATH_KERNELS[path])
        assert not any(path_counts[k] for k in others), (path, path_counts)
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
