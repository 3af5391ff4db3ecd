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
   plain version and a one-call PyTorch yardstick;
3. the same for the SGD kernel, for each loss: the main-path window (the
   first 100,000 rows of a 10,000,000 x 100 table), a window in the middle,
   the clipped window at the end, a ragged window, a one-row window,
   zero-weight rows, an odd width, rows so wide that the kernel stages
   them in column chunks (d = 1,500, and an odd d = 6,001), and margins
   that overflow exp for the logistic loss; the timed calls move their
   window on by lb each call, so none finds its rows in L2;
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
6. print one ``{"kernels": [...]}`` line with every kernel's launches in
   its main-path run, error, times and bound, then the result line.

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
- small linear fits on the card against the CPU: coefficients rtol
  SMALL_RTOL, atol SMALL_ATOL (a few hundred rows, sums in another order).
"""

import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
# reduce_partials, the second stage of both, is in neither tuple
KMEANS_KERNELS = ("assign_nearest", "lloyd_partial_sums")
SGD_KERNELS = ("sgd_batch_terms",)
LOSSES = ("logistic", "hinge", "least_square")

TIE_RTOL = 1e-5
SUM_RTOL, SUM_ATOL = 1e-4, 1e-3
CENTROID_ATOL = 1e-3
LABEL_AGREEMENT = 0.99
COEFF_RTOL, COEFF_ATOL = 1e-4, 1e-6
SMALL_RTOL, SMALL_ATOL = 1e-5, 1e-6

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


def rolling_starts(n, lb):
    """A function giving window starts that move on by lb at every call and
    wrap at the end of n rows: a timed call reads rows that the calls just
    before it did not leave in L2, as every round of a fit does."""
    starts = itertools.cycle(range(0, n - lb + 1, lb))
    return lambda: next(starts)


def bound_ms(nbytes, ops):
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
    assert torch.equal(r_got, r_want), "reduce differs from the in-order sum"
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
            bytes=4 * (n * d + k * d + k + n), ops=2 * n * k * d),
        "lloyd_partial_sums": dict(
            err=float((p_got - p_want).abs().max()),
            kernel=lambda: K.lloyd_partial_sums(x, v, c),
            plain=lambda: K.lloyd_partial_sums_plain(x, v, c),
            # the one-hot product alone, given the labels
            library=lambda: torch.matmul(one_hot.T, x_aug),
            bytes=4 * (n * d + n + k * d + k + k * (d + 1)),
            ops=2 * n * k * d + 2 * n * (d + 1)),
        "reduce_partials": dict(
            err=float((r_got - r_want).abs().max()),
            kernel=lambda: K.reduce_partials(partials),
            plain=lambda: K.reduce_partials_plain(partials),
            library=lambda: torch.sum(partials, dim=0),
            bytes=4 * (blocks + 1) * k * (d + 1), ops=blocks * k * (d + 1)),
    }
    measured = {}
    for name, r in rows.items():
        b_ms, b_by = bound_ms(r["bytes"], r["ops"])
        measured[name] = {
            "max_abs_err": r["err"], "ms": time_ms(r["kernel"]),
            "plain_ms": time_ms(r["plain"]), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": time_ms(r["library"])}
        log(f"  {name} @ 1M x 100, k=10: {measured[name]}")
    stage1 = time_ms(lambda: K._launch_lloyd_partials(x, v, c))
    log(f"  lloyd stage 1 alone: {stage1:.4f} ms over {blocks} blocks")
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
    log(f"  sgd_batch_terms {loss} {tag}: start={start} clip={clip} lb={lb} "
        f"d={x.shape[1]} max|err|={err:.3g}")
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
            assert (K._sgd_layout(dd)[1] < dd) == (dd > K.SGD_CHUNK_COLS), tag
    # margins far past exp's float32 range: the multipliers must come out
    # as +-0 or +-w, and the loss finite
    big = c * 1000
    got, want, _ = check_sgd(K, x, y, w, big, 0, 0, lb, "logistic", "overflow")

    # the shared second stage on this path's partials
    loss = "logistic"
    partials = K._launch_sgd_terms(x, y, w, c, 0, 0, lb, loss)
    assert torch.equal(K.reduce_partials(partials),
                       K.reduce_partials_plain(partials)), (
        "reduce differs from the in-order sum")
    blocks = partials.shape[0]
    log(f"  reduce_partials @ ({blocks}, {d + 2}): "
        f"{time_ms(lambda: K.reduce_partials(partials)):.5f} ms")

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
            bytes=4 * (lb * d + 2 * lb + d + d + 2), ops=4 * lb * d),
    }
    measured = {}
    for name, r in rows.items():
        b_ms, b_by = bound_ms(r["bytes"], r["ops"])
        measured[name] = {
            "max_abs_err": r["err"], "ms": time_ms(r["kernel"]),
            "plain_ms": time_ms(r["plain"]), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": time_ms(r["library"])}
        log(f"  {name} @ lb=100,000 of 10M x 100: {measured[name]}")
    stage1_start = rolling_starts(n, lb)
    stage1 = time_ms(lambda: K._launch_sgd_terms(x, y, w, c, stage1_start(),
                                                 0, lb, loss))
    log(f"  sgd stage 1 alone: {stage1:.4f} ms over {blocks} blocks")
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
    del x, y, w, mult, partials, xw
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
    assert counts["reduce_partials"] >= max_iter * fits, counts
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.benchmark import runner
    from flink_ml_tpu_torch.models.clustering import kmeans as kmeans_mod
    from flink_ml_tpu_torch.ops import kernels as K
    from flink_ml_tpu_torch.ops import optimizer

    phase_build(K)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("card:", card)
    measured = phase_kernels(K)
    measured.update(phase_sgd_kernels(K))
    # each path is driven with the counts at 0 and read just after; a
    # path's count of the other path's kernels is 0
    kmeans_counts = phase_main_path(K, runner, kmeans_mod)
    linear_counts = phase_linear_main_path(K, runner, optimizer, Table)

    line = {"kernels": [
        {"name": name, **{key: K.KERNELS[name][key]
                          for key in ("route", "source", "replaces")},
         "launches": kmeans_counts[name] + linear_counts[name],
         **measured[name]}
        for name in K.KERNELS]}
    missing = [r["name"] for r in line["kernels"] if r["launches"] < 1]
    assert not missing, f"kernels the main path never launched: {missing}"
    assert not any(linear_counts[k] for k in KMEANS_KERNELS), linear_counts
    assert not any(kmeans_counts[k] for k in SGD_KERNELS), kmeans_counts
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
