#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``flink_ml_tpu_torch``).

Run from the repository root on a machine with one CUDA card (Hopper):

    python3 chip_smoke.py

Phases, each of which fails the run (no result line, nonzero exit):

1. build the port's CUDA kernels from ``flink_ml_tpu_torch/csrc/`` with nvcc
   and print the card's name and power limit;
2. hold every kernel against its plain PyTorch version on the card, at the
   main-path shape (1,000,000 x 100, k = 10), a ragged n, n = 0, zero-weight
   rows, a wide k that makes the kernels stage centroids in chunks, and an
   odd width; reruns must be bit-identical; time kernel, plain version and a
   one-call PyTorch yardstick;
3. drive the main path as a user would: the benchmark runner on
   ``flink_ml_tpu/benchmark/configs/kmeans-benchmark.json`` (KMeans fit at
   full size), then transform of the same table, save, load and transform
   again; hold the fit against a plain PyTorch fit on the card and a small
   fit against the CPU;
4. print one ``{"kernels": [...]}`` line with every kernel's launches in the
   main-path run, error, times and bound, then the result line.

Tolerances (float32 throughout, TF32 off):
- labels: identical, except rows whose two nearest centroids are closer than
  TIE_RTOL (relative, in float64) — summation order decides those;
- partial sums: |kernel - plain| <= SUM_RTOL * |plain| + SUM_ATOL; counts
  exact wherever the labels agree;
- the main-path fit: centroids within CENTROID_ATOL of the plain fit's, and
  at least LABEL_AGREEMENT of its labels equal to the plain fit's. The
  benchmark's rows are uniform in [0, 1)^100 and have no cluster structure,
  so many rows sit near a boundary between clusters: the centroid drift that
  summation order causes over 10 rounds (about 3e-4) moves some tenths of a
  percent of the labels. The transform itself is held exactly (up to ties)
  against the plain assignment on the same centroids.
"""

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
CONFIG = REPO / "flink_ml_tpu" / "benchmark" / "configs" / "kmeans-benchmark.json"

TIE_RTOL = 1e-5
SUM_RTOL, SUM_ATOL = 1e-4, 1e-3
CENTROID_ATOL = 1e-3
LABEL_AGREEMENT = 0.99

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
    log("phase 2: kernels against their plain versions on the card")
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
    r_got = K.lloyd_reduce_partials(partials)
    r_want = K.lloyd_reduce_partials_plain(partials)
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
        "lloyd_reduce_partials": dict(
            err=float((r_got - r_want).abs().max()),
            kernel=lambda: K.lloyd_reduce_partials(partials),
            plain=lambda: K.lloyd_reduce_partials_plain(partials),
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


def phase_main_path(K, runner, kmeans_mod):
    log("phase 3: the KMeans main path through the port's entry points")
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
    assert counts["lloyd_reduce_partials"] >= max_iter, counts
    assert counts["assign_nearest"] >= 1, counts
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from flink_ml_tpu_torch.benchmark import runner
    from flink_ml_tpu_torch.models.clustering import kmeans as kmeans_mod
    from flink_ml_tpu_torch.ops import kernels as K

    phase_build(K)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    measured = phase_kernels(K)
    counts = phase_main_path(K, runner, kmeans_mod)

    line = {"kernels": [
        {"name": name, **{key: K.KERNELS[name][key]
                          for key in ("route", "source", "replaces")},
         "launches": counts[name], **measured[name]}
        for name in K.KERNELS]}
    missing = [r["name"] for r in line["kernels"] if r["launches"] < 1]
    assert not missing, f"kernels the main path never launched: {missing}"
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
