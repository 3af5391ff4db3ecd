"""The frozen arithmetic against hand-computed values and the program's own
count."""

import pytest

from portbench import cost
from portbench.harness.bench import load_module

KM = {"k": 10, "maxIter": 10}
LR = {"maxIter": 20, "globalBatchSize": 100_000}


def test_peaks_are_the_data_sheet_constants():
    assert cost.PEAK_FLOPS_F32 == 67e12
    assert cost.PEAK_BYTES_PER_S == 3.35e12


def test_kmeans_fit_reads_the_table_ten_times():
    nbytes, ops = load_module("cost", "kmeans").fit_cost(KM, 1_000_000, 100)
    # x, the row weights, the centroids in, the (k, d+1) partials out
    assert nbytes == 10 * 4 * (100_000_000 + 1_000_000 + 1_000 + 10 + 1_010)
    assert abs(nbytes - 10 * 400e6) / (10 * 400e6) < 0.011
    assert ops == 10 * (2 * 1_000_000 * 10 * 100 + 2 * 1_000_000 * 101)
    assert cost.floor_s(nbytes, ops) == pytest.approx(1.20599e-3, rel=1e-4)


def test_lr_fit_reads_the_window_twenty_times():
    """20 windows of 100,000 rows of 100 features: 40 MB each, 800 MB a
    fit, 4 operations a feature (the dot's and mult · x's multiply-adds)."""
    nbytes, ops = load_module("cost", "logisticregression").fit_cost(
        LR, 10_000_000, 100)
    assert nbytes == 20 * 4 * (100_000 * 100 + 2 * 100_000 + 2 * 100 + 2)
    assert abs(nbytes - 20 * 40e6) / (20 * 40e6) < 0.021
    assert ops == 20 * 4 * 100_000 * 100
    assert cost.floor_s(nbytes, ops) == pytest.approx(2.4359e-4, rel=1e-4)


def test_lr_window_is_the_table_when_the_table_is_smaller():
    nbytes, ops = load_module("cost", "logisticregression").fit_cost(
        LR, 10_000, 262_144)
    assert nbytes == 20 * 4 * (10_000 * 262_144 + 2 * 10_000
                               + 2 * 262_144 + 2)
    assert ops == 20 * 4 * 10_000 * 262_144


@pytest.mark.parametrize("name,dims", [
    ("lloyd_partial_sums", {"n": 1_000_000, "k": 10, "d": 100}),
    ("lloyd_partial_sums", {"n": 1_000, "k": 1_024, "d": 1_536}),
    ("reduce_partials", {"blocks": 391, "inner": 1_010}),
    ("sgd_batch_terms", {"lb": 10_000, "d": 262_144}),
    ("sgd_batch_terms", {"lb": 1_250, "d": 2_097_152}),
])
def test_copy_matches_the_program_today(name, dims):
    from flink_ml_tpu_torch.ops import kernels

    assert cost.launch_cost(name, **dims) == kernels.launch_cost(name, **dims)


def test_unknown_kernel_raises():
    with pytest.raises(KeyError):
        cost.launch_cost("knn_topk_indices", n=1, nt=1, d=1, k=1)
