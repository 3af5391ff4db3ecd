"""The plain references against the port at tiny sizes on the CPU, and the
TF32 rounding of the control."""

import numpy as np
import pytest
import torch

from portbench.harness.bench import load_module
from portbench.reference import to_tf32

kmeans_ref = load_module("reference", "kmeans")
lr_ref = load_module("reference", "logisticregression")


def test_tf32_keeps_ten_mantissa_bits_rounding_to_nearest_even():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + one_ulp / 4, 1.0 + 3 * one_ulp / 4,
                      1.0 + one_ulp / 2, 1.0 + 3 * one_ulp / 2, -1.5,
                      -(1.0 + 3 * one_ulp / 4), 0.0])
    want = torch.tensor([1.0, 1.0, 1.0 + one_ulp, 1.0, 1.0 + 2 * one_ulp,
                         -1.5, -(1.0 + one_ulp), 0.0])
    assert torch.equal(to_tf32(x), want)
    y = torch.rand(1000, generator=torch.Generator().manual_seed(0))
    r = to_tf32(y)
    assert torch.equal(r.view(torch.int32) & 0x1FFF,
                       torch.zeros(1000, dtype=torch.int32))
    assert float(((r - y).abs() / y).max()) <= 2.0 ** -11
    assert torch.equal(to_tf32(r), r)


def test_init_rows_are_the_ports():
    from flink_ml_tpu_torch.models.clustering.kmeans import initial_centroids

    x = torch.rand(500, 7, generator=torch.Generator().manual_seed(1))
    for seed in (0, 5, 3_000_000_123):
        rows = x[torch.as_tensor(kmeans_ref.init_indices(500, 10, seed))]
        assert torch.equal(rows, initial_centroids(x, 10, seed))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lloyd_round_is_the_ports(seed):
    from flink_ml_tpu_torch.models.clustering.kmeans import lloyd_round
    from flink_ml_tpu_torch.ops import kernels

    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(3000, 100, generator=gen)
    c = x[:10].clone()
    ref_c, ref_n = kmeans_ref.lloyd_round(x, c.double(), block_rows=1024)
    port_c, port_n = lloyd_round(kernels.lloyd_partial_sums_plain, x,
                                 torch.ones(3000), c)
    assert np.array_equal(ref_n.numpy(), port_n.double().numpy())
    assert np.abs(ref_c.numpy() - port_c.double().numpy()).max() < 1e-6


def test_lloyd_round_keeps_an_empty_cluster_and_counts_every_row():
    x = torch.tensor([[0.0, 0.0], [0.1, 0.0], [1.0, 1.0]])
    c = torch.tensor([[0.0, 0.0], [1.0, 1.0], [9.0, 9.0]], dtype=torch.float64)
    new, counts = kmeans_ref.lloyd_round(x, c)
    assert counts.tolist() == [2.0, 1.0, 0.0]
    assert torch.allclose(new, torch.tensor(
        [[0.05, 0.0], [1.0, 1.0], [9.0, 9.0]], dtype=torch.float64))


@pytest.mark.parametrize("n,batch", [(64, 100_000), (100, 30)])
def test_lr_fit_is_the_ports(n, batch):
    """The port's fit on the CPU (plain terms, float32) against the float64
    reference, including a batch that wraps around the table."""
    from flink_ml_tpu_torch.common.table import Table
    from flink_ml_tpu_torch.models.classification.logisticregression import (
        LogisticRegression)

    gen = torch.Generator().manual_seed(n)
    x = torch.rand(n, 512, generator=gen)
    y = torch.floor(torch.rand(n, generator=gen) * 2)
    params = {"maxIter": 20, "reg": 0.0, "elasticNet": 0.0,
              "learningRate": 0.1, "globalBatchSize": batch, "tol": 1e-6}
    stage = LogisticRegression(device="cpu")
    stage.params_from_json(params, strict=True)
    model = stage.fit(Table.from_columns(features=x, label=y))
    ref = lr_ref.fit(x, y, torch.ones(n), params, block_rows=16)
    # one round from the port's own state after 19 rounds
    stage.params_from_json({**params, "maxIter": 19}, strict=True)
    state = stage.fit(Table.from_columns(features=x, label=y)).coefficients
    offset = 0
    for _ in range(19):
        offset = 0 if offset + batch >= n else offset + batch
    one, _, _ = lr_ref.sgd_round(x, y, torch.ones(n), torch.as_tensor(
        state), offset, params)
    step = np.linalg.norm(one.numpy() - state)
    assert np.linalg.norm(model.coefficients - one.numpy()) / step < 1e-4
    gap = np.linalg.norm(model.coefficients - ref) / np.linalg.norm(ref)
    assert gap < 1e-5


def test_lr_fit_stops_at_tol():
    x = torch.zeros(8, 4)
    y = torch.ones(8)
    # margins stay 0: mean loss log 2 > tol, so every round runs ...
    params = {"maxIter": 3, "learningRate": 0.1, "globalBatchSize": 8,
              "tol": 1e-6}
    assert np.array_equal(lr_ref.fit(x, y, torch.ones(8), params),
                          np.zeros(4))
    # ... and a tol above it stops after the first round
    x[:, 0] = 1.0
    one = lr_ref.fit(x, y, torch.ones(8), {**params, "maxIter": 1})
    stopped = lr_ref.fit(x, y, torch.ones(8), {**params, "tol": 1.0})
    assert np.array_equal(one, stopped)
