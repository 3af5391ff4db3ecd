"""The port's CSR-fed linear models (``SGD.optimize_csr`` on the segment
kernel, the CSR branch of the linear estimators and models), held against
the JAX package on the CPU, where the port's segment sums run their plain
versions (``torch-csr``).

The same seeded numpy inputs go through both packages. The JAX fits are
pinned to a mesh of as many devices as the port's virtual shards, so both
slice the batches alike.

Tolerances:
- port CSR against the JAX package's CSR fit (float64 scipy on the host,
  where the port's rounds are float32): coefficients rtol 1e-4, atol 1e-6;
- port CSR against the port's dense fit of the same rows, full pattern
  (both float32, sums in another order): rtol 1e-5, atol 1e-6;
- predictions of a CSR column against the dense column's: exactly (the
  JAX package's own test); margins rtol 1e-6, atol 1e-6;
- host rounds, segments and a crash-resume against the all-device fit:
  exactly.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from flink_ml_tpu.common.table import Table as JaxTable
from flink_ml_tpu.linalg import sparse as jax_sparse
from flink_ml_tpu.models import classification as jax_cls
from flink_ml_tpu.models import regression as jax_reg
from flink_ml_tpu.parallel import create_mesh, set_default_mesh
from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.iteration import (
    CheckpointManager,
    IterationConfig,
    IterationListener,
)
from flink_ml_tpu_torch.linalg import sparse
from flink_ml_tpu_torch.models import classification, regression
from flink_ml_tpu_torch.ops import kernels, losses, optimizer
from flink_ml_tpu_torch.parallel import create_mesh as port_create_mesh

JAX_RTOL, JAX_ATOL = 1e-4, 1e-6
DENSE_RTOL, DENSE_ATOL = 1e-5, 1e-6

ESTIMATORS = {
    "logistic": (classification.LogisticRegression,
                 jax_cls.LogisticRegression),
    "hinge": (classification.LinearSVC, jax_cls.LinearSVC),
    "least_square": (regression.LinearRegression, jax_reg.LinearRegression),
}


@pytest.fixture
def jax_mesh():
    """Pins the JAX package's default mesh to ``n`` devices."""
    import jax

    def pin(n):
        set_default_mesh(create_mesh(devices=jax.devices()[:n]))

    yield pin
    set_default_mesh(None)


def _data(seed, n, d, density=1.0, regression=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    if density < 1.0:
        x[rng.random((n, d)) >= density] = 0.0
    w_true = rng.normal(size=d)
    y = x @ w_true if regression else (x @ w_true > 0).astype(np.float64)
    w = rng.random(n) + 0.5
    return sp.csr_matrix(x), y, w


def _full_pattern(x):
    """A CSR matrix storing every coordinate, zeros included (so dense and
    sparse semantics coincide)."""
    dense = x.toarray()
    n, d = dense.shape
    return sp.csr_matrix((dense.ravel(), np.tile(np.arange(d), n),
                          np.arange(0, n * d + 1, d)), shape=(n, d))


def _fit(cls, col, y, w=None, table=Table, **params):
    cols = dict(features=col, label=y)
    if w is not None:
        cols["weight"] = w
        params["weight_col"] = "weight"
    est = cls(**params)
    return est, est.fit(table.from_columns(**cols))


def _port(loss, x, y, w=None, shards=1, **params):
    mesh = port_create_mesh((shards,), devices=["cpu"] * shards) \
        if shards > 1 else None
    return _fit(ESTIMATORS[loss][0], sparse.CsrVectorColumn(x), y, w,
                device="cpu", mesh=mesh, **params)


def _jax(loss, x, y, w=None, **params):
    return _fit(ESTIMATORS[loss][1], jax_sparse.CsrVectorColumn(x), y, w,
                table=JaxTable, **params)


@pytest.mark.parametrize("loss", sorted(ESTIMATORS))
@pytest.mark.parametrize("density", [1.0, 0.3])
def test_sgd_csr_matches_jax_csr_fit(jax_mesh, loss, density):
    jax_mesh(1)
    x, y, w = _data(1, 500, 12, density, regression=loss == "least_square")
    params = dict(global_batch_size=120, max_iter=15, reg=0.01,
                  elastic_net=0.5)
    est, got = _port(loss, x, y, w, **params)
    jest, want = _jax(loss, x, y, w, **params)
    assert est.last_execution_path == "torch-csr"
    assert jest.last_execution_path == "csr-host"
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               rtol=JAX_RTOL, atol=JAX_ATOL)
    assert got.params_to_json_str() == want.params_to_json_str()


@pytest.mark.parametrize("shards", [2, 3])
def test_sgd_csr_on_virtual_shards_matches_jax_mesh(jax_mesh, shards):
    """A CSR fit on 2 (and 3) virtual shards slices its batches as the JAX
    package's on a mesh of as many devices: a ragged last shard, a batch
    share with a remainder, the clip at the shard end and the wrap."""
    jax_mesh(shards)
    x, y, w = _data(2, 203, 9, 0.5)
    params = dict(global_batch_size=37, max_iter=12, learning_rate=0.3)
    est, got = _port("logistic", x, y, w, shards=shards, **params)
    _, want = _jax("logistic", x, y, w, **params)
    assert est.mesh.size == shards
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               rtol=JAX_RTOL, atol=JAX_ATOL)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("loss", sorted(ESTIMATORS))
def test_sgd_csr_matches_port_dense_fit(loss, shards):
    """Full pattern: the CSR rounds and the dense rounds see the same rows
    in the same windows, so the fits agree to float32 sums."""
    x, y, w = _data(3, 400, 7, regression=loss == "least_square")
    params = dict(global_batch_size=90, max_iter=10, reg=0.02,
                  elastic_net=0.3)
    mesh = port_create_mesh((shards,), devices=["cpu"] * shards) \
        if shards > 1 else None
    _, dense = _fit(ESTIMATORS[loss][0], x.toarray(), y, w, device="cpu",
                    mesh=mesh, **params)
    _, got = _port(loss, _full_pattern(x), y, w, shards=shards, **params)
    np.testing.assert_allclose(got.coefficients, dense.coefficients,
                               rtol=DENSE_RTOL, atol=DENSE_ATOL)


@pytest.mark.parametrize("method", ["momentum", "adam"])
def test_sgd_csr_stateful_rules_match_dense(method):
    x, y, w = _data(4, 300, 6)
    params = dict(global_batch_size=64, max_iter=8, optimizer=method)
    _, dense = _fit(classification.LogisticRegression, x.toarray(), y, w,
                    device="cpu", **params)
    _, got = _port("logistic", _full_pattern(x), y, w, **params)
    np.testing.assert_allclose(got.coefficients, dense.coefficients,
                               rtol=DENSE_RTOL, atol=DENSE_ATOL)


def test_sgd_csr_sharded_update_matches_replicated(monkeypatch):
    x, y, w = _data(5, 250, 11, 0.4)
    params = dict(global_batch_size=50, max_iter=6, optimizer="momentum")
    _, want = _port("logistic", x, y, w, shards=2, **params)
    monkeypatch.setenv("FLINK_ML_TPU_UPDATE_SHARDING", "1")
    _, got = _port("logistic", x, y, w, shards=2, **params)
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               rtol=DENSE_RTOL, atol=DENSE_ATOL)


@pytest.mark.parametrize("window", [(0, 0, 40), (10, 5, 30), (20, 0, 0),
                                    (0, 12, 12), (33, 0, 17)])
@pytest.mark.parametrize("loss", sorted(ESTIMATORS))
def test_csr_batch_terms_match_dense_terms(loss, window):
    """A CSR window's [Σ mult·x | Σ w | Σ loss] against the dense plain
    terms of the same window (rows below ``clip`` weigh 0)."""
    start, clip, lb = window
    x, y, w = _data(6, 50, 8, 0.5)
    coeffs = torch.from_numpy(np.random.default_rng(1).normal(
        size=8).astype(np.float32))
    yt, wt = (torch.from_numpy(a.astype(np.float32)) for a in (y, w))
    want = kernels.sgd_batch_terms_plain(
        torch.from_numpy(x.toarray().astype(np.float32)), yt, wt, coeffs,
        start, clip, lb, loss)
    got = optimizer.csr_batch_terms(optimizer.CsrShard(x, torch.device(
        "cpu")), yt, wt, coeffs, start, clip, lb, loss)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_csr_shard_layout():
    x, _, _ = _data(7, 9, 5, 0.4)
    shard = optimizer.CsrShard(x, torch.device("cpu"))
    assert shard.indices.dtype == torch.int32
    assert shard.data.dtype == torch.float32
    np.testing.assert_array_equal(shard.indptr_host, x.indptr)
    assert shard.rows.dtype == torch.int32
    np.testing.assert_array_equal(shard.rows.numpy(),
                                  np.repeat(np.arange(9), np.diff(x.indptr)))
    assert shard.shape == (9, 5) and shard.device == torch.device("cpu")


def test_sgd_optimize_routes_csr_with_two_launches_a_round(monkeypatch):
    """optimize hands a CSR matrix to optimize_csr; each round calls the
    segment sums twice per shard (the dots, then the gradient)."""
    x, y, w = _data(8, 120, 6, 0.5)
    calls = []
    real = kernels.segment_reduce_sum

    def spy(values, ids, u):
        calls.append(u)
        return real(values, ids, u)

    monkeypatch.setattr(kernels, "segment_reduce_sum", spy)
    sgd = optimizer.SGD(optimizer.SGDParams(global_batch_size=40,
                                            max_iter=5, tol=0.0))
    coeffs, loss = sgd.optimize(losses.BinaryLogisticLoss(), np.zeros(6), x,
                                y, w, device="cpu")
    assert sgd.last_execution_path == "torch-csr"
    assert calls == [40, 6] * 5
    assert coeffs.dtype == np.float64 and np.isfinite(loss)


def test_sparse_predict_matches_dense():
    x, y, _ = _data(9, 100, 5, 0.5)
    dense_t = Table.from_columns(features=x.toarray(), label=y)
    for cls in (classification.LogisticRegression, classification.LinearSVC,
                regression.LinearRegression):
        model = cls(global_batch_size=50, device="cpu").fit(dense_t)
        want = model.transform(dense_t)[0]
        got = model.transform(Table.from_columns(
            features=sparse.CsrVectorColumn(x), label=y))[0]
        if cls is regression.LinearRegression:
            np.testing.assert_allclose(got["prediction"].numpy(),
                                       want["prediction"].numpy(),
                                       rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got["prediction"].numpy(),
                                          want["prediction"].numpy())
            assert got["prediction"].dtype == want["prediction"].dtype


def test_sparse_predict_matches_jax():
    x, y, _ = _data(10, 80, 6, 0.5)
    jmodel = jax_cls.LogisticRegression(global_batch_size=40).fit(
        JaxTable.from_columns(features=x.toarray(), label=y))
    from flink_ml_tpu_torch.convert import linear_model_from_arrays

    model = linear_model_from_arrays(classification.LogisticRegressionModel,
                                     jmodel.coefficients, device="cpu")
    got = model.transform(Table.from_columns(
        features=sparse.CsrVectorColumn(x)))[0]
    want = jmodel.transform(JaxTable.from_columns(
        features=jax_sparse.CsrVectorColumn(x)))[0]
    np.testing.assert_array_equal(got["prediction"].numpy(),
                                  np.asarray(want["prediction"]))
    np.testing.assert_allclose(got["rawPrediction"].numpy(),
                               np.asarray(want["rawPrediction"]), rtol=1e-6,
                               atol=1e-6)


def test_object_column_of_sparse_vectors_takes_csr(monkeypatch):
    from flink_ml_tpu_torch.linalg.vectors import SparseVector

    x, y, _ = _data(11, 60, 4, 0.5)
    col = np.empty(60, dtype=object)
    for i in range(60):
        row = x.getrow(i)
        col[i] = SparseVector(4, row.indices, row.data)
    est = classification.LogisticRegression(global_batch_size=20,
                                            device="cpu")
    model = est.fit(Table.from_columns(features=col, label=y))
    assert est.last_execution_path == "torch-csr"
    _, want = _port("logistic", x, y, global_batch_size=20)
    np.testing.assert_array_equal(model.coefficients, want.coefficients)


def test_csr_fit_never_densifies(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("densified")

    x, y, _ = _data(12, 200, 50, 0.1)
    monkeypatch.setattr(sparse.CsrVectorColumn, "to_dense", refuse)
    monkeypatch.setattr(sp.csr_matrix, "toarray", refuse)
    t = Table.from_columns(features=sparse.CsrVectorColumn(x), label=y)
    model = classification.LogisticRegression(
        global_batch_size=50, device="cpu").fit(t)
    assert model.transform(t)[0]["prediction"].shape == (200,)


def test_sparse_fit_host_mode_matches_plain():
    x, y, _ = _data(13, 60, 4)
    t = Table.from_columns(f=sparse.CsrVectorColumn(x), l=y)

    def est():
        return classification.LogisticRegression(
            features_col="f", label_col="l", global_batch_size=16,
            max_iter=9, device="cpu")

    plain = est()
    expected = plain.fit(t).coefficients
    host = est().set_iteration_config(IterationConfig(mode="host"))
    got = host.fit(t).coefficients
    assert plain.last_execution_path == "torch-csr"
    assert host.last_execution_path == "torch-csr-rounds"
    np.testing.assert_array_equal(got, expected)


def test_sparse_fit_segments_match_plain(tmp_path):
    x, y, _ = _data(14, 90, 5, 0.6)
    t = Table.from_columns(f=sparse.CsrVectorColumn(x), l=y)

    def est():
        return classification.LinearSVC(
            features_col="f", label_col="l", global_batch_size=25,
            max_iter=11, device="cpu")

    expected = est().fit(t).coefficients
    seg = est().set_iteration_config(IterationConfig(
        checkpoint_interval=3,
        checkpoint_manager=CheckpointManager(str(tmp_path / "ck"))))
    got = seg.fit(t).coefficients
    assert seg.last_execution_path == "torch-csr-segments"
    np.testing.assert_array_equal(got, expected)


class _Crash(Exception):
    pass


class _CrashAt(IterationListener):
    def __init__(self, at):
        self.at = at

    def on_epoch_watermark_incremented(self, epoch, carry):
        if epoch == self.at:
            raise _Crash()


def test_sparse_fit_crash_resume_identical_result(tmp_path):
    """A crash mid-fit and a resume from the newest checkpoint reproduce
    the uninterrupted CSR fit bit for bit."""
    x, y, _ = _data(15, 80, 6, 0.5)
    t = Table.from_columns(f=sparse.CsrVectorColumn(x), l=y)

    def est():
        return classification.LogisticRegression(
            features_col="f", label_col="l", global_batch_size=32,
            max_iter=10, device="cpu")

    expected = est().fit(t).coefficients
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    cfg = IterationConfig(mode="host", checkpoint_interval=2,
                          checkpoint_manager=mgr)
    with pytest.raises(_Crash):
        est().set_iteration_config(cfg, listeners=[_CrashAt(6)]).fit(t)
    assert mgr.list_checkpoints()
    resumed = est().set_iteration_config(cfg).fit(t).coefficients
    np.testing.assert_array_equal(resumed, expected)
    assert not mgr.list_checkpoints()


def test_csr_fit_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, _ = _data(16, 20, 3, 0.5)
    t = Table.from_columns(features=sparse.CsrVectorColumn(x), label=y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        classification.LogisticRegression().fit(t)


def test_csr_fit_with_health_and_drift_armed(monkeypatch):
    """Armed, a CSR fit records its per-round series and attaches the drift
    and quality baselines of its CSR sample, and its coefficients are the
    unarmed fit's bits, as the dense fit's are."""
    x, y, _ = _data(17, 150, 8, 0.4)
    t = Table.from_columns(features=sparse.CsrVectorColumn(x), label=y)

    def fit():
        return classification.LogisticRegression(
            global_batch_size=50, max_iter=6, device="cpu").fit(t)

    plain = fit()
    for env in ("FLINK_ML_TPU_HEALTH", "FLINK_ML_TPU_DRIFT",
                "FLINK_ML_TPU_QUALITY"):
        monkeypatch.setenv(env, "1")
    armed = fit()
    np.testing.assert_array_equal(armed.coefficients, plain.coefficients)
    assert armed.drift_baseline is not None
    assert armed.quality_baseline is not None
    assert getattr(plain, "drift_baseline", None) is None
