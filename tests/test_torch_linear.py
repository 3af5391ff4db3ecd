"""The port's linear models, held against the JAX package end to end.

The same numpy tables, made from a seed, go through the JAX estimators and
through the port's with ``device="cpu"`` (the plain PyTorch version of the
``sgd_batch_terms`` kernel). The JAX default mesh is pinned to one device
for each fit and restored afterwards: on the tests' 8-device mesh every
shard would take its own share of each minibatch, another schedule than
the port's single device.

Tolerances: coefficients rtol 1e-5, atol 1e-7 (float32 fits whose sums are
added in another order; see ``test_torch_sgd.py``); float prediction
columns rtol 1e-5, atol 1e-5 (a margin near 0 is a float32 sum of terms of
order 5, so its rounding is some 1e-6 absolute); 0/1 predictions exactly,
on data whose margins sit away from the decision threshold.
"""

import json

import numpy as np
import pytest
import torch

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.benchmark import datagen as jax_datagen
from flink_ml_tpu.benchmark import runner as jax_runner
from flink_ml_tpu.models.classification import LinearSVC as JaxLinearSVC
from flink_ml_tpu.models.classification import (
    LogisticRegression as JaxLogisticRegression,
)
from flink_ml_tpu.models.classification import (
    LogisticRegressionModel as JaxLogisticRegressionModel,
)
from flink_ml_tpu.models.regression import LinearRegression as JaxLinearRegression
from flink_ml_tpu.parallel import create_mesh, set_default_mesh
from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.benchmark import datagen, runner
from flink_ml_tpu_torch.convert import linear_model_from_arrays
from flink_ml_tpu_torch.models.classification import (
    LinearSVC,
    LinearSVCModel,
    LogisticRegression,
    LogisticRegressionModel,
)
from flink_ml_tpu_torch.models.regression import (
    LinearRegression,
    LinearRegressionModel,
)
from flink_ml_tpu_torch.utils import io as rw

RTOL, ATOL = 1e-5, 1e-7
PRED_ATOL = 1e-5
CONFIGS = "flink_ml_tpu/benchmark/configs/"

PAIRS = {
    "LogisticRegression": (JaxLogisticRegression, LogisticRegression),
    "LinearSVC": (JaxLinearSVC, LinearSVC),
    "LinearRegression": (JaxLinearRegression, LinearRegression),
}


@pytest.fixture
def one_device_mesh():
    import jax

    set_default_mesh(create_mesh(devices=jax.devices()[:1]))
    try:
        yield
    finally:
        set_default_mesh(None)


def _np(values):
    return (values.numpy() if isinstance(values, torch.Tensor)
            else np.asarray(values))


def _table(seed, n, d, regression=False, weights=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    truth = rng.normal(size=d) * 2
    margin = x @ truth
    if regression:
        y = margin + 0.1 * rng.normal(size=n)
    else:
        y = (margin > 0).astype(np.float64)
    cols = dict(features=x, label=y)
    if weights:
        cols["weight"] = rng.random(n) + 0.5
    return cols


def _check_predictions(got_table, want_table, columns, exact=()):
    for col in columns:
        got, want = _np(got_table[col]), _np(want_table[col])
        assert got.shape == want.shape, col
        if col in exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=PRED_ATOL)


@pytest.mark.parametrize("name", sorted(PAIRS))
@pytest.mark.parametrize("weighted,optimizer", [
    (False, "sgd"), (True, "sgd"), (True, "adam")])
def test_estimator_fit_transform_matches_jax(one_device_mesh, name, weighted,
                                             optimizer):
    jax_cls, port_cls = PAIRS[name]
    cols = _table(3, 400, 7, regression=name == "LinearRegression",
                  weights=weighted)
    params = dict(max_iter=15, global_batch_size=96, learning_rate=0.05,
                  reg=0.01, elastic_net=0.3, optimizer=optimizer, tol=0.0)
    if weighted:
        params["weight_col"] = "weight"
    jax_est = jax_cls(**params)
    want = jax_est.fit(JaxTable.from_columns(**cols))
    est = port_cls(device="cpu", **params)
    model = est.fit(Table.from_columns(**cols))
    assert est.last_execution_path == "torch-sgd"
    assert jax_est.last_execution_path == "xla-unrolled"
    assert model.coefficients.dtype == np.float64
    np.testing.assert_allclose(model.coefficients, want.coefficients,
                               rtol=RTOL, atol=ATOL)
    assert model.params_to_json_str() == want.params_to_json_str()

    got_out = model.transform(Table.from_columns(**cols))[0]
    want_out = want.transform(JaxTable.from_columns(**cols))[0]
    columns = ["prediction"] + (["rawPrediction"]
                                if name != "LinearRegression" else [])
    assert set(got_out.column_names) == set(want_out.column_names)
    exact = () if name == "LinearRegression" else ("prediction",)
    _check_predictions(got_out, want_out, columns, exact)
    assert got_out["prediction"].dtype == torch.float32


def test_threshold_and_column_names_follow_params(one_device_mesh):
    cols = _table(5, 200, 4)
    params = dict(max_iter=5, global_batch_size=50, threshold=0.4,
                  prediction_col="p", raw_prediction_col="raw")
    want = JaxLinearSVC(**params).fit(JaxTable.from_columns(**cols))
    model = LinearSVC(device="cpu", **params).fit(Table.from_columns(**cols))
    got_out = model.transform(Table.from_columns(**cols))[0]
    want_out = want.transform(JaxTable.from_columns(**cols))[0]
    _check_predictions(got_out, want_out, ["p", "raw"], exact=("p",))
    assert _np(got_out["p"]).sum() < len(cols["label"])


def test_device_label_column_stays_a_tensor(monkeypatch):
    cols = _table(6, 120, 3)
    table = Table.from_columns(
        features=torch.as_tensor(cols["features"], dtype=torch.float32),
        label=torch.as_tensor(cols["label"], dtype=torch.float32))

    def no_host(*args, **kwargs):
        raise AssertionError("a tensor label column went to the host")

    monkeypatch.setattr(Table, "scalars", no_host)
    model = LogisticRegression(device="cpu", max_iter=3).fit(table)
    assert model.coefficients.shape == (3,)


def test_jax_saved_model_loads_in_port(one_device_mesh, tmp_path):
    cols = _table(7, 300, 5)
    jax_model = JaxLogisticRegression(
        max_iter=8, global_batch_size=64, prediction_col="pred").fit(
        JaxTable.from_columns(**cols))
    jax_model.save(str(tmp_path / "m"))
    assert rw.load_metadata(str(tmp_path / "m"))["className"].startswith(
        "flink_ml_tpu.models.classification.logisticregression.")
    loaded = rw.load_stage(str(tmp_path / "m"), device="cpu")
    assert type(loaded) is LogisticRegressionModel
    assert loaded.prediction_col == "pred"
    np.testing.assert_array_equal(loaded.coefficients, jax_model.coefficients)
    got = loaded.transform(Table.from_columns(**cols))[0]
    want = jax_model.transform(JaxTable.from_columns(**cols))[0]
    _check_predictions(got, want, ["pred", "rawPrediction"], exact=("pred",))


@pytest.mark.parametrize("model_name", ["LogisticRegressionModel",
                                        "LinearSVCModel",
                                        "LinearRegressionModel"])
def test_port_model_save_load_and_model_data(tmp_path, model_name):
    port_cls = {"LogisticRegressionModel": LogisticRegressionModel,
                "LinearSVCModel": LinearSVCModel,
                "LinearRegressionModel": LinearRegressionModel}[model_name]
    cols = _table(8, 90, 4)
    coeffs = np.random.default_rng(2).normal(size=4)
    model = port_cls(coefficients=coeffs, device="cpu")
    model.save(str(tmp_path / "p"))
    loaded = port_cls.load(str(tmp_path / "p"), device="cpu")
    np.testing.assert_array_equal(loaded.coefficients, coeffs)
    table = Table.from_columns(**cols)
    assert torch.equal(loaded.transform(table)[0]["prediction"],
                       model.transform(table)[0]["prediction"])
    again = port_cls(device="cpu").set_model_data(model.get_model_data()[0])
    np.testing.assert_array_equal(again.coefficients, coeffs)
    with pytest.raises(ValueError, match="no model data"):
        port_cls(device="cpu").transform(table)


def test_convert_linear_model_from_arrays_matches_jax():
    cols = _table(9, 150, 6)
    coeffs = np.random.default_rng(3).normal(size=6)
    jax_model = JaxLogisticRegressionModel(coefficients=coeffs)
    model = linear_model_from_arrays(LogisticRegressionModel, coeffs,
                                     device="cpu")
    _check_predictions(model.transform(Table.from_columns(**cols))[0],
                       jax_model.transform(JaxTable.from_columns(**cols))[0],
                       ["prediction", "rawPrediction"], exact=("prediction",))
    svc = linear_model_from_arrays(LinearSVCModel, coeffs, device="cpu",
                                   threshold=0.5)
    assert svc.threshold == 0.5
    with pytest.raises(ValueError):
        linear_model_from_arrays(LinearSVCModel, coeffs[None, :])
    with pytest.raises(TypeError):
        linear_model_from_arrays(JaxLogisticRegressionModel, coeffs)


def test_params_json_round_trip_across_packages():
    params = dict(max_iter=7, reg=0.2, elastic_net=0.5, learning_rate=0.3,
                  global_batch_size=128, tol=1e-4, weight_col="w",
                  optimizer="momentum", momentum=0.5)
    for jax_cls, port_cls in PAIRS.values():
        port, jax = port_cls(**params), jax_cls(**params)
        assert port.params_to_json_str() == jax.params_to_json_str()
        assert (port_cls().params_from_json(
            json.loads(jax.params_to_json_str()), strict=True)
            .params_to_json_str() == jax.params_to_json_str())


@pytest.mark.parametrize("n,d,arities,seed", [
    (1000, 10, (0, 2), 2), (37, 3, (3, 10), None), (500, 100, (2, 0), 5)])
def test_labeled_point_datagen_matches_jax_below_threshold(n, d, arities,
                                                           seed):
    params = dict(col_names=[["features", "label", "weight"]], num_values=n,
                  vector_dim=d, feature_arity=arities[0],
                  label_arity=arities[1])
    if seed is not None:
        params["seed"] = seed
    got = datagen.LabeledPointWithWeightGenerator(device="cpu",
                                                  **params).get_data()
    want = jax_datagen.LabeledPointWithWeightGenerator(**params).get_data()
    for col in ("features", "label", "weight"):
        assert isinstance(got[col], np.ndarray)
        np.testing.assert_array_equal(got[col], np.asarray(want[col]))


def test_labeled_point_datagen_above_threshold_generates_on_the_device():
    gen = datagen.LabeledPointWithWeightGenerator(
        device="cpu", seed=2, col_names=[["f", "l", "w"]], num_values=21000,
        vector_dim=100, feature_arity=0, label_arity=10)
    table = gen.get_data()
    f, lab, w = table["f"], table["l"], table["w"]
    for col in (f, lab, w):
        assert isinstance(col, torch.Tensor) and col.dtype == torch.float32
    assert tuple(f.shape) == (21000, 100)
    assert tuple(lab.shape) == tuple(w.shape) == (21000,)
    assert 0.0 <= float(f.min()) and float(f.max()) < 1.0
    assert 0.0 <= float(w.min()) and float(w.max()) < 1.0
    assert torch.equal(lab, torch.floor(lab))
    assert set(torch.unique(lab).tolist()) == set(range(10))
    # one stream per column: the label draws are not the weight draws
    assert not torch.equal(lab / 10, torch.floor(w * 10) / 10)
    assert torch.equal(f, gen.get_data()["f"])  # seeded


@pytest.mark.parametrize("config,name,cls_name", [
    ("logisticregression-benchmark.json", "logisticregression",
     "LogisticRegression"),
    ("linearsvc-benchmark.json", "linearsvc", "LinearSVC"),
    ("linearregression-benchmark.json", "linearregression",
     "LinearRegression")])
def test_runner_row_schema_matches_jax(config, name, cls_name):
    spec = runner.load_config(CONFIGS + config)[name]
    assert spec == jax_runner.load_config(CONFIGS + config)[name]
    spec["inputData"]["paramMap"]["numValues"] = 600
    spec["inputData"]["paramMap"]["vectorDim"] = 5
    spec["stage"]["paramMap"]["globalBatchSize"] = 128
    assert type(runner.build_stage(spec, device="cpu")).__name__ == cls_name
    row = runner.run_benchmark(name, spec, device="cpu")
    jax_row = jax_runner.run_benchmark(name, spec)
    shared = {"totalTimeMs", "inputRecordNum", "inputThroughput",
              "outputRecordNum", "outputThroughput", "dataGenTimeMs",
              "executeTimeMs", "inputBytes", "achievedGBps", "executionPath"}
    assert shared <= set(row) and shared <= set(jax_row)
    assert row["inputRecordNum"] == jax_row["inputRecordNum"] == 600
    assert row["outputRecordNum"] == jax_row["outputRecordNum"] == 1
    assert row["inputBytes"] == jax_row["inputBytes"]
    assert row["executionPath"] == "torch-sgd" and row["device"] == "cpu"
