"""The port's KMeans slice, held against the JAX package end to end.

The same numpy tables, made from a seed, go through the JAX package on its
CPU mesh and through the port with ``device="cpu"`` (the plain PyTorch
versions of the kernels). Tolerances: labels and counts exact (the data sit
far from any tie); centroids rtol 1e-5, atol 1e-5 (float32 means whose sums
are added in a different order — across 8 mesh shards in the JAX package).
"""

import json

import numpy as np
import pytest
import torch

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.benchmark import datagen as jax_datagen
from flink_ml_tpu.benchmark import runner as jax_runner
from flink_ml_tpu.models.clustering import KMeans as JaxKMeans
from flink_ml_tpu.models.clustering import KMeansModel as JaxKMeansModel
from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.benchmark import datagen, runner
from flink_ml_tpu_torch.convert import kmeans_model_from_arrays
from flink_ml_tpu_torch.models.clustering import KMeans, KMeansModel
from flink_ml_tpu_torch.utils import io as rw

RTOL = ATOL = 1e-5
CONFIG = "flink_ml_tpu/benchmark/configs/kmeans-benchmark.json"


def _blobs(seed, n, d, k):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 10
    return centers[rng.integers(0, k, n)] + rng.normal(size=(n, d)) * 0.2


def _labels(table, col="prediction"):
    values = table[col]
    return values.numpy() if isinstance(values, torch.Tensor) else np.asarray(values)


@pytest.mark.parametrize("n,d,k,max_iter,measure", [
    (300, 8, 3, 5, "euclidean"),
    (250, 16, 4, 10, "euclidean"),
    (200, 6, 3, 4, "manhattan"),
    (200, 6, 3, 4, "cosine"),
])
def test_fit_transform_matches_jax(n, d, k, max_iter, measure):
    x = _blobs(n + d, n, d, k)
    params = dict(k=k, seed=11, max_iter=max_iter, distance_measure=measure)
    want = JaxKMeans(**params).fit(JaxTable.from_columns(features=x))
    model = KMeans(device="cpu", **params).fit(Table.from_columns(features=x))

    np.testing.assert_allclose(model.centroids, want.centroids,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(model.weights, want.weights)
    assert model.weights.sum() == n
    labels = _labels(model.transform(Table.from_columns(features=x))[0])
    jax_labels = _labels(want.transform(JaxTable.from_columns(features=x))[0])
    np.testing.assert_array_equal(labels, jax_labels)
    assert model.last_execution_path == "torch-assign"


def test_fit_execution_path_names_the_plain_version_on_cpu():
    x = _blobs(0, 100, 4, 2)
    est = KMeans(k=2, seed=1, max_iter=2, device="cpu")
    est.fit(Table.from_columns(features=x))
    assert est.last_execution_path == "torch-lloyd"


def test_empty_cluster_keeps_its_position_like_jax():
    # two distinct points, three clusters: two initial centroids coincide,
    # the first minimum takes every row, and the other cluster stays empty
    x = np.repeat(np.array([[0.0, 0.0], [5.0, 5.0]]), 20, axis=0)
    params = dict(k=3, seed=4, max_iter=3)
    want = JaxKMeans(**params).fit(JaxTable.from_columns(features=x))
    got = KMeans(device="cpu", **params).fit(Table.from_columns(features=x))
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.weights, want.weights)
    assert 0.0 in got.weights


def test_fewer_rows_than_clusters_repeat_like_jax():
    x = np.array([[0.0, 1.0], [2.0, 3.0]])
    params = dict(k=3, seed=0, max_iter=2)
    want = JaxKMeans(**params).fit(JaxTable.from_columns(features=x))
    got = KMeans(device="cpu", **params).fit(Table.from_columns(features=x))
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=RTOL, atol=ATOL)


def test_jax_saved_model_loads_in_port(tmp_path):
    x = _blobs(3, 240, 5, 4)
    jax_model = JaxKMeans(k=4, seed=2, max_iter=6,
                          prediction_col="cluster").fit(
        JaxTable.from_columns(features=x))
    jax_model.save(str(tmp_path / "m"))
    meta = rw.load_metadata(str(tmp_path / "m"))
    assert meta["className"].startswith("flink_ml_tpu.models.")

    loaded = rw.load_stage(str(tmp_path / "m"), device="cpu")
    assert type(loaded) is KMeansModel
    assert loaded.prediction_col == "cluster" and loaded.k == 4
    np.testing.assert_array_equal(loaded.centroids, jax_model.centroids)
    np.testing.assert_array_equal(loaded.weights, jax_model.weights)
    labels = _labels(loaded.transform(Table.from_columns(features=x))[0],
                     "cluster")
    want = _labels(jax_model.transform(JaxTable.from_columns(features=x))[0],
                   "cluster")
    np.testing.assert_array_equal(labels, want)


def test_port_model_save_load_round_trip(tmp_path):
    x = _blobs(8, 150, 3, 3)
    model = KMeans(k=3, seed=5, max_iter=4, device="cpu").fit(
        Table.from_columns(features=x))
    model.save(str(tmp_path / "p"))
    loaded = KMeansModel.load(str(tmp_path / "p"), device="cpu")
    np.testing.assert_array_equal(loaded.centroids, model.centroids)
    assert loaded.params_to_json_str() == model.params_to_json_str()
    table = Table.from_columns(features=x)
    np.testing.assert_array_equal(_labels(loaded.transform(table)[0]),
                                  _labels(model.transform(table)[0]))
    # model data as a table, and back
    again = KMeansModel(device="cpu").set_model_data(model.get_model_data()[0])
    np.testing.assert_array_equal(again.centroids, model.centroids)
    np.testing.assert_array_equal(again.weights, model.weights)


def test_convert_kmeans_model_from_arrays_matches_jax():
    x = _blobs(9, 200, 6, 5)
    rng = np.random.default_rng(1)
    centroids, weights = rng.normal(size=(5, 6)) * 10, rng.random(5)
    jax_model = JaxKMeansModel(centroids=centroids, weights=weights, k=5)
    model = kmeans_model_from_arrays(centroids, weights, device="cpu", k=5)
    np.testing.assert_array_equal(
        _labels(model.transform(Table.from_columns(features=x))[0]),
        _labels(jax_model.transform(JaxTable.from_columns(features=x))[0]))
    got, want = model.get_model_data()[0], jax_model.get_model_data()[0]
    np.testing.assert_array_equal(got.vectors("centroid", np.float64),
                                  want.vectors("centroid", np.float64))
    np.testing.assert_array_equal(got.scalars("weight", np.float64),
                                  want.scalars("weight", np.float64))
    with pytest.raises(ValueError):
        kmeans_model_from_arrays(centroids, weights[:3], device="cpu")


def test_params_json_round_trip_across_packages():
    port = KMeans(k=7, seed=3, max_iter=12, distance_measure="cosine",
                  features_col="f")
    jax = JaxKMeans(k=7, seed=3, max_iter=12, distance_measure="cosine",
                    features_col="f")
    assert port.params_to_json_str() == jax.params_to_json_str()
    assert (KMeans().params_from_json(json.loads(jax.params_to_json_str()))
            .params_to_json_str() == jax.params_to_json_str())
    assert (JaxKMeans().params_from_json(json.loads(port.params_to_json_str()))
            .params_to_json_str() == port.params_to_json_str())
    assert (KMeansModel().params_to_json_str()
            == JaxKMeansModel().params_to_json_str())
    with pytest.raises(ValueError):
        KMeans().params_from_json({"noSuchParam": 1}, strict=True)


@pytest.mark.parametrize("n,d,seed", [(1000, 10, 2), (37, 3, None)])
def test_datagen_matches_jax_below_device_threshold(n, d, seed):
    params = dict(col_names=[["features"]], num_values=n, vector_dim=d)
    if seed is not None:
        params["seed"] = seed
    got = datagen.DenseVectorGenerator(device="cpu", **params).get_data()
    want = jax_datagen.DenseVectorGenerator(**params).get_data()
    assert isinstance(got["features"], np.ndarray)
    np.testing.assert_array_equal(got["features"], np.asarray(want["features"]))


def test_datagen_above_threshold_generates_on_the_device():
    gen = datagen.DenseVectorGenerator(
        device="cpu", seed=2, col_names=[["features"]], num_values=21000,
        vector_dim=100)
    col = gen.get_data()["features"]
    assert isinstance(col, torch.Tensor) and col.dtype == torch.float32
    assert tuple(col.shape) == (21000, 100)
    assert 0.0 <= float(col.min()) and float(col.max()) < 1.0
    assert torch.equal(col, gen.get_data()["features"])  # seeded


def test_runner_row_schema_matches_jax():
    spec = runner.load_config(CONFIG)["KMeans"]
    assert spec == jax_runner.load_config(CONFIG)["KMeans"]
    spec["inputData"]["paramMap"]["numValues"] = 500
    spec["inputData"]["paramMap"]["vectorDim"] = 4
    row = runner.run_benchmark("KMeans", spec, device="cpu")
    jax_row = jax_runner.run_benchmark("KMeans", spec)
    shared = {"totalTimeMs", "inputRecordNum", "inputThroughput",
              "outputRecordNum", "outputThroughput", "dataGenTimeMs",
              "executeTimeMs", "inputBytes", "achievedGBps", "executionPath"}
    assert shared <= set(row) and shared <= set(jax_row)
    assert row["inputRecordNum"] == jax_row["inputRecordNum"] == 500
    assert row["outputRecordNum"] == jax_row["outputRecordNum"] == 10
    assert row["inputBytes"] == jax_row["inputBytes"]
    assert row["executionPath"] == "torch-lloyd" and row["device"] == "cpu"
    best = runner.best_of("KMeans", spec, runs=1, device="cpu")
    assert best["warmupTimeMs"] > 0


def test_runner_cli_prints_results(tmp_path, capsys):
    spec = runner.load_config(CONFIG)
    spec["KMeans"]["inputData"]["paramMap"].update(numValues=64, vectorDim=3)
    path = tmp_path / "c.json"
    path.write_text(json.dumps({"version": 1, **spec}))
    assert runner.main([str(path), "--device", "cpu",
                        "--output-file", str(tmp_path / "r.json")]) == 0
    out = json.loads((tmp_path / "r.json").read_text())
    assert out["KMeans"]["results"]["inputRecordNum"] == 64
