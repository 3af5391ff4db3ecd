"""The port's Pipeline, Graph and Table API, held against the JAX package.

The same numpy-seeded tables go through the JAX package (its fits pinned
to a one-device mesh, the port's single device's schedule) and the port
with ``device="cpu"``. Tolerances: scaler statistics rtol 1e-9 (float64
host fits on both sides) or 1e-5 (float32 tensor fits); LR coefficients
rtol 1e-5, atol 1e-7 (float32 fits adding in another order, as in
``test_torch_linear.py``); predictions exactly (data away from the
threshold); KMeans labels exactly (separated blobs).

Pipelines and graphs saved by either package load in the other's layout
(``numStages``, ``stages/<i>/``), and a JAX-saved PipelineModel or
GraphModel loaded in the port predicts what the JAX model predicts. On the
CPU, a tensor column one stage leaves is the next stage's input as it is.
"""

import numpy as np
import pytest
import torch

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.api import GraphBuilder as JaxGraphBuilder
from flink_ml_tpu.api import Pipeline as JaxPipeline
from flink_ml_tpu.models.classification import (
    LogisticRegression as JaxLogisticRegression,
)
from flink_ml_tpu.models.clustering import KMeans as JaxKMeans
from flink_ml_tpu.models import feature as jf
from flink_ml_tpu.parallel import create_mesh, set_default_mesh
from flink_ml_tpu.servable.api import DataFrame as JaxDataFrame
from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.api import (
    Graph,
    GraphBuilder,
    GraphModel,
    Pipeline,
    PipelineModel,
    TableId,
    Transformer,
)
from flink_ml_tpu_torch.models import feature as pf
from flink_ml_tpu_torch.models.classification import LogisticRegression
from flink_ml_tpu_torch.models.clustering import KMeans
from flink_ml_tpu_torch.servable.api import DataFrame, Row
from flink_ml_tpu_torch.utils import io as rw

COEF_RTOL, COEF_ATOL = 1e-5, 1e-7


@pytest.fixture(autouse=True)
def one_device_mesh():
    import jax

    set_default_mesh(create_mesh(devices=jax.devices()[:1]))
    try:
        yield
    finally:
        set_default_mesh(None)


def _np(col):
    return col.numpy() if isinstance(col, torch.Tensor) else np.asarray(col)


def _example_table(seed=4, n=300):
    rng = np.random.default_rng(seed)
    a, b = rng.normal(size=n) * 10, rng.normal(size=n)
    label = (a / 10 + b > 0.3).astype(np.float64)
    return dict(a=a, b=b, label=label)


def _readme_stages(pkg, **dev):
    """The README's assemble → scale → classify pipeline, in either
    package (``pkg`` is a namespace of its classes)."""
    return [pkg.VectorAssembler(input_cols=["a", "b"],
                                output_col="assembled", **dev),
            pkg.StandardScaler(input_col="assembled", output_col="features",
                               with_mean=True, **dev),
            pkg.LogisticRegression(max_iter=40, global_batch_size=100, **dev)]


class _Jax:
    VectorAssembler = jf.VectorAssembler
    StandardScaler = jf.StandardScaler
    LogisticRegression = JaxLogisticRegression


class _Port:
    VectorAssembler = pf.VectorAssembler
    StandardScaler = pf.StandardScaler
    LogisticRegression = LogisticRegression


def _fit_both(cols):
    want = JaxPipeline(_readme_stages(_Jax)).fit(JaxTable.from_columns(**cols))
    got = Pipeline(_readme_stages(_Port, device="cpu"), device="cpu") \
        .fit(Table.from_columns(**cols))
    return want, got


def _assert_pipeline_models_agree(got, want):
    g_scaler, w_scaler = got.stages[1], want.stages[1]
    np.testing.assert_allclose(g_scaler.mean, w_scaler.mean, rtol=1e-9)
    np.testing.assert_allclose(g_scaler.std, w_scaler.std, rtol=1e-9)
    np.testing.assert_allclose(got.stages[2].coefficients,
                               want.stages[2].coefficients,
                               rtol=COEF_RTOL, atol=COEF_ATOL)


def test_readme_pipeline_fit_transform_save_load_matches_jax(tmp_path):
    cols = _example_table()
    want, got = _fit_both(cols)
    assert isinstance(got, PipelineModel)
    assert [type(s).__name__ for s in got.stages] == [
        "VectorAssembler", "StandardScalerModel", "LogisticRegressionModel"]
    _assert_pipeline_models_agree(got, want)
    jax_out = want.transform(JaxTable.from_columns(**cols))[0]
    out = got.transform(Table.from_columns(**cols))[0]
    np.testing.assert_array_equal(_np(out["prediction"]),
                                  _np(jax_out["prediction"]))
    assert isinstance(out["features"], torch.Tensor)
    got.save(str(tmp_path / "port"))
    reloaded = PipelineModel.load(str(tmp_path / "port"), device="cpu")
    again = reloaded.transform(Table.from_columns(**cols))[0]
    np.testing.assert_array_equal(_np(again["prediction"]),
                                  _np(out["prediction"]))
    assert all(s._device == "cpu" for s in reloaded.stages)


@pytest.mark.parametrize("what", ["PipelineModel", "Pipeline"])
def test_jax_saved_pipelines_load_in_the_port(what, tmp_path):
    cols = _example_table(seed=6)
    if what == "PipelineModel":
        want, _ = _fit_both(cols)
    else:
        want = JaxPipeline(_readme_stages(_Jax))
    want.save(str(tmp_path / "jax"))
    loaded = rw.load_stage(str(tmp_path / "jax"), device="cpu")
    assert type(loaded).__name__ == what
    assert len(loaded.stages) == 3
    if what == "Pipeline":
        loaded = loaded.fit(Table.from_columns(**cols))
        want = want.fit(JaxTable.from_columns(**cols))
        _assert_pipeline_models_agree(loaded, want)
    jax_pred = want.transform(JaxTable.from_columns(**cols))[0]["prediction"]
    for table in (Table.from_columns(**cols),
                  Table.from_columns(**{k: torch.from_numpy(v)
                                        for k, v in cols.items()})):
        pred = loaded.transform(table)[0]["prediction"]
        np.testing.assert_array_equal(_np(pred), _np(jax_pred))


def test_port_saved_pipeline_model_loads_in_jax(tmp_path):
    cols = _example_table(seed=7)
    _, got = _fit_both(cols)
    got.save(str(tmp_path / "port"))
    meta = rw.load_metadata(str(tmp_path / "port"))
    assert meta["extra"] == {"numStages": 3}
    # the JAX loader resolves class names under its own package: rewrite
    # the port's names as the JAX package would have written them
    import json
    import pathlib

    for path in pathlib.Path(tmp_path / "port").rglob("metadata.json"):
        doc = json.loads(path.read_text())
        doc["className"] = doc["className"].replace("flink_ml_tpu_torch.",
                                                    "flink_ml_tpu.")
        path.write_text(json.dumps(doc))
    from flink_ml_tpu.api import PipelineModel as JaxPipelineModel

    jax_model = JaxPipelineModel.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(
        _np(jax_model.transform(JaxTable.from_columns(**cols))[0]
            ["prediction"]),
        _np(got.transform(Table.from_columns(**cols))[0]["prediction"]))


def _blobs(seed, n=240, d=4, k=3):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 10
    return centers[rng.integers(0, k, n)] + rng.normal(size=(n, d)) * 0.3


@pytest.mark.parametrize("kind", ["host", "tensor"])
def test_minmax_kmeans_pipeline_matches_jax(kind):
    x = _blobs(8)
    jcol = x if kind == "host" else x.astype(np.float32)
    pcol = x if kind == "host" else torch.from_numpy(x.astype(np.float32))
    stages = lambda pkg, **dev: [  # noqa: E731
        pkg[0](input_col="features", output_col="scaled", **dev),
        pkg[1](k=3, seed=2, max_iter=6, features_col="scaled", **dev)]
    want = JaxPipeline(stages((jf.MinMaxScaler, JaxKMeans))) \
        .fit(JaxTable.from_columns(features=jcol))
    got = Pipeline(stages((pf.MinMaxScaler, KMeans), device="cpu")) \
        .fit(Table.from_columns(features=pcol))
    np.testing.assert_allclose(got.stages[1].centroids,
                               want.stages[1].centroids, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(
        _np(got.transform(Table.from_columns(features=pcol))[0]
            ["prediction"]),
        _np(want.transform(JaxTable.from_columns(features=jcol))[0]
            ["prediction"]))


def test_pipeline_stages_after_the_last_estimator_are_kept_unfitted():
    cols = _example_table(seed=9)
    tail = pf.Normalizer(input_col="assembled", output_col="normed",
                         device="cpu")
    model = Pipeline(_readme_stages(_Port, device="cpu") + [tail]) \
        .fit(Table.from_columns(**cols))
    assert model.stages[-1] is tail
    out = model.transform(Table.from_columns(**cols))[0]
    assert {"prediction", "normed"} <= set(out.column_names)
    # no estimator at all: the stages as they are
    only = Pipeline([tail]).fit(Table.from_columns(**cols))
    assert only.stages == [tail]


class _TensorProbe(Transformer):
    """A pass-through stage that records the type of every column it is
    given."""

    seen = []

    def transform(self, table):
        type(self).seen.append({n: type(table[n]) for n in table.column_names})
        return (table,)


def test_tensor_columns_chain_between_stages_on_the_cpu(monkeypatch):
    x = _blobs(10, n=200, d=3)
    y = (x[:, 0] > np.median(x[:, 0])).astype(np.float32)
    table = Table.from_columns(features=torch.from_numpy(x.astype(np.float32)),
                               label=torch.from_numpy(y))
    _TensorProbe.seen = []
    # a tensor column never goes to the host on its way through the stages
    real_vectors = Table.vectors

    def no_off_ramp(self, name, dtype=np.float32):
        out = real_vectors(self, name, dtype)
        assert not (isinstance(self.column(name), torch.Tensor)
                    and isinstance(out, np.ndarray)), name
        return out

    monkeypatch.setattr(Table, "vectors", no_off_ramp)
    model = Pipeline([
        pf.StandardScaler(input_col="features", output_col="scaled",
                          with_mean=True, device="cpu"),
        _TensorProbe(device="cpu"),
        pf.MaxAbsScaler(input_col="scaled", output_col="maxabs",
                        device="cpu"),
        _TensorProbe(device="cpu"),
        LogisticRegression(features_col="maxabs", max_iter=5,
                           global_batch_size=50, device="cpu"),
    ]).fit(table)
    out = model.transform(table)[0]
    assert all(t is torch.Tensor for seen in _TensorProbe.seen
               for t in seen.values())
    assert isinstance(out["prediction"], torch.Tensor)
    scaled = model.stages[0].transform(table)[0]["scaled"]
    np.testing.assert_allclose(scaled.mean(0).numpy(), 0.0, atol=1e-5)


# -- graphs ------------------------------------------------------------------

def _graph_data(seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(200, 3)) * 5
    y = (x @ [1.0, -1.0, 2.0] > 0).astype(np.float64)
    return x, y


def _graph_example(pkg_builder, scaler_cls, lr_cls, **dev):
    """``examples/graph_example.py``'s DAG: a StandardScaler feeding
    LogisticRegression."""
    builder = pkg_builder()
    source = builder.create_table_id()
    (scaled,) = builder.add_estimator(
        scaler_cls(input_col="features", output_col="scaled", **dev),
        [source])
    (predictions,) = builder.add_estimator(
        lr_cls(features_col="scaled", max_iter=20, global_batch_size=200,
               **dev), [scaled])
    return builder.build_estimator([source], [predictions])


def test_graph_example_matches_jax_and_round_trips(tmp_path):
    x, y = _graph_data()
    want = _graph_example(JaxGraphBuilder, jf.StandardScaler,
                          JaxLogisticRegression) \
        .fit(JaxTable.from_columns(features=x, label=y))
    graph = _graph_example(GraphBuilder, pf.StandardScaler,
                           LogisticRegression, device="cpu")
    assert isinstance(graph, Graph)
    got = graph.fit(Table.from_columns(features=x, label=y))
    assert isinstance(got, GraphModel)
    np.testing.assert_allclose(got.nodes[1].stage.coefficients,
                               want.nodes[1].stage.coefficients,
                               rtol=COEF_RTOL, atol=COEF_ATOL)
    pred = got.transform(Table.from_columns(features=x, label=y))[0]
    np.testing.assert_array_equal(
        _np(pred["prediction"]),
        _np(want.transform(JaxTable.from_columns(features=x, label=y))[0]
            ["prediction"]))
    for obj, cls in ((graph, Graph), (got, GraphModel)):
        obj.save(str(tmp_path / cls.__name__))
        back = cls.load(str(tmp_path / cls.__name__), device="cpu")
        assert [n.outputs for n in back.nodes] == \
            [n.outputs for n in obj.nodes]
        model = back.fit(Table.from_columns(features=x, label=y)) \
            if cls is Graph else back
        np.testing.assert_array_equal(
            _np(model.transform(Table.from_columns(features=x, label=y))[0]
                ["prediction"]), _np(pred["prediction"]))
    # the JAX package's saved graph model, loaded in the port
    want.save(str(tmp_path / "jax"))
    loaded = rw.load_stage(str(tmp_path / "jax"), device="cpu")
    assert isinstance(loaded, GraphModel)
    np.testing.assert_array_equal(
        _np(loaded.transform(Table.from_columns(features=x, label=y))[0]
            ["prediction"]), _np(pred["prediction"]))


def test_graph_fan_out_and_model_data_edges():
    x, y = _graph_data(8)
    table = Table.from_columns(features=x, label=y)
    builder = GraphBuilder()
    src = builder.create_table_id()
    scaler = pf.StandardScaler(input_col="features", output_col="scaled",
                               device="cpu")
    (scaled,) = builder.add_estimator(scaler, [src])
    (md,) = builder.get_model_data(scaler)
    (pred,) = builder.add_estimator(
        LogisticRegression(features_col="scaled", max_iter=5,
                           global_batch_size=100, device="cpu"), [scaled])
    (clusters,) = builder.add_estimator(
        KMeans(k=2, seed=1, max_iter=3, features_col="scaled",
               device="cpu"), [scaled])
    model = builder.build_estimator([src], [pred, clusters, md]).fit(table)
    out_pred, out_clusters, model_data = model.transform(table)
    assert "prediction" in out_pred and "prediction" in out_clusters
    np.testing.assert_allclose(model_data.vectors("mean", np.float64)[0],
                               x.mean(axis=0), rtol=1e-12)

    # model data fed into a fresh model through the graph
    builder = GraphBuilder()
    src, md_in = builder.create_table_id(), builder.create_table_id()
    fresh = pf.StandardScalerModel(input_col="features", output_col="s2",
                                   device="cpu")
    (out,) = builder.add_algo_operator(fresh, [src])
    builder.set_model_data_on_model(fresh, md_in)
    op = builder.build_algo_operator([src, md_in], [out])
    (result,) = op.transform(table, model_data)
    np.testing.assert_allclose(result["s2"].numpy(),
                               (x / x.std(axis=0, ddof=1)).astype(np.float32),
                               rtol=1e-5)


def test_graph_errors_and_ids():
    builder = GraphBuilder()
    a, b = builder.create_table_id(), builder.create_table_id()
    assert a != b and isinstance(a, TableId) and repr(a) == "TableId(0)"
    (out,) = builder.add_algo_operator(
        pf.Normalizer(input_col="features", device="cpu"), [b])
    with pytest.raises(ValueError, match="unsatisfiable"):
        builder.build_algo_operator([a], [out]).transform(
            Table.from_columns(features=np.ones((2, 2))))
    with pytest.raises(ValueError, match="not found"):
        builder.set_model_data_on_estimator(
            pf.StandardScaler(device="cpu"), a)


# -- Table -------------------------------------------------------------------

def test_table_methods_match_jax(tmp_path):
    rows = [(1.0, "x", 3), (2.5, "y", 4), (-1.0, "z", 5)]
    jt = JaxTable.from_rows(rows, ["f", "s", "i"])
    pt = Table.from_rows(rows, ["f", "s", "i"])
    assert pt.rows() == jt.rows() and pt.to_dict() == jt.to_dict()
    for op in (lambda t: t.select("s", "f"), lambda t: t.drop("s"),
               lambda t: t.rename({"f": "g"}), lambda t: t.head(2),
               lambda t: t.head(-1), lambda t: t.head(9)):
        assert op(pt).rows() == op(jt).rows()
        assert op(pt).column_names == op(jt).column_names
    # CSV round trips, numeric and mixed, with and without a header
    for table, name in ((pt.select("f", "i"), "num.csv"), (pt, "mixed.csv")):
        table.to_csv(str(tmp_path / name))
        for kw in ({}, {"names": ["p", "q", "r"][:len(table.column_names)]}):
            got = Table.from_csv(str(tmp_path / name), **kw)
            want = JaxTable.from_csv(str(tmp_path / name), **kw)
            assert got.column_names == want.column_names
            for c in got.column_names:
                assert got[c].dtype == want[c].dtype
                assert list(got[c]) == list(want[c])
    got = Table.from_csv(str(tmp_path / "num.csv"), header=False)
    want = JaxTable.from_csv(str(tmp_path / "num.csv"), header=False)
    assert got.column_names == want.column_names == ["c0", "c1"]
    assert got.rows() == want.rows()
    with pytest.raises(ValueError, match="scalar"):
        Table.from_columns(v=np.ones((2, 2))).to_csv(str(tmp_path / "v.csv"))
    # a servable DataFrame
    from flink_ml_tpu.servable.api import DataTypes as JaxDataTypes
    from flink_ml_tpu.servable.api import Row as JaxRow
    from flink_ml_tpu_torch.servable.api import DataTypes

    df = DataFrame(["a", "b"], [DataTypes.DOUBLE, DataTypes.DOUBLE],
                   [Row([1.0, 2.0]), Row([3.0, 4.0])])
    jdf = JaxDataFrame(["a", "b"], [JaxDataTypes.DOUBLE, JaxDataTypes.DOUBLE],
                       [JaxRow([1.0, 2.0]), JaxRow([3.0, 4.0])])
    assert Table.from_data_frame(df).rows() == \
        JaxTable.from_data_frame(jdf).rows()


def test_table_take_with_a_tensor_index_keeps_tensor_columns_in_place():
    t = Table.from_columns(x=torch.arange(8.0).reshape(4, 2),
                           h=np.arange(4.0))
    sub = t.take(torch.tensor([3, 1]))
    assert isinstance(sub["x"], torch.Tensor)
    np.testing.assert_array_equal(sub["x"].numpy(), [[6.0, 7.0], [2.0, 3.0]])
    np.testing.assert_array_equal(sub["h"], [3.0, 1.0])
    assert t.take(slice(1, 3))["x"].data_ptr() == t["x"][1:].data_ptr()
