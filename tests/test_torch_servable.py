"""The port's servables, held against the JAX package's.

Modelled on tests/test_servable.py and the serving half of
test_serving_telemetry.py. The same numpy-seeded inputs go through both
packages:

- the byte codecs: ``LogisticRegressionModelData`` and the dense and
  sparse vectors encode to the same bytes and decode each other's;
- LR predictions: the host path (float64 numpy in both) is bit for bit the
  JAX host path; the device path (``device="cpu"`` here, the JAX jitted
  product on the CPU) gives dots within rtol 1e-5 and the same predictions
  on inputs whose margins are all at least 1e-4 away from zero (the test
  counts those rows and requires none);
- the device path never falls back to the host: without a card it raises,
  and a card that cannot run raises out of ``transform``;
- saved models: a JAX-saved LR model and pipeline load as the port's
  servables; a stage without a servable is refused;
- the ``_served`` wrapper: the same request sequence (successes, a
  ``RejectedRequest``, an error) leaves the same metric keys and counts in
  both registries, the batcher's ``drift_real_rows`` and
  ``request_segments`` markers feed the drift window and the feedback join
  alike, and a telemetry fault is logged, never raised.
"""

import io
import logging
import types

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the conftest pins it to the CPU)

from flink_ml_tpu.api import Pipeline as JaxPipeline
from flink_ml_tpu.common.table import Table as JaxTable
from flink_ml_tpu.common.table import as_dense_vector_column
from flink_ml_tpu.models.classification import (
    LogisticRegression as JaxLogisticRegression,
)
from flink_ml_tpu.models.clustering import KMeans as JaxKMeans
from flink_ml_tpu.parallel import create_mesh as jax_create_mesh
from flink_ml_tpu.parallel import set_default_mesh as jax_set_default_mesh

PKGS = ("jax", "torch")
_NS = {}


def _namespace(name):
    if name in _NS:
        return _NS[name]
    if name == "jax":
        from flink_ml_tpu.common import metrics as metrics_mod
        from flink_ml_tpu.linalg import vectors
        from flink_ml_tpu.observability import drift, evaluation, health
        from flink_ml_tpu.servable import api, builder, lr
    else:
        from flink_ml_tpu_torch.common import metrics as metrics_mod
        from flink_ml_tpu_torch.linalg import vectors
        from flink_ml_tpu_torch.observability import (drift, evaluation,
                                                      health)
        from flink_ml_tpu_torch.servable import api, builder, lr
    ns = types.SimpleNamespace(
        name=name, api=api, lr=lr, builder=builder, drift=drift,
        evaluation=evaluation, health=health, vectors=vectors,
        metrics=metrics_mod.metrics, ML_GROUP=metrics_mod.ML_GROUP)
    _NS[name] = ns
    return ns


@pytest.fixture(params=PKGS)
def pkg(request):
    return _namespace(request.param)


JAX, PORT = _namespace("jax"), _namespace("torch")


@pytest.fixture(autouse=True)
def _clean():
    for ns in (JAX, PORT):
        ns.drift.clear()
        ns.evaluation.clear()
    yield
    for ns in (JAX, PORT):
        ns.drift.clear()
        ns.evaluation.clear()


def make_df(ns, x):
    return ns.api.DataFrame(
        ["features"], [ns.api.DataTypes.vector()],
        [ns.api.Row([ns.vectors.DenseVector(v)]) for v in x])


def servable(ns, coef, version=0, device=False):
    sv = ns.lr.LogisticRegressionModelServable()
    if device:
        if ns.name == "torch":
            sv.set_device_predict(True, device="cpu")
        else:
            sv.set_device_predict(True)
    sv.model_data = ns.lr.LogisticRegressionModelData(coef, version)
    return sv


def outputs(df):
    return (np.asarray(df.get("prediction").values),
            np.asarray([v.to_array() for v in df.get("rawPrediction")
                        .values]))


# -- the API and the codecs ----------------------------------------------------

def test_dataframe_api(pkg):
    df = make_df(pkg, np.eye(2))
    assert df.column_names == ["features"]
    df.add_column("id", pkg.api.DataTypes.INT, [1, 2])
    assert df.get("id").values == [1, 2]
    assert df.collect()[0].size() == 2
    assert df.get_data_type("id") == pkg.api.DataTypes.INT
    with pytest.raises(ValueError):
        df.add_column("bad", pkg.api.DataTypes.INT, [1])
    with pytest.raises(ValueError):
        df.get_index("missing")
    with pytest.raises(ValueError):
        pkg.api.DataFrame(["a"], [], [])
    assert pkg.api.serving_name(pkg.api.TransformerServable()) == (
        "TransformerServable")


@pytest.mark.parametrize("seed,dim,version", [(0, 1, 0), (1, 7, 3),
                                              (2, 100, 2**40 + 5)])
def test_model_data_encodes_and_decodes_byte_for_byte(seed, dim, version):
    coef = np.random.default_rng(seed).normal(size=dim)
    jax_bytes = JAX.lr.LogisticRegressionModelData(coef, version).encode()
    port_bytes = PORT.lr.LogisticRegressionModelData(coef, version).encode()
    assert port_bytes == jax_bytes
    for data in (JAX.lr.LogisticRegressionModelData.decode(port_bytes),
                 PORT.lr.LogisticRegressionModelData.decode(jax_bytes)):
        np.testing.assert_array_equal(data.coefficient, coef)
        assert data.model_version == version


def test_vector_codecs_match():
    dense = np.random.default_rng(3).normal(size=9)
    for mod_a, mod_b in ((JAX.vectors, PORT.vectors),
                         (PORT.vectors, JAX.vectors)):
        d = mod_a.DenseVector(dense)
        s = mod_a.SparseVector(12, [7, 1, 4], [0.5, -2.0, 3.0])
        for vec in (d, s):
            back = mod_b.Vector.from_bytes(vec.to_bytes())
            np.testing.assert_array_equal(back.to_array(), vec.to_array())
            assert back.to_bytes() == vec.to_bytes()
    with pytest.raises(ValueError, match="kind byte"):
        PORT.vectors.Vector.from_bytes(b"\x07")


def test_set_model_data_stream_from_jax_bytes():
    md = JAX.lr.LogisticRegressionModelData(np.array([2.0, 0.0]), 4)
    sv = PORT.lr.LogisticRegressionModelServable()
    sv.set_model_data(io.BytesIO(md.encode()))
    assert sv.model_data.model_version == 4
    out = sv.transform(make_df(PORT, np.array([[1.0, 0.0], [-1.0, 0.0]])))
    assert out.get("prediction").values == [1.0, 0.0]


# -- predictions -----------------------------------------------------------------

@pytest.mark.parametrize("seed,n,dim", [(10, 1, 3), (11, 37, 16),
                                        (12, 128, 100)])
def test_host_predict_is_the_jax_host_predict(seed, n, dim):
    rng = np.random.default_rng(seed)
    coef, x = rng.normal(size=dim), rng.normal(size=(n, dim))
    jp, jr = outputs(servable(JAX, coef).transform(make_df(JAX, x)))
    pp, pr = outputs(servable(PORT, coef).transform(make_df(PORT, x)))
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pr, jr)


@pytest.mark.parametrize("seed,n,dim", [(20, 1, 3), (21, 8, 16),
                                        (22, 32, 100), (23, 128, 100)])
def test_device_predict_matches_jax_jitted_predict(seed, n, dim):
    rng = np.random.default_rng(seed)
    coef, x = rng.normal(size=dim), rng.normal(size=(n, dim))
    dots64 = x @ coef
    near_zero = int(np.sum(np.abs(dots64) < 1e-4))
    assert near_zero == 0  # these seeds have no near-zero margins
    jsv, psv = servable(JAX, coef, device=True), servable(PORT, coef,
                                                          device=True)
    jp, jr = outputs(jsv.transform(make_df(JAX, x)))
    pp, pr = outputs(psv.transform(make_df(PORT, x)))
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pp, (dots64 >= 0).astype(float))
    # dots through the probabilities: p = 1 - 1/(1+e^dot)
    np.testing.assert_allclose(np.log(pr[:, 1] / pr[:, 0]),
                               np.log(jr[:, 1] / jr[:, 0]), rtol=1e-5,
                               atol=1e-6)
    pd = psv._device_dots(np.asarray(x, np.float32))
    assert pd.dtype == np.float64
    np.testing.assert_allclose(pd, dots64, rtol=1e-5, atol=1e-5)


def test_device_coefficient_placed_once_per_version():
    sv = servable(PORT, np.ones(4), version=1, device=True)
    sv.aot_warm(8)
    first = sv._device_coef()
    sv.transform(make_df(PORT, np.eye(4)))
    assert sv._device_coef() is first
    assert first.dtype == torch.float32 and first.device.type == "cpu"
    sv.model_data = PORT.lr.LogisticRegressionModelData(np.zeros(4), 2)
    assert sv._device_coef() is not first
    np.testing.assert_array_equal(sv._device_coef().numpy(), np.zeros(4))


def test_aot_warm_runs_the_device_product_only_with_device_predict(
        monkeypatch):
    calls = []
    for device in (False, True):
        sv = servable(PORT, np.ones(3), device=device)
        monkeypatch.setattr(sv, "_device_dots",
                            lambda x: calls.append(x.shape))
        sv.aot_warm(16)
    assert calls == [(16, 3)]
    empty = PORT.lr.LogisticRegressionModelServable().set_device_predict(
        True, device="cpu")
    empty.aot_warm(4)  # no model data: nothing to warm


def test_device_predict_defaults_to_the_card_and_never_falls_back(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sv = PORT.lr.LogisticRegressionModelServable()
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        sv.set_device_predict(True)
    # a card that is there but cannot run (this CPU build) raises out of
    # transform: nothing quietly predicts on the host instead
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    sv.set_device_predict(True)
    assert sv.device == torch.device("cuda", 0)
    sv.model_data = PORT.lr.LogisticRegressionModelData(np.ones(2))
    with pytest.raises((RuntimeError, AssertionError)):
        sv.transform(make_df(PORT, np.eye(2)))
    sv.set_device_predict(False)
    assert sv.device is None
    assert sv.transform(make_df(PORT, np.eye(2))).get(
        "prediction").values == [1.0, 1.0]


def test_set_mesh_keeps_single_device_and_refuses_sharding():
    from flink_ml_tpu_torch.parallel import create_mesh

    sv = servable(PORT, np.ones(3), device=True)
    assert sv.set_mesh(None) is sv
    assert sv.set_mesh(create_mesh((1,), devices=["cpu"])) is sv
    with pytest.raises(NotImplementedError, match="meshstats"):
        sv.set_mesh(create_mesh((8,), devices=["cpu"] * 8))


def test_no_model_data_raises(pkg):
    with pytest.raises(ValueError, match="no model data"):
        pkg.lr.LogisticRegressionModelServable().transform(
            make_df(pkg, np.eye(2)))


# -- saved models -----------------------------------------------------------------

def _jax_table(rng, n, w):
    x = rng.normal(size=(n, len(w)))
    y = (x @ np.asarray(w) > 0).astype(np.float64)
    return x, JaxTable.from_columns(features=as_dense_vector_column(x),
                                    label=y)


def test_jax_saved_model_and_pipeline_load_as_port_servables(tmp_path):
    from flink_ml_tpu_torch.servable import PipelineModelServable

    rng = np.random.default_rng(42)
    x, table = _jax_table(rng, 60, [1.0, 2.0, -1.0])
    jax_set_default_mesh(jax_create_mesh(devices=jax.devices()[:1]))
    try:
        model = JaxLogisticRegression(max_iter=10,
                                      global_batch_size=60).fit(table)
        model.save(str(tmp_path / "lr"))
        pm = JaxPipeline([JaxLogisticRegression(
            max_iter=10, global_batch_size=60)]).fit(table)
        pm.save(str(tmp_path / "pipe"))
    finally:
        jax_set_default_mesh(None)
    want_lr = JAX.lr.LogisticRegressionModelServable.load(
        str(tmp_path / "lr")).transform(make_df(JAX, x))
    for loaded in (PORT.lr.LogisticRegressionModelServable.load(
            str(tmp_path / "lr")),
            PORT.builder.load_servable(str(tmp_path / "lr"))):
        out = loaded.transform(make_df(PORT, x))
        np.testing.assert_array_equal(outputs(out)[0], outputs(want_lr)[0])
        np.testing.assert_array_equal(outputs(out)[1], outputs(want_lr)[1])
    pipe = PipelineModelServable.load(str(tmp_path / "pipe"))
    np.testing.assert_array_equal(
        pipe.transform(make_df(PORT, x)).get("prediction").values,
        pm.transform(table)[0]["prediction"])


def test_pipeline_servable_unsupported_stage(tmp_path):
    x = np.random.default_rng(1).normal(size=(30, 2)).astype(np.float32)
    pm = JaxPipeline([JaxKMeans(k=2, seed=0)]).fit(
        JaxTable.from_columns(features=x))
    pm.save(str(tmp_path / "pk"))
    with pytest.raises(ValueError, match="no servable"):
        PORT.builder.PipelineModelServable.load(str(tmp_path / "pk"))


# -- the _served wrapper ------------------------------------------------------------

def _request_sequence(ns):
    """Three good transforms, a shed one and a failing one, all under one
    serving name."""
    class Shedding(ns.api.TransformerServable):
        def transform(self, df):
            raise ns.api.RejectedRequest("shed", "queue-full")

    class Failing(ns.api.TransformerServable):
        def transform(self, df):
            raise KeyError("boom")

    rng = np.random.default_rng(77)
    lr = servable(ns, rng.normal(size=5))
    shed, fail = Shedding(), Failing()
    for sv in (lr, shed, fail):
        sv.serving_name = "seq@v1"
    for n in (1, 4, 9):
        lr.transform(make_df(ns, rng.normal(size=(n, 5))))
    with pytest.raises(ns.api.RejectedRequest):
        shed.transform(make_df(ns, np.eye(5)))
    with pytest.raises(KeyError):
        fail.transform(make_df(ns, np.eye(5)))


def _serving_view(ns):
    snap = ns.metrics.snapshot()
    out = {}
    for group, gsnap in snap.items():
        if not group.startswith(f"{ns.ML_GROUP}.serving"):
            continue
        out["counters"] = dict(gsnap.get("counters", {}))
        out["gauges"] = {k: v for k, v in gsnap.get("gauges", {}).items()}
        out["histograms"] = {k: h.get("count") for k, h in
                             gsnap.get("histograms", {}).items()}
    return out


def test_served_wrapper_records_the_same_metrics_as_jax():
    views = {}
    for ns in (JAX, PORT):
        ns.metrics.clear()
        _request_sequence(ns)
        views[ns.name] = _serving_view(ns)
    jv, pv = views["jax"], views["torch"]
    assert pv["counters"] == jv["counters"]
    assert pv["histograms"] == jv["histograms"]
    assert set(pv["gauges"]) == set(jv["gauges"])
    for key, value in jv["gauges"].items():
        # the probability/prediction summaries of host predict are the
        # same float64 numbers; only ms gauges could differ (none here)
        assert pv["gauges"][key] == pytest.approx(value, rel=1e-12), key
    grp = PORT.metrics.group(PORT.ML_GROUP, "serving")
    assert grp.get_gauge("inFlight", labels={"servable": "seq@v1"}) == 0
    assert grp.get_counter("rejected", labels={
        "servable": "seq@v1", "reason": "queue-full"}) == 1
    assert grp.get_counter("errorsByClass", labels={
        "servable": "seq@v1", "exception": "KeyError"}) == 1


def test_batcher_markers_feed_drift_and_feedback_join(pkg):
    rng = np.random.default_rng(8)
    coef = rng.normal(size=3)
    sv = servable(pkg, coef)
    sv.serving_name = "mark@v1"
    x = rng.normal(size=(6, 3))
    df = make_df(pkg, x)
    df.drift_real_rows = 4  # two pad rows at the tail
    df.request_segments = ((100, 1), (101, 3))
    sv.transform(df)
    live = pkg.drift.state_snapshot()["servables"]["mark@v1"]["live"]
    assert live["f0"]["count"] == 4 and live["prediction"]["count"] == 4
    assert pkg.evaluation.record_feedback(101, [1.0, 0.0, 1.0])
    assert pkg.evaluation.record_feedback(100, 0.0)
    assert not pkg.evaluation.record_feedback(100, 0.0)  # joined once
    sketch = pkg.evaluation.state_snapshot()["servables"]["mark@v1"]
    assert sketch["coverage"]["joined"] == 2
    assert sketch["sketch"]["pos"]["count"] == 2


def test_telemetry_fault_is_logged_not_raised(pkg, monkeypatch, caplog):
    def broken(*args, **kwargs):
        raise RuntimeError("registry down")

    monkeypatch.setattr(pkg.health, "observe_serving", broken)
    sv = servable(pkg, np.ones(2))
    with caplog.at_level(logging.WARNING):
        out = sv.transform(make_df(pkg, np.eye(2)))
    assert out.get("prediction").values == [1.0, 1.0]
    assert any("serving metrics recording failed" in r.getMessage()
               for r in caplog.records)
