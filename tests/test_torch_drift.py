"""The port's drift detection and continuous evaluation, held against the
JAX package's.

Modelled on tests/test_drift.py and tests/test_evaluation.py. Both
packages' modules are host numpy in float64, so the same numpy-seeded
values give the same state:

- sketches: moments, auto-ranging, the JSON form and the merges (same
  edges, an unranged side, mismatched edges rebinned) give equal
  ``to_json`` documents; ``psi``, ``js_distance``, ``ks_stat`` and
  ``compare_sketches`` agree within rtol 1e-9, and so do the quality
  sketch's AUC, logloss, confusion and calibration;
- live state: the same install/observe/evaluate sequence (clean and
  shifted traffic, a thin window, a missing baseline) gives the same
  verdicts, the same ``ml.drift``/``ml.quality`` gauges and counters, and
  the same feedback-join coverage and ring evictions;
- artifacts: the JAX ``drift.read_state`` and ``evaluation.read_state``
  read the port's ``dump_state`` files (also as ``dump_metrics`` writes
  them); baselines serialized by one package load in the other;
- fit seams: a traced or armed LR, LinearRegression and FTRL fit on the
  CPU attaches baselines whose feature sketches equal the JAX fit's and
  whose prediction and quality sketches agree within the fits' own
  tolerance; an unarmed fit attaches none.
"""

import json
import math
import os
import types

import numpy as np
import pytest

import jax

from flink_ml_tpu.common.table import Table as JaxTable
from flink_ml_tpu.common.table import as_dense_vector_column
from flink_ml_tpu.models import online as jax_online
from flink_ml_tpu.models.classification import (
    LogisticRegression as JaxLogisticRegression,
)
from flink_ml_tpu.models.regression import (
    LinearRegression as JaxLinearRegression,
)
from flink_ml_tpu.parallel import create_mesh as jax_create_mesh
from flink_ml_tpu.parallel import set_default_mesh as jax_set_default_mesh

from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.models import online as port_online
from flink_ml_tpu_torch.models.classification import LogisticRegression
from flink_ml_tpu_torch.models.regression import LinearRegression

RTOL = 1e-9
_NS = {}


def _namespace(name):
    if name in _NS:
        return _NS[name]
    if name == "jax":
        from flink_ml_tpu.common import metrics as metrics_mod
        from flink_ml_tpu.observability import (drift, evaluation,
                                                exporters, tracing)
    else:
        from flink_ml_tpu_torch.common import metrics as metrics_mod
        from flink_ml_tpu_torch.observability import (drift, evaluation,
                                                      exporters, tracing)
    ns = types.SimpleNamespace(name=name, drift=drift, evaluation=evaluation,
                               exporters=exporters, tracing=tracing,
                               metrics=metrics_mod.metrics)
    _NS[name] = ns
    return ns


JAX, PORT = _namespace("jax"), _namespace("torch")
BOTH = (JAX, PORT)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("FLINK_ML_TPU_TRACE_DIR", "FLINK_ML_TPU_DRIFT",
                "FLINK_ML_TPU_QUALITY", "FLINK_ML_TPU_DRIFT_WINDOW_S",
                "FLINK_ML_TPU_QUALITY_RING"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("FLINK_ML_TPU_DRIFT_INTERVAL_S", "0")
    monkeypatch.setenv("FLINK_ML_TPU_DRIFT_MIN_COUNT", "20")
    monkeypatch.setenv("FLINK_ML_TPU_QUALITY_INTERVAL_S", "0")
    monkeypatch.setenv("FLINK_ML_TPU_QUALITY_MIN_LABELS", "20")
    for ns in BOTH:
        ns.drift.clear()
        ns.evaluation.clear()
        ns.metrics.clear()
    yield
    for ns in BOTH:
        ns.drift.clear()
        ns.evaluation.clear()
        ns.tracing.tracer.configure(None)


def _drop_times(doc):
    """A verdict without its wall-clock stamps (and lag timings)."""
    if isinstance(doc, dict):
        return {k: _drop_times(v) for k, v in doc.items()
                if k not in ("evaluated_unix", "created_unix",
                             "labelLagP99Ms", "lagP99Ms")}
    if isinstance(doc, list):
        return [_drop_times(v) for v in doc]
    return doc


def _close(a, b, rtol=RTOL):
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        return math.isclose(a, b, rel_tol=rtol, abs_tol=1e-300)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], rtol)
                                            for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y, rtol)
                                        for x, y in zip(a, b))
    return a == b


# -- sketches and statistics ---------------------------------------------------------

@pytest.mark.parametrize("seed,n,edges", [
    (1, 50, None), (2, 256, None), (3, 5000, None),
    (4, 3000, (-3.0, -1.0, 0.0, 1.0, 3.0)), (5, 1, None)])
def test_streaming_sketch_state_is_the_jax_state(seed, n, edges):
    values = np.random.default_rng(seed).normal(0.3, 1.7, size=n)
    values[::97] = np.nan
    docs = []
    for ns in BOTH:
        sk = ns.drift.StreamingSketch(edges=edges)
        for chunk in np.array_split(values, 7):
            sk.observe_many(chunk)
        docs.append((sk.to_json(), sk.finalize().to_json(), sk.stddev))
    assert _close(docs[0], docs[1])


def test_sketch_merges_match_including_rebin():
    rng = np.random.default_rng(6)
    a_vals, b_vals = rng.normal(size=600), rng.normal(1.0, 2.0, size=900)
    c_vals = rng.normal(size=40)  # unranged side
    out = []
    for ns in BOTH:
        a = ns.drift.StreamingSketch()
        a.observe_many(a_vals)
        b = ns.drift.StreamingSketch()
        b.observe_many(b_vals)
        c = ns.drift.StreamingSketch()
        c.observe_many(c_vals)
        a.merge(b.to_json())  # differing edges: midpoint rebin
        a.merge(c)
        round_trip = ns.drift.StreamingSketch.from_json(a.to_json())
        out.append((a.to_json(), round_trip.to_json()))
    assert _close(out[0], out[1])
    assert out[1][0]["rebinned"] == 1
    with pytest.raises(ValueError, match="bin mismatch"):
        PORT.drift.StreamingSketch().merge(
            {"edges": [0.0, 1.0, 2.0], "counts": [1]})


@pytest.mark.parametrize("shift,scale", [(0.0, 1.0), (0.4, 1.0),
                                         (3.0, 1.0), (0.0, 3.0)])
def test_psi_js_ks_and_compare_agree(shift, scale):
    rng = np.random.default_rng(int(10 * shift + scale))
    base_vals = rng.normal(size=3000)
    live_vals = rng.normal(shift, scale, size=700)
    rows = []
    for ns in BOTH:
        base = ns.drift.StreamingSketch()
        base.observe_many(base_vals)
        base.finalize()
        live = ns.drift.StreamingSketch(edges=base.edges)
        live.observe_many(live_vals)
        stats = ns.drift.compare_sketches(base, live)
        p, q = ns.drift._coarsen(*ns.drift._aligned_counts(
            base.to_json(), live.to_json()))
        rows.append((stats, ns.drift.psi(p, q), ns.drift.js_distance(p, q),
                     ns.drift.ks_stat(p, q)))
    assert _close(rows[0], rows[1])
    assert rows[1][0]["live_n"] == 700
    empty = np.zeros(4)
    assert all(math.isnan(f(empty, np.ones(4))) for f in (
        PORT.drift.psi, PORT.drift.js_distance, PORT.drift.ks_stat))


@pytest.mark.parametrize("seed,n", [(7, 30), (8, 500), (9, 4000)])
def test_quality_sketch_metrics_agree(seed, n):
    rng = np.random.default_rng(seed)
    scores = rng.uniform(size=n)
    labels = (rng.uniform(size=n) < scores).astype(float)
    labels[::53] = 0.5  # non-binary: tallied, dropped
    out = []
    for ns in BOTH:
        sk = ns.evaluation.QualitySketch()
        for part in range(3):
            sl = slice(part * n // 3, (part + 1) * n // 3)
            sk.observe(scores[sl], labels[sl])
        merged = ns.evaluation.QualitySketch.from_json(sk.to_json())
        out.append((sk.quality_metrics(), sk.quality_metrics(0.3),
                    merged.to_json(), sk.auc()))
    assert _close(out[0], out[1])
    assert out[1][0]["nonbinary"] > 0


def test_baselines_serialize_across_packages(tmp_path):
    rng = np.random.default_rng(12)
    for writer, reader in ((JAX, PORT), (PORT, JAX)):
        base = writer.drift.DriftBaseline("lr", version=3)
        base.group.observe({"f0": rng.normal(size=400),
                            "prediction": rng.uniform(size=400)})
        path = tmp_path / f"{writer.name}-drift.json"
        path.write_text(json.dumps(base.to_json()))
        loaded = reader.drift.load_baseline_file(str(path))
        assert loaded.version == 3
        assert loaded.to_json() == base.to_json()
        q = writer.evaluation.QualityBaseline(
            "lr", version=3, sketch=writer.evaluation.QualitySketch())
        q.sketch.observe(rng.uniform(size=100),
                         (rng.uniform(size=100) > 0.5).astype(float))
        qpath = tmp_path / f"{writer.name}-quality.json"
        qpath.write_text(json.dumps(q.to_json()))
        qloaded = reader.evaluation.load_baseline_file(str(qpath))
        assert qloaded.to_json() == q.to_json()
    assert PORT.drift.load_baseline_file(str(tmp_path / "none")) is None
    (tmp_path / "bad.json").write_text("{")
    with pytest.raises(ValueError, match="unreadable"):
        PORT.drift.load_baseline_file(str(tmp_path / "bad.json"))


# -- live state --------------------------------------------------------------------

def _drift_session(ns, seed):
    """Install a baseline, feed clean and shifted live traffic to two
    servables and a thin one, evaluate; return verdicts and telemetry."""
    rng = np.random.default_rng(seed)
    base = ns.drift.DriftBaseline("lr", version=1)
    base.group.observe({"f0": rng.normal(size=2000),
                        "f1": rng.normal(2.0, 1.0, size=2000),
                        "prediction": rng.uniform(size=2000)})
    ns.drift.install_baseline("lr@v1", base)
    ns.drift.install_baseline("lr@v2", ns.drift.DriftBaseline.from_json(
        base.to_json()))
    ns.drift.install_baseline("lr@v3", None)
    for i in range(12):
        feats = np.stack([rng.normal(size=16), rng.normal(2.0, 1.0, 16)],
                         axis=1)
        ns.drift.observe_transform("lr@v1", features=list(feats),
                                   predictions=rng.uniform(size=16))
        ns.drift.observe_transform("lr@v2", features=list(feats + 3.0),
                                   predictions=rng.uniform(size=16))
    ns.drift.observe_transform("lr@v3", predictions=[0.5] * 4)
    report = ns.drift.drift_report(emit=True)
    gsnap = ns.metrics.group("ml", "drift").snapshot()
    return (_drop_times(report), gsnap.get("gauges", {}),
            gsnap.get("counters", {}), ns.drift.provenance(),
            _drop_times(ns.drift.state_snapshot()))


def test_live_drift_verdicts_and_telemetry_agree():
    jax_state, port_state = _drift_session(JAX, 40), _drift_session(PORT, 40)
    assert _close(jax_state, port_state)
    report = port_state[0]
    assert report["drifted"] == ["lr@v2"]
    assert report["servables"]["lr@v3"]["source"] == "missing"
    assert set(report["servables"]["lr@v2"]["drifted"]) == {"f0", "f1"}
    assert port_state[2]['violations{servable="lr@v2"}'] >= 2


def _quality_session(ns, seed, monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_QUALITY_RING", "8")
    rng = np.random.default_rng(seed)
    qsk = ns.evaluation.QualitySketch()
    s = rng.uniform(size=800)
    qsk.observe(s, (rng.uniform(size=800) < s).astype(float))
    ns.evaluation.install_baseline(
        "lr@v1", ns.evaluation.QualityBaseline("lr", 1, qsk))
    joined = []
    seq = 0
    for tick in range(30):
        scores = rng.uniform(size=4)
        segments = ((seq, 1), (seq + 1, 3))
        ns.evaluation.observe_served("lr@v1", scores, segments=segments)
        if tick % 5:
            joined.append(ns.evaluation.record_feedback(
                seq, float(scores[0] > 0.5)))
            joined.append(ns.evaluation.record_feedback(
                seq + 1, (rng.uniform(size=3) < scores[1:]).astype(float)))
        seq += 2
    joined.append(ns.evaluation.record_feedback(0, 1.0))  # evicted: late
    joined.append(ns.evaluation.record_feedback(10**6, 1.0))  # unknown
    report = ns.evaluation.quality_report(emit=True)
    gsnap = ns.metrics.group("ml", "quality").snapshot()
    counters = gsnap.get("counters", {})
    return (joined, _drop_times(report), gsnap.get("gauges", {}),
            counters, _drop_times(ns.evaluation.provenance()),
            _drop_times(ns.evaluation.state_snapshot()))


def test_feedback_join_and_quality_verdicts_agree(monkeypatch):
    jax_state = _quality_session(JAX, 50, monkeypatch)
    port_state = _quality_session(PORT, 50, monkeypatch)
    jax_state[-1].pop("lags"), port_state[-1].pop("lags")
    assert _close(jax_state, port_state)
    joined, report = port_state[0], port_state[1]
    assert joined[-2:] == [False, False]
    row = report["servables"]["lr@v1"]
    assert row["source"] == "baseline" and math.isfinite(
        row["live"]["auc"])
    assert row["coverage"]["evicted"] > 0 and row["coverage"]["late"] == 1
    assert port_state[3]["feedbackUnknown"] == 1


def test_forget_eviction_kill_switch_and_reseed(monkeypatch):
    for ns in BOTH:
        base = ns.drift.DriftBaseline("m")
        base.group.observe({"prediction": np.linspace(0, 1, 50)})
        n = ns.drift.MAX_TRACKED_SERVABLES + 3
        for i in range(n):
            ns.drift.install_baseline(f"m@v{i}", base)
        assert ns.drift.baseline_for("m@v0") is None
        assert ns.drift.baseline_for(f"m@v{n - 1}") is not None
        ns.drift.observe_transform("m@v5", predictions=[0.5] * 8)
        ns.drift.forget_servable("m@v5")
        assert ns.drift.state_snapshot() == {"servables": {}}
        ns.evaluation.observe_served("q@v1", np.ones(2), segments=((1, 2),))
        ns.evaluation.forget_servable("q@v1")
        assert not ns.evaluation.record_feedback(1, 1.0)
        monkeypatch.setenv("FLINK_ML_TPU_DRIFT", "0")
        monkeypatch.setenv("FLINK_ML_TPU_QUALITY", "0")
        ns.drift.observe_transform("m@v9", predictions=[1.0])
        ns.evaluation.observe_served("q@v1", np.ones(1), segments=((2, 1),))
        assert ns.drift.state_snapshot() == {"servables": {}}
        assert not ns.evaluation.record_feedback(2, 1.0)
        monkeypatch.delenv("FLINK_ML_TPU_DRIFT")
        monkeypatch.delenv("FLINK_ML_TPU_QUALITY")
        # a forked child keeps the baselines, not the live windows
        ns.drift.observe_transform(f"m@v{n - 1}", predictions=[0.5] * 8)
        ns.drift.reseed_child()
        ns.evaluation.reseed_child()
        assert ns.drift.baseline_for(f"m@v{n - 1}") is not None
        assert ns.drift.state_snapshot() == {"servables": {}}


def test_state_snapshot_merges_across_packages():
    rng = np.random.default_rng(60)
    values = rng.normal(size=300)
    JAX.drift.observe_transform("x@v1", predictions=values)
    PORT.drift.merge_state(JAX.drift.state_snapshot())
    PORT.evaluation.observe_served("x@v1", np.full(3, 0.8),
                                   segments=((1, 3),))
    PORT.evaluation.record_feedback(1, 1.0)
    JAX.evaluation.merge_state(PORT.evaluation.state_snapshot())
    assert _close(PORT.drift.state_snapshot(), JAX.drift.state_snapshot())
    assert JAX.evaluation.state_snapshot()["servables"]["x@v1"][
        "coverage"]["joined"] == 1


def test_jax_read_state_reads_the_port_dumps(tmp_path):
    rng = np.random.default_rng(70)
    for ns in BOTH:
        base = ns.drift.DriftBaseline("lr", version=2)
        base.group.observe({"prediction": rng.uniform(size=500)})
        ns.drift.install_baseline("lr@v2", base)
        ns.drift.observe_transform("lr@v2", predictions=rng.uniform(
            size=64))
        ns.drift.evaluate("lr@v2")
        ns.evaluation.observe_served("lr@v2", np.full(2, 0.7),
                                     segments=((5, 2),))
        ns.evaluation.record_feedback(5, [1.0, 0.0])
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    JAX.drift.dump_state(str(jdir))
    JAX.evaluation.dump_state(str(jdir))
    PORT.exporters.dump_metrics(str(pdir))  # drift + quality ride along
    assert sorted(f.split("-")[0] for f in os.listdir(pdir)) == [
        "drift", "metrics", "quality"]
    jd, pd = JAX.drift.read_state(str(jdir)), JAX.drift.read_state(
        str(pdir))
    assert set(pd) == set(jd) == {"lr@v2"}
    assert pd["lr@v2"]["baseline"]["modelVersion"] == 2
    assert pd["lr@v2"]["live"].to_json()["prediction"]["count"] == 64
    assert pd["lr@v2"]["results"]["source"] == "baseline"
    jq, pq = (JAX.evaluation.read_state(str(jdir)),
              JAX.evaluation.read_state(str(pdir)))
    assert pq["lr@v2"]["coverage"] == jq["lr@v2"]["coverage"]
    assert pq["lr@v2"]["sketch"].to_json() == jq["lr@v2"]["sketch"].to_json()
    assert PORT.drift.dump_state(str(tmp_path / "x")) is not None
    PORT.drift.clear()
    assert PORT.drift.dump_state(str(tmp_path / "y")) is None


# -- fit-time seams -------------------------------------------------------------------

def _labeled(seed, n, d, regression=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d)
    y = (x @ w).astype(np.float32) if regression else (
        (x @ w > 0).astype(np.float32))
    return x, y


@pytest.fixture
def one_device_jax():
    jax_set_default_mesh(jax_create_mesh(devices=jax.devices()[:1]))
    yield
    jax_set_default_mesh(None)


@pytest.mark.parametrize("regression", [False, True])
def test_linear_fit_baselines_match_jax(regression, one_device_jax,
                                        monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_DRIFT", "1")
    monkeypatch.setenv("FLINK_ML_TPU_QUALITY", "1")
    monkeypatch.setenv("FLINK_ML_TPU_DRIFT_SAMPLE_ROWS", "300")
    x, y = _labeled(3 + regression, 400, 5, regression)
    kw = dict(max_iter=5, global_batch_size=100, learning_rate=0.1)
    if regression:
        jm = JaxLinearRegression(**kw).fit(JaxTable.from_columns(
            features=x, label=y))
        pm = LinearRegression(device="cpu", **kw).fit(Table.from_columns(
            features=x, label=y))
    else:
        jm = JaxLogisticRegression(**kw).fit(JaxTable.from_columns(
            features=x, label=y))
        pm = LogisticRegression(device="cpu", **kw).fit(Table.from_columns(
            features=x, label=y))
    jd, pd = jm.drift_baseline.to_json(), pm.drift_baseline.to_json()
    assert pd["model"] == jd["model"]
    assert set(pd["sketches"]) == set(jd["sketches"])
    for name in (f"f{i}" for i in range(5)):  # the same sampled inputs
        assert pd["sketches"][name] == jd["sketches"][name]
    jp, pp = jd["sketches"]["prediction"], pd["sketches"]["prediction"]
    assert pp["count"] == jp["count"] == 300
    # predictions of two float32 fits that agree within 1e-4: the
    # 0/1 (or regression) values agree to that tolerance
    assert pp["mean"] == pytest.approx(jp["mean"], rel=1e-3, abs=1e-3)
    if regression:
        assert getattr(pm, "quality_baseline", None) is None
        assert getattr(jm, "quality_baseline", None) is None
    else:
        ja = jm.quality_baseline.sketch.auc()
        pa = pm.quality_baseline.sketch.auc()
        assert pm.quality_baseline.sketch.n == 300
        assert pa == pytest.approx(ja, abs=2e-3)


def test_ftrl_fit_baselines_match_jax(one_device_jax, monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_DRIFT", "1")
    monkeypatch.setenv("FLINK_ML_TPU_QUALITY", "1")
    x, y = _labeled(11, 1200, 4)
    x = x.astype(np.float64)
    jinit = JaxTable.from_columns(
        coefficient=as_dense_vector_column(np.zeros((1, 4))),
        modelVersion=np.asarray([0], np.int64))
    jm = (jax_online.OnlineLogisticRegression(
        global_batch_size=300, alpha=0.5, beta=0.5)
        .set_initial_model_data(jinit)
        .fit(JaxTable.from_columns(features=x, label=y)))
    pm = (port_online.OnlineLogisticRegression(
        device="cpu", global_batch_size=300, alpha=0.5, beta=0.5)
        .warm_start(np.zeros(4))
        .fit(Table.from_columns(features=x, label=y)))
    jd, pd = jm.drift_baseline, pm.drift_baseline
    assert pd.version == jd.version == pm.model_version == 4
    assert set(pd.group.sketches) == {"f0", "f1", "f2", "f3", "prediction"}
    for name in ("f0", "f1", "f2", "f3"):
        assert _close(pd.group.sketch(name).to_json(),
                      jd.group.sketch(name).to_json(), rtol=1e-6)
    assert pd.group.sketch("prediction").count == 1200
    assert pd.group.sketch("prediction").mean == pytest.approx(
        jd.group.sketch("prediction").mean, abs=2e-3)
    assert pm.quality_baseline.version == 4
    assert pm.quality_baseline.sketch.auc() == pytest.approx(
        jm.quality_baseline.sketch.auc(), abs=2e-3)


def test_unarmed_fit_attaches_nothing_traced_fit_writes_artifacts(tmp_path):
    x, y = _labeled(13, 200, 2)
    table = Table.from_columns(features=x, label=y)
    model = LogisticRegression(device="cpu", max_iter=3,
                               global_batch_size=64).fit(table)
    assert getattr(model, "drift_baseline", None) is None
    assert getattr(model, "quality_baseline", None) is None
    PORT.tracing.tracer.configure(str(tmp_path))
    try:
        model = LogisticRegression(device="cpu", max_iter=3,
                                   global_batch_size=64).fit(table)
    finally:
        PORT.tracing.tracer.configure(None)
    assert model.drift_baseline.group.sketch("f0").count == 200
    files = os.listdir(tmp_path)
    for prefix in ("drift-baseline-LogisticRegression",
                   "quality-baseline-LogisticRegression"):
        assert any(f.startswith(prefix) for f in files), files
