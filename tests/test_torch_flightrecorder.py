"""The port's flight recorder, held against the JAX package's.

Modelled on the incident cases of tests/test_causaltrace.py and
tests/test_profiling.py. Each case runs once per package (the ``pkg``
fixture) with the same assertions: the five triggers (``slo``,
``divergence``, ``drift``, ``quality``, ``rollback``) each leave a bundle
of their kind; debounce and cap count ``suppressed`` exactly as the JAX
recorder does; a restarting process extends the bundle series; the CLI's
``--check`` exits 4 until ``--ack``; ``/incidents`` serves the bundles.
Across packages: a CPU bundle holds the JAX file set (pinned below), each
package reads and acknowledges the other's bundles, and the two recorders
extend one series in a shared trace dir. The incident profile refuses
rather than initialize a card.
"""

import json
import os
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the conftest pins it to the CPU)

PKGS = ("jax", "torch")
_NS = {}

#: what an incident bundle holds on the CPU, in either package: the
#: evidence files, and the incident profile (a trace file under profile/
#: and its attribution) — the CPU backend is live in both, so both capture
BUNDLE_FILES = {"incident.json", "spans-recent.jsonl", "metrics.json",
                "windows.json", "slo.json", "drift.json", "profile.json",
                "profile"}


def _namespace(name):
    if name in _NS:
        return _NS[name]
    if name == "jax":
        from flink_ml_tpu import serving
        from flink_ml_tpu.common import metrics as metrics_mod
        from flink_ml_tpu.linalg.vectors import DenseVector
        from flink_ml_tpu.observability import (drift, evaluation,
                                                exporters, flightrecorder,
                                                health, profiling, server,
                                                slo, tracing)
        from flink_ml_tpu.servable import api
    else:
        from flink_ml_tpu_torch import serving
        from flink_ml_tpu_torch.common import metrics as metrics_mod
        from flink_ml_tpu_torch.linalg.vectors import DenseVector
        from flink_ml_tpu_torch.observability import (drift, evaluation,
                                                      exporters,
                                                      flightrecorder,
                                                      health, profiling,
                                                      server, slo, tracing)
        from flink_ml_tpu_torch.servable import api

    class Echo(api.TransformerServable):
        features_col = "features"
        prediction_col = "pred"

        def transform(self, df):
            df.add_column("pred", api.DataTypes.DOUBLE,
                          [1.0] * df.num_rows())
            return df

    def frame(rows):
        return api.DataFrame(["features"], [api.DataTypes.vector()],
                             [api.Row([DenseVector(np.ones(3))])
                              for _ in range(rows)])

    ns = types.SimpleNamespace(
        name=name, serving=serving, api=api, drift=drift,
        evaluation=evaluation, exporters=exporters, fr=flightrecorder,
        health=health, profiling=profiling, server=server, slo=slo,
        tracer=tracing.tracer, metrics=metrics_mod.metrics,
        ML_GROUP=metrics_mod.ML_GROUP, Echo=Echo, frame=frame)
    _NS[name] = ns
    return ns


@pytest.fixture(params=PKGS)
def pkg(request):
    return _namespace(request.param)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("FLINK_ML_TPU_METRICS_PORT", raising=False)
    monkeypatch.delenv("FLINK_ML_TPU_TRACE_DIR", raising=False)
    monkeypatch.delenv("FLINK_ML_TPU_FLIGHT_RECORDER", raising=False)
    monkeypatch.delenv("FLINK_ML_TPU_INCIDENT_MAX", raising=False)
    # one bundle per case: debounce off; no profile window unless a case
    # asks for one (it costs a real profiler start/stop per bundle)
    monkeypatch.setenv("FLINK_ML_TPU_INCIDENT_DEBOUNCE_S", "0")
    monkeypatch.setenv("FLINK_ML_TPU_INCIDENT_PROFILE_MS", "0")
    for name in PKGS:
        ns = _namespace(name)
        ns.tracer.shutdown()
        ns.fr.reset()
        ns.server.stop()
        ns.drift.clear()
        ns.evaluation.clear()
    yield
    for name in PKGS:
        ns = _namespace(name)
        ns.tracer.shutdown()
        ns.fr.reset()
        ns.server.stop()
        ns.drift.clear()
        ns.evaluation.clear()


def incident_counter(ns, name, **labels):
    return ns.metrics.group(ns.ML_GROUP, "incident").get_counter(
        name, labels=labels)


def _tight_slo(ns):
    return ns.slo.SLO(name="impossible-latency", kind="latency",
                      threshold_ms=0.000001, window_s=60.0)


def _serve_some(ns, trace_dir, n=4):
    ns.tracer.configure(trace_dir)
    with ns.serving.MicroBatcher(ns.Echo(), ns.serving.BatcherConfig(
            buckets=(1, 8), window_ms=1.0)) as b:
        for _ in range(n):
            b.submit(ns.frame(1)).result(timeout=10)
        time.sleep(0.05)


def _one_bundle(ns, d, kind="slo", **attrs):
    ns.tracer.configure(d)
    with ns.tracer.span("work"):
        pass
    bundle = ns.fr.record_incident(kind, **(attrs or {"slo": "x"}))
    ns.tracer.shutdown()
    return bundle


# -- the bundle -----------------------------------------------------------------

def test_cpu_bundle_holds_the_jax_file_set(tmp_path, monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_INCIDENT_PROFILE_MS", "5")
    metas = {}
    for name in PKGS:
        ns = _namespace(name)
        bundle = _one_bundle(ns, str(tmp_path / name))
        assert set(os.listdir(bundle)) == BUNDLE_FILES, name
        assert ns.profiling.find_trace_file(
            os.path.join(bundle, "profile")) is not None
        with open(os.path.join(bundle, "incident.json")) as f:
            metas[name] = json.load(f)
        assert metas[name]["device_profile"] is True
    assert set(metas["jax"]) == set(metas["torch"])
    with open(os.path.join(str(tmp_path / "torch"), "incident-000",
                           "profile.json")) as f:
        assert json.load(f)["source"] == "host-fallback"


def test_slo_violation_dumps_incident_bundle(pkg, tmp_path):
    d = str(tmp_path)
    _serve_some(pkg, d)
    verdicts = pkg.slo.evaluate_slos([_tight_slo(pkg)], emit=True)
    assert not verdicts[0]["ok"]
    pkg.tracer.shutdown()
    (inc,) = pkg.fr.read_incidents(d)
    assert inc["kind"] == "slo"
    assert inc["attrs"]["slo"] == "impossible-latency"
    assert not inc["acknowledged"]
    assert "serving.batch" in {sp["name"] for sp in inc["recent_spans"]}
    with open(os.path.join(inc["dir"], "slo.json")) as f:
        frozen = json.load(f)
    assert frozen and all({"slo", "ok"} <= set(v) for v in frozen)
    with open(os.path.join(inc["dir"], "metrics.json")) as f:
        assert f"{pkg.ML_GROUP}.serving" in json.load(f)
    events = [ev for sp in pkg.exporters.read_spans(d)
              for ev in sp.get("events", ())]
    assert any(ev["name"] == pkg.fr.INCIDENT_EVENT for ev in events)


def _drift_trigger(ns, monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_DRIFT_MIN_COUNT", "20")
    rng = np.random.default_rng(3)
    base = ns.drift.DriftBaseline("fr", version=1)
    base.group.observe({"f0": rng.normal(size=2000)})
    ns.drift.install_baseline("fr@v1", base)
    for _ in range(8):
        ns.drift.observe_transform(
            "fr@v1", features=list(rng.normal(4.0, 1.0, size=(16, 1))))
    assert ns.drift.evaluate("fr@v1", emit=True)["drifted"] == ["f0"]
    return {"servable": "fr@v1", "drifted": "f0"}


def _quality_trigger(ns, monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_QUALITY_MIN_LABELS", "20")
    rng = np.random.default_rng(4)
    qsk = ns.evaluation.QualitySketch()
    s = rng.uniform(size=800)
    qsk.observe(s, (rng.uniform(size=800) < s).astype(float))
    ns.evaluation.install_baseline(
        "fr@v1", ns.evaluation.QualityBaseline("fr", 1, qsk))
    for seq in range(64):
        score = float(rng.uniform())
        ns.evaluation.observe_served("fr@v1", np.array([score]),
                                     segments=((seq, 1),))
        # inverted ground truth: the live AUC collapses
        ns.evaluation.record_feedback(seq, float(score < 0.5))
    verdict = ns.evaluation.evaluate("fr@v1", emit=True)
    assert verdict["degraded"]
    return {"servable": "fr@v1"}


@pytest.mark.parametrize("kind", ["divergence", "drift", "quality",
                                  "rollback"])
def test_each_trigger_records_its_kind(pkg, tmp_path, monkeypatch, kind):
    d = str(tmp_path / "trace")
    pkg.tracer.configure(d)
    with pkg.tracer.span("work"):
        if kind == "divergence":
            pkg.health.report_divergence("TestAlgo", "non-finite", epoch=3)
            want = {"algo": "TestAlgo", "divergence": "non-finite",
                    "epoch": 3}
        elif kind == "drift":
            want = _drift_trigger(pkg, monkeypatch)
        elif kind == "quality":
            want = _quality_trigger(pkg, monkeypatch)
        else:
            watch = str(tmp_path / "models")
            for v in (1, 2):
                pkg.serving.publish_model(watch, [np.full(3, float(v))], v)
            reg = pkg.serving.ModelRegistry(
                watch, lambda leaves, version: pkg.Echo(), model="fr")
            reg._adopt(1)
            reg._adopt(2)
            assert reg.rollback(reason="regression") == 1
            want = {"model": "fr", "demoted": 2, "restored": 1,
                    "reason": "regression"}
    pkg.tracer.shutdown()
    (row,) = pkg.fr.read_incidents(d)
    assert row["kind"] == kind
    assert {k: row["attrs"].get(k) for k in want} == want
    assert incident_counter(pkg, "recorded", kind=kind) >= 1


def _suppression_run(ns, d, monkeypatch):
    ns.tracer.configure(d)
    with ns.tracer.span("work"):
        pass
    got = []
    monkeypatch.setenv("FLINK_ML_TPU_INCIDENT_DEBOUNCE_S", "3600")
    got.append(ns.fr.record_incident("slo", slo="a") is not None)
    got.append(ns.fr.record_incident("slo", slo="b") is not None)
    monkeypatch.setenv("FLINK_ML_TPU_INCIDENT_DEBOUNCE_S", "0")
    monkeypatch.setenv("FLINK_ML_TPU_INCIDENT_MAX", "2")
    got.append(ns.fr.record_incident("drift", servable="s") is not None)
    got.append(ns.fr.record_incident("drift", servable="s") is not None)
    ns.tracer.shutdown()
    monkeypatch.delenv("FLINK_ML_TPU_INCIDENT_MAX")
    return got


def test_debounce_and_cap_count_suppressed_as_jax(tmp_path, monkeypatch):
    seen = {}
    for name in PKGS:
        ns = _namespace(name)
        before = {r: incident_counter(ns, "suppressed", reason=r)
                  for r in ("debounced", "capped")}
        got = _suppression_run(ns, str(tmp_path / name), monkeypatch)
        seen[name] = (got, {r: incident_counter(ns, "suppressed",
                                                reason=r) - before[r]
                            for r in before},
                      len(ns.fr.read_incidents(str(tmp_path / name))))
    assert seen["torch"] == seen["jax"] == (
        [True, False, True, False], {"debounced": 1, "capped": 1}, 2)


def test_recorder_extends_the_series_across_restarts_and_packages(
        tmp_path):
    d = str(tmp_path)
    writers = ["jax", "torch", "jax"]
    for i, name in enumerate(writers):
        ns = _namespace(name)
        ns.fr.reset()  # a fresh process's per-run state
        bundle = _one_bundle(ns, d, slo=f"s{i}")
        assert bundle.endswith(f"incident-00{i}")
    for name in PKGS:
        rows = _namespace(name).fr.read_incidents(d, include_spans=False)
        assert [r["seq"] for r in rows] == [0, 1, 2]
        assert [r["attrs"]["slo"] for r in rows] == ["s0", "s1", "s2"]


@pytest.mark.parametrize("case", ["no-trace-dir", "disabled-by-env"])
def test_recorder_writes_nothing_when_disarmed(pkg, tmp_path, monkeypatch,
                                               case):
    if case == "no-trace-dir":
        assert pkg.tracer.trace_dir is None
        before = incident_counter(pkg, "suppressed", reason="no-trace-dir")
        assert pkg.fr.record_incident("slo", slo="x") is None
        assert incident_counter(pkg, "suppressed",
                                reason="no-trace-dir") == before + 1
    else:
        pkg.tracer.configure(str(tmp_path))
        monkeypatch.setenv(pkg.fr.RECORDER_ENV, "0")
        assert pkg.fr.record_incident("slo", slo="x") is None
        assert pkg.fr.read_incidents(str(tmp_path)) == []


def test_read_incidents_equal_across_packages(tmp_path):
    dirs = {}
    for name in PKGS:
        ns = _namespace(name)
        dirs[name] = str(tmp_path / name)
        _serve_some(ns, dirs[name])
        ns.slo.evaluate_slos([_tight_slo(ns)], emit=True)
        ns.tracer.shutdown()
    rows = {}
    for reader in PKGS:
        for writer, d in dirs.items():
            rows[reader, writer] = _namespace(reader).fr.read_incidents(d)
    for writer in PKGS:
        assert rows["jax", writer] == rows["torch", writer]
    (jrow,), (prow,) = rows["jax", "jax"], rows["torch", "torch"]
    assert set(jrow) == set(prow)
    for key in ("seq", "kind", "attrs", "acknowledged", "process"):
        assert jrow[key] == prow[key], key


# -- CLI and route ------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_incident_cli_check_ack_cycle(tmp_path, capsys, writer, reader):
    d = str(tmp_path)
    w, r = _namespace(writer), _namespace(reader)
    _serve_some(w, d)
    w.slo.evaluate_slos([_tight_slo(w)], emit=True)
    w.tracer.shutdown()
    assert r.fr.main([d]) == 0
    out = capsys.readouterr().out
    assert "kind=slo" in out and "UNACKNOWLEDGED" in out
    assert r.fr.main([d, "--check"]) == 4
    assert w.fr.main([d, "--check"]) == 4
    capsys.readouterr()
    assert r.fr.main([d, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["incidents"][0]["kind"] == "slo"
    assert doc["incidents"][0]["recent_spans"] > 0
    assert r.fr.main([d, "--ack", "--check"]) == 0
    assert w.fr.main([d, "--check"]) == 0


def test_incident_cli_clean_and_invalid(pkg, tmp_path, capsys):
    clean = tmp_path / "clean"
    clean.mkdir()
    assert pkg.fr.main([str(clean), "--check"]) == 0
    assert "no incident bundles" in capsys.readouterr().out
    assert pkg.fr.main([str(tmp_path / "missing"), "--check"]) == 2


def test_acknowledge_one_seq(pkg, tmp_path):
    d = str(tmp_path)
    for i in range(2):
        _one_bundle(pkg, d, slo=f"s{i}")
    assert pkg.fr.acknowledge(d, seq=1) == 1
    assert [r["acknowledged"] for r in pkg.fr.read_incidents(d)] == [
        False, True]
    assert pkg.fr.acknowledge(d) == 1


def test_latest_never_resolves_an_incident_bundle(pkg, tmp_path):
    d = str(tmp_path)
    assert _one_bundle(pkg, d) is not None
    assert pkg.exporters.latest_trace_dir(d) == d
    resolved = pkg.exporters.latest_trace_dir(str(tmp_path.parent))
    assert resolved is not None
    assert "incident-" not in os.path.basename(resolved)


def test_incidents_live_route(tmp_path, monkeypatch):
    docs = {}
    for name in PKGS:
        ns = _namespace(name)
        d = str(tmp_path / name)
        ns.tracer.configure(d)
        with ns.tracer.span("w"):
            pass
        ns.fr.record_incident("slo", slo="latency")
        srv = ns.server.maybe_start(0)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/incidents", timeout=10) as r:
            assert r.status == 200
            docs[name] = json.loads(r.read())
        assert docs[name]["trace_dir"] == d
        (row,) = docs[name]["incidents"]
        assert row["kind"] == "slo" and "recent_spans" not in row
        ns.server.stop()
        ns.tracer.shutdown()
    assert set(docs["jax"]) == set(docs["torch"])
    assert set(docs["jax"]["incidents"][0]) == set(
        docs["torch"]["incidents"][0])


# -- the incident profile -----------------------------------------------------------

def test_incident_profile_refuses_rather_than_initialize_a_card(
        tmp_path, monkeypatch):
    prof = _namespace("torch").profiling
    starts = []
    monkeypatch.setattr(prof, "_profiler_start",
                        lambda log_dir: starts.append(log_dir))
    monkeypatch.setenv(prof.INCIDENT_MS_ENV, "5")
    # a card present but not initialized in this process: refuse
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert prof._backend_ready() is False
    assert prof.capture_incident_profile(str(tmp_path)) is False
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert prof._backend_ready() is True
    # the length knob and the kill-switch refuse before any start
    monkeypatch.setenv(prof.INCIDENT_MS_ENV, "0")
    assert prof.capture_incident_profile(str(tmp_path)) is False
    monkeypatch.setenv(prof.INCIDENT_MS_ENV, "5")
    monkeypatch.setenv(prof.CAPTURE_ENV, "0")
    assert prof.capture_incident_profile(str(tmp_path)) is False
    assert starts == []
    # no card at all: the host window is harmless, so capture proceeds
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert prof._backend_ready() is True


def test_incident_without_profile_when_refused(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_INCIDENT_PROFILE_MS", "5")
    monkeypatch.setattr(pkg.profiling, "_backend_ready", lambda: False)
    bundle = _one_bundle(pkg, str(tmp_path))
    assert set(os.listdir(bundle)) == BUNDLE_FILES - {"profile",
                                                      "profile.json"}
    with open(os.path.join(bundle, "incident.json")) as f:
        assert json.load(f)["device_profile"] is False
