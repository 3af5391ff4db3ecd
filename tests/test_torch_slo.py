"""The port's SLO engine, held against the JAX package's.

Modelled on the SLO cases of tests/test_serving_telemetry.py (spec
loading, latency and error-rate verdicts with burn rates, vacuous empty
series, emitted counters and events, the CLI's exit codes, the live
``/slo`` route) plus the drift and quality kinds. Each case runs once per
package (the ``pkg`` fixture) with the same assertions; the parity cases
record the same numpy-seeded latencies and errors into each package's
registry and require equal verdicts (floats within rtol 1e-9), and each
package evaluates the other's ``metrics-*.json`` artifacts to the same
verdicts.
"""

import json
import math
import types
import urllib.request

import numpy as np
import pytest

import jax  # noqa: F401  (the conftest pins it to the CPU)

PKGS = ("jax", "torch")
_NS = {}


def _namespace(name):
    if name in _NS:
        return _NS[name]
    if name == "jax":
        from flink_ml_tpu.common import metrics as metrics_mod
        from flink_ml_tpu.observability import (exporters, flightrecorder,
                                                server, slo, tracing)
    else:
        from flink_ml_tpu_torch.common import metrics as metrics_mod
        from flink_ml_tpu_torch.observability import (exporters,
                                                      flightrecorder,
                                                      server, slo, tracing)
    ns = types.SimpleNamespace(name=name, slo=slo, server=server,
                               exporters=exporters, fr=flightrecorder,
                               tracer=tracing.tracer, mm=metrics_mod,
                               metrics=metrics_mod.metrics)
    _NS[name] = ns
    return ns


@pytest.fixture(params=PKGS)
def pkg(request):
    return _namespace(request.param)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("FLINK_ML_TPU_METRICS_PORT", "FLINK_ML_TPU_SLO_SPEC",
                "FLINK_ML_TPU_TRACE_DIR", "FLINK_ML_TPU_FLEET_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("FLINK_ML_TPU_INCIDENT_DEBOUNCE_S", "0")
    monkeypatch.setenv("FLINK_ML_TPU_INCIDENT_PROFILE_MS", "0")
    for name in PKGS:
        _namespace(name).fr.reset()  # another file may have hit the cap
    yield
    for name in PKGS:
        ns = _namespace(name)
        ns.server.stop()
        ns.tracer.shutdown()
        ns.fr.reset()


def close(a, b, rtol=1e-9):
    """Structural equality with floats compared within ``rtol``."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(close(a[k], b[k], rtol)
                                            for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(close(x, y, rtol)
                                        for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        if math.isnan(a) and math.isnan(b):
            return True
        return math.isclose(a, b, rel_tol=rtol, abs_tol=0.0)
    return a == b


def _seeded_registry(ns, seed, windowed=True):
    """The same latencies and errors, from one numpy seed, in a fresh
    registry of ``ns``: two servables, a slow tail, some errors."""
    rng = np.random.default_rng(seed)
    reg = ns.mm.MetricsRegistry()
    grp = reg.group("ml", "serving")
    for servable, scale in (("lr@v1", 20.0), ("lr@v2", 80.0)):
        labels = {"servable": servable}
        lat = rng.lognormal(np.log(scale), 0.8, size=400)
        n_err = int(rng.integers(0, 12))
        if windowed:
            h = grp.windowed_histogram("transformMs", labels=labels)
            grp.windowed_counter("transforms", labels=labels).inc(400)
            grp.windowed_counter("errors", labels=labels).inc(n_err)
        else:
            h = grp.histogram("transformMs", labels=labels)
            grp.counter("transforms", 400, labels=labels)
            grp.counter("errors", n_err, labels=labels)
        for v in lat:
            h.observe(float(v))
    return reg


def _specs(ns):
    S = ns.slo.SLO
    return [S(name="p99-100", kind="latency", threshold_ms=100.0),
            S(name="p90-v1", kind="latency", quantile=0.9,
              threshold_ms=60.0, labels={"servable": "lr@v1"}),
            S(name="p50-tight", kind="latency", quantile=0.5,
              threshold_ms=10.0, window_s=30.0,
              burn_windows=((30.0, 2.0), (120.0, 1.0))),
            S(name="err-1pct", kind="error-rate", max_error_ratio=0.01),
            S(name="err-v2", kind="error-rate", max_error_ratio=0.05,
              labels={"servable": "lr@v2"})]


# -- specs ----------------------------------------------------------------------

def test_slo_spec_json_round_trip(pkg, tmp_path):
    spec = tmp_path / "slo.json"
    spec.write_text(json.dumps({"slos": [
        {"name": "lat", "kind": "latency", "quantile": 0.9,
         "threshold_ms": 50.0, "labels": {"servable": "X"}},
        {"name": "err", "kind": "error-rate", "max_error_ratio": 0.05}]}))
    specs = pkg.slo.load_specs(str(spec))
    assert [s.name for s in specs] == ["lat", "err"]
    assert specs[0].labels == {"servable": "X"}
    assert pkg.slo.SLO.from_dict(specs[0].to_dict()) == specs[0]
    assert [s.name for s in pkg.slo.default_slos()] == [
        "serving-latency-p99", "serving-error-rate"]


@pytest.mark.parametrize("doc,match", [
    ({"slos": [{"name": "x", "kind": "latency", "nope": 1}]},
     "unknown spec key"),
    ({"slos": [{"name": "x", "kind": "availability"}]}, "unknown kind"),
    ({"slos": []}, "non-empty"),
    ({"slos": [{"name": "a"}, {"name": "a"}]}, "duplicate"),
    ({"slos": [{"kind": "latency"}]}, "name"),
    ({"slos": [{"name": "q", "quantile": 1.5}]}, "quantile"),
    ({"slos": [{"name": "w", "window_s": 0}]}, "window_s"),
    ({"slos": [{"name": "d", "kind": "drift", "stat": "kl"}]}, "psi"),
    ({"slos": [{"name": "q", "kind": "quality",
                "max_quality_delta": -1}]}, "max_quality_delta")])
def test_bad_specs_raise(pkg, tmp_path, doc, match):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match=match):
        pkg.slo.load_specs(str(bad))


def test_slo_spec_toml(pkg, tmp_path):
    spec = tmp_path / "slo.toml"
    spec.write_text('[[slos]]\nname = "lat"\nkind = "latency"\n'
                    'threshold_ms = 50.0\n\n[[slos]]\nname = "drift"\n'
                    'kind = "drift"\nstat = "js"\n')
    specs = pkg.slo.load_specs(str(spec))
    assert [s.name for s in specs] == ["lat", "drift"]
    assert specs[0].threshold_ms == 50.0
    assert specs[1].group == "ml.drift" and specs[1].stat == "js"
    (tmp_path / "bad.toml").write_text("[[slos]\nname=")
    with pytest.raises(ValueError, match="invalid TOML"):
        pkg.slo.load_specs(str(tmp_path / "bad.toml"))


def test_active_slos_reads_the_spec_env(pkg, tmp_path, monkeypatch):
    assert [s.name for s in pkg.slo.active_slos()] == [
        s.name for s in pkg.slo.default_slos()]
    spec = tmp_path / "slo.json"
    spec.write_text(json.dumps([{"name": "custom", "threshold_ms": 1e9}]))
    monkeypatch.setenv(pkg.slo.SLO_SPEC_ENV, str(spec))
    assert [s.name for s in pkg.slo.active_slos()] == ["custom"]


# -- verdicts -------------------------------------------------------------------

def test_slo_latency_violation_and_burn_rate(pkg):
    reg = pkg.mm.MetricsRegistry()
    wh = reg.group("ml", "serving").windowed_histogram(
        "transformMs", labels={"servable": "S"})
    for _ in range(100):
        wh.observe(400.0)
    spec = pkg.slo.SLO(name="lat", kind="latency", threshold_ms=100.0)
    (verdict,) = pkg.slo.evaluate_slos([spec], registry=reg)
    assert not verdict["ok"]
    primary = verdict["objectives"][0]
    assert primary["objective"] == "latency-quantile"
    assert primary["source"] == "windowed" and primary["samples"] == 100
    assert primary["value_ms"] > 100.0
    burns = [o for o in verdict["objectives"]
             if o["objective"] == "latency-burn"]
    assert burns and all(b["burn_rate"] > b["max_burn_rate"]
                         and not b["ok"] for b in burns)
    ok_spec = pkg.slo.SLO(name="lat-ok", kind="latency", threshold_ms=1e9)
    assert pkg.slo.evaluate_slos([ok_spec], registry=reg)[0]["ok"]


def test_slo_error_rate_windowed(pkg):
    reg = pkg.mm.MetricsRegistry()
    g = reg.group("ml", "serving")
    g.windowed_counter("transforms", labels={"servable": "S"}).inc(90)
    g.windowed_counter("errors", labels={"servable": "S"}).inc(10)
    bad, good = pkg.slo.evaluate_slos(
        [pkg.slo.SLO(name="err", kind="error-rate", max_error_ratio=0.05),
         pkg.slo.SLO(name="ok", kind="error-rate", max_error_ratio=0.5)],
        registry=reg)
    assert not bad["ok"] and good["ok"]
    primary = bad["objectives"][0]
    assert primary["objective"] == "error-ratio"
    assert primary["value"] == pytest.approx(0.1)
    assert primary["source"] == "windowed"
    burns = [o for o in bad["objectives"] if o["objective"] == "error-burn"]
    assert burns and all(b["ok"] for b in burns)  # 2x under 14.4x / 6x


def test_slo_empty_series_passes_vacuously(pkg):
    verdicts = pkg.slo.evaluate_slos(pkg.slo.default_slos(),
                                     registry=pkg.mm.MetricsRegistry())
    assert all(v["ok"] for v in verdicts)
    assert verdicts[0]["objectives"][0]["samples"] == 0


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("windowed", [True, False])
def test_live_verdicts_equal_across_packages(seed, windowed):
    verdicts = {name: _namespace(name).slo.evaluate_slos(
        _specs(_namespace(name)),
        registry=_seeded_registry(_namespace(name), seed, windowed))
        for name in PKGS}
    assert close(verdicts["torch"], verdicts["jax"])
    assert {o["source"] for v in verdicts["torch"]
            for o in v["objectives"]} == (
        {"windowed"} if windowed else {"cumulative"})
    assert _namespace("torch").slo.render_verdicts(verdicts["torch"]) == \
        _namespace("jax").slo.render_verdicts(verdicts["jax"])


def test_snapshot_verdicts_read_the_other_packages_artifacts(tmp_path):
    dirs = {}
    for i, name in enumerate(PKGS):
        ns = _namespace(name)
        dirs[name] = str(tmp_path / name)
        ns.exporters.dump_metrics(dirs[name],
                                  _seeded_registry(ns, 7, windowed=True))
    got = {}
    for reader in PKGS:
        ns = _namespace(reader)
        for writer, d in dirs.items():
            got[reader, writer] = ns.slo.evaluate_slos(
                _specs(ns), snapshot=ns.exporters.read_metrics(d))
    first = got["jax", "jax"]
    assert not all(v["ok"] for v in first) and any(v["ok"] for v in first)
    for key, verdicts in got.items():
        assert close(verdicts, first), key
    assert all(o["source"] == "cumulative"
               for v in first for o in v["objectives"])


@pytest.mark.parametrize("kind", ["drift", "quality"])
def test_gauge_kinds(pkg, kind):
    reg = pkg.mm.MetricsRegistry()
    S = pkg.slo.SLO
    if kind == "drift":
        spec = S(name="d", kind="drift", stat="psi", max_drift=0.2)
        (missing,) = pkg.slo.evaluate_slos([spec], registry=reg)
        grp = reg.group("ml", "drift")
        for feature, val in (("f0", 0.05), ("f1", 0.9)):
            grp.gauge("drift", val, labels={"servable": "lr@v1",
                                            "feature": feature,
                                            "stat": "psi"})
        grp.gauge("drift", 5.0, labels={"servable": "lr@v1",
                                        "feature": "f2", "stat": "ks"})
        (verdict,) = pkg.slo.evaluate_slos([spec], registry=reg)
        obj = verdict["objectives"][0]
        assert obj["value"] == 0.9 and obj["series"] == 2
        assert "f1" in obj["worst"]
    else:
        spec = S(name="q", kind="quality", min_quality=0.6,
                 max_quality_delta=0.05)
        (missing,) = pkg.slo.evaluate_slos([spec], registry=reg)
        grp = reg.group("ml", "quality")
        for servable, live, base in (("lr@v1", 0.8, 0.82),
                                     ("lr@v2", 0.7, 0.9)):
            labels = {"servable": servable, "metric": "auc"}
            grp.gauge("quality", live, labels=labels)
            grp.gauge("qualityBaseline", base, labels=labels)
        (verdict,) = pkg.slo.evaluate_slos([spec], registry=reg)
        floor, delta = verdict["objectives"]
        assert floor["ok"] and floor["value"] == 0.7
        assert not delta["ok"] and delta["value"] == pytest.approx(0.2)
        assert "lr@v2" in delta["worst"]
    assert missing["ok"] and missing["objectives"][0]["source"] == "missing"
    assert not verdict["ok"]
    assert "VIOLATED" in pkg.slo.render_verdicts([verdict])


def test_slo_emit_counters_event_and_incident(pkg, tmp_path):
    trace_dir = str(tmp_path / "trace")
    pkg.tracer.configure(trace_dir)
    reg = pkg.mm.MetricsRegistry()
    reg.group("ml", "serving").windowed_histogram(
        "transformMs", labels={"servable": "S"}).observe(500.0)
    spec = pkg.slo.SLO(name="emit-me", kind="latency", quantile=0.5,
                       threshold_ms=1.0)
    grp = pkg.metrics.group("ml", "slo")
    before = grp.get_counter("slo_violations", labels={"slo": "emit-me"})
    with pkg.tracer.span("scrape"):
        pkg.slo.evaluate_slos([spec], registry=reg, emit=True)
    assert grp.get_counter("slo_violations",
                           labels={"slo": "emit-me"}) == before + 1
    pkg.tracer.shutdown()
    events = [ev for sp in pkg.exporters.read_spans(trace_dir)
              for ev in sp.get("events", ())
              if ev.get("name") == pkg.slo.SLO_EVENT]
    assert events and events[0]["attrs"]["slo"] == "emit-me"
    assert "latency-quantile" in events[0]["attrs"]["failing"]
    (row,) = pkg.fr.read_incidents(trace_dir)
    assert row["kind"] == "slo" and row["attrs"]["slo"] == "emit-me"


# -- CLI and route ----------------------------------------------------------------

def test_slo_cli_exit_codes(pkg, tmp_path, capsys):
    reg = pkg.mm.MetricsRegistry()
    g = reg.group("ml", "serving")
    h = g.histogram("transformMs", labels={"servable": "S"})
    for _ in range(50):
        h.observe(100.0)
    g.counter("transforms", 50, labels={"servable": "S"})
    trace = tmp_path / "trace"
    pkg.exporters.dump_metrics(str(trace), reg)
    tight = tmp_path / "tight.json"
    tight.write_text(json.dumps({"slos": [
        {"name": "tight", "kind": "latency", "quantile": 0.5,
         "threshold_ms": 0.001}]}))
    loose = tmp_path / "loose.toml"
    loose.write_text('[[slos]]\nname = "loose"\nkind = "latency"\n'
                     'threshold_ms = 1e9\n\n[[slos]]\nname = "errs"\n'
                     'kind = "error-rate"\nmax_error_ratio = 0.99\n')
    main = pkg.slo.main
    assert main([str(trace), "--spec", str(tight), "--check"]) == 4
    assert main([str(trace), "--spec", str(loose), "--check"]) == 0
    assert main([str(trace), "--spec", str(tight)]) == 0  # report only
    capsys.readouterr()
    assert main([str(trace), "--spec", str(loose), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["source"] == "cumulative"
    assert {v["slo"] for v in doc["verdicts"]} == {"loose", "errs"}
    empty = tmp_path / "empty"
    empty.mkdir()
    assert main([str(empty), "--check"]) == 2
    badspec = tmp_path / "bad.json"
    badspec.write_text("{not json")
    assert main([str(trace), "--spec", str(badspec)]) == 2
    assert main([str(tmp_path / "missing-spec"), "--spec",
                 str(tmp_path / "nope.json")]) == 2


def test_slo_cli_json_equal_across_packages(tmp_path, capsys):
    ns = _namespace("jax")
    trace = str(tmp_path / "trace")
    ns.exporters.dump_metrics(trace, _seeded_registry(ns, 9, False))
    docs = {}
    for name in PKGS:
        assert _namespace(name).slo.main([trace, "--json"]) == 0
        docs[name] = json.loads(capsys.readouterr().out)
    assert close(docs["jax"], docs["torch"])
    for name in PKGS:
        rc = _namespace(name).slo.main([trace, "--check"])
        assert rc == (0 if all(v["ok"] for v in docs[name]["verdicts"])
                      else 4)


def test_slo_route(tmp_path, monkeypatch):
    bodies = {}
    spec = tmp_path / "slo.json"
    spec.write_text(json.dumps({"slos": [
        {"name": "custom", "kind": "latency", "quantile": 0.5,
         "threshold_ms": 1e9}]}))
    for name in PKGS:
        ns = _namespace(name)
        # the route reads the process registry: give both packages the
        # same serving series (other test files share the process)
        ns.metrics.clear()
        h = ns.metrics.group("ml", "serving").windowed_histogram(
            "transformMs", labels={"servable": "lr@v1"})
        for v in np.random.default_rng(5).lognormal(3.0, 0.5, size=200):
            h.observe(float(v))
        srv = ns.server.maybe_start(0)
        url = f"http://127.0.0.1:{srv.port}/slo"
        with urllib.request.urlopen(url, timeout=10) as r:
            assert r.status == 200
            live = json.loads(r.read())
        assert live["source"] == "windowed"
        assert {v["slo"] for v in live["verdicts"]} == {
            s.name for s in ns.slo.default_slos()}
        assert set(live) == {"source", "verdicts", "violated"}
        monkeypatch.setenv(ns.slo.SLO_SPEC_ENV, str(spec))
        with urllib.request.urlopen(url, timeout=10) as r:
            bodies[name] = json.loads(r.read())
        monkeypatch.delenv(ns.slo.SLO_SPEC_ENV)
        assert [v["slo"] for v in bodies[name]["verdicts"]] == ["custom"]
        assert bodies[name]["verdicts"][0]["objectives"][0]["samples"] == 200
        ns.server.stop()
        ns.metrics.clear()
    assert close(bodies["jax"], bodies["torch"])


def test_match_key_label_subset(pkg):
    mk = pkg.slo._match_key
    assert mk('transformMs{servable="a",process="p0"}', "transformMs",
              {"servable": "a"})
    assert not mk('transformMs{servable="b"}', "transformMs",
                  {"servable": "a"})
    assert mk("transformMs", "transformMs", None)
    assert not mk("transformMsX", "transformMs", None)
    with pytest.raises(ValueError, match="bucket"):
        pkg.slo._combine([
            {"buckets": [1.0], "counts": [1], "sum": 1.0, "count": 1},
            {"buckets": [2.0], "counts": [1], "sum": 1.0, "count": 1}])
