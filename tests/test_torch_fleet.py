"""The port's fleet telemetry plane, held against the JAX package's.

Modelled on tests/test_fleet.py. Each reference case runs once per package
(the ``pkg`` fixture) with the same assertions: all-or-nothing beacon
admission, newest stamp per member, alive/stale/dead by beacon age,
bin-exact folds, fleet-scope SLOs that fail outright on a dead member,
the CLI's exit codes, the ``/fleet`` route and the periodic writer.
Across packages: a beacon payload has the JAX keys, beacons written from
the same observations carry bin-equal windowed slices, either package's
``FleetView`` reads the other's beacons to the same report, and a member
that stops beating flips either CLI's ``--check`` to 4 within two
intervals. The JAX package's elastic ``beat()`` writes beacons the port's
liveness view reads.
"""

import functools
import json
import os
import time
import types
import urllib.request

import pytest

import jax  # noqa: F401  (the conftest pins it to the CPU)

PKGS = ("jax", "torch")
_NS = {}
BUCKETS = [1.0, 5.0, 25.0]
_DIR_VARS = ("FLINK_ML_TPU_FLEET_DIR", "FLINK_ML_TPU_HEARTBEAT_DIR",
             "FLINK_ML_TPU_TRACE_DIR")


def _namespace(name):
    if name in _NS:
        return _NS[name]
    if name == "jax":
        from flink_ml_tpu.common import metrics as metrics_mod
        from flink_ml_tpu.observability import (evaluation, exporters,
                                                fleet, profiling, server,
                                                slo, tracing)
    else:
        from flink_ml_tpu_torch.common import metrics as metrics_mod
        from flink_ml_tpu_torch.observability import (evaluation, exporters,
                                                      fleet, profiling,
                                                      server, slo, tracing)
    ns = types.SimpleNamespace(name=name, fleet=fleet, slo=slo,
                               server=server, exporters=exporters,
                               evaluation=evaluation, profiling=profiling,
                               tracer=tracing.tracer, mm=metrics_mod)
    _NS[name] = ns
    return ns


@pytest.fixture(params=PKGS)
def pkg(request):
    return _namespace(request.param)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in _DIR_VARS + ("FLINK_ML_TPU_FLEET_BEACON_S",
                            "FLINK_ML_TPU_FLEET_STALE_S",
                            "FLINK_ML_TPU_METRICS_PORT",
                            "FLINK_ML_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    yield
    for name in PKGS:
        ns = _namespace(name)
        ns.server.stop()
        ns.tracer.shutdown()


def _snap(counts, total=None, total_sum=None):
    return {"buckets": list(BUCKETS), "counts": list(counts),
            "count": total if total is not None else counts[-1],
            "sum": total_sum if total_sum is not None
            else float(sum(counts))}


def _write_beacon(tmp_path, idx, stamp, hist=None, counters=None,
                  gauges=None, pid=None, role="serving", epoch=None,
                  interval=2.0):
    """Hand-write a valid schema-1 beacon for member ``p<idx>``."""
    raw = {"schema": 1, "time": float(stamp), "seq": 1,
           "pid": pid if pid is not None else 1000 + idx,
           "process": idx, "processIndex": idx, "role": role,
           "interval_s": interval, "windows": {}, "gauges": gauges or {},
           "load": {}, "events": []}
    if epoch is not None:
        raw["epoch"] = epoch
    entry = {}
    if hist:
        entry["histograms"] = {k: {"60": s, "300": s}
                               for k, s in hist.items()}
    if counters:
        entry["counters"] = {k: {"60": v, "300": v}
                             for k, v in counters.items()}
    if entry:
        raw["windows"]["ml.serving"] = entry
    path = tmp_path / f"fleet-p{idx}-{raw['pid']}.json"
    path.write_text(json.dumps(raw))
    return path


def _registry(ns):
    reg = ns.mm.MetricsRegistry()
    grp = reg.group("ml", "serving")
    wh = grp.windowed_histogram("queueMs", buckets=BUCKETS)
    for v in (0.5, 2.0, 50.0, 3.0, 7.5):
        wh.observe(v)
    grp.windowed_histogram("transformMs", labels={"servable": "lr@v1"},
                           buckets=BUCKETS).observe(4.0)
    grp.windowed_counter("transforms").inc(4)
    grp.histogram("plainMs", buckets=BUCKETS).observe(1.0)
    grp.gauge("queueDepth", 3)
    return reg


def _no_elapsed(obj):
    """``obj`` without the windows' ``elapsed_s`` (wall time since the
    window opened: the one field two registries cannot share)."""
    if isinstance(obj, dict):
        return {k: _no_elapsed(v) for k, v in obj.items()
                if k != "elapsed_s"}
    return obj


# -- beacon writing -------------------------------------------------------------

def test_write_beacon_roundtrips_windowed_slices(pkg, tmp_path):
    path = pkg.fleet.write_beacon(str(tmp_path), role="serving",
                                  registry=_registry(pkg))
    raw = json.loads(open(path).read())
    assert raw["schema"] == pkg.fleet.BEACON_SCHEMA == 1
    assert raw["role"] == "serving"
    hist = raw["windows"]["ml.serving"]["histograms"]["queueMs"]
    assert set(hist) == {"60", "300"} and hist["60"]["count"] == 5
    assert "plainMs" not in raw["windows"]["ml.serving"]["histograms"]
    assert raw["windows"]["ml.serving"]["counters"]["transforms"][
        "60"] == 4
    assert raw["gauges"]["ml.serving"]["queueDepth"] == 3
    pkg.mm.check_histogram_snapshot("queueMs", hist["60"], tuple(BUCKETS))


def test_beacon_payload_has_the_jax_keys_and_bin_equal_slices(
        monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_PROCESS_ID", "3")
    for name in PKGS:
        # the load row reads process-wide state other files leave behind
        ns = _namespace(name)
        ns.server.stop()
        ns.evaluation.clear()
        ns.profiling.reset_boot()
    payloads = {name: _namespace(name).fleet.beacon_payload(
        role="serving", registry=_registry(_namespace(name)), epoch=2,
        now=1234.5) for name in PKGS}
    jp, pp = payloads["jax"], payloads["torch"]
    assert set(jp) == set(pp)
    assert set(jp["load"]) == set(pp["load"])
    assert pp["load"]["participation"] == jp["load"]["participation"]
    assert pp["load"]["elasticEvents"] == jp["load"]["elasticEvents"]
    assert pp["processIndex"] == jp["processIndex"] == 3
    for key in ("schema", "time", "role", "epoch", "interval_s",
                "windows", "gauges"):
        assert _no_elapsed(pp[key]) == _no_elapsed(jp[key]), key


def test_disarmed_writer_returns_none(pkg):
    assert pkg.fleet.fleet_dir() is None
    assert pkg.fleet.write_beacon() is None
    assert pkg.fleet.start_beacon(role="serving") is None
    pkg.fleet.stop_beacon(None)  # tolerated
    assert pkg.fleet.provenance() == {"fleetMembers": None,
                                      "fleetP99Ms": None}


def test_histogram_items_enumeration_seam(pkg):
    reg = pkg.mm.MetricsRegistry()
    grp = reg.group("ml", "serving")
    wh = grp.windowed_histogram("queueMs", buckets=BUCKETS)
    plain = grp.histogram("plainMs", buckets=BUCKETS)
    items = dict(grp.histogram_items())
    assert items["queueMs"] is wh and items["plainMs"] is plain
    assert dict(reg.group_items())["ml.serving"] is grp


def test_writer_dir_resolution(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_FLEET_DIR", str(tmp_path / "a"))
    monkeypatch.setenv("FLINK_ML_TPU_HEARTBEAT_DIR", str(tmp_path / "b"))
    assert pkg.fleet.fleet_dir() == str(tmp_path / "a")
    monkeypatch.delenv("FLINK_ML_TPU_FLEET_DIR")
    assert pkg.fleet.fleet_dir() == str(tmp_path / "b")
    monkeypatch.delenv("FLINK_ML_TPU_HEARTBEAT_DIR")
    monkeypatch.setenv("FLINK_ML_TPU_TRACE_DIR", str(tmp_path / "t"))
    assert pkg.fleet.fleet_dir() == os.path.join(str(tmp_path / "t"),
                                                 "fleet")


# -- beacon reading -------------------------------------------------------------

def test_torn_beacon_rejected_whole(pkg, tmp_path):
    _write_beacon(tmp_path, 0, time.time(),
                  hist={"queueMs": _snap([2, 4, 6])})
    (tmp_path / "fleet-p1-2001.json").write_text('{"schema": 1, "tim')
    bad = json.loads((tmp_path / "fleet-p0-1000.json").read_text())
    bad["process"], bad["processIndex"], bad["pid"] = 2, 2, 3002
    bad["windows"]["ml.serving"]["histograms"]["queueMs"]["60"] = {
        "buckets": BUCKETS, "counts": [1, 2], "sum": 1.0, "count": 2}
    (tmp_path / "fleet-p2-3002.json").write_text(json.dumps(bad))
    beacons, invalid = pkg.fleet.read_beacons(str(tmp_path))
    assert len(beacons) == 1 and invalid == 2
    view = pkg.fleet.FleetView(str(tmp_path))
    snap, _src = view.hist_window("ml.serving", "queueMs", None, 60.0)
    assert snap["count"] == 6
    assert view.report()["counts"]["invalid"] == 2


def test_unknown_schema_rejected_and_newest_stamp_wins(pkg, tmp_path):
    path = _write_beacon(tmp_path, 5, time.time())
    raw = json.loads(path.read_text())
    raw["schema"] = 99
    path.write_text(json.dumps(raw))
    assert pkg.fleet.read_beacons(str(tmp_path)) == ([], 1)
    path.unlink()
    now = time.time()
    _write_beacon(tmp_path, 0, now - 30.0, pid=111)
    _write_beacon(tmp_path, 0, now, pid=222)  # relaunched: new pid
    beacons, invalid = pkg.fleet.read_beacons(str(tmp_path))
    assert invalid == 0 and [b["pid"] for b in beacons] == [222]


# -- staleness ------------------------------------------------------------------

def test_stale_member_excluded_from_quantiles_but_in_membership(
        pkg, tmp_path):
    now = 1000.0
    _write_beacon(tmp_path, 0, now - 1.0,
                  hist={"queueMs": _snap([10, 10, 10])})
    _write_beacon(tmp_path, 1, now - 9.0,
                  hist={"queueMs": _snap([0, 0, 1000])})
    view = pkg.fleet.FleetView(str(tmp_path), stale_s=5.0,
                               clock=lambda: now)
    assert {r["member"]: r["state"] for r in view.membership()} == {
        "p0": "alive", "p1": "stale"}
    snap, src = view.hist_window("ml.serving", "queueMs", None, 60.0)
    assert snap["count"] == 10 and src == "fleet[1]:60s"
    assert view.members_missing() == ["p1"]
    report = view.report()
    assert report["counts"] == {"alive": 1, "stale": 1, "dead": 0,
                                "invalid": 0}
    assert report["aggregates"]["ml.serving/queueMs"]["count"] == 10


def test_clock_skewed_beacon_reads_fresh_and_folds_once(pkg, tmp_path):
    now = 1000.0
    _write_beacon(tmp_path, 0, now + 50.0,
                  hist={"queueMs": _snap([1, 2, 3])})
    _write_beacon(tmp_path, 1, now - 1.0,
                  hist={"queueMs": _snap([4, 5, 6])})
    view = pkg.fleet.FleetView(str(tmp_path), stale_s=5.0,
                               clock=lambda: now)
    assert all(r["state"] == "alive" and r["age_s"] >= 0.0
               for r in view.membership())
    snap, _src = view.hist_window("ml.serving", "queueMs", None, 60.0)
    assert snap["counts"] == [5, 7, 9] and snap["count"] == 9


@pytest.mark.parametrize("offset,state", [(1.0, "alive"), (4.0, "alive"),
                                          (5.0, "stale"), (8.0, "stale"),
                                          (9.0, "dead")])
def test_killed_member_ages_alive_stale_dead(pkg, tmp_path, offset, state):
    t0 = 5000.0
    _write_beacon(tmp_path, 0, t0)
    view = pkg.fleet.FleetView(str(tmp_path), stale_s=4.0,
                               clock=lambda: t0 + offset)
    assert view.membership()[0]["state"] == state


def test_stale_threshold_env_tracks_beacon_interval(pkg, monkeypatch):
    f = pkg.fleet
    monkeypatch.setenv(f.BEACON_S_ENV, "0.5")
    assert f.stale_after_s() == pytest.approx(1.0)
    monkeypatch.setenv(f.STALE_S_ENV, "7.5")
    assert f.stale_after_s() == pytest.approx(7.5)
    monkeypatch.setenv(f.BEACON_S_ENV, "junk")
    assert f.beacon_interval_s() == f.DEFAULT_BEACON_S


# -- bin-exact aggregation ------------------------------------------------------

def test_fold_matches_ground_truth_bucket_merge(pkg, tmp_path):
    members = [[3, 10, 20], [1, 4, 9], [0, 7, 30]]
    for idx, counts in enumerate(members):
        _write_beacon(tmp_path, idx, time.time(),
                      hist={"queueMs": _snap(counts)})
    view = pkg.fleet.FleetView(str(tmp_path))
    snap, _src = view.hist_window("ml.serving", "queueMs", None, 60.0)
    expected = [sum(m[i] for m in members) for i in range(3)]
    assert snap["counts"] == expected
    assert snap["count"] == sum(m[-1] for m in members)
    q = pkg.mm.histogram_quantile
    assert q(snap, 0.99) == pytest.approx(q(_snap(
        expected, total=snap["count"], total_sum=snap["sum"]), 0.99))
    aggs = view.aggregates(60.0)
    assert aggs["ml.serving/queueMs"]["members"] == 3
    assert aggs["ml.serving/queueMs"]["p99"] == q(snap, 0.99)


def test_fold_snapshots_rejects_layout_drift(pkg):
    drifted = {"buckets": [1.0, 2.0], "counts": [1, 2], "sum": 1.0,
               "count": 2}
    with pytest.raises(ValueError):
        pkg.fleet.fold_snapshots([_snap([1, 2, 3]), drifted])
    assert pkg.fleet.fold_snapshots([]) is None


def test_counter_window_and_pick_window(pkg, tmp_path):
    _write_beacon(tmp_path, 0, time.time(), counters={"transforms": 5})
    _write_beacon(tmp_path, 1, time.time(), counters={"transforms": 7})
    view = pkg.fleet.FleetView(str(tmp_path))
    assert view.counter_window("ml.serving", "transforms", None,
                               60.0) == (12.0, "fleet[2]:60s")
    per = {"60": "sixty", "300": "threehundred"}
    assert pkg.fleet._pick_window(per, 60.0) == "sixty"
    assert pkg.fleet._pick_window(per, 120.0) == "threehundred"
    assert pkg.fleet._pick_window(per, 900.0) == "threehundred"


def test_each_fleet_view_reads_the_other_packages_beacons(tmp_path,
                                                          monkeypatch):
    """Two real members, one per package, written from the same
    observations: both views give the same report, and the fold is the
    bin-exact sum of the two members' slices."""
    now = time.time()
    for idx, name in enumerate(PKGS):
        monkeypatch.setenv("FLINK_ML_TPU_PROCESS_ID", str(idx))
        ns = _namespace(name)
        payload = ns.fleet.beacon_payload(role="serving",
                                          registry=_registry(ns), now=now)
        payload["process"] = idx  # a labelled multi-process runtime
        (tmp_path / f"fleet-p{idx}-{payload['pid']}.json").write_text(
            json.dumps(payload))
    reports = {name: _namespace(name).fleet.FleetView(
        str(tmp_path), stale_s=30.0, clock=lambda: now).report()
        for name in PKGS}
    assert reports["jax"] == reports["torch"]
    agg = reports["torch"]["aggregates"]["ml.serving/queueMs"]
    assert agg["count"] == 10 and agg["members"] == 2
    view = _namespace("torch").fleet.FleetView(str(tmp_path))
    snap, src = view.hist_window("ml.serving", "queueMs", None, 60.0)
    jsnap = _registry(_namespace("jax")).group(
        "ml", "serving").histogram("queueMs").window_snapshot(60.0)
    assert snap["counts"] == [2 * c for c in jsnap["counts"]]
    assert src == "fleet[2]:60s"


# -- fleet-scope SLOs -----------------------------------------------------------

def test_slo_scope_field_validates(pkg):
    assert pkg.slo.SLO.from_dict(
        {"name": "f", "scope": "fleet"}).scope == "fleet"
    with pytest.raises(ValueError, match="scope"):
        pkg.slo.SLO(name="bad", scope="galaxy")


def _fleet_spec(ns, threshold=500.0):
    return ns.slo.SLO(name="fleet-latency", kind="latency",
                      histogram="transformMs", threshold_ms=threshold,
                      scope="fleet")


def test_fleet_scope_slo_carries_membership_and_per_member(tmp_path):
    now = time.time()
    _write_beacon(tmp_path, 0, now,
                  hist={"transformMs": _snap([50, 50, 50])})
    _write_beacon(tmp_path, 1, now,
                  hist={"transformMs": _snap([0, 10, 20])})
    verdicts = {}
    for name in PKGS:
        ns = _namespace(name)
        (v,) = ns.slo.evaluate_slos([_fleet_spec(ns)],
                                    fleet_dir=str(tmp_path))
        assert v["scope"] == "fleet" and v["ok"]
        assert v["members"] == 2 and v["membersAlive"] == 2
        assert v["membersMissing"] == []
        assert set(v["perMember"]) == {"p0", "p1"}
        assert v["objectives"][0]["samples"] == 70
        assert v["objectives"][0]["source"] == "fleet[2]:60s"
        verdicts[name] = v
    assert verdicts["jax"] == verdicts["torch"]


def test_fleet_scope_slo_fails_on_dead_member(pkg, tmp_path):
    now = time.time()
    _write_beacon(tmp_path, 0, now,
                  hist={"transformMs": _snap([100, 100, 100])})
    _write_beacon(tmp_path, 1, now - 60.0,
                  hist={"transformMs": _snap([100, 100, 100])})
    (v,) = pkg.slo.evaluate_slos([_fleet_spec(pkg)],
                                 fleet_dir=str(tmp_path))
    assert all(o["ok"] for o in v["objectives"])
    assert not v["ok"]
    assert v["membersDead"] == ["p1"] and v["membersMissing"] == ["p1"]
    rendered = pkg.slo.render_verdicts([v])
    assert "DEAD: p1" in rendered and "VIOLATED" in rendered


def test_fleet_scope_without_telemetry_is_visible_not_fatal(pkg,
                                                            tmp_path):
    (v,) = pkg.slo.evaluate_slos([_fleet_spec(pkg)],
                                 fleet_dir=str(tmp_path / "nope"))
    assert v["fleet"] == "missing" and v["members"] == 0
    assert v["objectives"][0]["source"] == "fleet-missing"


# -- CLI ------------------------------------------------------------------------

def test_cli_exit_2_without_fleet_telemetry(pkg, tmp_path, capsys):
    assert pkg.fleet.main([str(tmp_path)]) == pkg.fleet.EXIT_INVALID
    assert "no fleet telemetry" in capsys.readouterr().err


def test_cli_renders_membership_and_aggregates(pkg, tmp_path, capsys):
    nested = tmp_path / "fleet"
    nested.mkdir()
    _write_beacon(nested, 0, time.time(),
                  hist={"queueMs": _snap([5, 10, 20])}, epoch=7)
    assert pkg.fleet.main([str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "1 alive" in out and "p0" in out and "ml.serving/queueMs" in out
    assert pkg.fleet.main([str(tmp_path), "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["counts"]["alive"] == 1
    assert doc["members"][0]["member"] == "p0"
    assert doc["aggregates"]["ml.serving/queueMs"]["count"] == 20


def test_cli_check_exit_4_on_dead_member_or_fleet_slo(pkg, tmp_path):
    dead = tmp_path / "dead"
    dead.mkdir()
    _write_beacon(dead, 0, time.time() - 120.0)
    assert pkg.fleet.main([str(dead), "--check", "--stale-s", "1"]) == 4
    _write_beacon(tmp_path, 0, time.time(),
                  hist={"transformMs": _snap([0, 0, 100])})
    spec = tmp_path / "spec.json"
    for threshold, rc in ((2.0, 4), (500.0, 0)):
        spec.write_text(json.dumps({"slos": [
            {"name": "fleet-p99", "kind": "latency",
             "histogram": "transformMs", "threshold_ms": threshold,
             "scope": "fleet"}]}))
        assert pkg.fleet.main([str(tmp_path), "--check", "--spec",
                               str(spec)]) == rc
    spec.write_text("{broken")
    assert pkg.fleet.main([str(tmp_path), "--check", "--spec",
                           str(spec)]) == 2


def test_slo_cli_fleet_scope_over_beacon_dir(pkg, tmp_path, capsys):
    _write_beacon(tmp_path, 0, time.time(),
                  hist={"transformMs": _snap([5, 10, 20])})
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"slos": [
        {"name": "fleet-p99", "kind": "latency",
         "histogram": "transformMs", "threshold_ms": 500.0,
         "scope": "fleet"}]}))
    assert pkg.slo.main([str(tmp_path), "--spec", str(spec),
                         "--json"]) == 0
    verdict = json.loads(capsys.readouterr().out)["verdicts"][0]
    assert verdict["scope"] == "fleet" and verdict["members"] == 1


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_member_that_stops_beating_flips_check_within_two_intervals(
        tmp_path, monkeypatch, writer, reader):
    """One real beacon, then silence: with the stale threshold at one
    beacon interval, ``--check`` reads 0 at once and 4 once two intervals
    passed (dead = twice the stale threshold). Both fleet modules read a
    fake clock stepped by the test, so a loaded machine cannot stretch the
    window."""
    interval = 0.25
    monkeypatch.setenv("FLINK_ML_TPU_FLEET_BEACON_S", str(interval))
    w, r = _namespace(writer), _namespace(reader)
    now = [1.7e9]
    _fake_clock(monkeypatch, (w.fleet, r.fleet), lambda: now[0])
    path = w.fleet.write_beacon(str(tmp_path), role="serving")
    with open(path) as f:
        stamp = json.load(f)["time"]
    assert stamp == now[0]
    argv = [str(tmp_path), "--check", "--stale-s", str(interval)]
    assert r.fleet.main(argv) == 0
    while r.fleet.main(argv) != 4:
        assert now[0] - stamp < 2 * interval + 0.5, "never flipped"
        now[0] += 0.02
    assert now[0] - stamp > 2 * interval


def _fake_clock(monkeypatch, modules, clock):
    """Point the ``time.time`` a fleet module reads at runtime — its
    ``time`` global and its ``FleetView``'s default clock — at ``clock``,
    without touching the module's source or the process-wide time."""
    class _Time:
        def __getattr__(self, name):
            return getattr(time, name)

    fake = _Time()
    fake.time = clock
    for mod in modules:
        monkeypatch.setattr(mod, "time", fake)
        monkeypatch.setattr(mod, "FleetView", functools.partial(
            mod.FleetView, clock=clock))


# -- elastic liveness and provenance --------------------------------------------

def test_jax_elastic_beat_is_a_beacon_the_port_reads(tmp_path,
                                                     monkeypatch):
    from flink_ml_tpu.parallel import elastic

    port = _namespace("torch").fleet
    monkeypatch.setenv(elastic.HEARTBEAT_DIR_ENV, str(tmp_path))
    assert port.HEARTBEAT_DIR_ENV == elastic.HEARTBEAT_DIR_ENV
    assert port.fleet_dir() == str(tmp_path)
    elastic.beat(epoch=11)
    beacons, invalid = port.read_beacons(str(tmp_path))
    assert invalid == 0 and beacons[0]["role"] == "trainer"
    assert beacons[0]["epoch"] == 11
    assert elastic.stale_processes(30.0, num_processes=2) == [1]
    assert port.stale_member_indices(str(tmp_path), 30.0,
                                     num_processes=2) == [1]
    assert port.find_fleet_dir(str(tmp_path)) == str(tmp_path)


def test_stale_member_indices_counts_silence(pkg, tmp_path):
    now = time.time()
    _write_beacon(tmp_path, 0, now)
    _write_beacon(tmp_path, 2, now - 50.0)
    assert pkg.fleet.stale_member_indices(
        str(tmp_path), 10.0, num_processes=3, now=now) == [1, 2]


def test_provenance_reads_fleet_queue_p99(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_FLEET_DIR", str(tmp_path))
    for idx in (0, 1):
        _write_beacon(tmp_path, idx, time.time(),
                      hist={"queueMs": _snap([5, 10, 20])})
    prov = pkg.fleet.provenance()
    assert prov["fleetMembers"] == 2
    assert prov["fleetP99Ms"] == pytest.approx(pkg.mm.histogram_quantile(
        _snap([10, 20, 40], total=40, total_sum=70.0), 0.99))


def test_process_index_sources(monkeypatch):
    port = _namespace("torch").fleet
    assert port._process_index() == 0
    monkeypatch.setenv(port.PROCESS_ID_ENV, "5")
    assert port._process_index() == 5
    monkeypatch.setenv(port.PROCESS_ID_ENV, "junk")
    assert port._process_index() == 0


def test_relabeled_dumps_merge_without_collision(pkg, tmp_path):
    for k in (0, 1):
        snap = {"ml.serving": {
            "gauges": {}, "histograms": {},
            "counters": {f'transforms{{process="p{k}"}}': 10 + k}}}
        with open(tmp_path / f"metrics-p{k}-{100 + k}.json", "w") as f:
            json.dump(snap, f)
    merged = pkg.exporters.read_metrics(str(tmp_path))
    assert merged["ml.serving"]["counters"] == {
        'transforms{process="p0"}': 10, 'transforms{process="p1"}': 11}
    (v,) = pkg.slo.evaluate_slos([pkg.slo.SLO(name="er",
                                              kind="error-rate")],
                                 snapshot=merged)
    assert v["objectives"][0]["requests"] == 21
    out = pkg.exporters.relabel_snapshot(
        {"ml.x": {"counters": {'n{process="p0"}': 1, "m": 2},
                  "gauges": {}, "histograms": {}}}, {"process": "p1"})
    assert set(out["ml.x"]["counters"]) == {'n{process="p0"}',
                                            'm{process="p1"}'}


# -- live route and the periodic writer -----------------------------------------

def test_fleet_route(tmp_path, monkeypatch):
    docs = {}
    for name in PKGS:
        ns = _namespace(name)
        assert "/fleet" in ns.server.ROUTE_TABLE
        srv = ns.server.maybe_start(0)
        url = f"http://127.0.0.1:{srv.port}/fleet"
        with urllib.request.urlopen(url, timeout=10) as r:
            assert json.loads(r.read())["fleet"] is None
        monkeypatch.setenv("FLINK_ML_TPU_FLEET_DIR", str(tmp_path))
        _write_beacon(tmp_path, 0, 1000.0,
                      hist={"queueMs": _snap([5, 10, 20])})
        with urllib.request.urlopen(url, timeout=10) as r:
            docs[name] = json.loads(r.read())["fleet"]
        monkeypatch.delenv("FLINK_ML_TPU_FLEET_DIR")
        ns.server.stop()
        assert docs[name]["members"][0]["member"] == "p0"
    for doc in docs.values():
        doc.pop("time")
        for row in doc["members"]:
            row.pop("age_s")
    assert docs["jax"] == docs["torch"]


def test_start_stop_beacon_lifecycle(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_FLEET_BEACON_S", "0.2")
    token = pkg.fleet.start_beacon(role="serving", base_dir=str(tmp_path))
    try:
        beacons, _ = pkg.fleet.read_beacons(str(tmp_path))
        assert beacons and beacons[0]["role"] == "serving"
        first_seq = beacons[0]["seq"]
        deadline = time.time() + 5.0
        while time.time() < deadline:
            beacons, _ = pkg.fleet.read_beacons(str(tmp_path))
            if beacons[0]["seq"] > first_seq:
                break
            time.sleep(0.05)
        assert beacons[0]["seq"] > first_seq
    finally:
        pkg.fleet.stop_beacon(token)
    beacons, _ = pkg.fleet.read_beacons(str(tmp_path))
    assert beacons[0]["role"] == "stopped"


def test_stacked_roles_join(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_FLEET_BEACON_S", "60")
    t1 = pkg.fleet.start_beacon(role="serving", base_dir=str(tmp_path))
    t2 = pkg.fleet.start_beacon(role="controller", base_dir=str(tmp_path))
    try:
        beacons, _ = pkg.fleet.read_beacons(str(tmp_path))
        assert beacons[0]["role"] == "serving+controller"
    finally:
        pkg.fleet.stop_beacon(t2)
        pkg.fleet.stop_beacon(t1)
