"""The port's metrics registry and lock seam (``flink_ml_tpu_torch/common/
{metrics,locks}.py``), held against the JAX package's.

- Cases carried over from tests/test_observability.py:66-256,555-616 and
  tests/test_lockcheck.py, run against the port: labeled metrics,
  cumulative histograms, the all-or-nothing merge, a concurrent stress run,
  the Prometheus grammar and escaping, ``histogram_quantile``'s edge
  contracts, the armed lock watchdog (order edges, cycles, long holds, the
  ``locks-*.json`` dump) and the thread excepthook.
- Registry parity: one seeded sequence of operations (counters, gauges,
  histograms with labels that need escaping, windowed views, merges of a
  child snapshot) runs on a registry of each package; their ``snapshot()``
  JSON must be equal, their Prometheus text byte-identical, and
  ``histogram_quantile`` must agree exactly on every histogram at every
  quantile. Each package merges the other's snapshot.
- The ``profile()`` hook on ``torch.profiler``: a region with
  ``trace_dir`` writes a Chrome trace, keeps the single-window claim and
  releases it.
"""

import json
import math
import os
import re
import threading

import numpy as np
import pytest

from flink_ml_tpu.common import metrics as jax_metrics
from flink_ml_tpu.observability import exporters as jax_exporters
from flink_ml_tpu_torch.common import locks
from flink_ml_tpu_torch.common import metrics as port_metrics
from flink_ml_tpu_torch.common.metrics import (
    ML_GROUP,
    Histogram,
    MetricsRegistry,
    WindowedHistogram,
    histogram_quantile,
    metric_key,
    metrics,
)
from flink_ml_tpu_torch.observability import exporters
from flink_ml_tpu_torch.observability.exporters import prometheus_text


# -- metrics: labels, histograms, thread safety, merge -----------------------

def test_labeled_metrics_round_trip():
    reg = MetricsRegistry()
    g = reg.group("ml", "test")
    g.counter("retries", labels={"site": "epoch"})
    g.counter("retries", 2, labels={"site": "epoch"})
    g.counter("retries")  # unlabeled is a distinct series
    g.gauge("lastMs", 5.0, labels={"mode": "host"})
    assert g.get_counter("retries", labels={"site": "epoch"}) == 3
    assert g.get_counter("retries") == 1
    assert g.get_gauge("lastMs", labels={"mode": "host"}) == 5.0
    snap = reg.snapshot()["ml.test"]
    assert snap["counters"]['retries{site="epoch"}'] == 3
    assert snap["counters"]["retries"] == 1
    assert snap["gauges"]['lastMs{mode="host"}'] == 5.0


def test_histogram_cumulative_buckets():
    h = Histogram(buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    snap = h.snapshot()
    assert snap["counts"] == [1, 2, 3]  # cumulative per bucket
    assert snap["count"] == 4
    assert snap["sum"] == pytest.approx(555.5)


def test_registry_merge_folds_counters_histograms_gauges():
    parent, child = MetricsRegistry(), MetricsRegistry()
    parent.group("ml").counter("rows", 5)
    parent.group("ml").histogram("ms", buckets=(1.0, 10.0)).observe(0.5)
    child.group("ml").counter("rows", 7)
    child.group("ml").histogram("ms", buckets=(1.0, 10.0)).observe(5.0)
    child.group("ml").gauge("last", 42.0)
    child.group("ml", "new").counter("only_child")
    parent.merge(child.snapshot())
    snap = parent.snapshot()
    assert snap["ml"]["counters"]["rows"] == 12
    assert snap["ml"]["gauges"]["last"] == 42.0
    assert snap["ml"]["histograms"]["ms"]["count"] == 2
    assert snap["ml"]["histograms"]["ms"]["counts"] == [1, 2]
    assert snap["ml.new"]["counters"]["only_child"] == 1


def test_registry_merge_rejects_bucket_drift_whole():
    parent, child = MetricsRegistry(), MetricsRegistry()
    parent.group("ml").histogram("ms", buckets=(1.0,)).observe(0.5)
    child.group("ml").counter("rows", 7)
    child.group("ml").histogram("ms", buckets=(1.0, 2.0)).observe(0.5)
    with pytest.raises(ValueError):
        parent.merge(child.snapshot())
    assert parent.group("ml").get_counter("rows") == 0
    assert parent.group("ml").histogram(
        "ms", buckets=(1.0,)).snapshot()["count"] == 1


def test_registry_concurrent_stress():
    """Concurrent writers hammering one registry lose no update."""
    reg = MetricsRegistry()
    threads, per_thread = 8, 500
    barrier = threading.Barrier(threads)

    def worker(i):
        barrier.wait()
        for n in range(per_thread):
            g = reg.group("ml", f"shared{n % 3}")
            g.counter("hits")
            g.histogram("ms").observe(float(n % 50))
            g.gauge("last", n)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    snap = reg.snapshot()
    assert sum(snap[f"ml.shared{k}"]["counters"]["hits"]
               for k in range(3)) == threads * per_thread
    assert sum(snap[f"ml.shared{k}"]["histograms"]["ms"]["count"]
               for k in range(3)) == threads * per_thread


# -- Prometheus exposition ----------------------------------------------------

_LV = r'"(?:[^"\\\n]|\\.)*"'
_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*=' + _LV +
    r'(,[a-zA-Z_][a-zA-Z0-9_]*=' + _LV + r')*\})?'
    r' (-?[0-9]+(\.[0-9]+)?([eE][+-]?[0-9]+)?|[+-]Inf|NaN)$')
_PROM_TYPE = re.compile(r"^# TYPE [a-zA-Z_:][a-zA-Z0-9_:]* "
                        r"(gauge|counter|histogram)$")


def test_prometheus_exposition_parses():
    reg = MetricsRegistry()
    g = reg.group("ml", "iteration")
    for ms in (0.5, 3.0, 700.0):
        g.histogram("epochMs", labels={"mode": "host"}).observe(ms)
    g.counter("rounds", 3)
    g.gauge("lastRoundMs", 700.0)
    text = prometheus_text(reg.snapshot())
    for line in text.strip().splitlines():
        assert _PROM_LINE.match(line) or _PROM_TYPE.match(line), line
    assert ('flink_ml_tpu_ml_iteration_epochMs_bucket'
            '{mode="host",le="+Inf"} 3') in text
    assert 'flink_ml_tpu_ml_iteration_epochMs_count{mode="host"} 3' in text
    assert 'flink_ml_tpu_ml_iteration_rounds_total 3' in text


def test_prometheus_one_type_line_per_metric_name():
    reg = MetricsRegistry()
    g = reg.group("ml", "checkpoint")
    g.histogram("opMs", labels={"op": "save"}).observe(1.0)
    g.histogram("opMs", labels={"op": "restore"}).observe(2.0)
    g.counter("ops", labels={"op": "save"})
    g.counter("ops", labels={"op": "restore"})
    text = prometheus_text(reg.snapshot())
    type_lines = [ln for ln in text.splitlines() if ln.startswith("# TYPE")]
    assert len(type_lines) == len(set(type_lines)), type_lines
    assert 'opMs_bucket{op="save"' in text
    assert 'opMs_bucket{op="restore"' in text


def test_prometheus_label_value_escaping():
    assert metric_key("m", {"p": "a\\b"}) == 'm{p="a\\\\b"}'
    assert metric_key("m", {"p": 'say "hi"'}) == 'm{p="say \\"hi\\""}'
    assert metric_key("m", {"p": "l1\nl2"}) == 'm{p="l1\\nl2"}'
    reg = MetricsRegistry()
    g = reg.group("ml", "esc")
    g.counter("hits", labels={"path": 'a\\b"c'})
    g.gauge("v", 1.5, labels={"note": "line1\nline2"})
    g.histogram("h", buckets=(1.0,), labels={"q": '"'}).observe(0.5)
    text = prometheus_text(reg.snapshot())
    assert 'flink_ml_tpu_ml_esc_hits_total{path="a\\\\b\\"c"} 1' in text
    assert 'flink_ml_tpu_ml_esc_v{note="line1\\nline2"} 1.5' in text
    assert 'flink_ml_tpu_ml_esc_h_bucket{q="\\"",le="1"} 1' in text
    assert "line1\nline2" not in text
    for line in text.strip().splitlines():
        assert _PROM_LINE.match(line) or _PROM_TYPE.match(line), line


# -- histogram_quantile edge contracts ---------------------------------------

def test_histogram_quantile_rejects_invalid_q():
    snap = {"buckets": [1.0, 10.0], "counts": [1, 2], "sum": 7.0,
            "count": 2}
    for bad in (-0.1, 1.5, float("nan")):
        with pytest.raises(ValueError):
            histogram_quantile(snap, bad)


def test_histogram_quantile_empty_and_bucketless():
    assert math.isnan(histogram_quantile({"count": 0}, 0.5))
    assert math.isnan(Histogram(buckets=(1.0, 2.0)).quantile(0.5))
    assert math.isnan(histogram_quantile({"count": 3}, 0.5))


def test_histogram_quantile_q0_q1_and_single_bucket():
    h = Histogram(buckets=(5.0,))
    h.observe(3.0)
    h.observe(7.0)  # past the last finite bound (+Inf bucket)
    assert h.quantile(0.0) == 0.0
    assert 0.0 < h.quantile(0.5) <= 5.0
    assert h.quantile(1.0) == 5.0
    h2 = Histogram(buckets=(1.0, 10.0))
    h2.observe(0.5)
    h2.observe(5.0)
    assert h2.quantile(1.0) == 10.0


def test_histogram_quantile_interpolates():
    snap = {"buckets": [1.0, 2.0, 4.0], "counts": [0, 10, 10], "sum": 15.0,
            "count": 10}
    assert histogram_quantile(snap, 0.5) == pytest.approx(1.5)


# -- windowed views -----------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_windowed_histogram_slides_and_keeps_cumulative_view():
    clock = _Clock()
    h = WindowedHistogram(buckets=(1.0, 10.0), horizon_s=60.0, slices=6,
                          clock=clock)
    h.observe(0.5)
    clock.t += 30.0
    h.observe(5.0)
    clock.t += 40.0  # the first observation is now older than 60 s
    window = h.window_snapshot(60.0)
    assert window["count"] == 1 and window["counts"] == [0, 1]
    assert h.snapshot()["count"] == 2  # the cumulative view is untouched
    assert h.window_rate(60.0) > 0.0


def test_windowed_counter_counts_only_its_window():
    g = MetricsRegistry().group("ml", "serving")
    g.counter("errors", 5)  # before the window exists: never in it
    wc = g.windowed_counter("errors", horizon_s=60.0, slices=6)
    wc.inc(3)
    assert wc.value == 8
    assert wc.window_delta() == 3


# -- registry parity with the JAX package -------------------------------------

_LABELS = ({}, {"mode": "host"}, {"op": 'save "a"'}, {"p": "x\\y\nz"},
           {"fn": "sgd_batch_terms", "device": "0"})
_BUCKETS = (None, (1.0, 10.0, 100.0), (0.1, 0.5, 0.9, 1.0))


def _drive(pkg_metrics, seed):
    """One seeded sequence of registry operations, from one numpy
    generator, run against ``pkg_metrics`` (a metrics module)."""
    rng = np.random.default_rng(seed)
    reg = pkg_metrics.MetricsRegistry()
    child = pkg_metrics.MetricsRegistry()
    for step in range(300):
        target = child if rng.random() < 0.2 else reg
        group = target.group("ml", ("iteration", "checkpoint",
                                    "serving")[rng.integers(3)])
        labels = _LABELS[rng.integers(len(_LABELS))] or None
        kind = rng.integers(4)
        if kind == 0:
            group.counter(f"c{rng.integers(3)}", int(rng.integers(1, 5)),
                          labels=labels)
        elif kind == 1:
            group.gauge(f"g{rng.integers(3)}", float(rng.normal()),
                        labels=labels)
        elif kind == 2:
            b = _BUCKETS[rng.integers(len(_BUCKETS))]
            name = f"h{rng.integers(2)}{len(b) if b else 0}"
            hist = (group.histogram(name, labels=labels) if b is None
                    else group.histogram(name, buckets=b, labels=labels))
            hist.observe(float(rng.exponential(50.0)))
        else:
            group.windowed_histogram("w", labels=labels).observe(
                float(rng.exponential(20.0)))
    reg.merge(child.snapshot())
    reg.report_model(7, timestamp_ms=1234)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_registry_parity_with_jax(seed):
    port = _drive(port_metrics, seed)
    ref = _drive(jax_metrics, seed)
    port_snap, ref_snap = port.snapshot(), ref.snapshot()
    assert json.dumps(port_snap, sort_keys=True) == json.dumps(
        ref_snap, sort_keys=True)
    assert prometheus_text(port_snap) == jax_exporters.prometheus_text(
        ref_snap)
    for group, gsnap in port_snap.items():
        for key, hist in gsnap["histograms"].items():
            ref_hist = ref_snap[group]["histograms"][key]
            for q in np.linspace(0.0, 1.0, 21):
                a = histogram_quantile(hist, q)
                b = jax_metrics.histogram_quantile(ref_hist, q)
                assert a == b or (math.isnan(a) and math.isnan(b)), (key, q)


@pytest.mark.parametrize("seed", [0, 1])
def test_each_package_merges_the_others_snapshot(seed):
    port = _drive(port_metrics, seed)
    ref = _drive(jax_metrics, seed)
    into_port = port_metrics.MetricsRegistry()
    into_port.merge(ref.snapshot())
    into_jax = jax_metrics.MetricsRegistry()
    into_jax.merge(port.snapshot())
    assert json.dumps(into_port.snapshot(), sort_keys=True) == json.dumps(
        into_jax.snapshot(), sort_keys=True)


# -- the profile() hook on torch.profiler -------------------------------------

def test_profile_region_writes_a_torch_trace(tmp_path):
    out = tmp_path / "prof"
    with port_metrics.profile(str(out), name="Region"):
        np.ones(4).sum()
    traces = [p for p in os.listdir(out) if p.endswith(".pt.trace.json")]
    assert len(traces) == 1
    doc = json.loads((out / traces[0]).read_text())
    assert isinstance(doc["traceEvents"], list)
    assert metrics.group(ML_GROUP, "profile").get_gauge("RegionLastMs") >= 0
    # the claim was released: the next window may start
    assert port_metrics.claim_profiler()
    port_metrics.release_profiler()


def test_profile_region_inside_a_claimed_window_records_wall_time_only(
        tmp_path):
    assert port_metrics.claim_profiler()
    try:
        with port_metrics.profile(str(tmp_path / "inner"), name="Inner"):
            pass
    finally:
        port_metrics.release_profiler()
    assert not (tmp_path / "inner").exists()
    assert metrics.group(ML_GROUP, "profile").get_gauge("InnerLastMs") >= 0


# -- the lock seam --------------------------------------------------------------

@pytest.fixture
def armed(monkeypatch):
    """Arm the watchdog with a fresh graph; restore a clean one after."""
    monkeypatch.setenv(locks.LOCKCHECK_ENV, "1")
    locks.reseed_child()
    yield
    locks.reseed_child()


def test_unarmed_factories_return_bare_primitives(monkeypatch):
    monkeypatch.delenv(locks.LOCKCHECK_ENV, raising=False)
    assert type(locks.make_lock("t.bare")) is type(threading.Lock())
    assert isinstance(locks.make_condition("t.bare"), threading.Condition)


def test_armed_lock_records_acquires_and_holds(armed):
    lk = locks.make_lock("t.hold")
    with lk:
        assert "t.hold" in locks.watchdog().held_names()
    assert locks.watchdog().held_names() == []
    snap = locks.state_snapshot()
    assert snap["acquires"]["t.hold"] == 1
    assert snap["holds"]["t.hold"]["count"] == 1


def test_condition_wait_closes_and_reopens_hold(armed):
    cond = locks.make_condition("t.cond")
    with cond:
        cond.wait(timeout=0.01)
    assert locks.state_snapshot()["holds"]["t.cond"]["count"] == 2
    assert locks.watchdog().held_names() == []


def _seed_cycle():
    a, b = locks.make_lock("t.cycleA"), locks.make_lock("t.cycleB")

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    for fn in (forward, backward):
        t = threading.Thread(target=fn)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()


def test_cycle_detected_mirrored_and_dumped(armed, tmp_path):
    _seed_cycle()
    snap = locks.state_snapshot()
    assert len(snap["cycles"]) == 1
    path = snap["cycles"][0]
    assert path[0] == path[-1] and set(path) == {"t.cycleA", "t.cycleB"}
    before = metrics.group(ML_GROUP, "lock").get_counter("lockCycles")
    written = locks.dump_state(str(tmp_path))
    assert written == os.path.join(
        str(tmp_path), f"locks-{exporters.artifact_suffix()}.json")
    assert json.loads(open(written).read())["cycles"] == snap["cycles"]
    assert metrics.group(ML_GROUP, "lock").get_counter(
        "lockCycles") == before + 1


def test_long_hold_threshold_fires(armed, monkeypatch):
    monkeypatch.setenv(locks.HOLD_MS_ENV, "1")
    lk = locks.make_lock("t.long")
    with lk:
        threading.Event().wait(0.02)
    snap = locks.state_snapshot()
    assert snap["long_hold_total"] == 1
    assert snap["long_holds"][0]["lock"] == "t.long"


def test_unarmed_run_dumps_nothing(monkeypatch, tmp_path):
    monkeypatch.delenv(locks.LOCKCHECK_ENV, raising=False)
    locks.reseed_child()
    with locks.make_lock("t.quiet"):
        pass
    assert locks.dump_state(str(tmp_path)) is None
    assert os.listdir(tmp_path) == []


def test_thread_excepthook_counts_crash(monkeypatch):
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    monkeypatch.setattr(locks, "_hook_installed", False)
    locks.install_thread_excepthook()
    before = metrics.group(ML_GROUP, "thread").get_counter(
        "crashed", labels={"thread": "t-crash"})

    def boom():
        raise RuntimeError("boom")

    t = threading.Thread(target=boom, name="t-crash")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert metrics.group(ML_GROUP, "thread").get_counter(
        "crashed", labels={"thread": "t-crash"}) == before + 1
