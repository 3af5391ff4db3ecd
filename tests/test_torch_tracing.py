"""The port's tracer and exporters (``flink_ml_tpu_torch/observability/
{tracing,exporters}.py``), held against the JAX package's.

- Cases carried over from tests/test_observability.py:66-256 against the
  port: span nesting and parent links, instant events carrying their
  owning span, the disarmed no-op tracer, the Chrome trace, metrics dumps.
- The tracer's cross-boundary causality: ``TraceContext`` headers, links
  and a linked root adopting the link's trace, ``TRACE_PARENT_ENV``, the
  recent-span ring and its eviction count, a child's reseed.
- Cross-reading: each package's ``read_spans``, ``chrome_trace`` and
  ``read_metrics`` read a trace dir the other wrote, to the same records.
"""

import json
import os

import numpy as np
import pytest

from flink_ml_tpu.common.metrics import metrics as jax_registry
from flink_ml_tpu.observability import exporters as jax_exporters
from flink_ml_tpu.observability import tracing as jax_tracing
from flink_ml_tpu_torch.common.metrics import ML_GROUP, MetricsRegistry, metrics
from flink_ml_tpu_torch.observability import exporters, tracing
from flink_ml_tpu_torch.observability.exporters import (
    chrome_trace,
    chrome_trace_events,
    dump_metrics,
    latest_trace_dir,
    read_metrics,
    read_spans,
    resolve_trace_dir,
    write_chrome_trace,
)
from flink_ml_tpu_torch.observability.tracing import (
    TRACE_DIR_ENV,
    TRACE_PARENT_ENV,
    TraceContext,
    Tracer,
    context_of,
    fresh_context,
    tracer,
)


@pytest.fixture(autouse=True)
def _clean_tracer(monkeypatch):
    monkeypatch.delenv(TRACE_DIR_ENV, raising=False)
    monkeypatch.delenv(TRACE_PARENT_ENV, raising=False)
    yield
    tracer.shutdown()
    jax_tracing.tracer.shutdown()


def test_span_nesting_parent_links(tmp_path):
    tracer.configure(str(tmp_path))
    with tracer.span("outer", job="j1") as outer:
        with tracer.span("inner") as inner:
            tracer.event("tick", n=1)
        assert inner.parent_id == outer.span_id
        assert inner.trace_id == outer.trace_id
    tracer.configure(None)
    spans = read_spans(str(tmp_path))
    by_name = {s["name"]: s for s in spans}
    assert by_name["inner"]["parent"] == by_name["outer"]["id"]
    assert by_name["outer"]["parent"] is None
    assert by_name["inner"]["events"][0]["name"] == "tick"
    assert by_name["outer"]["attrs"]["job"] == "j1"
    assert by_name["outer"]["dur_us"] >= by_name["inner"]["dur_us"]
    assert os.listdir(tmp_path) == [f"spans-{os.getpid()}.jsonl"]


def test_chrome_instant_events_carry_owning_span_id(tmp_path):
    tracer.configure(str(tmp_path))
    with tracer.span("outer"):
        with tracer.span("inner"):
            tracer.event("tick", n=1)
    tracer.configure(None)
    spans = read_spans(str(tmp_path))
    by_name = {s["name"]: s for s in spans}
    instants = [e for e in chrome_trace_events(spans) if e["ph"] == "i"]
    tick = next(e for e in instants if e["name"] == "tick")
    assert tick["args"]["span_id"] == by_name["inner"]["id"]
    assert tick["args"]["parent_id"] == by_name["outer"]["id"]
    assert tick["args"]["n"] == 1


def test_disarmed_tracer_is_noop(tmp_path):
    with tracer.span("ghost") as sp:
        sp.set_attribute("x", 1)
        tracer.event("never")
    assert read_spans(str(tmp_path)) == []
    assert tracer.current() is None
    assert context_of(sp) is None


def test_error_attribute_and_event_without_span(tmp_path):
    tracer.configure(str(tmp_path))
    with pytest.raises(KeyError):
        with tracer.span("fails"):
            raise KeyError("x")
    tracer.event("supervisor.restart", attempt=1)  # no span open
    tracer.configure(None)
    spans = {s["name"]: s for s in read_spans(str(tmp_path))}
    assert spans["fails"]["attrs"]["error"] == "KeyError"
    assert spans["event:supervisor.restart"]["events"][0]["attrs"] == {
        "attempt": 1}


def test_trace_context_header_round_trip_and_links(tmp_path):
    ctx = TraceContext("abc-1", "abc-2")
    assert TraceContext.from_header(ctx.to_header()) == ctx
    assert TraceContext.from_header("garbage") is None
    assert TraceContext.from_dict(ctx.to_dict()) == ctx
    tracer.configure(str(tmp_path))
    with tracer.span("producer") as prod:
        handoff = context_of(prod)
    with tracer.span("consumer", links=[handoff]) as cons:
        pass
    tracer.configure(None)
    assert cons.trace_id == prod.trace_id  # a linked root adopts the trace
    rec = {s["name"]: s for s in read_spans(str(tmp_path))}["consumer"]
    assert rec["links"] == [{"trace": prod.trace_id, "span": prod.span_id,
                             "kind": "follows_from"}]
    doc = chrome_trace(str(tmp_path))
    cons_ev = next(e for e in doc["traceEvents"] if e["name"] == "consumer")
    assert cons_ev["args"]["follows_from"] == [prod.span_id]


def test_trace_parent_env_joins_the_launchers_trace(tmp_path, monkeypatch):
    parent = fresh_context()
    monkeypatch.setenv(TRACE_PARENT_ENV, parent.to_header())
    tracer.configure(str(tmp_path))
    with tracer.span("child-root") as sp:
        pass
    tracer.configure(None)
    assert sp.trace_id == parent.trace_id and sp.parent_id is None


def test_recent_ring_counts_evictions(monkeypatch):
    monkeypatch.setenv(tracing.RING_ENV, "2")
    t = Tracer()
    t.keep_recent = True
    for i in range(5):
        with t.span(f"s{i}"):
            pass
    assert [r["name"] for r in t.recent] == ["s3", "s4"]
    assert t.dropped_spans == 3
    before = metrics.group(ML_GROUP, "tracing").get_counter("droppedSpans")
    assert t.mirror_dropped() == 3
    assert metrics.group(ML_GROUP, "tracing").get_counter(
        "droppedSpans") == before + 3


def test_reseed_child_freezes_the_parent_context(tmp_path):
    t = Tracer()
    t.configure(str(tmp_path))
    with t.span("dispatch") as sp:
        ctx = context_of(sp)
        t.reseed_child(ctx)
        t.configure(str(tmp_path))
    with t.span("child-work") as child:
        pass
    t.shutdown()
    assert child.parent_id == ctx.span_id and child.trace_id == ctx.trace_id


def test_maybe_dump_root_metrics_and_read_back(tmp_path):
    tracer.configure(str(tmp_path))
    metrics.group(ML_GROUP, "tracetest").counter("hits", 2)
    with tracer.span("root"):
        tracing.maybe_dump_root_metrics()  # a span is open: no dump
        assert not any(p.startswith("metrics-") for p in os.listdir(tmp_path))
    tracing.maybe_dump_root_metrics()
    tracer.configure(None)
    merged = read_metrics(str(tmp_path))
    assert merged["ml.tracetest"]["counters"]["hits"] >= 2
    assert latest_trace_dir(str(tmp_path)) == str(tmp_path)
    assert resolve_trace_dir(str(tmp_path.parent), latest=False) == str(
        tmp_path.parent)


def test_relabel_snapshot_keeps_members_apart():
    reg = MetricsRegistry()
    reg.group("ml").counter("rows", labels={"servable": "lr"})
    reg.group("ml").counter("x")
    out = exporters.relabel_snapshot(reg.snapshot(), {"process": "p1"})
    assert set(out["ml"]["counters"]) == {
        'rows{process="p1",servable="lr"}', 'x{process="p1"}'}
    assert exporters.safe_process_label() is None
    assert exporters.artifact_suffix() == str(os.getpid())


def test_write_chrome_trace_counts_spans(tmp_path):
    tracer.configure(str(tmp_path / "t"))
    for name in ("a", "b"):
        with tracer.span(name):
            tracer.event("e")
    tracer.configure(None)
    out = tmp_path / "chrome.json"
    assert write_chrome_trace(str(tmp_path / "t"), str(out)) == 2
    doc = json.loads(out.read_text())
    assert {"X", "i"} <= {e["ph"] for e in doc["traceEvents"]}


# -- cross-reading: either package's readers on the other's trace dir ----------

def _write_trace(trc, registry, trace_dir):
    trc.configure(str(trace_dir))
    with trc.span("fit", stage="X") as root:
        with trc.span("segment", epoch_from=0, epoch_to=2):
            trc.event("ml.convergence", algo="X", epoch=0, loss=0.5)
        with trc.span("checkpoint.save", epoch=2, bytes=408):
            pass
        root.set_attribute("rounds", 2)
    registry.group("ml", "crossread").histogram(
        "epochMs", labels={"mode": "host"}).observe(3.0)
    registry.group("ml", "crossread").counter("rounds", 2)
    trc.configure(None)


def _shape(spans):
    by_id = {s["id"]: s for s in spans}
    return sorted((s["name"], (by_id.get(s["parent"]) or {}).get("name"),
                   json.dumps(s["attrs"], sort_keys=True),
                   [e["name"] for e in s["events"]]) for s in spans)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_trace_dir(tmp_path, writer):
    trace_dir = tmp_path / writer
    if writer == "port":
        _write_trace(tracer, metrics, trace_dir)
        dump_metrics(str(trace_dir))
    else:
        _write_trace(jax_tracing.tracer, jax_registry, trace_dir)
        jax_exporters.dump_metrics(str(trace_dir))
    port_spans = read_spans(str(trace_dir))
    jax_spans = jax_exporters.read_spans(str(trace_dir))
    assert port_spans == jax_spans and len(port_spans) == 3
    assert _shape(port_spans)[0][0] == "checkpoint.save"
    assert chrome_trace(str(trace_dir)) == jax_exporters.chrome_trace(
        str(trace_dir))
    port_metrics = read_metrics(str(trace_dir))
    assert port_metrics == jax_exporters.read_metrics(str(trace_dir))
    assert port_metrics["ml.crossread"]["counters"]["rounds"] >= 2


def test_both_packages_write_the_same_record_schema(tmp_path):
    _write_trace(tracer, MetricsRegistry(), tmp_path / "port")
    _write_trace(jax_tracing.tracer, jax_registry, tmp_path / "jax")
    port_spans = read_spans(str(tmp_path / "port"))
    jax_spans = jax_exporters.read_spans(str(tmp_path / "jax"))
    assert _shape(port_spans) == _shape(jax_spans)
    assert [sorted(s) for s in port_spans] == [sorted(s) for s in jax_spans]
    assert (sorted(os.listdir(tmp_path / "port"))
            == sorted(os.listdir(tmp_path / "jax")))


def test_span_ids_are_process_unique():
    ids = {tracing._new_id() for _ in range(1000)}
    assert len(ids) == 1000
    assert all(i.startswith(f"{os.getpid():x}-") for i in ids)
    assert np.all([":" not in i for i in ids])
