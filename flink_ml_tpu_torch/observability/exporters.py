"""Trace/metrics exporters: JSONL span merge, Chrome trace-event JSON,
Prometheus text exposition.

The port of ``flink_ml_tpu/observability/exporters.py``: the same artifact
names, merge rules and ``PROM_PREFIX``, so the series a port fit exposes
are named as the JAX package's are.

Writers (observability/tracing.py) stream one ``spans-<pid>.jsonl`` per
process into the trace dir; host-pool children add their own pid files.
The readers here merge the whole directory — that merge IS the
"collect" step of the fork-boundary design, so a trace survives any mix
of parent/child crashes that left files behind.

Chrome trace-event output loads in Perfetto / chrome://tracing: spans
become complete (``ph: "X"``) events, span events become instants
(``ph: "i"``). Prometheus output is the text exposition format
(name{labels} value), rendered from a registry snapshot — the labeled
key syntax in common/metrics.py is chosen so this is a string split,
not a parser.
"""

from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import re
import sys
from typing import Dict, List, Optional

from flink_ml_tpu_torch.common.metrics import MetricsRegistry, metrics

#: metrics snapshot files in a trace dir (one per traced process)
METRICS_GLOB = "metrics-*.json"
SPANS_GLOB = "spans-*.jsonl"

PROM_PREFIX = "flink_ml_tpu"

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


@contextlib.contextmanager
def pipe_guard():
    """Swallow the BrokenPipeError every ``flink-ml-tpu-trace``
    subcommand's stdout rendering is exposed to (``... | head`` closing
    the pipe is how the CLI is used, not an error) — shared by summary,
    diff, health, shards and the exporter paths so the guard cannot
    drift per subcommand. Exit-code logic stays with the caller: the
    guard only absorbs the write failure."""
    try:
        yield
    except BrokenPipeError:
        try:
            sys.stdout.close()
        except OSError:
            pass


# -- trace-dir resolution -----------------------------------------------------
def latest_trace_dir(root: str) -> Optional[str]:
    """The newest trace dir under ``root``: ``root`` itself or any
    direct child holding ``spans-*.jsonl`` / ``metrics-*.json``
    artifacts, newest by the artifacts' own mtimes (a dir's newest
    artifact decides). Returns None when nothing qualifies — shared by
    every CLI subcommand's ``--latest`` so CI and humans stop
    hand-globbing ``trace-*`` dirs."""
    candidates: Dict[str, float] = {}
    for pat in (SPANS_GLOB, METRICS_GLOB):
        for path in (glob.glob(os.path.join(root, pat))
                     + glob.glob(os.path.join(root, "*", pat))):
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                continue
            d = os.path.dirname(path)
            if os.path.basename(d).startswith("incident-"):
                # a flight-recorder bundle (observability/
                # flightrecorder.py) carries spans-recent.jsonl /
                # metrics.json copies of its OWNING trace dir — it is
                # evidence inside a trace dir, never the trace dir
                # itself (and it is always the newest thing around)
                continue
            candidates[d] = max(candidates.get(d, 0.0), mtime)
    if not candidates:
        return None
    # mtime ties (same-second writes) break on the path so the pick is
    # deterministic
    return max(candidates.items(), key=lambda kv: (kv[1], kv[0]))[0]


def resolve_trace_dir(path: str, latest: bool = False) -> str:
    """The ``--latest`` seam of the trace CLI: with ``latest``, treat
    ``path`` as a root and return its newest trace dir (raising
    FileNotFoundError — an OSError, so existing exit-2 paths catch it —
    when none exists); otherwise return ``path`` unchanged."""
    if not latest:
        return path
    resolved = latest_trace_dir(path)
    if resolved is None:
        raise FileNotFoundError(
            f"{path}: no trace dirs with spans-*.jsonl or "
            f"metrics-*.json under it")
    return resolved


# -- span collection ---------------------------------------------------------
def read_spans(trace_dir: str) -> List[dict]:
    """All span records from every ``spans-*.jsonl`` in ``trace_dir``
    (parent + forked children), in start-time order. Truncated trailing
    lines (a process killed mid-write) are skipped, not fatal — a trace
    from a crashed run is exactly when this reader matters most."""
    records: List[dict] = []
    for path in sorted(glob.glob(os.path.join(trace_dir, SPANS_GLOB))):
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("type") == "span":
                    records.append(rec)
    records.sort(key=lambda r: (r.get("ts_us", 0), r.get("id", "")))
    return records


# -- Chrome trace-event format ----------------------------------------------
def chrome_trace_events(spans: List[dict]) -> List[dict]:
    events: List[dict] = []
    for sp in spans:
        args = dict(sp.get("attrs", {}))
        args["span_id"] = sp.get("id")
        if sp.get("parent"):
            args["parent_id"] = sp["parent"]
        if sp.get("links"):
            # the follows_from handoff edges (tracing.TraceContext):
            # Perfetto has no native link rendering, but the ids in
            # args make the DAG walkable from the event inspector
            args["follows_from"] = [ln.get("span")
                                    for ln in sp["links"]]
        events.append({
            "name": sp.get("name", "?"),
            "cat": "span",
            "ph": "X",
            "ts": sp.get("ts_us", 0),
            "dur": sp.get("dur_us") or 0,
            "pid": sp.get("pid", 0),
            "tid": sp.get("tid", 0),
            "args": args,
        })
        for ev in sp.get("events", ()):
            ev_args = dict(ev.get("attrs", {}))
            # the owning span's ids must ride along, or Perfetto shows a
            # floating instant nobody can correlate with its span
            ev_args["span_id"] = sp.get("id")
            if sp.get("parent"):
                ev_args["parent_id"] = sp["parent"]
            events.append({
                "name": ev.get("name", "?"),
                "cat": "event",
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "ts": ev.get("ts_us", sp.get("ts_us", 0)),
                "pid": sp.get("pid", 0),
                "tid": sp.get("tid", 0),
                "args": ev_args,
            })
    return events


def chrome_trace(trace_dir: str) -> dict:
    """Perfetto-loadable JSON object for a whole trace directory."""
    return {"traceEvents": chrome_trace_events(read_spans(trace_dir)),
            "displayTimeUnit": "ms"}


def write_chrome_trace(trace_dir: str, out_path: str) -> int:
    """Write the merged Chrome trace; returns the number of span records
    exported."""
    doc = chrome_trace(trace_dir)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return sum(1 for e in doc["traceEvents"] if e["ph"] == "X")


# -- metrics snapshots in the trace dir --------------------------------------
def safe_process_label() -> Optional[int]:
    """This process's rank when it runs in a ``torch.distributed`` group
    of more than one process (``parallel/mesh.py`` ``init_distributed``),
    else None; never raises — THE wrapper every artifact writer (span
    sink, metrics dumps, span-record attribution) shares: labeling must
    never sink a write. Recomputed per call: cheap next to the disk write
    it accompanies."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 — see above
        pass
    return None


def artifact_suffix() -> str:
    """The per-process artifact name suffix: the pid alone in a
    single-process runtime, ``p<rank>-<pid>`` when the runtime spans
    processes (a ``torch.distributed`` group of more than one, see
    :func:`safe_process_label`). Two hosts routinely hand out the same pid,
    so pid-only names silently collide when a multi-process run shares
    one trace dir: one process's ``metrics-<pid>.json`` overwrites
    another's and their spans interleave under one pid. Shared by the
    span sink (tracing.py), the metrics snapshots below and the drift
    state dump — every writer into a trace dir names files through this
    one seam."""
    k = safe_process_label()
    pid = os.getpid()
    return f"p{k}-{pid}" if k is not None else str(pid)


def dump_metrics(trace_dir: str,
                 registry: MetricsRegistry = metrics) -> str:
    """Write the registry snapshot as ``metrics-<pid>.json``
    (``metrics-p<k>-<pid>.json`` in a multi-process runtime — see
    :func:`artifact_suffix`; overwrite: the newest snapshot per process
    supersedes earlier ones). The lock watchdog's state dumps alongside
    as ``locks-<pid>.json`` (a no-op for processes that never armed it),
    and, when the drift and evaluation modules are loaded (the serving
    path loads them), their live state as ``drift-<pid>.json`` and
    ``quality-<pid>.json``."""
    os.makedirs(trace_dir, exist_ok=True)
    if registry is metrics:
        # fold the span-ring eviction tally into ml.tracing
        # droppedSpans before snapshotting — the per-span hot path
        # only increments an int (tracing.Tracer.mirror_dropped)
        from flink_ml_tpu_torch.observability import tracing

        tracing.tracer.mirror_dropped()
        # same dump-point pattern for the lock watchdog (common/
        # locks.py): hold-time histograms and cycle/long-hold counters
        # fold into ml.lock BEFORE the snapshot is written
        from flink_ml_tpu_torch.common import locks

        locks.mirror_metrics()
    path = os.path.join(trace_dir, f"metrics-{artifact_suffix()}.json")
    snap = registry.snapshot()
    proc = _process_labels()
    if proc is not None:
        # multi-process runs share one trace dir: label every series
        # with its member so the artifact merge keeps them distinct
        # (the Prometheus-collision fix, see relabel_snapshot)
        snap = relabel_snapshot(snap, proc)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(snap, f, default=str)
    os.replace(tmp, path)
    # lock-watchdog acquisition graph rides alongside as
    # locks-<suffix>.json (a no-op for processes that never armed it)
    for name in ("drift", "evaluation"):
        mod = sys.modules.get(f"flink_ml_tpu_torch.observability.{name}")
        if mod is not None:
            try:
                mod.dump_state(trace_dir)
            except OSError:
                pass  # the metrics snapshot is the primary artifact
    try:
        from flink_ml_tpu_torch.common import locks as locks_mod

        locks_mod.dump_state(trace_dir)
    except OSError:
        pass
    return path


def read_metrics(trace_dir: str) -> Dict[str, dict]:
    """Merge every ``metrics-*.json`` in the dir into one snapshot."""
    merged = MetricsRegistry()
    for path in sorted(glob.glob(os.path.join(trace_dir, METRICS_GLOB))):
        try:
            with open(path, "r", encoding="utf-8") as f:
                merged.merge(json.load(f))
        except (OSError, json.JSONDecodeError, ValueError):
            continue  # a torn snapshot must not sink the readable ones
    return merged.snapshot()


# -- multi-process series disambiguation --------------------------------------
def _relabel_key(key: str, extra: Dict[str, str]) -> str:
    """Fold ``extra`` labels into a rendered series key; labels the key
    already carries win (a series explicitly attributed stays as
    written)."""
    from flink_ml_tpu_torch.common.metrics import metric_key
    from flink_ml_tpu_torch.observability.health import _parse_labels

    name, rest = _split_labels(key)
    got = _parse_labels(rest)
    for k, v in extra.items():
        got.setdefault(k, v)
    return metric_key(name, got)


def relabel_snapshot(snapshot: Dict[str, dict],
                     extra: Dict[str, str]) -> Dict[str, dict]:
    """A copy of a registry snapshot with ``extra`` labels folded into
    every series key. The multi-process collision fix: two replicas
    both recording ``transformMs{servable="lr"}`` would otherwise dump
    and expose IDENTICAL series names — a scraper silently
    last-writes-wins, and the artifact merge sums them with no way to
    tell members apart. A ``process="p<k>"`` label keeps every member's
    series distinct while the slo/diff readers' label-subset matching
    still aggregates across them."""
    out: Dict[str, dict] = {}
    for group, gsnap in snapshot.items():
        gout = dict(gsnap)
        for section in ("gauges", "counters", "histograms"):
            entries = gsnap.get(section)
            if isinstance(entries, dict):
                gout[section] = {_relabel_key(k, extra): v
                                 for k, v in entries.items()}
        out[group] = gout
    return out


def _process_labels() -> Optional[Dict[str, str]]:
    """``{"process": "p<k>"}`` in a multi-process runtime, else None."""
    k = safe_process_label()
    return {"process": f"p{k}"} if k is not None else None


# -- Prometheus text exposition ----------------------------------------------
def _prom_name(group: str, metric: str, suffix: str = "") -> str:
    name = f"{PROM_PREFIX}_{group}_{metric}{suffix}".replace(".", "_")
    return _NAME_OK.sub("_", name)


def _split_labels(key: str):
    """``name{k="v"}`` → (name, 'k="v"'); plain names → (key, '')."""
    if "{" in key and key.endswith("}"):
        name, _, rest = key.partition("{")
        return name, rest[:-1]
    return key, ""


def _with_labels(name: str, labels: str, extra: str = "") -> str:
    inner = ",".join(x for x in (labels, extra) if x)
    return f"{name}{{{inner}}}" if inner else name


def _fmt(value) -> str:
    try:
        v = float(value)
    except (TypeError, ValueError):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _series_by_name(entries: Dict[str, object]):
    """Group ``key -> value`` (key possibly labeled) by bare metric name:
    name → [(labels, value), ...] — one exposition family per name (the
    text format allows exactly one ``# TYPE`` line per metric name, so
    labeled series of one metric must render under a single header)."""
    by_name: Dict[str, List] = {}
    for key in sorted(entries):
        name, labels = _split_labels(key)
        by_name.setdefault(name, []).append((labels, entries[key]))
    return by_name


def prometheus_text(snapshot: Optional[Dict[str, dict]] = None) -> str:
    """Render a registry snapshot (default: the live process registry) in
    the Prometheus text exposition format, histograms as cumulative
    ``_bucket{le=...}`` series plus ``_sum``/``_count``. In a
    multi-process runtime every series gains a ``process="p<k>"`` label
    (see :func:`relabel_snapshot` — two scraped replicas must never
    emit identical series names)."""
    if snapshot is None:
        snapshot = metrics.snapshot()
    proc = _process_labels()
    if proc is not None:
        snapshot = relabel_snapshot(snapshot, proc)
    lines: List[str] = []
    for group in sorted(snapshot):
        gsnap = snapshot[group]
        for name, series in _series_by_name(
                gsnap.get("gauges", {})).items():
            prom = _prom_name(group, name)
            lines.append(f"# TYPE {prom} gauge")
            for labels, value in series:
                lines.append(f"{_with_labels(prom, labels)} "
                             f"{_fmt(value)}")
        for name, series in _series_by_name(
                gsnap.get("counters", {})).items():
            prom = _prom_name(group, name, "_total")
            lines.append(f"# TYPE {prom} counter")
            for labels, value in series:
                lines.append(f"{_with_labels(prom, labels)} "
                             f"{_fmt(value)}")
        for name, series in _series_by_name(
                gsnap.get("histograms", {})).items():
            prom = _prom_name(group, name)
            lines.append(f"# TYPE {prom} histogram")
            for labels, hist in series:
                # counts are already cumulative (metrics.Histogram)
                for bound, cnt in zip(hist["buckets"], hist["counts"]):
                    lines.append(
                        f"{_with_labels(prom + '_bucket', labels, _le(bound))}"
                        f" {_fmt(cnt)}")
                lines.append(
                    f"{_with_labels(prom + '_bucket', labels, _le(math.inf))}"
                    f" {_fmt(hist['count'])}")
                lines.append(f"{_with_labels(prom + '_sum', labels)} "
                             f"{_fmt(hist['sum'])}")
                lines.append(f"{_with_labels(prom + '_count', labels)} "
                             f"{_fmt(hist['count'])}")
    return "\n".join(lines) + "\n"


def _le(bound: float) -> str:
    return f'le="{_fmt(bound)}"'
