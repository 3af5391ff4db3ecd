"""Anomaly-triggered flight recorder: when something degrades, hand the
operator the evidence — not a dashboard snapshot taken after the fact.

The port of ``flink_ml_tpu/observability/flightrecorder.py``: the same
triggers, bundle layout, debounce, cap and counters, so either package
reads and acknowledges the other's bundles.

The tracer already keeps a bounded ring of recently closed spans
(tracing.Tracer.recent, capacity ``FLINK_ML_TPU_TRACE_RING``) and the
metrics registry holds the live counters/gauges/windows. This module is
the dump valve: :func:`record_incident` freezes both — plus the SLO,
drift and controller state that explain *why* — into an
``incident-<seq>/`` bundle under the armed trace dir the moment an
anomaly fires, BEFORE the ring rotates the explanation away.

Wired triggers (each calls :func:`record_incident` with its own kind):

==============  ============================================================
kind            fired by
==============  ============================================================
``slo``         a violated SLO during an emitting evaluation
                (observability/slo.py — the ``/slo`` scrape, the ops
                controller's watch step)
``divergence``  a model-health divergence classification — the
                ``ml.health`` event that precedes the terminal
                :class:`~flink_ml_tpu_torch.resilience.policy.NonFiniteState`
                (observability/health.py)
``drift``       a drift verdict crossing its threshold during an
                emitting evaluation (observability/drift.py)
``quality``     a degraded continuous-evaluation verdict during an
                emitting evaluation (observability/evaluation.py)
``rollback``    :meth:`~flink_ml_tpu_torch.serving.registry.ModelRegistry
                .rollback` — the ops loop demoted a serving version
==============  ============================================================

Bundle layout (everything best-effort: a bundle with a missing optional
file is still evidence; a recorder failure must never worsen the
incident it records)::

    incident-000/
      incident.json        seq, kind, trigger attrs, ts, acknowledged
      spans-recent.jsonl   the span ring at trigger time (the evidence)
      metrics.json         full registry snapshot (cumulative)
      windows.json         windowed ml.serving views (recent p99s/rates)
      slo.json             SLO verdicts at trigger time (non-emitting)
      drift.json           drift report at trigger time (non-emitting)
      controller.json      /controller provider state, when registered
      mesh.json            copied from the trace dir when present
      profile/             a short bounded ``torch.profiler`` window of the
      profile.json         anomaly's aftermath + its per-op attribution,
                           unless that would initialize the card
                           (observability/profiling.py; length
                           ``FLINK_ML_TPU_INCIDENT_PROFILE_MS``, default
                           200, 0 disables)

Bundles are **debounced** (``FLINK_ML_TPU_INCIDENT_DEBOUNCE_S``,
default 30 — one incident usually fires several triggers in a burst:
the SLO violation, the drift verdict AND the rollback it caused) and
**capped** (``FLINK_ML_TPU_INCIDENT_MAX``, default 8) per process;
suppressed triggers are counted (``ml.incident suppressed{reason=}``)
so a quiet recorder is distinguishable from a disarmed one. Without an
armed trace dir there is nowhere durable to dump — the trigger counts
(``skipped{reason="no-trace-dir"}``) and nothing is written.

Inspect with ``python -m flink_ml_tpu_torch.observability.flightrecorder
<dir> [--json|--check]`` (the port's trace CLI is each module's
:func:`main` until its dispatcher is ported):
renders each bundle's trigger and the preceding-span timeline; with
``--check`` exits :data:`EXIT_UNACKED` (4) while any unacknowledged
incident exists (``--ack`` marks them reviewed), 2 on unreadable
artifacts — the CI smoke's gate (docs/observability.md).
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import threading
import time
from typing import Dict, List, Optional

from flink_ml_tpu_torch.common.locks import make_lock
from flink_ml_tpu_torch.common.metrics import ML_GROUP, metrics
from flink_ml_tpu_torch.observability import tracing

__all__ = [
    "DEBOUNCE_ENV", "MAX_ENV", "RECORDER_ENV", "INCIDENT_EVENT",
    "INCIDENT_PREFIX", "EXIT_OK", "EXIT_INVALID", "EXIT_UNACKED",
    "record_incident", "read_incidents", "acknowledge", "reset",
    "main",
]

#: ``0`` disables the recorder outright (the triggers stay compiled in;
#: one env read decides)
RECORDER_ENV = "FLINK_ML_TPU_FLIGHT_RECORDER"
#: minimum seconds between bundles (default 30): one degradation fires
#: many triggers — the first bundle carries the evidence
DEBOUNCE_ENV = "FLINK_ML_TPU_INCIDENT_DEBOUNCE_S"
#: bundle cap per process (default 8): a flapping SLO must not fill the
#: disk with near-identical bundles
MAX_ENV = "FLINK_ML_TPU_INCIDENT_MAX"

#: instant-event name stamped when a bundle lands
INCIDENT_EVENT = "ml.incident"

INCIDENT_PREFIX = "incident-"
INCIDENT_FILE = "incident.json"

EXIT_OK = 0
EXIT_INVALID = 2
#: the CLI's --check exit while an unacknowledged incident exists —
#: same violation class as slo/drift/controller's 4
EXIT_UNACKED = 4

_lock = make_lock("observability.flightrecorder")
_seq = 0
_last_ts: Optional[float] = None
# re-entrancy latch: building a bundle evaluates SLOs/drift, which can
# themselves trigger — the recorder must never recurse into itself
_recording = threading.local()


def _enabled() -> bool:
    return os.environ.get(RECORDER_ENV, "").strip() != "0"


def _debounce_s() -> float:
    raw = os.environ.get(DEBOUNCE_ENV)
    if raw:
        try:
            return max(0.0, float(raw))
        except ValueError:
            pass
    return 30.0


def _max_incidents() -> int:
    raw = os.environ.get(MAX_ENV)
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return 8


def _group():
    return metrics.group(ML_GROUP, "incident")


def _suppress(reason: str) -> None:
    try:
        _group().counter("suppressed", labels={"reason": reason})
    except Exception:  # noqa: BLE001 — accounting only
        pass


def reset() -> None:
    """Forget the per-process debounce/sequence state (tests; also the
    right call after re-pointing the trace dir at a fresh run)."""
    global _seq, _last_ts
    with _lock:
        _seq = 0
        _last_ts = None


def _write_json(path: str, payload) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, default=str)


def _windowed_views() -> Dict[str, dict]:
    """Recent windowed views of the serving seam — the "what did the
    last minute look like" half a cumulative snapshot cannot answer."""
    out: Dict[str, dict] = {}
    grp = metrics.group(ML_GROUP, "serving")
    from flink_ml_tpu_torch.common.metrics import (
        WindowedHistogram,
        histogram_quantile,
    )

    for key in list(grp.snapshot().get("histograms", {})):
        h = grp.histogram(key)
        if not isinstance(h, WindowedHistogram):
            continue
        snap = h.window_snapshot(60.0)
        out[key] = {
            "window_s": 60.0,
            "count": snap.get("count", 0),
            "p50_ms": histogram_quantile(snap, 0.5),
            "p99_ms": histogram_quantile(snap, 0.99),
        }
    for key, wc in grp.windowed_counter_items():
        out[key] = {"window_s": 60.0,
                    "delta": wc.window_delta(60.0),
                    "rate_per_s": wc.window_rate(60.0)}
    return out


def record_incident(kind: str, **attrs) -> Optional[str]:
    """Dump an incident bundle for an anomaly of ``kind``; returns the
    bundle path (None when disabled, debounced, capped, undumpable or
    re-entered). ``attrs`` are the triggering event's own attributes —
    they land verbatim in ``incident.json`` so the bundle names its
    cause. Never raises: the recorder must not worsen the incident."""
    if not _enabled():
        return None
    if getattr(_recording, "active", False):
        return None
    trace_dir = tracing.tracer.trace_dir
    if not trace_dir:
        _suppress("no-trace-dir")
        return None
    global _seq, _last_ts
    with _lock:
        now = time.monotonic()
        if _last_ts is not None and now - _last_ts < _debounce_s():
            _suppress("debounced")
            return None
        if _seq >= _max_incidents():
            _suppress("capped")
            return None
        _seq += 1  # the per-process cap counts THIS process's bundles
        _last_ts = now
    _recording.active = True
    try:
        return _dump(trace_dir, kind, attrs)
    except Exception:  # noqa: BLE001 — see docstring
        import logging

        logging.getLogger(__name__).warning(
            "flight recorder failed to dump incident (kind=%s)", kind,
            exc_info=True)
        return None
    finally:
        _recording.active = False


def _next_seq(trace_dir: str) -> int:
    """One past the highest bundle index already on disk — the dir may
    hold bundles from a PREVIOUS run of the same trace dir (or another
    process sharing it); a restarting process must extend the series,
    not collide with incident-000 and lose its evidence."""
    top = -1
    for path in glob.glob(os.path.join(trace_dir,
                                       INCIDENT_PREFIX + "*")):
        name = os.path.basename(path)
        if name.endswith(".tmp"):
            continue
        try:
            top = max(top, int(name[len(INCIDENT_PREFIX):]))
        except ValueError:
            continue
    return top + 1


def _dump(trace_dir: str, kind: str, attrs: dict) -> str:
    seq = _next_seq(trace_dir)
    final = os.path.join(trace_dir, f"{INCIDENT_PREFIX}{seq:03d}")
    tmp = final + ".tmp"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp, exist_ok=True)

    # the spans that ran up to the trigger: the ring, oldest first.
    # deque iteration can race a concurrent append (RuntimeError) —
    # retry, the /spans/recent idiom
    spans: List[dict] = []
    for _ in range(8):
        try:
            spans = list(tracing.tracer.recent)
            break
        except RuntimeError:
            continue
    with open(os.path.join(tmp, "spans-recent.jsonl"), "w",
              encoding="utf-8") as f:
        for rec in spans:
            f.write(json.dumps(rec, default=str) + "\n")

    dropped = tracing.tracer.mirror_dropped()
    _write_json(os.path.join(tmp, "metrics.json"), metrics.snapshot())
    try:
        _write_json(os.path.join(tmp, "windows.json"),
                    _windowed_views())
    except Exception:  # noqa: BLE001 — optional evidence
        pass
    try:
        from flink_ml_tpu_torch.observability import slo

        _write_json(os.path.join(tmp, "slo.json"),
                    slo.evaluate_slos(slo.active_slos(), emit=False))
    except Exception:  # noqa: BLE001 — optional evidence
        pass
    try:
        from flink_ml_tpu_torch.observability import drift
        from flink_ml_tpu_torch.observability.health import _json_safe

        _write_json(os.path.join(tmp, "drift.json"),
                    _json_safe(drift.drift_report(emit=False)))
    except Exception:  # noqa: BLE001 — optional evidence
        pass
    try:
        from flink_ml_tpu_torch.observability import server
        from flink_ml_tpu_torch.observability.health import _json_safe

        provider = server.get_controller_status()
        if provider is not None:
            _write_json(os.path.join(tmp, "controller.json"),
                        _json_safe(provider()))
    except Exception:  # noqa: BLE001 — optional evidence
        pass
    mesh_src = os.path.join(trace_dir, "mesh.json")
    if os.path.isfile(mesh_src):
        try:
            shutil.copyfile(mesh_src, os.path.join(tmp, "mesh.json"))
        except OSError:
            pass
    # a short bounded device profile of the anomaly's aftermath — raw
    # trace under profile/, attribution at profile.json. profiling
    # refuses on its own (kill-switch, not the owning process, a card
    # not yet initialized, another trace active) rather than block the
    # dump
    profiled = False
    try:
        from flink_ml_tpu_torch.observability import profiling

        profiled = profiling.capture_incident_profile(tmp)
    except Exception:  # noqa: BLE001 — optional evidence
        pass

    from flink_ml_tpu_torch.observability.exporters import safe_process_label

    meta = {
        "seq": seq,
        "kind": kind,
        "ts_us": time.time_ns() // 1000,
        "attrs": dict(attrs),
        "pid": os.getpid(),
        "process": safe_process_label(),
        "spans": len(spans),
        # cumulative ring evictions say how long the process has been
        # up; evidence_truncated answers the question that matters for
        # THIS bundle — was the ring full, i.e. did older spans of the
        # incident's window rotate out before the dump
        "dropped_spans": dropped,
        "ring_capacity": tracing.tracer.recent.maxlen,
        "evidence_truncated": (
            tracing.tracer.recent.maxlen is not None
            and len(spans) >= tracing.tracer.recent.maxlen),
        "device_profile": profiled,
        "acknowledged": False,
    }
    _write_json(os.path.join(tmp, INCIDENT_FILE), meta)
    # atomic publish: readers (the CLI, an artifact uploader racing the
    # serving process) never see a half-written bundle. Another process
    # sharing the trace dir may have claimed the index between the scan
    # and here — step past it (meta rewritten to match the dir name)
    # instead of discarding the evidence
    for _ in range(8):
        try:
            os.replace(tmp, final)
            break
        except OSError:
            meta["seq"] = seq = _next_seq(trace_dir)
            final = os.path.join(trace_dir,
                                 f"{INCIDENT_PREFIX}{seq:03d}")
            _write_json(os.path.join(tmp, INCIDENT_FILE), meta)
    else:
        raise OSError(f"could not publish incident bundle into "
                      f"{trace_dir}")
    try:
        _group().counter("recorded", labels={"kind": kind})
    except Exception:  # noqa: BLE001 — accounting only
        pass
    tracing.tracer.event(INCIDENT_EVENT, kind=kind, seq=seq,
                         bundle=os.path.basename(final))
    return final


# -- reading / acknowledging --------------------------------------------------

def read_incidents(trace_dir: str,
                   include_spans: bool = True) -> List[dict]:
    """All incident bundles under ``trace_dir``, sequence order; each
    row is the bundle's ``incident.json`` plus ``dir`` (the bundle
    path) and ``recent_spans`` (the preceding-span evidence).
    ``include_spans=False`` skips parsing the span files — callers that
    only list bundles (the live ``/incidents`` route, the CLI's
    ``--json``) must not re-read up to cap x ring-capacity span lines
    per scrape; the meta's own ``spans`` count still reports how much
    evidence each bundle holds."""
    rows: List[dict] = []
    for path in sorted(glob.glob(
            os.path.join(trace_dir, INCIDENT_PREFIX + "*"))):
        if not os.path.isdir(path) or path.endswith(".tmp"):
            continue
        meta_path = os.path.join(path, INCIDENT_FILE)
        try:
            with open(meta_path, "r", encoding="utf-8") as f:
                meta = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue  # a torn bundle must not sink the readable ones
        spans: List[dict] = []
        spans_path = os.path.join(path, "spans-recent.jsonl")
        if include_spans and os.path.isfile(spans_path):
            with open(spans_path, "r", encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        spans.append(json.loads(line))
                    except json.JSONDecodeError:
                        continue
        meta["dir"] = path
        meta["recent_spans"] = spans
        rows.append(meta)
    rows.sort(key=lambda r: r.get("seq", 0))
    return rows


def acknowledge(trace_dir: str, seq: Optional[int] = None) -> int:
    """Mark incidents reviewed (all, or just ``seq``): flips
    ``acknowledged`` in each bundle's ``incident.json`` so ``--check``
    stops exiting 4 for it. Returns the number acknowledged."""
    n = 0
    for row in read_incidents(trace_dir, include_spans=False):
        if seq is not None and row.get("seq") != seq:
            continue
        if row.get("acknowledged"):
            continue
        meta = {k: v for k, v in row.items()
                if k not in ("dir", "recent_spans")}
        meta["acknowledged"] = True
        _write_json(os.path.join(row["dir"], INCIDENT_FILE), meta)
        n += 1
    return n


# -- rendering / CLI ----------------------------------------------------------

def render_incidents(rows: List[dict], spans_tail: int = 12) -> str:
    if not rows:
        return "no incident bundles"
    unacked = sum(1 for r in rows if not r.get("acknowledged"))
    out = [f"{len(rows)} incident bundle(s), {unacked} unacknowledged"]
    for row in rows:
        out.append("")
        attrs = " ".join(f"{k}={v}"
                         for k, v in row.get("attrs", {}).items())
        flag = "" if row.get("acknowledged") else "  [UNACKNOWLEDGED]"
        out.append(f"incident {row.get('seq'):>3}  "
                   f"kind={row.get('kind')}  {attrs}{flag}".rstrip())
        spans = row.get("recent_spans", [])
        if spans:
            ts0 = row.get("ts_us", 0)
            out.append(f"  preceding spans ({len(spans)} ringed, "
                       f"last {min(spans_tail, len(spans))}):")
            for sp in spans[-spans_tail:]:
                dt_ms = (sp.get("ts_us", 0) - ts0) / 1000.0
                dur = (sp.get("dur_us") or 0) / 1000.0
                out.append(f"    {dt_ms:>12.3f} ms  "
                           f"{sp.get('name', '?'):<28} "
                           f"{dur:.3f} ms  trace={sp.get('trace')}")
    return "\n".join(out)


def main(argv=None) -> int:
    """``flink-ml-tpu-trace incident <dir>`` — render incident bundles;
    ``--check`` exits :data:`EXIT_UNACKED` (4) while any unacknowledged
    incident exists (0 when clean — no bundles IS the healthy state),
    :data:`EXIT_INVALID` (2) on an unreadable dir; ``--ack [SEQ]``
    acknowledges (all, or one) first."""
    import argparse
    import sys

    from flink_ml_tpu_torch.observability.exporters import (
        pipe_guard,
        resolve_trace_dir,
    )

    parser = argparse.ArgumentParser(
        prog="flink-ml-tpu-trace incident",
        description="Flight-recorder incident bundles of a "
                    "FLINK_ML_TPU_TRACE_DIR (docs/observability.md "
                    "\"Causal tracing, critical path & incidents\").")
    parser.add_argument("trace_dir")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    parser.add_argument("--check", action="store_true",
                        help="exit 4 while any unacknowledged incident "
                             "exists (clean dir exits 0), 2 on an "
                             "unreadable dir")
    parser.add_argument("--ack", nargs="?", const=-1, type=int,
                        default=None, metavar="SEQ",
                        help="acknowledge incidents (all, or just SEQ) "
                             "before rendering/checking")
    parser.add_argument("--latest", action="store_true",
                        help="treat TRACE_DIR as a root and pick the "
                             "newest trace dir under it")
    args = parser.parse_args(argv)

    try:
        trace_dir = resolve_trace_dir(args.trace_dir, args.latest)
        if not os.path.isdir(trace_dir):
            raise FileNotFoundError(trace_dir)
        if args.ack is not None:
            n = acknowledge(trace_dir,
                            None if args.ack == -1 else args.ack)
            print(f"acknowledged {n} incident(s)", file=sys.stderr)
        # the text render shows the preceding-span timeline; the JSON
        # listing reports the meta's own span count without re-parsing
        # every bundle's evidence
        rows = read_incidents(trace_dir, include_spans=not args.json)
    except OSError as e:
        print(f"flink-ml-tpu-trace incident: cannot read "
              f"{args.trace_dir}: {e}", file=sys.stderr)
        return EXIT_INVALID
    with pipe_guard():
        if args.json:
            slim = [{k: v for k, v in r.items() if k != "recent_spans"}
                    | {"recent_spans": r.get("spans", 0)}
                    for r in rows]
            print(json.dumps({"trace_dir": trace_dir,
                              "incidents": slim}, indent=2,
                             default=str))
        else:
            print(render_incidents(rows))
    unacked = [r for r in rows if not r.get("acknowledged")]
    if args.check and unacked:
        print(f"flink-ml-tpu-trace incident: "
              f"{len(unacked)} unacknowledged incident(s) in "
              f"{trace_dir}", file=sys.stderr)
        return EXIT_UNACKED
    return EXIT_OK


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
