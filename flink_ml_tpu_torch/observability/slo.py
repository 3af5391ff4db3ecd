"""SLO engine: declarative latency/error-rate objectives, multi-window
burn-rate evaluation, and the ``slo`` trace gate.

The port of ``flink_ml_tpu/observability/slo.py``: the same specs,
verdicts, events, counters and exit codes, so either package evaluates the
other's ``metrics-*.json`` artifacts to the same verdicts.

The serving seam (servable/api.py) records windowed latency histograms
and error counters into ``ml.serving`` (common/metrics.py
:class:`~flink_ml_tpu_torch.common.metrics.WindowedHistogram` /
:class:`~flink_ml_tpu_torch.common.metrics.WindowedCounter`); this module
turns them into verdicts:

- an :class:`SLO` pairs a metric selector with ONE objective — a
  latency quantile bound (``p99 of transformMs <= threshold_ms``), a
  max error ratio (``errors / (errors + transforms) <= max``), or a
  **drift** bound (the worst ``drift{servable=,feature=,stat=}`` gauge
  the drift evaluator records, observability/drift.py, must stay
  ``<= max_drift``; no gauges → ok, ``source: "missing"``) — over a
  primary ``window_s``;
- every SLO additionally evaluates **multi-window burn rates** (Google
  SRE style): the fraction of the error budget being consumed, per
  window — ``bad_fraction / budget`` where the budget is ``1 -
  quantile`` for latency and ``max_error_ratio`` for errors. A short
  window catches fast burns, a long one slow ones; each has its own
  ``max_burn_rate``;
- violations emit ``ml.slo`` instant events (tracing) and
  ``slo_violations{slo=...}`` counters in the ``ml.slo`` registry
  group, so the trace artifacts carry the verdict history.

Specs load from JSON or TOML (stdlib ``tomllib``) — see
docs/observability.md "Live telemetry & SLOs" for the format — or fall
back to :func:`default_slos`. Evaluation sources:

- **live** (the ``/slo`` endpoint, observability/server.py): sliding
  windows straight from the process registry's windowed metrics;
- **artifacts** (``flink-ml-tpu-trace slo <dir>``): the merged
  ``metrics-*.json`` snapshots are cumulative, so every objective
  evaluates the run-total distribution and is tagged
  ``source: "cumulative"`` — the windowed half needs the live endpoint;
- **fleet** (``scope: fleet`` on the SLO): windowed bucket slices from
  the live fleet beacons (observability/fleet.py) are summed bin-exactly
  across *alive* members BEFORE quantiles/burn rates, tagged
  ``source: "fleet[<n>]:<w>s"``; the verdict carries ``members`` /
  ``membersAlive`` / ``membersMissing`` (+ a ``perMember`` quantile
  table for latency kinds) and FAILS outright while any member is dead
  — a half-dead fleet must not report a healthy p99 from survivors
  alone.

CLI: ``python -m flink_ml_tpu_torch.observability.slo <dir> [--spec F]
[--check] [--json] [--latest]`` (the port's trace CLI is each module's
:func:`main` until its dispatcher is ported) — with ``--check`` exits
:data:`EXIT_VIOLATION` (4) on any violated SLO, :data:`EXIT_INVALID` (2)
on broken artifacts or an unreadable spec; consistent with ``diff``
(docs/observability.md exit codes).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

from flink_ml_tpu_torch.common.metrics import (
    ML_GROUP,
    WindowedHistogram,
    histogram_quantile,
    metrics,
)
from flink_ml_tpu_torch.observability import tracing

__all__ = [
    "EXIT_OK",
    "EXIT_INVALID",
    "EXIT_VIOLATION",
    "SLO_EVENT",
    "SLO_SPEC_ENV",
    "SLO",
    "default_slos",
    "active_slos",
    "load_specs",
    "evaluate_slos",
    "render_verdicts",
    "main",
]

EXIT_OK = 0
EXIT_INVALID = 2
#: the documented violation exit code — same class as ``diff --budget``
EXIT_VIOLATION = 4

#: instant-event name for SLO violations in the trace
SLO_EVENT = "ml.slo"

#: env var holding a spec file path; when set, the live ``/slo``
#: endpoint evaluates it instead of :func:`default_slos`
SLO_SPEC_ENV = "FLINK_ML_TPU_SLO_SPEC"

#: default multi-window burn-rate gates: (window_s, max_burn_rate) —
#: the SRE-handbook fast/slow pair scaled to a process-local horizon
DEFAULT_BURN_WINDOWS = ((60.0, 14.4), (300.0, 6.0))

_KINDS = ("latency", "error-rate", "drift", "quality")


@dataclasses.dataclass
class SLO:
    """One declarative objective over a metric family. Fields unused by
    the ``kind`` (e.g. ``threshold_ms`` for error-rate) are ignored.

    Kind ``drift`` reads the ``drift{servable=,feature=,stat=}`` gauges
    the drift evaluator records (observability/drift.py): the max gauge
    matching ``stat`` (+ any ``labels`` narrowing) must stay at or
    under ``max_drift``; with no matching gauges the objective is ok
    and tagged ``source: "missing"`` — an unpublished baseline must
    never fail an SLO. ``group`` defaults to ``ml.drift`` for this
    kind.

    Kind ``quality`` reads the ``quality{servable=,metric=}`` gauges
    the continuous-evaluation plane records
    (observability/evaluation.py): the WORST gauge matching ``metric``
    (higher-is-better — AUC by default) must stay at or above
    ``min_quality``, and with ``max_quality_delta`` set, each
    servable's live gauge must not fall more than that under its
    ``qualityBaseline`` twin. No matching gauges — no feedback joined
    yet, or a thin window — is ok with ``source: "missing"``: absence
    of ground truth never burns an error budget. ``group`` defaults to
    ``ml.quality`` for this kind."""

    name: str
    kind: str = "latency"   # "latency" | "error-rate" | "drift" | "quality"
    group: str = f"{ML_GROUP}.serving"
    histogram: str = "transformMs"   # latency source (ms histogram)
    total: str = "transforms"        # error-rate denominator counter
    errors: str = "errors"           # error-rate numerator counter
    labels: Optional[Dict[str, str]] = None  # None → every series
    quantile: float = 0.99
    threshold_ms: float = 500.0
    max_error_ratio: float = 0.01
    window_s: float = 60.0
    burn_windows: Tuple[Tuple[float, float], ...] = DEFAULT_BURN_WINDOWS
    stat: str = "psi"                # drift statistic: psi | js | ks
    max_drift: float = 0.2           # drift gauge bound
    metric: str = "auc"              # quality metric (higher-is-better)
    min_quality: float = 0.6         # quality gauge floor
    max_quality_delta: Optional[float] = None  # live-under-baseline bound
    scope: str = "process"           # "process" | "fleet"

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"SLO {self.name!r}: unknown kind {self.kind!r} "
                f"(expected one of {_KINDS})")
        if self.scope not in ("process", "fleet"):
            raise ValueError(
                f"SLO {self.name!r}: unknown scope {self.scope!r} "
                f"(expected 'process' or 'fleet')")
        if not 0.0 < float(self.quantile) < 1.0:
            raise ValueError(
                f"SLO {self.name!r}: quantile must be in (0, 1)")
        if float(self.window_s) <= 0:
            raise ValueError(f"SLO {self.name!r}: window_s must be > 0")
        if self.kind == "drift":
            if self.stat not in ("psi", "js", "ks"):
                raise ValueError(
                    f"SLO {self.name!r}: drift stat must be psi|js|ks, "
                    f"got {self.stat!r}")
            if self.group == f"{ML_GROUP}.serving":
                # the drift gauges live in their own group; only the
                # untouched default is redirected — an explicit group
                # (a custom evaluator's) is honored
                self.group = f"{ML_GROUP}.drift"
        if self.kind == "quality":
            if self.max_quality_delta is not None \
                    and float(self.max_quality_delta) < 0:
                raise ValueError(
                    f"SLO {self.name!r}: max_quality_delta must be "
                    f">= 0")
            if self.group == f"{ML_GROUP}.serving":
                # same rule as drift: only the untouched default moves
                self.group = f"{ML_GROUP}.quality"
        self.burn_windows = tuple(
            (float(w), float(m)) for w, m in self.burn_windows)

    @classmethod
    def from_dict(cls, d: dict) -> "SLO":
        if not isinstance(d, dict) or "name" not in d:
            raise ValueError(f"SLO spec entry must be a mapping with a "
                             f"'name', got {d!r}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"SLO {d.get('name')!r}: unknown spec "
                             f"key(s) {sorted(unknown)}")
        return cls(**d)

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["burn_windows"] = [list(bw) for bw in self.burn_windows]
        return out


def default_slos() -> List[SLO]:
    """The out-of-the-box serving SLOs: p99 transform latency and the
    aggregate error ratio, each across every servable's series."""
    return [SLO(name="serving-latency-p99", kind="latency"),
            SLO(name="serving-error-rate", kind="error-rate")]


def load_specs(path: str) -> List[SLO]:
    """Parse an SLO spec file — JSON anywhere, TOML on Python 3.11+
    (stdlib ``tomllib``; no new dependency). The document is a
    ``{"slos": [...]}`` mapping (TOML: ``[[slos]]`` tables) or a bare
    JSON list. Raises ValueError on malformed specs."""
    with open(path, "rb") as f:
        raw = f.read()
    if path.endswith(".toml"):
        try:
            import tomllib
        except ImportError as e:  # Python 3.10: no stdlib TOML parser
            raise ValueError(
                "TOML SLO specs need Python 3.11+ (tomllib); "
                "use the JSON spelling instead") from e
        try:
            doc = tomllib.loads(raw.decode("utf-8"))
        except tomllib.TOMLDecodeError as e:
            raise ValueError(f"{path}: invalid TOML: {e}") from e
    else:
        try:
            doc = json.loads(raw.decode("utf-8"))
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: invalid JSON: {e}") from e
    items = doc.get("slos") if isinstance(doc, dict) else doc
    if not isinstance(items, list) or not items:
        raise ValueError(f"{path}: expected a non-empty 'slos' list")
    specs = [SLO.from_dict(d) for d in items]
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"{path}: duplicate SLO names in spec")
    return specs


def active_slos() -> List[SLO]:
    """The SLOs the live endpoint evaluates: ``FLINK_ML_TPU_SLO_SPEC``
    (a spec file path) when set, else :func:`default_slos`."""
    path = os.environ.get(SLO_SPEC_ENV)
    if path:
        return load_specs(path)
    return default_slos()


# -- series matching / combination -------------------------------------------

def _match_key(key: str, name: str,
               labels: Optional[Dict[str, str]]) -> bool:
    base, _, rest = key.partition("{")
    if base != name:
        return False
    if not labels:
        return True
    from flink_ml_tpu_torch.observability.health import _parse_labels

    got = _parse_labels(rest[:-1] if rest else "")
    return all(got.get(k) == str(v) for k, v in labels.items())


def _combine(snaps: Sequence[dict]) -> dict:
    """Sum matching labeled histogram series into one snapshot (they
    must share a bucket layout — ``ml.serving transformMs`` does by
    construction; drift raises, surfacing as broken artifacts)."""
    buckets = tuple(float(b) for b in snaps[0].get("buckets", ()))
    out = {"buckets": list(buckets), "counts": [0] * len(buckets),
           "sum": 0.0, "count": 0}
    for s in snaps:
        if tuple(float(b) for b in s.get("buckets", ())) != buckets:
            raise ValueError(
                "mismatched bucket layouts across matching SLO series — "
                "narrow the SLO with labels")
        for i, c in enumerate(s.get("counts", ())):
            out["counts"][i] += int(c)
        out["sum"] += float(s.get("sum", 0.0))
        out["count"] += int(s.get("count", 0))
    return out


def _fraction_le(snap: dict, bound: float) -> float:
    """Fraction of observations <= ``bound`` (linear interpolation
    inside the winning bucket, same rule as histogram_quantile);
    observations past the last finite bucket count as above."""
    total = int(snap.get("count", 0))
    if total <= 0:
        return 1.0
    prev_b, prev_c = 0.0, 0
    for b, c in zip(snap.get("buckets", ()), snap.get("counts", ())):
        b = float(b)
        if bound <= b:
            if b <= prev_b:
                return c / total
            frac = (bound - prev_b) / (b - prev_b)
            return (prev_c + (c - prev_c) * frac) / total
        prev_b, prev_c = b, int(c)
    return prev_c / total


class _RegistrySource:
    """Live evaluation: sliding windows from the process registry's
    windowed metrics; plain series fall back to cumulative."""

    def __init__(self, registry):
        self._registry = registry

    def hist_window(self, group: str, name: str,
                    labels: Optional[Dict[str, str]], window_s: float):
        grp = self._registry.group(*group.split("."))
        keys = [k for k in grp.snapshot().get("histograms", {})
                if _match_key(k, name, labels)]
        snaps, sources = [], set()
        for key in keys:
            # a fully-rendered key passes through metric_key unchanged,
            # so histogram(key) returns the existing registered object
            h = grp.histogram(key)
            if isinstance(h, WindowedHistogram):
                snaps.append(h.window_snapshot(window_s))
                sources.add("windowed")
            else:
                snaps.append(h.snapshot())
                sources.add("cumulative")
        if not snaps:
            return None, "windowed"
        return _combine(snaps), ("windowed" if sources == {"windowed"}
                                 else "cumulative")

    def counter_window(self, group: str, name: str,
                       labels: Optional[Dict[str, str]],
                       window_s: float):
        grp = self._registry.group(*group.split("."))
        wcs = [wc for key, wc in grp.windowed_counter_items()
               if _match_key(key, name, labels)]
        if wcs:
            return (sum(wc.window_delta(window_s) for wc in wcs),
                    "windowed")
        counters = grp.snapshot().get("counters", {})
        vals = [int(v) for k, v in counters.items()
                if _match_key(k, name, labels)]
        if vals:
            return sum(vals), "cumulative"
        return 0, "none"

    def gauge_values(self, group: str, name: str,
                     labels: Optional[Dict[str, str]]):
        gauges = self._registry.group(
            *group.split(".")).snapshot().get("gauges", {})
        return [(k, float(v)) for k, v in gauges.items()
                if _match_key(k, name, labels)]


class _SnapshotSource:
    """Artifact evaluation: a merged registry snapshot is cumulative —
    window sizes are ignored and every value is tagged accordingly."""

    def __init__(self, snapshot: Dict[str, dict]):
        self._snap = snapshot or {}

    def hist_window(self, group, name, labels, window_s):
        hists = (self._snap.get(group) or {}).get("histograms", {})
        snaps = [h for k, h in hists.items()
                 if _match_key(k, name, labels)]
        if not snaps:
            return None, "cumulative"
        return _combine(snaps), "cumulative"

    def counter_window(self, group, name, labels, window_s):
        counters = (self._snap.get(group) or {}).get("counters", {})
        vals = [int(v) for k, v in counters.items()
                if _match_key(k, name, labels)]
        if vals:
            return sum(vals), "cumulative"
        return 0, "none"

    def gauge_values(self, group, name, labels):
        gauges = (self._snap.get(group) or {}).get("gauges", {})
        out = []
        for k, v in gauges.items():
            if not _match_key(k, name, labels):
                continue
            try:
                out.append((k, float(v)))
            except (TypeError, ValueError):
                continue  # non-numeric gauge: not comparable
        return out


class _FleetSource:
    """``scope: fleet`` evaluation: windowed bucket slices summed
    bin-exactly across the fleet's *alive* members
    (observability/fleet.py :class:`~FleetView`) BEFORE any quantile or
    burn rate — a half-dead fleet must not report a healthy p99 from
    survivors alone, so the members that did NOT contribute surface as
    ``membersMissing`` on the verdict (and a dead member fails it)."""

    def __init__(self, view):
        self.view = view

    def hist_window(self, group, name, labels, window_s):
        return self.view.hist_window(group, name, labels, window_s)

    def counter_window(self, group, name, labels, window_s):
        return self.view.counter_window(group, name, labels, window_s)

    def gauge_values(self, group, name, labels):
        return self.view.gauge_values(group, name, labels)


class _EmptyFleetSource:
    """A fleet-scope SLO with no fleet telemetry resolvable: every read
    answers 'no data' tagged ``fleet-missing`` — absence of a fleet
    plane is visible on the verdict, never a crash."""

    view = None

    def hist_window(self, group, name, labels, window_s):
        return None, "fleet-missing"

    def counter_window(self, group, name, labels, window_s):
        return 0, "fleet-missing"

    def gauge_values(self, group, name, labels):
        return []


def _make_fleet_source(fleet_view=None, fleet_dir: Optional[str] = None):
    """The ``scope: fleet`` source: an explicit view, a directory, or
    this process's own fleet-dir resolution (the ``/slo`` route path)."""
    if fleet_view is not None:
        return _FleetSource(fleet_view)
    from flink_ml_tpu_torch.observability import fleet

    base = fleet_dir
    if base is not None:
        base = fleet.find_fleet_dir(base) or base
    else:
        base = fleet.fleet_dir()
    if not base:
        return _EmptyFleetSource()
    view = fleet.FleetView(base)
    if not view.members:
        return _EmptyFleetSource()
    return _FleetSource(view)


# -- evaluation ---------------------------------------------------------------

def _eval_latency(slo: SLO, source) -> List[dict]:
    objectives = []
    snap, src = source.hist_window(slo.group, slo.histogram, slo.labels,
                                   slo.window_s)
    n = int(snap["count"]) if snap else 0
    value = histogram_quantile(snap, slo.quantile) if snap else \
        float("nan")
    ok = not (n > 0 and value > slo.threshold_ms)
    objectives.append({
        "objective": "latency-quantile", "window_s": slo.window_s,
        "quantile": slo.quantile,
        "value_ms": None if math.isnan(value) else round(value, 3),
        "threshold_ms": slo.threshold_ms, "samples": n, "ok": ok,
        "source": src})
    budget = max(1.0 - slo.quantile, 1e-9)
    for window_s, max_burn in slo.burn_windows:
        snap, src = source.hist_window(slo.group, slo.histogram,
                                       slo.labels, window_s)
        n = int(snap["count"]) if snap else 0
        bad = (1.0 - _fraction_le(snap, slo.threshold_ms)) if n else 0.0
        burn = bad / budget
        objectives.append({
            "objective": "latency-burn", "window_s": window_s,
            "bad_fraction": round(bad, 6),
            "budget_fraction": round(budget, 6),
            "burn_rate": round(burn, 3), "max_burn_rate": max_burn,
            "samples": n, "ok": n == 0 or burn <= max_burn,
            "source": src})
    return objectives


def _eval_error_rate(slo: SLO, source) -> List[dict]:
    objectives = []
    windows = [(slo.window_s, None)] + list(slo.burn_windows)
    for window_s, max_burn in windows:
        errors, esrc = source.counter_window(slo.group, slo.errors,
                                             slo.labels, window_s)
        total, tsrc = source.counter_window(slo.group, slo.total,
                                            slo.labels, window_s)
        requests = int(errors) + int(total)
        ratio = (errors / requests) if requests else 0.0
        if esrc.startswith("fleet") or tsrc.startswith("fleet"):
            # fleet-scope reads keep their member-count attribution
            src = tsrc if tsrc.startswith("fleet") else esrc
        else:
            src = ("windowed" if {esrc, tsrc} <= {"windowed", "none"}
                   else "cumulative")
        if max_burn is None:  # the primary objective
            objectives.append({
                "objective": "error-ratio", "window_s": window_s,
                "errors": int(errors), "requests": requests,
                "value": round(ratio, 6),
                "max_error_ratio": slo.max_error_ratio,
                "ok": requests == 0 or ratio <= slo.max_error_ratio,
                "source": src})
        else:
            budget = max(slo.max_error_ratio, 1e-9)
            burn = ratio / budget
            objectives.append({
                "objective": "error-burn", "window_s": window_s,
                "bad_fraction": round(ratio, 6),
                "budget_fraction": round(budget, 6),
                "burn_rate": round(burn, 3), "max_burn_rate": max_burn,
                "samples": requests,
                "ok": requests == 0 or burn <= max_burn,
                "source": src})
    return objectives


def _eval_drift(slo: SLO, source) -> List[dict]:
    """The ``drift`` objective: the worst matching
    ``drift{servable=,feature=,stat=}`` gauge (observability/drift.py
    records them on every evaluation) must not exceed ``max_drift``.
    No matching gauges — no baseline published, or no evaluation yet —
    is ok with ``source: "missing"``: drift absence of evidence never
    burns an error budget."""
    labels = dict(slo.labels or {})
    labels["stat"] = slo.stat
    gauges = source.gauge_values(slo.group, "drift", labels)
    finite = [(k, v) for k, v in gauges if math.isfinite(v)]
    if not finite:
        return [{"objective": "drift-stat", "stat": slo.stat,
                 "value": None, "max_drift": slo.max_drift,
                 "series": 0, "worst": None, "ok": True,
                 "source": "missing"}]
    worst_key, worst = max(finite, key=lambda kv: kv[1])
    return [{"objective": "drift-stat", "stat": slo.stat,
             "value": round(worst, 6), "max_drift": slo.max_drift,
             "series": len(finite), "worst": worst_key,
             "ok": worst <= slo.max_drift, "source": "gauge"}]


def _eval_quality(slo: SLO, source) -> List[dict]:
    """The ``quality`` objective: the worst matching
    ``quality{servable=,metric=}`` gauge (observability/evaluation.py
    records them once the joined-label floor is met) must stay at or
    above ``min_quality``; with ``max_quality_delta``, each servable's
    live gauge is also held within that delta under its
    ``qualityBaseline`` twin. No matching gauges — no feedback joined,
    or a thin window — is ok with ``source: "missing"``: absence of
    ground truth never burns an error budget."""
    from flink_ml_tpu_torch.observability.health import _parse_labels

    labels = dict(slo.labels or {})
    labels["metric"] = slo.metric
    gauges = source.gauge_values(slo.group, "quality", labels)
    finite = [(k, v) for k, v in gauges if math.isfinite(v)]
    if not finite:
        return [{"objective": "quality-metric", "metric": slo.metric,
                 "value": None, "min_quality": slo.min_quality,
                 "series": 0, "worst": None, "ok": True,
                 "source": "missing"}]
    worst_key, worst = min(finite, key=lambda kv: kv[1])
    objectives = [{"objective": "quality-metric", "metric": slo.metric,
                   "value": round(worst, 6),
                   "min_quality": slo.min_quality,
                   "series": len(finite), "worst": worst_key,
                   "ok": worst >= slo.min_quality, "source": "gauge"}]
    if slo.max_quality_delta is None:
        return objectives
    base_gauges = source.gauge_values(slo.group, "qualityBaseline",
                                      labels)
    def _series_key(key: str):
        # "quality{metric=auc,servable=X}" — fleet-scope reads append
        # "@member", so pair live/baseline by (servable, member tail)
        _, _, rest = key.partition("{")
        body, _, tail = rest.partition("}")
        return _parse_labels(body).get("servable"), tail

    by_servable = {}
    for k, v in base_gauges:
        if not math.isfinite(v):
            continue
        by_servable[_series_key(k)] = v
    worst_delta, worst_pair = None, None
    for k, v in finite:
        base = by_servable.get(_series_key(k))
        if base is None:
            continue
        delta = base - v
        if worst_delta is None or delta > worst_delta:
            worst_delta, worst_pair = delta, k
    if worst_delta is None:
        # live gauges with no baseline twin: the delta objective has
        # nothing to anchor on — a publishing gap, not a regression
        objectives.append({
            "objective": "quality-delta", "metric": slo.metric,
            "value": None,
            "max_quality_delta": slo.max_quality_delta,
            "worst": None, "ok": True, "source": "missing"})
    else:
        objectives.append({
            "objective": "quality-delta", "metric": slo.metric,
            "value": round(worst_delta, 6),
            "max_quality_delta": slo.max_quality_delta,
            "worst": worst_pair,
            "ok": worst_delta <= slo.max_quality_delta,
            "source": "gauge"})
    return objectives


def evaluate_slos(slos: Optional[Sequence[SLO]] = None, registry=None,
                  snapshot: Optional[Dict[str, dict]] = None,
                  emit: bool = False, fleet_view=None,
                  fleet_dir: Optional[str] = None) -> List[dict]:
    """Evaluate ``slos`` (default: :func:`active_slos`) against either a
    live ``registry`` (default: the process registry — sliding windows)
    or an artifact ``snapshot`` (cumulative). SLOs declaring
    ``scope: fleet`` instead read live fleet beacons — an explicit
    ``fleet_view`` (:class:`~flink_ml_tpu_torch.observability.fleet.FleetView`),
    a ``fleet_dir``, or this process's own fleet-dir resolution — and
    their verdicts carry fleet bookkeeping: ``members`` /
    ``membersAlive`` / ``membersMissing`` plus a ``perMember`` quantile
    table, and FAIL whenever a member is dead even if the survivors'
    aggregate meets the objective. With ``emit``, every violated SLO
    lands an ``ml.slo`` trace event plus a ``slo_violations{slo=...}``
    counter in the ``ml.slo`` group of the process registry. Returns
    one verdict dict per SLO."""
    if slos is None:
        slos = active_slos()
    if snapshot is not None:
        source = _SnapshotSource(snapshot)
    else:
        source = _RegistrySource(metrics if registry is None
                                 else registry)
    fleet_source = None
    verdicts = []
    for slo in slos:
        src = source
        if slo.scope == "fleet":
            if fleet_source is None:
                fleet_source = _make_fleet_source(fleet_view, fleet_dir)
            src = fleet_source
        if slo.kind == "latency":
            objectives = _eval_latency(slo, src)
        elif slo.kind == "drift":
            objectives = _eval_drift(slo, src)
        elif slo.kind == "quality":
            objectives = _eval_quality(slo, src)
        else:
            objectives = _eval_error_rate(slo, src)
        ok = all(o["ok"] for o in objectives)
        verdict = {"slo": slo.name, "kind": slo.kind, "ok": ok,
                   "objectives": objectives}
        if slo.scope == "fleet":
            verdict["scope"] = "fleet"
            view = getattr(src, "view", None)
            if view is None:
                verdict.update(members=0, membersAlive=0,
                               membersMissing=[], fleet="missing")
            else:
                membership = view.membership()
                missing = view.members_missing()
                dead = [row["member"] for row in membership
                        if row["state"] == "dead"]
                verdict.update(
                    members=len(membership),
                    membersAlive=sum(1 for row in membership
                                     if row["state"] == "alive"),
                    membersMissing=missing)
                if slo.kind == "latency":
                    verdict["perMember"] = {
                        m: round(q, 3) for m, q in
                        view.per_member_quantile(
                            slo.group, slo.histogram, slo.labels,
                            slo.window_s, slo.quantile).items()}
                if dead:
                    # survivors meeting the bound is NOT a healthy
                    # fleet: a dead member fails the verdict outright
                    verdict["ok"] = ok = False
                    verdict["membersDead"] = dead
        verdicts.append(verdict)
        if emit and not ok:
            failing = [o["objective"] for o in objectives
                       if not o["ok"]]
            metrics.group(ML_GROUP, "slo").counter(
                "slo_violations", labels={"slo": slo.name})
            tracing.tracer.event(SLO_EVENT, slo=slo.name, ok=False,
                                 failing=",".join(failing))
            try:
                # flight recorder (observability/flightrecorder.py):
                # freeze the span ring + windowed metrics that explain
                # the violation before they rotate away — debounced,
                # capped, no-op without an armed trace dir, and
                # re-entrancy-latched (building a bundle evaluates
                # SLOs itself, non-emitting)
                from flink_ml_tpu_torch.observability import flightrecorder

                flightrecorder.record_incident(
                    "slo", slo=slo.name, failing=",".join(failing))
            except Exception:  # noqa: BLE001 — recording must never
                # break the evaluation that detected the violation
                pass
    return verdicts


# -- rendering / CLI ----------------------------------------------------------

def render_verdicts(verdicts: List[dict]) -> str:
    bad = sum(1 for v in verdicts if not v["ok"])
    out = [f"{len(verdicts)} SLO(s), {bad} violated"]
    for v in verdicts:
        out.append("")
        out.append(f"SLO {v['slo']} ({v['kind']})  "
                   f"[{'ok' if v['ok'] else 'VIOLATED'}]")
        if v.get("scope") == "fleet":
            if v.get("fleet") == "missing":
                out.append("  fleet: no telemetry (no beacons resolve)")
            else:
                missing = v.get("membersMissing") or []
                dead = v.get("membersDead") or []
                line = (f"  fleet: {v.get('membersAlive', 0)}/"
                        f"{v.get('members', 0)} member(s) alive")
                if missing:
                    line += f", missing: {', '.join(missing)}"
                if dead:
                    line += f", DEAD: {', '.join(dead)}"
                out.append(line)
                per = v.get("perMember") or {}
                if per:
                    out.append("  per-member: " + "  ".join(
                        f"{m}={q:g}ms" for m, q in sorted(per.items())))
        for o in v["objectives"]:
            if o["objective"] == "drift-stat":
                val = "-" if o["value"] is None else f"{o['value']:g}"
                worst = f" worst {o['worst']}" if o.get("worst") else ""
                flag = "ok" if o["ok"] else "VIOLATED"
                out.append(
                    f"  {o['objective']:<17} "
                    f"{'(' + o['source'] + ')':<26} "
                    f"{o['stat']} {val} (<= {o['max_drift']:g}, "
                    f"{o['series']} series){worst}  [{flag}]")
                continue
            if o["objective"] == "quality-metric":
                val = "-" if o["value"] is None else f"{o['value']:g}"
                worst = f" worst {o['worst']}" if o.get("worst") else ""
                flag = "ok" if o["ok"] else "VIOLATED"
                out.append(
                    f"  {o['objective']:<17} "
                    f"{'(' + o['source'] + ')':<26} "
                    f"{o['metric']} {val} (>= {o['min_quality']:g}, "
                    f"{o['series']} series){worst}  [{flag}]")
                continue
            if o["objective"] == "quality-delta":
                val = "-" if o["value"] is None else f"{o['value']:g}"
                worst = f" worst {o['worst']}" if o.get("worst") else ""
                flag = "ok" if o["ok"] else "VIOLATED"
                out.append(
                    f"  {o['objective']:<17} "
                    f"{'(' + o['source'] + ')':<26} "
                    f"{o['metric']} under baseline by {val} "
                    f"(<= {o['max_quality_delta']:g}){worst}  "
                    f"[{flag}]")
                continue
            window = f"window {o['window_s']:g}s ({o['source']})"
            if o["objective"] == "latency-quantile":
                val = "-" if o["value_ms"] is None else \
                    f"{o['value_ms']:g} ms"
                detail = (f"p{o['quantile'] * 100:g} {val} "
                          f"(<= {o['threshold_ms']:g} ms, "
                          f"{o['samples']} sample(s))")
            elif o["objective"] == "error-ratio":
                detail = (f"ratio {o['value']:g} "
                          f"(<= {o['max_error_ratio']:g}, "
                          f"{o['errors']}/{o['requests']} request(s))")
            else:
                detail = (f"burn {o['burn_rate']:g}x "
                          f"(max {o['max_burn_rate']:g}x, bad "
                          f"{o['bad_fraction']:g} of budget "
                          f"{o['budget_fraction']:g})")
            flag = "ok" if o["ok"] else "VIOLATED"
            out.append(f"  {o['objective']:<17} {window:<26} {detail}"
                       f"  [{flag}]")
    return "\n".join(out)


def main(argv=None) -> int:
    """``flink-ml-tpu-trace slo <dir>`` — evaluate SLOs against the
    metrics artifacts of a trace dir (cumulative; the windowed view
    lives on the ``/slo`` endpoint of a running process). ``--check``
    exits 4 on any violated SLO, 2 on broken artifacts/spec."""
    import argparse
    import sys

    from flink_ml_tpu_torch.observability.exporters import (
        pipe_guard,
        read_metrics,
        resolve_trace_dir,
    )

    parser = argparse.ArgumentParser(
        prog="flink-ml-tpu-trace slo",
        description="SLO verdicts from a FLINK_ML_TPU_TRACE_DIR's "
                    "metrics artifacts (latency quantiles, error "
                    "ratios, burn rates).")
    parser.add_argument("trace_dir")
    parser.add_argument("--spec", metavar="FILE",
                        help="SLO spec file (JSON, or TOML on Python "
                             "3.11+); default: the built-in serving "
                             "SLOs")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    parser.add_argument("--check", action="store_true",
                        help="exit 4 when any SLO is violated, 2 on "
                             "broken artifacts")
    parser.add_argument("--latest", action="store_true",
                        help="treat TRACE_DIR as a root and pick the "
                             "newest trace dir under it")
    parser.add_argument("--fleet", metavar="DIR", default=None,
                        help="fleet beacon dir for 'scope: fleet' "
                             "SLOs (default: TRACE_DIR's fleet/ "
                             "subdir)")
    args = parser.parse_args(argv)

    try:
        trace_dir = resolve_trace_dir(args.trace_dir, args.latest)
        snapshot = read_metrics(trace_dir)
    except OSError as e:
        print(f"flink-ml-tpu-trace slo: cannot read {args.trace_dir}: "
              f"{e}", file=sys.stderr)
        return EXIT_INVALID
    try:
        slos = load_specs(args.spec) if args.spec else default_slos()
    except (OSError, ValueError) as e:
        print(f"flink-ml-tpu-trace slo: {e}", file=sys.stderr)
        return EXIT_INVALID
    if not snapshot and not any(s.scope == "fleet" for s in slos):
        # a fleet-scope spec evaluates from beacons, not metrics
        # artifacts — only the artifact path needs them
        print(f"flink-ml-tpu-trace slo: no metrics-*.json artifacts in "
              f"{trace_dir}", file=sys.stderr)
        return EXIT_INVALID
    try:
        verdicts = evaluate_slos(
            slos, snapshot=snapshot,
            fleet_dir=args.fleet if args.fleet else trace_dir)
    except (OSError, ValueError) as e:
        print(f"flink-ml-tpu-trace slo: {e}", file=sys.stderr)
        return EXIT_INVALID

    with pipe_guard():
        if args.json:
            print(json.dumps({"trace_dir": trace_dir,
                              "source": "cumulative",
                              "verdicts": verdicts}, indent=2,
                             default=str))
        else:
            print(render_verdicts(verdicts))
    violated = [v["slo"] for v in verdicts if not v["ok"]]
    if args.check and violated:
        print(f"flink-ml-tpu-trace slo: {len(violated)} violated "
              f"SLO(s): {', '.join(violated)}", file=sys.stderr)
        return EXIT_VIOLATION
    return EXIT_OK


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
