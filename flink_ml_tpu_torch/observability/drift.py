"""Drift detection: training-time baselines, mergeable streaming
sketches, live-vs-baseline comparison wired into serving.

The port of the serving and publishing half of
``flink_ml_tpu/observability/drift.py``: host numpy in float64, with the
same env switches, event names, counters and artifact formats, so either
package's readers read what the other wrote (a baseline published by one
is installed by the other's registry; the JAX ``drift.read_state`` reads
this module's ``drift-<pid>.json``).

Three stages:

- **Sketch** (:class:`StreamingSketch` / :class:`SketchGroup`): a
  fixed-bin histogram with an auto-ranging first pass (values buffer
  until :data:`WARMUP_VALUES`, then the range freezes) plus exact
  count/mean/M2 moments (Chan's parallel update), min/max and a
  non-finite tally. ``merge``/``to_json``/``from_json`` fold partial
  sketches: a merge between sketches sharing bin edges is bit-exact;
  differing edges rebin by bin midpoint (deterministic, counted in
  ``rebinned``).
- **Baseline** (:func:`capture_fit_baseline`): the traced-fit tail
  (models/common.py, models/online.py) sketches a row-capped sample of
  the training inputs per feature plus the final model's predictions
  and attaches the :class:`DriftBaseline` to the fitted model;
  ``serving.publish_model`` serializes it beside the v2 checkpoint
  manifest (``drift-baseline.json``, inside the atomic rename) so the
  hot-swap watcher (serving/registry.py) installs the *matching*
  baseline per model version. No baseline → evaluation reports
  ``source: "missing"`` and never blocks the swap.
- **Compare** (:func:`observe_transform` → :func:`evaluate`): the
  ``_served`` seam feeds per-feature/prediction values into a windowed
  live sketch ring per servable (seeded with the baseline's bin edges,
  so window merges stay exact), and a lazy evaluator on a cadence
  (``FLINK_ML_TPU_DRIFT_INTERVAL_S``) computes **PSI**, **Jensen-
  Shannon distance** and the **KS statistic** per feature and for
  predictions, recording ``drift{servable=,feature=,stat=}`` gauges in
  ``ml.drift``, emitting :data:`DRIFT_EVENT` instant events +
  ``violations{servable=}`` counters past the thresholds, and feeding
  the ``/drift`` live route (observability/server.py).

:func:`read_state` merges a trace dir's ``drift-*.json`` artifacts and
:func:`main` is the ``flink-ml-tpu-torch-trace drift`` view over them
(``--check``: 4 when a servable drifted, 2 on missing artifacts). An
emitting evaluation that reads drifted records a ``drift`` incident bundle
(observability/flightrecorder.py).
"""

from __future__ import annotations

import json
import math
import os
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from flink_ml_tpu_torch.common.locks import make_lock
from flink_ml_tpu_torch.common.metrics import ML_GROUP, metrics
from flink_ml_tpu_torch.observability import tracing

__all__ = [
    "DRIFT_ENV",
    "DRIFT_EVENT",
    "BASELINE_FILENAME",
    "STAT_NAMES",
    "StreamingSketch",
    "SketchGroup",
    "DriftBaseline",
    "enabled",
    "capture_armed",
    "sample_rows",
    "capture_fit_baseline",
    "load_baseline_file",
    "install_baseline",
    "forget_servable",
    "baseline_for",
    "observe_transform",
    "evaluate",
    "drift_report",
    "provenance",
    "compare_sketches",
    "psi",
    "js_distance",
    "ks_stat",
    "thresholds",
    "state_snapshot",
    "merge_state",
    "reseed_child",
    "dump_state",
    "clear",
    "read_state",
    "render_drift",
    "main",
]

#: "0" disables the whole layer (live sketching AND fit-time capture);
#: any other non-empty value force-arms fit-time capture even without a
#: trace dir (live sketching is on by default — it is the serving half)
DRIFT_ENV = "FLINK_ML_TPU_DRIFT"
#: evaluator cadence in seconds (0 = every observation; default 30)
INTERVAL_ENV = "FLINK_ML_TPU_DRIFT_INTERVAL_S"
#: live comparison window in seconds (default 300)
WINDOW_ENV = "FLINK_ML_TPU_DRIFT_WINDOW_S"
#: verdict thresholds per statistic
PSI_ENV = "FLINK_ML_TPU_DRIFT_PSI"
JS_ENV = "FLINK_ML_TPU_DRIFT_JS"
KS_ENV = "FLINK_ML_TPU_DRIFT_KS"
#: minimum live observations per series before a verdict is rendered
MIN_COUNT_ENV = "FLINK_ML_TPU_DRIFT_MIN_COUNT"
#: per-servable cap on sketched feature columns (wide hashed features
#: must not turn every request into a 2^18-column summary)
MAX_FEATURES_ENV = "FLINK_ML_TPU_DRIFT_MAX_FEATURES"
#: row cap for the fit-time training-input sample
SAMPLE_ROWS_ENV = "FLINK_ML_TPU_DRIFT_SAMPLE_ROWS"

#: instant-event name for detected drift in the trace
DRIFT_EVENT = "ml.drift"

#: exit codes (the convention of diff/slo/quality: 4 = gate fired,
#: 2 = broken artifacts)
EXIT_OK = 0
EXIT_INVALID = 2
EXIT_DRIFTED = 4

#: the baseline artifact filename beside a checkpoint's manifest.json
BASELINE_FILENAME = "drift-baseline.json"

#: the statistics every comparison computes, in reporting order
STAT_NAMES = ("psi", "js", "ks")

#: histogram bins per sketch and the auto-ranging buffer size
DEFAULT_BINS = 32
WARMUP_VALUES = 256

#: threshold defaults: PSI 0.25 is the standard "significant
#: population change" rule of thumb; JS/KS are set above the sampling
#: noise a few hundred observations put on 32-bin estimates, so a
#: same-distribution window does not flap the verdict
_DEFAULTS = {PSI_ENV: 0.25, JS_ENV: 0.2, KS_ENV: 0.25,
             INTERVAL_ENV: 30.0, WINDOW_ENV: 300.0}


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return max(1, int(raw))
    except ValueError:
        return default


def enabled() -> bool:
    """The live tier: per-request sketching on the serving seam. On by
    default; ``FLINK_ML_TPU_DRIFT=0`` is the kill switch."""
    return os.environ.get(DRIFT_ENV, "") != "0"


def capture_armed() -> bool:
    """The fit-time tier: baseline capture at the end of a fit. Armed
    when a trace dir is configured or ``FLINK_ML_TPU_DRIFT`` is truthy
    (mirrors health.armed — a plain untraced fit stays zero-cost);
    ``FLINK_ML_TPU_DRIFT=0`` disables it."""
    env = os.environ.get(DRIFT_ENV, "")
    if env == "0":
        return False
    return bool(env) or tracing.tracer.enabled


def thresholds() -> Dict[str, float]:
    """The per-statistic drift thresholds (env-tunable)."""
    return {"psi": _env_float(PSI_ENV, _DEFAULTS[PSI_ENV]),
            "js": _env_float(JS_ENV, _DEFAULTS[JS_ENV]),
            "ks": _env_float(KS_ENV, _DEFAULTS[KS_ENV])}


def _min_count() -> int:
    # below ~100 samples the 10-group estimates are noisy enough that a
    # same-distribution window can brush the thresholds
    return _env_int(MIN_COUNT_ENV, 100)


def _max_features() -> int:
    return _env_int(MAX_FEATURES_ENV, 32)


# -- the mergeable streaming sketch -------------------------------------------

def _merge_moments(n1, mean1, m2_1, n2, mean2, m2_2):
    """Chan's parallel mean/M2 update — deterministic, so the same fold
    order yields bit-identical results on either side of a process
    boundary."""
    if n2 == 0:
        return n1, mean1, m2_1
    if n1 == 0:
        return n2, mean2, m2_2
    n = n1 + n2
    delta = mean2 - mean1
    mean = mean1 + delta * (n2 / n)
    m2 = m2_1 + m2_2 + delta * delta * (n1 * n2 / n)
    return n, mean, m2


class StreamingSketch:
    """Mergeable streaming summary of ONE scalar distribution: exact
    count/mean/M2/min/max moments + a fixed-bin histogram whose range is
    frozen after an auto-ranging first pass (:data:`WARMUP_VALUES`
    buffered values), or seeded explicitly with ``edges`` — how live
    sketches adopt their baseline's binning so window merges and PSI
    comparisons share bins exactly. Thread-safety lives one level up
    (the live window holds the lock); a sketch itself is plain state so
    ``to_json``/``from_json`` round-trip losslessly."""

    __slots__ = ("bins", "edges", "counts", "underflow", "overflow",
                 "pending", "count", "mean", "m2", "vmin", "vmax",
                 "nonfinite", "rebinned")

    def __init__(self, bins: int = DEFAULT_BINS,
                 edges: Optional[Sequence[float]] = None):
        if edges is not None:
            self.edges: Optional[tuple] = tuple(float(e) for e in edges)
            self.bins = len(self.edges) - 1
            if self.bins < 1 or list(self.edges) != sorted(self.edges):
                raise ValueError(f"edges must be >= 2 sorted bounds, "
                                 f"got {edges!r}")
        else:
            self.bins = int(bins)
            if self.bins < 1:
                raise ValueError("bins must be >= 1")
            self.edges = None
        self.counts = [0] * self.bins
        self.underflow = 0
        self.overflow = 0
        self.pending: List[float] = []
        self.count = 0
        self.mean = 0.0
        self.m2 = 0.0
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None
        self.nonfinite = 0
        self.rebinned = 0

    # -- observation ---------------------------------------------------------
    def observe(self, value) -> None:
        self.observe_many([value])

    def observe_many(self, values) -> None:
        arr = np.asarray(values, np.float64).ravel()
        if arr.size == 0:
            return
        finite = np.isfinite(arr)
        self.nonfinite += int(arr.size - finite.sum())
        fv = arr[finite]
        if fv.size == 0:
            return
        bmean = float(fv.mean())
        bm2 = float(np.sum(np.square(fv - bmean)))
        self.count, self.mean, self.m2 = _merge_moments(
            self.count, self.mean, self.m2, int(fv.size), bmean, bm2)
        lo, hi = float(fv.min()), float(fv.max())
        self.vmin = lo if self.vmin is None else min(self.vmin, lo)
        self.vmax = hi if self.vmax is None else max(self.vmax, hi)
        if self.edges is None:
            self.pending.extend(float(v) for v in fv)
            if len(self.pending) >= WARMUP_VALUES:
                self._freeze_range()
        else:
            self._bin(fv)

    def _bin(self, fv: np.ndarray) -> None:
        e = np.asarray(self.edges)
        self.underflow += int((fv < e[0]).sum())
        self.overflow += int((fv > e[-1]).sum())
        hist, _ = np.histogram(fv, bins=e)
        for i, c in enumerate(hist):
            self.counts[i] += int(c)

    def _freeze_range(self) -> None:
        lo = min(self.pending)
        hi = max(self.pending)
        if lo == hi:  # a constant series still needs a non-empty range
            lo, hi = lo - 0.5, hi + 0.5
        self.edges = tuple(float(x)
                           for x in np.linspace(lo, hi, self.bins + 1))
        flush, self.pending = self.pending, []
        self._bin(np.asarray(flush, np.float64))

    def finalize(self) -> "StreamingSketch":
        """Freeze the auto-ranged histogram (no-op when already ranged
        or empty) — called before a baseline serializes so comparisons
        always see binned counts."""
        if self.edges is None and self.pending:
            self._freeze_range()
        return self

    # -- derived -------------------------------------------------------------
    @property
    def stddev(self) -> float:
        if self.count <= 0:
            return float("nan")
        return math.sqrt(max(self.m2, 0.0) / self.count)

    # -- merge / serialization -----------------------------------------------
    def merge(self, snap) -> None:
        """Fold another sketch (object or its ``to_json`` dict) in.
        Identical bin edges add bin-wise (bit-exact — the fork-boundary
        contract); an unranged side contributes its buffered raw values
        exactly; differing edges rebin the incoming counts by bin
        midpoint (deterministic, tallied in ``rebinned``)."""
        if isinstance(snap, StreamingSketch):
            snap = snap.to_json()
        n2 = int(snap.get("count", 0))
        self.count, self.mean, self.m2 = _merge_moments(
            self.count, self.mean, self.m2, n2,
            float(snap.get("mean", 0.0)), float(snap.get("m2", 0.0)))
        self.nonfinite += int(snap.get("nonfinite", 0))
        self.rebinned += int(snap.get("rebinned", 0))
        for attr, pick in (("vmin", min), ("vmax", max)):
            other = snap.get(attr[1:])  # "min"/"max" in the JSON
            if other is not None:
                mine = getattr(self, attr)
                setattr(self, attr, float(other) if mine is None
                        else pick(mine, float(other)))
        pending = snap.get("pending") or []
        if pending:
            if self.edges is None:
                self.pending.extend(float(v) for v in pending)
                if len(self.pending) >= WARMUP_VALUES:
                    self._freeze_range()
            else:
                self._bin(np.asarray(pending, np.float64))
        other_edges = snap.get("edges")
        if other_edges is None:
            return
        other_edges = tuple(float(e) for e in other_edges)
        other_counts = [int(c) for c in snap.get("counts", ())]
        if len(other_counts) != len(other_edges) - 1:
            raise ValueError(
                f"sketch snapshot bin mismatch: {len(other_counts)} "
                f"count(s) vs {len(other_edges) - 1} bin(s)")
        if self.edges is None:
            # adopt the ranged side's edges, flushing our buffer into it
            self.edges = other_edges
            self.bins = len(other_edges) - 1
            self.counts = [0] * self.bins
            flush, self.pending = self.pending, []
            if flush:
                self._bin(np.asarray(flush, np.float64))
        if self.edges == other_edges:
            for i, c in enumerate(other_counts):
                self.counts[i] += c
            self.underflow += int(snap.get("underflow", 0))
            self.overflow += int(snap.get("overflow", 0))
            return
        # differing ranges: deterministic midpoint rebin
        self.rebinned += 1
        e = np.asarray(other_edges)
        mids = (e[:-1] + e[1:]) / 2.0
        weights = np.asarray(other_counts, np.float64)
        mine = np.asarray(self.edges)
        self.underflow += int(snap.get("underflow", 0))
        self.overflow += int(snap.get("overflow", 0))
        self.underflow += int(weights[mids < mine[0]].sum())
        self.overflow += int(weights[mids > mine[-1]].sum())
        hist, _ = np.histogram(mids, bins=mine, weights=weights)
        for i, c in enumerate(hist):
            self.counts[i] += int(c)

    def to_json(self) -> dict:
        return {"bins": self.bins,
                "edges": (list(self.edges)
                          if self.edges is not None else None),
                "counts": list(self.counts),
                "underflow": self.underflow,
                "overflow": self.overflow,
                "pending": list(self.pending),
                "count": self.count,
                "mean": self.mean,
                "m2": self.m2,
                "min": self.vmin,
                "max": self.vmax,
                "nonfinite": self.nonfinite,
                "rebinned": self.rebinned}

    @classmethod
    def from_json(cls, snap: dict) -> "StreamingSketch":
        sk = cls(bins=int(snap.get("bins", DEFAULT_BINS)))
        sk.merge(snap)
        return sk


class SketchGroup:
    """A named bundle of sketches — the per-servable unit both the
    baseline and each live window slice hold. ``template`` maps names
    to bin edges new sketches are seeded with (how live sketches adopt
    the baseline's binning)."""

    def __init__(self, template: Optional[Dict[str, Sequence[float]]]
                 = None):
        self.sketches: Dict[str, StreamingSketch] = {}
        self._template = dict(template or {})

    def sketch(self, name: str) -> StreamingSketch:
        sk = self.sketches.get(name)
        if sk is None:
            edges = self._template.get(name)
            sk = self.sketches[name] = StreamingSketch(edges=edges)
        return sk

    def observe(self, columns: Dict[str, np.ndarray]) -> None:
        for name, values in columns.items():
            self.sketch(name).observe_many(values)

    def merge(self, snap: Dict[str, dict]) -> None:
        for name, ssnap in (snap or {}).items():
            self.sketch(name).merge(ssnap)

    def finalize(self) -> "SketchGroup":
        for sk in self.sketches.values():
            sk.finalize()
        return self

    def to_json(self) -> Dict[str, dict]:
        return {name: sk.to_json()
                for name, sk in self.sketches.items()}

    @classmethod
    def from_json(cls, snap: Dict[str, dict]) -> "SketchGroup":
        group = cls()
        group.merge(snap or {})
        return group


# -- comparison statistics ----------------------------------------------------

def _aligned_counts(base: dict, live: dict):
    """(baseline, live) count vectors over the BASELINE's bins plus its
    under/overflow tails — the shared support every statistic needs.
    Returns None when the baseline has no frozen range (empty sketch)."""
    edges = base.get("edges")
    if not edges:
        return None
    edges = tuple(float(e) for e in edges)
    p = np.asarray([base.get("underflow", 0)]
                   + [int(c) for c in base.get("counts", ())]
                   + [base.get("overflow", 0)], np.float64)
    live_edges = live.get("edges")
    if live_edges is not None:
        live_edges = tuple(float(e) for e in live_edges)
    if live_edges == edges:
        q = np.asarray([live.get("underflow", 0)]
                       + [int(c) for c in live.get("counts", ())]
                       + [live.get("overflow", 0)], np.float64)
        return p, q
    # rebin the live side onto the baseline's edges: buffered raw values
    # exactly, binned counts by midpoint, tails by their own endpoints
    values: List[float] = [float(v) for v in live.get("pending") or []]
    weights: List[float] = [1.0] * len(values)
    if live_edges is not None:
        e = np.asarray(live_edges)
        mids = (e[:-1] + e[1:]) / 2.0
        for m, c in zip(mids, live.get("counts", ())):
            if c:
                values.append(float(m))
                weights.append(float(c))
        if live.get("underflow"):
            values.append(float(e[0]))
            weights.append(float(live["underflow"]))
        if live.get("overflow"):
            values.append(float(e[-1]))
            weights.append(float(live["overflow"]))
    varr = np.asarray(values, np.float64)
    warr = np.asarray(weights, np.float64)
    me = np.asarray(edges)
    q = np.zeros(len(edges) + 1, np.float64)
    if varr.size:
        q[0] = warr[varr < me[0]].sum()
        q[-1] = warr[varr > me[-1]].sum()
        hist, _ = np.histogram(varr, bins=me, weights=warr)
        q[1:-1] = hist
    return p, q


def _coarsen(p_counts: np.ndarray, q_counts: np.ndarray,
             target_groups: int = 10):
    """Regroup two aligned count vectors into ~``target_groups``
    adjacent-bin groups, each holding at least 1/target of the
    BASELINE's mass — the standard PSI preparation: a small live sample
    spread over many fine bins otherwise accrues empty-bin penalties
    that read as drift when nothing moved."""
    pt = float(p_counts.sum())
    if pt <= 0:
        return p_counts, q_counts
    min_mass = pt / target_groups
    gp: List[float] = []
    gq: List[float] = []
    accp = accq = 0.0
    for pi, qi in zip(p_counts, q_counts):
        accp += float(pi)
        accq += float(qi)
        if accp >= min_mass:
            gp.append(accp)
            gq.append(accq)
            accp = accq = 0.0
    if accp or accq:  # the trailing partial group
        if gp:
            gp[-1] += accp
            gq[-1] += accq
        else:
            gp.append(accp)
            gq.append(accq)
    return np.asarray(gp, np.float64), np.asarray(gq, np.float64)


def psi(p_counts: np.ndarray, q_counts: np.ndarray) -> float:
    """Population Stability Index between two aligned count vectors
    (expected=baseline, actual=live), with Laplace (+0.5 per bin)
    smoothing so a sparse live sample's empty bins contribute a
    sample-size-bounded penalty instead of a fixed floor blowup."""
    pt, qt = float(p_counts.sum()), float(q_counts.sum())
    if pt <= 0 or qt <= 0:
        return float("nan")
    k = len(p_counts)
    p = (np.asarray(p_counts, np.float64) + 0.5) / (pt + 0.5 * k)
    q = (np.asarray(q_counts, np.float64) + 0.5) / (qt + 0.5 * k)
    return float(np.sum((q - p) * np.log(q / p)))


def js_distance(p_counts: np.ndarray, q_counts: np.ndarray) -> float:
    """Jensen-Shannon *distance* (sqrt of the base-2 divergence, so the
    value lives in [0, 1]) between two aligned count vectors."""
    pt, qt = float(p_counts.sum()), float(q_counts.sum())
    if pt <= 0 or qt <= 0:
        return float("nan")
    p = p_counts / pt
    q = q_counts / qt
    m = (p + q) / 2.0

    def _kl(a, b):
        mask = a > 0
        return float(np.sum(a[mask] * np.log2(a[mask] / b[mask])))

    jsd = 0.5 * _kl(p, m) + 0.5 * _kl(q, m)
    return math.sqrt(min(max(jsd, 0.0), 1.0))


def ks_stat(p_counts: np.ndarray, q_counts: np.ndarray) -> float:
    """Kolmogorov-Smirnov statistic (max CDF gap at the shared bin
    boundaries — binned, so a lower bound on the exact statistic)."""
    pt, qt = float(p_counts.sum()), float(q_counts.sum())
    if pt <= 0 or qt <= 0:
        return float("nan")
    return float(np.max(np.abs(np.cumsum(p_counts / pt)
                               - np.cumsum(q_counts / qt))))


def compare_sketches(baseline: dict, live: dict) -> Optional[dict]:
    """All :data:`STAT_NAMES` between a baseline sketch snapshot and a
    live one, plus the sample counts and the moment deltas; None when
    the baseline cannot anchor a comparison (no frozen range)."""
    if isinstance(baseline, StreamingSketch):
        baseline = baseline.to_json()
    if isinstance(live, StreamingSketch):
        live = live.to_json()
    aligned = _aligned_counts(baseline, live)
    if aligned is None:
        return None
    p, q = _coarsen(*aligned)
    return {"psi": round(psi(p, q), 6),
            "js": round(js_distance(p, q), 6),
            "ks": round(ks_stat(p, q), 6),
            "baseline_n": int(baseline.get("count", 0)),
            "live_n": int(live.get("count", 0)),
            "mean_delta": round(float(live.get("mean", 0.0))
                                - float(baseline.get("mean", 0.0)), 6)}


# -- the training-time baseline -----------------------------------------------

class DriftBaseline:
    """A fitted model's training-time distribution summary: one sketch
    per (capped) feature column plus one for the predictions, with the
    model/version provenance the hot-swap keys on."""

    def __init__(self, model: str, version: Optional[int] = None,
                 group: Optional[SketchGroup] = None,
                 created_unix: Optional[float] = None):
        self.model = model
        self.version = None if version is None else int(version)
        self.group = group or SketchGroup()
        self.created_unix = (time.time() if created_unix is None
                             else float(created_unix))

    def edges_template(self) -> Dict[str, tuple]:
        """name → frozen bin edges, for seeding live sketches."""
        return {name: sk.edges
                for name, sk in self.group.sketches.items()
                if sk.edges is not None}

    def to_json(self) -> dict:
        self.group.finalize()
        return {"version": 1, "model": self.model,
                "modelVersion": self.version,
                "created_unix": self.created_unix,
                "sketches": self.group.to_json()}

    @classmethod
    def from_json(cls, doc: dict) -> "DriftBaseline":
        if not isinstance(doc, dict) or "sketches" not in doc:
            raise ValueError(
                "drift baseline document must be a mapping with a "
                "'sketches' key")
        return cls(model=str(doc.get("model", "?")),
                   version=doc.get("modelVersion"),
                   group=SketchGroup.from_json(doc["sketches"]),
                   created_unix=doc.get("created_unix"))


def sample_rows(x, cap: Optional[int] = None):
    """Leading-row sample of a feature matrix for baseline capture —
    bounded work at fit end regardless of training-set size. Works on
    ndarray/jax arrays and CSR matrices alike."""
    cap = cap if cap is not None else _env_int(SAMPLE_ROWS_ENV, 4096)
    if getattr(x, "is_sharded_column", False):
        # a split column's leading rows as one tensor (a copy of those
        # rows only)
        return x.rows_range(0, cap)
    try:
        n = x.shape[0]
    except (AttributeError, IndexError):
        return x
    return x[:cap] if n > cap else x


def _matrix_columns(x, max_features: int) -> Dict[str, np.ndarray]:
    """A feature matrix → ``{"f0": col, ...}`` (capped), or
    ``{"value": vec}`` for a 1-D input. CSR inputs densify only the
    capped column slice."""
    if hasattr(x, "tocsr") or hasattr(x, "toarray"):
        x = x[:, :max_features].toarray()
    arr = np.asarray(x, np.float64)
    if arr.ndim == 1:
        return {"value": arr}
    if arr.ndim != 2:
        return {}
    return {f"f{i}": arr[:, i]
            for i in range(min(arr.shape[1], max_features))}


def feature_columns(values,
                    max_features: Optional[int] = None
                    ) -> Dict[str, np.ndarray]:
    """Row-oriented feature values (a DataFrame column: vectors or
    scalars per row) → named columns for sketching. Ragged or
    non-numeric rows yield ``{}`` — the seam must never raise."""
    cap = max_features if max_features is not None else _max_features()
    if not values:
        return {}
    first = values[0]
    try:
        if hasattr(first, "to_array"):
            mat = np.stack([np.asarray(v.to_array(), np.float64)
                            for v in values])
            return _matrix_columns(mat, cap)
        arr = np.asarray(values, np.float64)
    except (TypeError, ValueError):
        return {}
    if arr.ndim == 1:
        return {"value": arr}
    return _matrix_columns(arr, cap)


def capture_fit_baseline(model, algo: str, features=None,
                         predictions=None,
                         version: Optional[int] = None
                         ) -> Optional[DriftBaseline]:
    """Build the training-time baseline from a (row-capped) feature
    sample and the final model's predictions on it, attach it to the
    fitted model as ``model.drift_baseline``, and record the capture
    (``ml.drift baselineCaptured{algo=}`` counter + a trace-dir
    ``drift-baseline-<algo>.json`` artifact when tracing is armed).
    Returns the baseline (None when there was nothing numeric to
    sketch). Never raises past its own logging — a baseline failure
    must not fail the fit that produced the model."""
    group = SketchGroup()
    if features is not None:
        for name, col in _matrix_columns(features,
                                         _max_features()).items():
            group.sketch(name).observe_many(col)
    if predictions is not None:
        try:
            pred = np.asarray(predictions, np.float64).ravel()
        except (TypeError, ValueError):
            pred = None  # vector prediction column: no scalar sketch
        if pred is not None and pred.size:
            group.sketch("prediction").observe_many(pred)
    if not group.sketches:
        return None
    baseline = DriftBaseline(algo, version=version,
                             group=group.finalize())
    try:
        model.drift_baseline = baseline
    except AttributeError:
        pass  # __slots__ model: the caller still gets the return value
    metrics.group(ML_GROUP, "drift").counter(
        "baselineCaptured", labels={"algo": algo})
    if tracing.tracer.enabled:
        try:
            path = os.path.join(tracing.tracer.trace_dir,
                                f"drift-baseline-{algo}.json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(baseline.to_json(), f)
            os.replace(tmp, path)
        except OSError:
            pass  # artifact only; the in-memory baseline is attached
    return baseline


def load_baseline_file(path: str) -> Optional[DriftBaseline]:
    """Read a serialized baseline (the checkpoint-side artifact or a
    ``--baseline`` override); None when the file does not exist, raises
    ValueError on an unreadable/malformed document."""
    if not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: unreadable drift baseline: {e}") from e
    return DriftBaseline.from_json(doc)


# -- live state ---------------------------------------------------------------

class _LiveWindow:
    """Sliding window of live sketches for one servable: a ring of
    closed :class:`SketchGroup` slices plus the open one, rotated lazily
    (no timer thread — the WindowedHistogram shape in
    common/metrics.py). Slices seed their sketches from the baseline's
    bin edges so in-window merges stay bit-exact."""

    def __init__(self, horizon_s: float, slices: int = 30,
                 template: Optional[Dict[str, tuple]] = None,
                 clock=time.monotonic):
        self.horizon_s = float(horizon_s)
        self._slice_s = self.horizon_s / max(1, int(slices))
        self._template = dict(template or {})
        self._clock = clock
        self._ring: List[tuple] = []  # (t_closed, SketchGroup)
        self._current = SketchGroup(self._template)
        self._last_slice = clock()
        self.total = 0  # observations ever (cheap freshness probe)

    def _rotate(self, now: float) -> None:
        if now - self._last_slice < self._slice_s:
            return
        if self._current.sketches:
            self._ring.append((now, self._current))
            self._current = SketchGroup(self._template)
        self._last_slice = now
        cutoff = now - self.horizon_s
        while self._ring and self._ring[0][0] <= cutoff:
            self._ring.pop(0)

    def observe(self, columns: Dict[str, np.ndarray]) -> None:
        self._rotate(self._clock())
        self._current.observe(columns)
        self.total += 1

    def merge(self, snap: Dict[str, dict]) -> None:
        """Fold a child-process group snapshot into the open slice (so
        merged counts are window-visible from merge time — the
        WindowedCounter contract)."""
        self._rotate(self._clock())
        self._current.merge(snap)
        self.total += 1

    def window_json(self, window_s: Optional[float] = None
                    ) -> Dict[str, dict]:
        w = self.horizon_s if window_s is None \
            else min(float(window_s), self.horizon_s)
        now = self._clock()
        self._rotate(now)
        cutoff = now - w
        merged = SketchGroup(self._template)
        for t, group in self._ring:
            if t > cutoff:
                merged.merge(group.to_json())
        merged.merge(self._current.to_json())
        return merged.to_json()


_lock = make_lock("observability.drift")
_baselines: Dict[str, DriftBaseline] = {}
_missing: set = set()       # servables that swapped in without a baseline
_windows: Dict[str, _LiveWindow] = {}
_last_eval: Dict[str, float] = {}
_last_results: Dict[str, dict] = {}
#: insertion-ordered registry of tracked servable names — the eviction
#: order. A continuously-republishing online deployment mints a new
#: versioned name per hot-swap; without a cap, baselines/windows/
#: results for dead versions would grow (and /drift scrapes slow down)
#: without bound while the checkpoint side prunes to keep=8.
_tracked: Dict[str, None] = {}
MAX_TRACKED_SERVABLES = 64


def _track_locked(servable: str) -> None:
    """Mark ``servable`` as live (most-recently tracked) and evict the
    oldest tracked names past :data:`MAX_TRACKED_SERVABLES`. Caller
    holds ``_lock``."""
    _tracked.pop(servable, None)
    _tracked[servable] = None
    while len(_tracked) > MAX_TRACKED_SERVABLES:
        old = next(iter(_tracked))
        if old == servable:  # never evict the name just touched
            break
        _tracked.pop(old)
        _baselines.pop(old, None)
        _missing.discard(old)
        _windows.pop(old, None)
        _last_eval.pop(old, None)
        _last_results.pop(old, None)


def forget_servable(servable: str) -> None:
    """Drop all drift state for one servable — a rejected hot-swap
    candidate whose versioned name will never serve (serving/
    registry.py), or a caller retiring an old version early."""
    with _lock:
        _tracked.pop(servable, None)
        _baselines.pop(servable, None)
        _missing.discard(servable)
        _windows.pop(servable, None)
        _last_eval.pop(servable, None)
        _last_results.pop(servable, None)


def install_baseline(servable: str,
                     baseline: Optional[DriftBaseline]) -> None:
    """Install (or record as missing) the baseline the live comparison
    for ``servable`` anchors on — called by the serving registry's
    hot-swap with the baseline shipped beside that version's checkpoint
    manifest. Keyed by the *versioned* serving name (``lr@v2``), so
    requests still in flight on the previous version keep comparing
    against the previous baseline."""
    with _lock:
        _track_locked(servable)
        if baseline is None:
            _missing.add(servable)
            _baselines.pop(servable, None)
        else:
            _missing.discard(servable)
            _baselines[servable] = baseline
    metrics.group(ML_GROUP, "drift").gauge(
        "baselineInstalled", 0 if baseline is None else 1,
        labels={"servable": servable})


def baseline_for(servable: str) -> Optional[DriftBaseline]:
    with _lock:
        return _baselines.get(servable)


def _window_for(servable: str) -> _LiveWindow:
    with _lock:
        win = _windows.get(servable)
        if win is None:
            _track_locked(servable)
            base = _baselines.get(servable)
            win = _windows[servable] = _LiveWindow(
                _env_float(WINDOW_ENV, _DEFAULTS[WINDOW_ENV]),
                template=(base.edges_template()
                          if base is not None else None))
        return win


def observe_transform(servable: str, features=None,
                      predictions=None) -> None:
    """The serving seam (servable/api.py ``_served``): sketch one
    transform's feature columns and prediction values into the
    servable's live window, then give the lazy evaluator its tick.
    Quietly does nothing when disabled or when the values don't reduce
    to numeric columns — recording must never sink a serving call."""
    if not enabled():
        return
    columns: Dict[str, np.ndarray] = {}
    if features is not None:
        columns.update(feature_columns(features))
    if predictions is not None:
        try:
            pred = np.asarray(list(predictions), np.float64).ravel()
            if pred.size:
                columns["prediction"] = pred
        except (TypeError, ValueError):
            pass
    if not columns:
        return
    win = _window_for(servable)
    with _lock:
        win.observe(columns)
    maybe_evaluate(servable)


def maybe_evaluate(servable: str) -> Optional[dict]:
    """Run :func:`evaluate` when the cadence
    (``FLINK_ML_TPU_DRIFT_INTERVAL_S``) has lapsed for this servable;
    the fast path is one clock read + dict lookup."""
    interval = _env_float(INTERVAL_ENV, _DEFAULTS[INTERVAL_ENV])
    now = time.monotonic()
    with _lock:
        last = _last_eval.get(servable)
        if last is not None and now - last < interval:
            return None
        _last_eval[servable] = now
    return evaluate(servable)


def evaluate(servable: str, emit: bool = True,
             window_s: Optional[float] = None) -> dict:
    """Compare ``servable``'s live window against its installed
    baseline: per-series PSI / JS distance / KS statistic, recorded as
    ``drift{servable=,feature=,stat=}`` gauges in ``ml.drift``; past any
    threshold (and the ``FLINK_ML_TPU_DRIFT_MIN_COUNT`` sample floor)
    the series is *drifted* — with ``emit``, each drifted series lands a
    :data:`DRIFT_EVENT` instant event and the
    ``violations{servable=}`` counter. Without a baseline the verdict is
    ``source: "missing"`` and never a violation."""
    with _lock:
        base = _baselines.get(servable)
        win = _windows.get(servable)
        live = win.window_json(window_s) if win is not None else {}
    thr = thresholds()
    result = {"servable": servable,
              "source": "baseline" if base is not None else "missing",
              "baselineVersion": (base.version
                                  if base is not None else None),
              "thresholds": thr,
              "minCount": _min_count(),
              "series": {},
              "drifted": [],
              "evaluated_unix": time.time()}
    if base is not None:
        group = metrics.group(ML_GROUP, "drift")
        for name, bsnap in sorted(base.group.to_json().items()):
            stats = compare_sketches(bsnap, live.get(name, {}))
            if stats is None:
                continue
            fresh = stats["live_n"] >= _min_count()
            over = [s for s in STAT_NAMES
                    if math.isfinite(stats[s]) and stats[s] > thr[s]]
            drifted = bool(fresh and over)
            row = dict(stats)
            row["drifted"] = drifted
            row["thin"] = not fresh
            row["over"] = over if fresh else []
            result["series"][name] = row
            if fresh:
                # gauges carry the same sample floor as the verdict: a
                # thin window's estimates are noise (a 10-sample window
                # reads psi ~0.9 on clean traffic), and the drift SLO
                # kind consumes these gauges raw — publishing them
                # would flip /slo to VIOLATED on a service that just
                # started
                for stat in STAT_NAMES:
                    group.gauge("drift", stats[stat],
                                labels={"servable": servable,
                                        "feature": name, "stat": stat})
            if drifted:
                result["drifted"].append(name)
                if emit:
                    group.counter("violations",
                                  labels={"servable": servable})
                    tracing.tracer.event(
                        DRIFT_EVENT, servable=servable, feature=name,
                        over=",".join(over),
                        **{s: stats[s] for s in STAT_NAMES})
    if emit and result["drifted"]:
        try:
            # flight recorder (observability/flightrecorder.py): the
            # live sketches and span ring that explain the shift are
            # rotating windows — freeze them with the verdict
            # (debounced/capped; no-op without an armed trace dir)
            from flink_ml_tpu_torch.observability import flightrecorder

            flightrecorder.record_incident(
                "drift", servable=servable,
                drifted=",".join(result["drifted"]))
        except Exception:  # noqa: BLE001 — recording must never break
            # the evaluation (the ops controller acts on this verdict)
            pass
    with _lock:
        _last_results[servable] = result
    return result


def drift_report(emit: bool = False,
                 window_s: Optional[float] = None) -> dict:
    """Evaluate every servable with live sketches or an installed
    baseline — the ``/drift`` live route and the provenance seam."""
    with _lock:
        names = sorted(set(_windows) | set(_baselines) | set(_missing))
    servables = {name: evaluate(name, emit=emit, window_s=window_s)
                 for name in names}
    return {"servables": servables,
            "drifted": sorted(n for n, r in servables.items()
                              if r["drifted"]),
            "thresholds": thresholds()}


def provenance() -> dict:
    """``driftPsiMax`` (worst prediction/feature PSI across the last
    evaluations) + ``baselineVersion`` (newest installed) — benchmark
    row fields of a serving run. Nones when
    the process recorded no drift telemetry."""
    with _lock:
        results = list(_last_results.values())
        versions = [b.version for b in _baselines.values()
                    if b.version is not None]
    psis = [row["psi"] for r in results
            for row in r.get("series", {}).values()
            if math.isfinite(row.get("psi", float("nan")))]
    return {"driftPsiMax": (round(max(psis), 6) if psis else None),
            "baselineVersion": (max(versions) if versions else None)}


# -- fork boundary / artifacts ------------------------------------------------

def state_snapshot() -> dict:
    """Serializable live-sketch state — what a host-pool child ships
    back beside its metric snapshot."""
    with _lock:
        return {"servables": {
            name: {"live": win.window_json()}
            for name, win in _windows.items() if win.total}}


def merge_state(snap: dict) -> None:
    """Fold a child's :func:`state_snapshot` into this process — the
    drift twin of :meth:`MetricsRegistry.merge`; merged sketches land
    in the open window slice, so they are window-visible immediately."""
    for name, entry in (snap or {}).get("servables", {}).items():
        live = entry.get("live")
        if not live:
            continue
        win = _window_for(name)
        with _lock:
            win.merge(live)


def reseed_child() -> None:
    """Reset drift state in a freshly forked host-pool child WITHOUT
    touching the inherited lock (a parent-process thread may hold it at fork
    time — the metrics.reseed_child contract): the child's snapshot
    must hold only child-produced sketches. The installed BASELINES are
    kept — they are read-only reference data, and keeping them means a
    child's live sketches seed from the same bin edges as the parent's,
    so the fold back is bin-exact."""
    global _lock, _windows, _last_eval, _last_results
    _lock = make_lock("observability.drift")
    _windows = {}
    _last_eval = {}
    _last_results = {}
    # _tracked/_baselines stay: read-only reference data (see above)


def clear() -> None:
    """Drop all live drift state (tests)."""
    with _lock:
        _tracked.clear()
        _baselines.clear()
        _missing.clear()
        _windows.clear()
        _last_eval.clear()
        _last_results.clear()


def dump_state(trace_dir: str) -> Optional[str]:
    """Write this process's drift state as ``drift-<pid>.json``
    (``drift-p<k>-<pid>.json`` in a multi-process runtime —
    exporters.artifact_suffix) beside the metrics snapshots
    (exporters.dump_metrics calls this when the module is loaded);
    returns the path, or None when there is nothing to write."""
    with _lock:
        names = sorted(set(_windows) | set(_baselines) | set(_missing))
        if not names:
            return None
        doc = {"version": 1, "servables": {}}
        for name in names:
            win = _windows.get(name)
            base = _baselines.get(name)
            doc["servables"][name] = {
                "live": win.window_json() if win is not None else {},
                "baseline": base.to_json() if base is not None else None,
                "results": _last_results.get(name)}
    from flink_ml_tpu_torch.observability.exporters import artifact_suffix

    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"drift-{artifact_suffix()}.json")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, default=str)
    os.replace(tmp, path)
    return path


def read_state(trace_dir: str) -> Dict[str, dict]:
    """Merge every ``drift-*.json`` in a trace dir:
    ``{servable: {"live": SketchGroup-json, "baseline": json|None,
    "results": json|None}}`` — the CLI's artifact reader. Torn files
    are skipped, like the metrics reader."""
    import glob

    merged: Dict[str, dict] = {}
    for path in sorted(glob.glob(os.path.join(trace_dir,
                                              "drift-*.json"))):
        if os.path.basename(path).startswith("drift-baseline-"):
            continue  # fit-side baseline artifacts have their own shape
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        for name, entry in (doc.get("servables") or {}).items():
            row = merged.setdefault(
                name, {"live": SketchGroup(), "baseline": None,
                       "results": None})
            try:
                row["live"].merge(entry.get("live") or {})
            except ValueError:
                continue
            if entry.get("baseline"):
                row["baseline"] = entry["baseline"]
            if entry.get("results"):
                row["results"] = entry["results"]
    return merged


# -- the `flink-ml-tpu-torch-trace drift` view --------------------------------------

def _artifact_verdicts(state: Dict[str, dict],
                       override: Optional[DriftBaseline],
                       thr: Dict[str, float],
                       min_count: int) -> List[dict]:
    verdicts = []
    for name in sorted(state):
        entry = state[name]
        base_doc = entry.get("baseline")
        baseline = override
        if baseline is None and base_doc:
            baseline = DriftBaseline.from_json(base_doc)
        live = entry["live"].to_json()
        row = {"servable": name,
               "source": "baseline" if baseline is not None
               else "missing",
               "baselineVersion": (baseline.version
                                   if baseline is not None else None),
               "series": {}, "drifted": []}
        if baseline is not None:
            for sname, bsnap in sorted(
                    baseline.group.to_json().items()):
                stats = compare_sketches(bsnap, live.get(sname, {}))
                if stats is None:
                    continue
                fresh = stats["live_n"] >= min_count
                over = [s for s in STAT_NAMES
                        if math.isfinite(stats[s])
                        and stats[s] > thr[s]]
                srow = dict(stats)
                srow["drifted"] = bool(fresh and over)
                srow["thin"] = not fresh
                srow["over"] = over if fresh else []
                row["series"][sname] = srow
                if srow["drifted"]:
                    row["drifted"].append(sname)
        verdicts.append(row)
    return verdicts


def _fmt_stat(v) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "-"
    if math.isnan(f):
        return "nan"
    return f"{f:.4f}"


def render_drift(verdicts: List[dict], thr: Dict[str, float]) -> str:
    drifted = sum(1 for v in verdicts if v["drifted"])
    out = [f"{len(verdicts)} servable(s), {drifted} drifted  "
           f"(thresholds: psi>{thr['psi']:g} js>{thr['js']:g} "
           f"ks>{thr['ks']:g})"]
    for v in verdicts:
        out.append("")
        ver = (f" baseline v{v['baselineVersion']}"
               if v.get("baselineVersion") is not None else "")
        flag = "DRIFTED" if v["drifted"] else (
            "no baseline" if v["source"] == "missing" else "ok")
        out.append(f"servable {v['servable']}{ver}  [{flag}]")
        if v["source"] == "missing":
            out.append("  source: missing — published without a "
                       "training-time baseline")
            continue
        out.append(f"  {'series':<14} {'psi':>8} {'js':>8} {'ks':>8} "
                   f"{'base n':>8} {'live n':>8}  verdict")
        for name, st in v["series"].items():
            # "thin" = below the sample floor: the truthful answer is
            # "not enough samples yet", never "ok"
            verdict = ("DRIFTED(" + ",".join(st["over"]) + ")"
                       if st["drifted"] else
                       ("thin" if st.get("thin") else "ok"))
            out.append(
                f"  {name:<14} {_fmt_stat(st['psi']):>8} "
                f"{_fmt_stat(st['js']):>8} {_fmt_stat(st['ks']):>8} "
                f"{st['baseline_n']:>8} {st['live_n']:>8}  {verdict}")
    return "\n".join(out)


def main(argv=None) -> int:
    """``flink-ml-tpu-torch-trace drift <dir>`` — live-vs-baseline drift
    verdicts from a trace dir's ``drift-*.json`` artifacts.
    ``--baseline F`` overrides the artifact baselines with a serialized
    :class:`DriftBaseline` file (e.g. a fit's
    ``drift-baseline-<algo>.json``). ``--check`` exits 4 when any
    servable drifted, 2 on missing/broken artifacts; a servable that
    shipped without a baseline reports ``source: missing`` and exits 0
    — the absence of a baseline is a publishing gap, not drift."""
    import argparse

    from flink_ml_tpu_torch.observability.exporters import (
        pipe_guard,
        resolve_trace_dir,
    )

    parser = argparse.ArgumentParser(
        prog="flink-ml-tpu-torch-trace drift",
        description="Drift verdicts (PSI / JS distance / KS) from a "
                    "FLINK_ML_TPU_TRACE_DIR's drift artifacts.")
    parser.add_argument("trace_dir")
    parser.add_argument("--baseline", metavar="FILE",
                        help="serialized DriftBaseline overriding the "
                             "artifact baselines for every servable")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    parser.add_argument("--check", action="store_true",
                        help="exit 4 when any servable drifted, 2 on "
                             "broken artifacts")
    parser.add_argument("--latest", action="store_true",
                        help="treat TRACE_DIR as a root and pick the "
                             "newest trace dir under it")
    parser.add_argument("--psi", type=float, default=None,
                        help="PSI threshold (default env/0.25)")
    parser.add_argument("--js", type=float, default=None,
                        help="JS-distance threshold (default env/0.2)")
    parser.add_argument("--ks", type=float, default=None,
                        help="KS threshold (default env/0.25)")
    parser.add_argument("--min-count", type=int, default=None,
                        help="min live samples per series before a "
                             "verdict (default env/100)")
    args = parser.parse_args(argv)

    try:
        trace_dir = resolve_trace_dir(args.trace_dir, args.latest)
        state = read_state(trace_dir)
    except OSError as e:
        print(f"flink-ml-tpu-torch-trace drift: cannot read "
              f"{args.trace_dir}: {e}", file=sys.stderr)
        return EXIT_INVALID
    override = None
    if args.baseline:
        try:
            override = load_baseline_file(args.baseline)
            if override is None:
                raise ValueError(f"{args.baseline}: no such file")
        except ValueError as e:
            print(f"flink-ml-tpu-torch-trace drift: {e}", file=sys.stderr)
            return EXIT_INVALID
    if not state:
        print(f"flink-ml-tpu-torch-trace drift: no drift-*.json artifacts "
              f"in {trace_dir}", file=sys.stderr)
        return EXIT_INVALID
    thr = thresholds()
    for stat in STAT_NAMES:
        flag = getattr(args, stat)
        if flag is not None:
            thr[stat] = float(flag)
    min_count = (args.min_count if args.min_count is not None
                 else _min_count())
    try:
        verdicts = _artifact_verdicts(state, override, thr, min_count)
    except ValueError as e:
        print(f"flink-ml-tpu-torch-trace drift: {e}", file=sys.stderr)
        return EXIT_INVALID

    with pipe_guard():
        if args.json:
            # strict JSON: a baseline series never observed live has
            # NaN stats, and the bare NaN token breaks jq exactly when
            # someone is debugging coverage — render as strings (the
            # health --json precedent)
            from flink_ml_tpu_torch.observability.health import _json_safe

            print(json.dumps(_json_safe({"trace_dir": trace_dir,
                                         "thresholds": thr,
                                         "min_count": min_count,
                                         "verdicts": verdicts}),
                             indent=2, default=str))
        else:
            print(render_drift(verdicts, thr))
    drifted = [v["servable"] for v in verdicts if v["drifted"]]
    if args.check and drifted:
        print(f"flink-ml-tpu-torch-trace drift: {len(drifted)} drifted "
              f"servable(s): {', '.join(drifted)}", file=sys.stderr)
        return EXIT_DRIFTED
    return EXIT_OK


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
