"""Continuous evaluation: streaming ground-truth quality joined to
live traffic.

The port of the serving and publishing half of
``flink_ml_tpu/observability/evaluation.py``: host numpy in float64, with
the same env switches, event names, counters and artifact formats (the
JAX ``evaluation.read_state`` reads this module's ``quality-<pid>.json``).

Three layers:

- **Sketch** (:class:`QualitySketch`): fixed-bin score histograms per
  label class — one :class:`~flink_ml_tpu_torch.observability.drift
  .StreamingSketch` for positives, one for negatives, both seeded with
  the same frozen [0, 1] bin edges so every merge is bin-exact — plus an
  exact logloss accumulator. Streaming AUC (the tie-corrected
  Mann-Whitney sum, i.e. trapezoidal over the binned ROC), logloss,
  accuracy/precision/recall at a configurable threshold and expected
  calibration error are all *derived* from the sketch.
- **Join** (:func:`record_feedback`): delayed ground-truth labels join
  a bounded ring of recent predictions captured at the ``_served`` seam
  (keyed by the ``req`` ordinal the batcher mints), routed into
  per-servable-VERSION quality windows like drift state. The ring is
  capped and evicted with lag/coverage telemetry (``ml.quality
  labelLagMs`` / ``feedbackCoverage{servable=}``), and a fit-time quality
  baseline (:func:`capture_fit_baseline`) rides the checkpoint's atomic
  rename as ``quality-baseline.json`` beside the drift baseline.
- **Judge** (:func:`evaluate`): windowed ``ml.quality`` gauges and
  :data:`QUALITY_EVENT` instant events, and the ``/quality`` live route
  (observability/server.py).

The trace-dir reader and the ``flink-ml-tpu-trace quality`` view
(``read_state``, ``render_quality``, ``main``) come with the port's CLI.
The quality SLO kind (observability/slo.py) and the ops controller's canary
stage (serving/controller.py) read these verdicts, and an emitting
evaluation that reads degraded records a ``quality`` incident bundle
(observability/flightrecorder.py).
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from flink_ml_tpu_torch.common.locks import make_lock
from flink_ml_tpu_torch.common.metrics import ML_GROUP, metrics
from flink_ml_tpu_torch.observability import tracing
from flink_ml_tpu_torch.observability.drift import StreamingSketch

__all__ = [
    "QUALITY_ENV",
    "QUALITY_EVENT",
    "BASELINE_FILENAME",
    "QualitySketch",
    "QualityBaseline",
    "enabled",
    "capture_armed",
    "score_edges",
    "positive_scores",
    "capture_fit_baseline",
    "load_baseline_file",
    "install_baseline",
    "forget_servable",
    "baseline_for",
    "observe_served",
    "record_feedback",
    "evaluate",
    "quality_report",
    "provenance",
    "quality_thresholds",
    "state_snapshot",
    "merge_state",
    "reseed_child",
    "dump_state",
    "clear",
]

#: "0" disables the whole layer (join ring AND fit-time capture); any
#: other non-empty value force-arms fit-time capture even without a
#: trace dir (the join ring is on by default — it is the serving half)
QUALITY_ENV = "FLINK_ML_TPU_QUALITY"
#: evaluator cadence in seconds (0 = every joined label; default 30)
INTERVAL_ENV = "FLINK_ML_TPU_QUALITY_INTERVAL_S"
#: live quality window in seconds (default 300)
WINDOW_ENV = "FLINK_ML_TPU_QUALITY_WINDOW_S"
#: live AUC floor — below it a fresh window is *degraded*
MIN_AUC_ENV = "FLINK_ML_TPU_QUALITY_MIN_AUC"
#: max tolerated (baseline AUC - live AUC) before *degraded*
MAX_DELTA_ENV = "FLINK_ML_TPU_QUALITY_MAX_AUC_DELTA"
#: minimum joined labels per servable before a verdict is rendered
MIN_LABELS_ENV = "FLINK_ML_TPU_QUALITY_MIN_LABELS"
#: join-ring capacity (predictions awaiting feedback, process-wide)
RING_ENV = "FLINK_ML_TPU_QUALITY_RING"
#: decision threshold for accuracy/precision/recall
THRESHOLD_ENV = "FLINK_ML_TPU_QUALITY_THRESHOLD"

#: instant-event name for detected quality degradation in the trace
QUALITY_EVENT = "ml.quality"

#: the baseline artifact filename beside a checkpoint's manifest.json
#: (rides ``CheckpointManager.save(extras=)`` next to drift-baseline)
BASELINE_FILENAME = "quality-baseline.json"

#: score-histogram bins. Scores are probabilities, so the bin edges are
#: the SAME frozen [0, 1] grid in every process — merges across the
#: fork, artifacts and beacons are bin-exact by construction, no
#: auto-ranging warmup to disagree about. 64 bins keep the binned-ROC
#: trapezoid within ~1e-3 of the exact AUC at serving sample sizes
#: while 0.5 stays an exact edge for the default decision threshold.
DEFAULT_BINS = 64

_DEFAULTS = {MIN_AUC_ENV: 0.6, MAX_DELTA_ENV: 0.1,
             INTERVAL_ENV: 30.0, WINDOW_ENV: 300.0,
             THRESHOLD_ENV: 0.5}

#: logloss clamp — a hard 0/1 score would otherwise contribute inf
_EPS = 1e-12


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
    """The live tier: prediction capture + feedback join on the serving
    seam. On by default; ``FLINK_ML_TPU_QUALITY=0`` is the kill
    switch."""
    return os.environ.get(QUALITY_ENV, "") != "0"


def capture_armed() -> bool:
    """The fit-time tier: quality-baseline capture at the end of a fit.
    Armed when a trace dir is configured or ``FLINK_ML_TPU_QUALITY`` is
    truthy (mirrors drift.capture_armed — a plain untraced fit stays
    zero-cost); ``FLINK_ML_TPU_QUALITY=0`` disables it."""
    env = os.environ.get(QUALITY_ENV, "")
    if env == "0":
        return False
    return bool(env) or tracing.tracer.enabled


def quality_thresholds() -> Dict[str, float]:
    """The quality-verdict thresholds (env-tunable)."""
    return {"minAuc": _env_float(MIN_AUC_ENV, _DEFAULTS[MIN_AUC_ENV]),
            "maxAucDelta": _env_float(MAX_DELTA_ENV,
                                      _DEFAULTS[MAX_DELTA_ENV])}


def _min_labels() -> int:
    # below ~100 joined labels the binned AUC estimate is noisy enough
    # that a healthy window can brush the floor
    return _env_int(MIN_LABELS_ENV, 100)


def _ring_capacity() -> int:
    return _env_int(RING_ENV, 4096)


def decision_threshold() -> float:
    return _env_float(THRESHOLD_ENV, _DEFAULTS[THRESHOLD_ENV])


def score_edges(bins: int = DEFAULT_BINS) -> tuple:
    """The frozen [0, 1] score-bin grid every quality sketch shares."""
    return tuple(float(x) for x in np.linspace(0.0, 1.0, bins + 1))


# -- the mergeable quality sketch ---------------------------------------------

class QualitySketch:
    """Mergeable streaming summary of (score, binary label) pairs: one
    fixed-bin :class:`StreamingSketch` score histogram per label class
    (both seeded with the same frozen [0, 1] edges, so merges are
    bin-exact) plus an exact logloss sum. AUC, logloss,
    accuracy/precision/recall at a threshold and expected calibration
    error are all derived views of the same state — no second
    bookkeeping to drift out of sync. Thread-safety lives one level up
    (the live window holds the lock), like :class:`StreamingSketch`."""

    __slots__ = ("pos", "neg", "logloss_sum", "nonbinary")

    def __init__(self, edges: Optional[Sequence[float]] = None):
        e = tuple(float(x) for x in edges) if edges is not None \
            else score_edges()
        self.pos = StreamingSketch(edges=e)
        self.neg = StreamingSketch(edges=e)
        self.logloss_sum = 0.0
        self.nonbinary = 0

    # -- observation ---------------------------------------------------------
    def observe(self, scores, labels) -> None:
        """Fold (score, label) pairs in. Scores are positive-class
        probabilities; labels coerce to {0, 1} (anything else is
        tallied in ``nonbinary`` and dropped — the seam must never
        raise on a malformed feedback payload)."""
        s = np.asarray(scores, np.float64).ravel()
        y = np.asarray(labels, np.float64).ravel()
        if y.size == 1 and s.size > 1:
            y = np.full(s.size, float(y[0]))
        n = min(s.size, y.size)
        if n == 0:
            return
        s, y = s[:n], y[:n]
        ok = np.isfinite(s) & ((y == 0.0) | (y == 1.0))
        self.nonbinary += int(n - ok.sum())
        s, y = s[ok], y[ok]
        if s.size == 0:
            return
        pos = y == 1.0
        self.pos.observe_many(s[pos])
        self.neg.observe_many(s[~pos])
        p = np.clip(s, _EPS, 1.0 - _EPS)
        self.logloss_sum += float(
            -np.sum(y * np.log(p) + (1.0 - y) * np.log(1.0 - p)))

    # -- derived -------------------------------------------------------------
    @property
    def n(self) -> int:
        return self.pos.count + self.neg.count

    def _class_bins(self, sk: StreamingSketch) -> np.ndarray:
        # underflow + bins + overflow: the tails carry out-of-[0,1]
        # scores (a miscalibrated head) instead of silently vanishing
        return np.asarray([sk.underflow] + list(sk.counts)
                          + [sk.overflow], np.float64)

    def auc(self) -> float:
        """Streaming AUC: the tie-corrected Mann-Whitney sum over the
        shared bins — exactly the trapezoidal area under the binned
        ROC. NaN until both classes have mass."""
        p = self._class_bins(self.pos)
        q = self._class_bins(self.neg)
        pt, qt = float(p.sum()), float(q.sum())
        if pt <= 0 or qt <= 0:
            return float("nan")
        # negatives strictly below each bin count fully; same-bin
        # negatives count half (the trapezoid through a tied bin)
        below = np.concatenate(([0.0], np.cumsum(q)[:-1]))
        return float(np.sum(p * (below + q / 2.0)) / (pt * qt))

    def logloss(self) -> float:
        return self.logloss_sum / self.n if self.n else float("nan")

    def confusion(self, threshold: Optional[float] = None
                  ) -> Dict[str, int]:
        """tp/fp/tn/fn at ``threshold`` (snapped to the nearest bin
        edge — exact for the default 0.5 on the frozen grid)."""
        thr = decision_threshold() if threshold is None else threshold
        e = np.asarray(self.pos.edges)
        k = int(np.argmin(np.abs(e - thr)))
        pos_hi = int(sum(self.pos.counts[k:]) + self.pos.overflow)
        neg_hi = int(sum(self.neg.counts[k:]) + self.neg.overflow)
        return {"tp": pos_hi, "fn": self.pos.count - pos_hi,
                "fp": neg_hi, "tn": self.neg.count - neg_hi}

    def calibration_error(self) -> float:
        """Expected calibration error: per-bin |positive fraction -
        bin-midpoint confidence| weighted by bin mass (the standard
        binned ECE; tails anchor at their own edge)."""
        p = self._class_bins(self.pos)
        q = self._class_bins(self.neg)
        tot = p + q
        n = float(tot.sum())
        if n <= 0:
            return float("nan")
        e = np.asarray(self.pos.edges)
        conf = np.concatenate(([e[0]], (e[:-1] + e[1:]) / 2.0,
                               [e[-1]]))
        mask = tot > 0
        frac = p[mask] / tot[mask]
        return float(np.sum(tot[mask] * np.abs(frac - conf[mask])) / n)

    def quality_metrics(self, threshold: Optional[float] = None
                        ) -> dict:
        """Every derived metric in one dict — the evaluation row."""
        thr = decision_threshold() if threshold is None else threshold
        c = self.confusion(thr)
        n = self.n
        tp, fp, tn, fn = c["tp"], c["fp"], c["tn"], c["fn"]
        div = lambda a, b: (a / b) if b else float("nan")  # noqa: E731
        return {"n": n,
                "positives": self.pos.count,
                "negatives": self.neg.count,
                "auc": self.auc(),
                "logloss": self.logloss(),
                "threshold": thr,
                "accuracy": div(tp + tn, n),
                "precision": div(tp, tp + fp),
                "recall": div(tp, tp + fn),
                "calibrationError": self.calibration_error(),
                "nonbinary": self.nonbinary}

    # -- merge / serialization -----------------------------------------------
    def merge(self, snap) -> None:
        """Fold another quality sketch (object or ``to_json`` dict) in
        — bin-exact when edges match (always true on the frozen grid;
        the :meth:`StreamingSketch.merge` contract covers the rest)."""
        if isinstance(snap, QualitySketch):
            snap = snap.to_json()
        self.pos.merge(snap.get("pos") or {})
        self.neg.merge(snap.get("neg") or {})
        self.logloss_sum += float(snap.get("loglossSum", 0.0))
        self.nonbinary += int(snap.get("nonbinary", 0))

    def to_json(self) -> dict:
        return {"version": 1,
                "pos": self.pos.to_json(),
                "neg": self.neg.to_json(),
                "loglossSum": self.logloss_sum,
                "nonbinary": self.nonbinary}

    @classmethod
    def from_json(cls, snap: dict) -> "QualitySketch":
        edges = (snap.get("pos") or {}).get("edges")
        sk = cls(edges=edges)
        sk.merge(snap or {})
        return sk


# -- the training-time quality baseline ---------------------------------------

class QualityBaseline:
    """A fitted model's training-time quality summary — the final
    model's scores on a (row-capped) training sample vs the true
    labels, with the model/version provenance the hot-swap keys on.
    The live canary verdict anchors on its AUC."""

    def __init__(self, model: str, version: Optional[int] = None,
                 sketch: Optional[QualitySketch] = None,
                 created_unix: Optional[float] = None):
        self.model = model
        self.version = None if version is None else int(version)
        self.sketch = sketch or QualitySketch()
        self.created_unix = (time.time() if created_unix is None
                             else float(created_unix))

    def edges_template(self) -> tuple:
        """The frozen score-bin edges live sketches seed from."""
        return self.sketch.pos.edges or score_edges()

    def to_json(self) -> dict:
        return {"version": 1, "model": self.model,
                "modelVersion": self.version,
                "created_unix": self.created_unix,
                "sketch": self.sketch.to_json()}

    @classmethod
    def from_json(cls, doc: dict) -> "QualityBaseline":
        if not isinstance(doc, dict) or "sketch" not in doc:
            raise ValueError(
                "quality baseline document must be a mapping with a "
                "'sketch' key")
        return cls(model=str(doc.get("model", "?")),
                   version=doc.get("modelVersion"),
                   sketch=QualitySketch.from_json(doc["sketch"]),
                   created_unix=doc.get("created_unix"))


def positive_scores(raw_values=None, predictions=None
                    ) -> Optional[np.ndarray]:
    """The positive-class probability per row from a transform's
    output: the raw-prediction vectors' LAST element (the LR servable's
    ``[1-p, p]`` shape) when available, else the thresholded prediction
    column (a degenerate {0, 1} score — still rankable). None when
    neither reduces to numbers — the seam must never raise."""
    if raw_values is not None:
        try:
            first = raw_values[0]
        except (IndexError, TypeError):
            first = None
        if first is not None and hasattr(first, "to_array"):
            try:
                return np.asarray(
                    [float(np.asarray(v.to_array()).ravel()[-1])
                     for v in raw_values], np.float64)
            except (TypeError, ValueError, IndexError):
                pass
        elif first is not None:
            try:
                arr = np.asarray(raw_values, np.float64)
                if arr.ndim == 2:
                    return arr[:, -1]
                if arr.ndim == 1:
                    return arr
            except (TypeError, ValueError):
                pass
    if predictions is not None:
        try:
            return np.asarray(list(predictions), np.float64).ravel()
        except (TypeError, ValueError):
            return None
    return None


def capture_fit_baseline(model, algo: str, scores=None, labels=None,
                         version: Optional[int] = None
                         ) -> Optional[QualityBaseline]:
    """Build the training-time quality baseline from the final model's
    scores on a (row-capped) training sample and the matching labels,
    attach it to the fitted model as ``model.quality_baseline``, and
    record the capture (``ml.quality baselineCaptured{algo=}`` counter
    + a trace-dir ``quality-baseline-<algo>.json`` artifact when
    tracing is armed). Returns the baseline (None when there was
    nothing to sketch). Never raises past its own logging — a baseline
    failure must not fail the fit that produced the model."""
    sketch = QualitySketch()
    if scores is not None and labels is not None:
        sketch.observe(scores, labels)
    if not sketch.n:
        return None
    baseline = QualityBaseline(algo, version=version, sketch=sketch)
    try:
        model.quality_baseline = baseline
    except AttributeError:
        pass  # __slots__ model: the caller still gets the return value
    metrics.group(ML_GROUP, "quality").counter(
        "baselineCaptured", labels={"algo": algo})
    if tracing.tracer.enabled:
        try:
            path = os.path.join(tracing.tracer.trace_dir,
                                f"quality-baseline-{algo}.json")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(baseline.to_json(), f)
            os.replace(tmp, path)
        except OSError:
            pass  # artifact only; the in-memory baseline is attached
    return baseline


def load_baseline_file(path: str) -> Optional[QualityBaseline]:
    """Read a serialized quality baseline (the checkpoint-side artifact
    or a ``--baseline`` override); None when the file does not exist,
    raises ValueError on an unreadable/malformed document."""
    if not os.path.exists(path):
        return None
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(
            f"{path}: unreadable quality baseline: {e}") from e
    return QualityBaseline.from_json(doc)


# -- live state: join ring + quality windows ----------------------------------

class _QualityWindow:
    """Sliding window of joined (score, label) quality sketches for one
    servable: a ring of closed :class:`QualitySketch` slices plus the
    open one, rotated lazily (the drift ``_LiveWindow`` shape). Slices
    share the frozen score grid, so in-window merges are bit-exact."""

    def __init__(self, horizon_s: float, slices: int = 30,
                 edges: Optional[tuple] = None, clock=time.monotonic):
        self.horizon_s = float(horizon_s)
        self._slice_s = self.horizon_s / max(1, int(slices))
        self._edges = tuple(edges) if edges is not None \
            else score_edges()
        self._clock = clock
        self._ring: List[tuple] = []  # (t_closed, QualitySketch)
        self._current = QualitySketch(edges=self._edges)
        self._last_slice = clock()
        self.total = 0  # joins ever (cheap freshness probe)

    def _rotate(self, now: float) -> None:
        if now - self._last_slice < self._slice_s:
            return
        if self._current.n or self._current.nonbinary:
            self._ring.append((now, self._current))
            self._current = QualitySketch(edges=self._edges)
        self._last_slice = now
        cutoff = now - self.horizon_s
        while self._ring and self._ring[0][0] <= cutoff:
            self._ring.pop(0)

    def observe(self, scores, labels) -> None:
        self._rotate(self._clock())
        self._current.observe(scores, labels)
        self.total += 1

    def merge(self, snap: dict) -> None:
        """Fold a child-process sketch snapshot into the open slice (so
        merged labels are window-visible from merge time — the
        WindowedCounter contract)."""
        self._rotate(self._clock())
        self._current.merge(snap)
        self.total += 1

    def window_sketch(self, window_s: Optional[float] = None
                      ) -> QualitySketch:
        w = self.horizon_s if window_s is None \
            else min(float(window_s), self.horizon_s)
        now = self._clock()
        self._rotate(now)
        cutoff = now - w
        merged = QualitySketch(edges=self._edges)
        for t, sk in self._ring:
            if t > cutoff:
                merged.merge(sk.to_json())
        merged.merge(self._current.to_json())
        return merged


_lock = make_lock("observability.evaluation")
_baselines: Dict[str, QualityBaseline] = {}
_missing: set = set()       # servables that swapped in without a baseline
_windows: Dict[str, _QualityWindow] = {}
#: the join ring: request ordinal → (servable, scores, t_served). One
#: process-wide ring (feedback callers hold a request id, not a
#: servable name); entries carry the VERSIONED serving name so joins
#: land in that version's window. Bounded by FLINK_ML_TPU_QUALITY_RING.
_ring: "OrderedDict[int, tuple]" = OrderedDict()
#: recently evicted request ids (servable-tagged) — a late label for
#: one of these is "late", not "unknown": honest staleness accounting
_evicted: "OrderedDict[int, str]" = OrderedDict()
#: per-servable join/coverage tallies (lifetime, snapshot-mergeable)
_coverage: Dict[str, Dict[str, int]] = {}
#: recent label lags in ms (provenance p99), process-wide
_lags: deque = deque(maxlen=1024)
_last_eval: Dict[str, float] = {}
_last_results: Dict[str, dict] = {}
#: insertion-ordered registry of tracked servable names — the eviction
#: order (the drift MAX_TRACKED_SERVABLES rationale: a continuously
#: republishing deployment mints a new versioned name per hot-swap)
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
        _coverage.pop(old, None)
        _last_eval.pop(old, None)
        _last_results.pop(old, None)


def _coverage_locked(servable: str) -> Dict[str, int]:
    cov = _coverage.get(servable)
    if cov is None:
        cov = _coverage[servable] = {
            "predictions": 0, "joined": 0, "evicted": 0, "late": 0}
    return cov


def forget_servable(servable: str) -> None:
    """Drop all quality state for one servable — a rejected hot-swap
    candidate whose versioned name will never serve (serving/
    registry.py), or a caller retiring an old version early."""
    with _lock:
        _tracked.pop(servable, None)
        _baselines.pop(servable, None)
        _missing.discard(servable)
        _windows.pop(servable, None)
        _coverage.pop(servable, None)
        _last_eval.pop(servable, None)
        _last_results.pop(servable, None)
        for rid in [r for r, entry in _ring.items()
                    if entry[0] == servable]:
            _ring.pop(rid, None)


def install_baseline(servable: str,
                     baseline: Optional[QualityBaseline]) -> None:
    """Install (or record as missing) the quality baseline the live
    verdict for ``servable`` anchors on — called by the serving
    registry's hot-swap with the baseline shipped beside that version's
    checkpoint manifest. Keyed by the *versioned* serving name
    (``lr@v2``), like drift baselines."""
    with _lock:
        _track_locked(servable)
        if baseline is None:
            _missing.add(servable)
            _baselines.pop(servable, None)
        else:
            _missing.discard(servable)
            _baselines[servable] = baseline
    metrics.group(ML_GROUP, "quality").gauge(
        "baselineInstalled", 0 if baseline is None else 1,
        labels={"servable": servable})


def baseline_for(servable: str) -> Optional[QualityBaseline]:
    with _lock:
        return _baselines.get(servable)


def _window_for_locked(servable: str) -> _QualityWindow:
    win = _windows.get(servable)
    if win is None:
        _track_locked(servable)
        base = _baselines.get(servable)
        win = _windows[servable] = _QualityWindow(
            _env_float(WINDOW_ENV, _DEFAULTS[WINDOW_ENV]),
            edges=(base.edges_template()
                   if base is not None else None))
    return win


def observe_served(servable: str, scores, segments=None) -> None:
    """The serving seam (servable/api.py ``_served``): park each
    request's positive-class scores in the join ring keyed by the
    batcher's ``req`` ordinal, awaiting :func:`record_feedback`.
    ``segments`` is the batcher's per-request ``(seq, rows)`` layout
    (``df.request_segments``); without it there are no request ids to
    join on (a direct transform, a canary probe) and nothing is
    recorded — such rows must not sink coverage either. Quietly does
    nothing when disabled — recording must never sink a serving
    call."""
    if not enabled() or not segments:
        return
    arr = positive_scores(raw_values=None, predictions=scores) \
        if not isinstance(scores, np.ndarray) else scores
    if arr is None or arr.size == 0:
        return
    cap = _ring_capacity()
    now = time.monotonic()
    grp = metrics.group(ML_GROUP, "quality")
    evictions = 0
    with _lock:
        cov = _coverage_locked(servable)
        offset = 0
        for seq, rows in segments:
            chunk = arr[offset:offset + int(rows)]
            offset += int(rows)
            if chunk.size == 0:
                continue
            _ring[int(seq)] = (servable, chunk, now)
            cov["predictions"] += 1
        while len(_ring) > cap:
            rid, (sname, _, _) = _ring.popitem(last=False)
            _evicted[rid] = sname
            _coverage_locked(sname)["evicted"] += 1
            evictions += 1
        while len(_evicted) > cap:
            _evicted.popitem(last=False)
    if evictions:
        grp.counter("ringEvicted", evictions,
                    labels={"servable": servable})


def record_feedback(request_id: int, label) -> bool:
    """Join one delayed ground-truth label (scalar, broadcast across
    the request's rows, or a per-row sequence) to the prediction parked
    under ``request_id`` — the ordinal ``MicroBatcher.submit`` attached
    to the returned future as ``future.request_id``. Feeds the
    servable-version's quality window plus the staleness telemetry
    (``labelLagMs`` windowed histogram, ``labelsJoined`` /
    ``labelsLate`` / ``feedbackUnknown`` counters). Returns True when
    the join landed; False for a label that arrived after eviction
    (late) or for an id never seen (unknown)."""
    if not enabled():
        return False
    grp = metrics.group(ML_GROUP, "quality")
    with _lock:
        entry = _ring.pop(int(request_id), None)
        if entry is None:
            late_servable = _evicted.pop(int(request_id), None)
            if late_servable is not None:
                _coverage_locked(late_servable)["late"] += 1
        else:
            servable, chunk, t_served = entry
            lag_ms = (time.monotonic() - t_served) * 1000.0
            win = _window_for_locked(servable)
            win.observe(chunk, label)
            cov = _coverage_locked(servable)
            cov["joined"] += 1
            _lags.append(lag_ms)
    if entry is None:
        if late_servable is not None:
            grp.counter("labelsLate",
                        labels={"servable": late_servable})
        else:
            grp.counter("feedbackUnknown")
        return False
    grp.counter("labelsJoined", labels={"servable": servable})
    grp.windowed_histogram("labelLagMs", horizon_s=300.0,
                           slices=30,
                           labels={"servable": servable}).observe(
                               lag_ms)
    maybe_evaluate(servable)
    return True


def maybe_evaluate(servable: str) -> Optional[dict]:
    """Run :func:`evaluate` when the cadence
    (``FLINK_ML_TPU_QUALITY_INTERVAL_S``) has lapsed for this servable;
    the fast path is one clock read + dict lookup."""
    interval = _env_float(INTERVAL_ENV, _DEFAULTS[INTERVAL_ENV])
    now = time.monotonic()
    with _lock:
        last = _last_eval.get(servable)
        if last is not None and now - last < interval:
            return None
        _last_eval[servable] = now
    return evaluate(servable)


def _coverage_row(cov: Dict[str, int]) -> dict:
    preds = cov.get("predictions", 0)
    joined = cov.get("joined", 0)
    return {"predictions": preds, "joined": joined,
            "evicted": cov.get("evicted", 0),
            "late": cov.get("late", 0),
            "coverage": (joined / preds) if preds else None}


def _lag_p99_locked() -> Optional[float]:
    if not _lags:
        return None
    return round(float(np.percentile(np.asarray(_lags, np.float64),
                                     99.0)), 3)


def evaluate(servable: str, emit: bool = True,
             window_s: Optional[float] = None) -> dict:
    """Judge ``servable``'s joined-label quality window: live AUC /
    logloss / accuracy / calibration vs the installed quality baseline,
    recorded as ``quality{servable=,metric=}`` gauges in ``ml.quality``
    (plus ``qualityBaseline{servable=,metric=}`` for the anchor and
    ``feedbackCoverage{servable=}``). Below the live AUC floor — or
    past the allowed delta under the baseline's AUC — with the
    ``FLINK_ML_TPU_QUALITY_MIN_LABELS`` sample floor met, the servable
    is *degraded*: with ``emit``, a :data:`QUALITY_EVENT` instant event
    + the ``violations{servable=}`` counter land, and the flight
    recorder freezes the moment. A thin window (too few joined labels)
    is *insufficient evidence*, never a verdict — the drift
    precedent."""
    with _lock:
        base = _baselines.get(servable)
        win = _windows.get(servable)
        sketch = win.window_sketch(window_s) if win is not None \
            else QualitySketch()
        cov = dict(_coverage_locked(servable))
        lag_p99 = _lag_p99_locked()
    thr = quality_thresholds()
    live = sketch.quality_metrics()
    base_metrics = (base.sketch.quality_metrics()
                    if base is not None else None)
    fresh = live["n"] >= _min_labels()
    over: List[str] = []
    auc = live["auc"]
    if fresh and math.isfinite(auc):
        if auc < thr["minAuc"]:
            over.append("min-auc")
        if (base_metrics is not None
                and math.isfinite(base_metrics["auc"])
                and base_metrics["auc"] - auc > thr["maxAucDelta"]):
            over.append("auc-delta")
    degraded = bool(fresh and over)
    result = {"servable": servable,
              "source": "baseline" if base is not None else "missing",
              "baselineVersion": (base.version
                                  if base is not None else None),
              "thresholds": thr,
              "minLabels": _min_labels(),
              "live": live,
              "baseline": base_metrics,
              "aucDelta": (round(base_metrics["auc"] - auc, 6)
                           if base_metrics is not None
                           and math.isfinite(auc)
                           and math.isfinite(base_metrics["auc"])
                           else None),
              "coverage": _coverage_row(cov),
              "labelLagP99Ms": lag_p99,
              "degraded": degraded,
              "thin": not fresh,
              "over": over if fresh else [],
              "evaluated_unix": time.time()}
    group = metrics.group(ML_GROUP, "quality")
    if fresh:
        # gauges carry the same sample floor as the verdict: a thin
        # window's AUC is noise, and the quality SLO kind consumes
        # these gauges raw — publishing them would flip /slo to
        # VIOLATED on a service whose labels just started arriving
        for metric in ("auc", "logloss", "accuracy", "precision",
                       "recall", "calibrationError"):
            v = live[metric]
            if v is not None and math.isfinite(v):
                group.gauge("quality", round(v, 6),
                            labels={"servable": servable,
                                    "metric": metric})
        if base_metrics is not None \
                and math.isfinite(base_metrics["auc"]):
            group.gauge("qualityBaseline",
                        round(base_metrics["auc"], 6),
                        labels={"servable": servable,
                                "metric": "auc"})
    covr = result["coverage"]["coverage"]
    if covr is not None:
        group.gauge("feedbackCoverage", round(covr, 4),
                    labels={"servable": servable})
    if degraded and emit:
        group.counter("violations", labels={"servable": servable})
        tracing.tracer.event(
            QUALITY_EVENT, servable=servable, over=",".join(over),
            auc=round(auc, 6) if math.isfinite(auc) else None,
            baselineAuc=(round(base_metrics["auc"], 6)
                         if base_metrics is not None else None),
            n=live["n"])
        try:
            # flight recorder (observability/flightrecorder.py): the
            # joined window and span ring that explain the regression
            # are rotating state — freeze them with the verdict
            # (debounced/capped; no-op without an armed trace dir)
            from flink_ml_tpu_torch.observability import flightrecorder

            flightrecorder.record_incident(
                "quality", servable=servable, over=",".join(over))
        except Exception:  # noqa: BLE001 — recording must never break
            # the evaluation (the ops controller acts on this verdict)
            pass
    with _lock:
        _last_results[servable] = result
    return result


def quality_report(emit: bool = False,
                   window_s: Optional[float] = None) -> dict:
    """Evaluate every servable with joined labels or an installed
    baseline — the ``/quality`` live route and the provenance seam."""
    with _lock:
        names = sorted(set(_windows) | set(_baselines) | set(_missing))
    servables = {name: evaluate(name, emit=emit, window_s=window_s)
                 for name in names}
    return {"servables": servables,
            "degraded": sorted(n for n, r in servables.items()
                               if r["degraded"]),
            "thresholds": quality_thresholds()}


def provenance() -> dict:
    """``aucLive`` (worst fresh live AUC across the last evaluations),
    ``feedbackCoverage`` (worst) and ``labelLagP99Ms`` — benchmark row
    fields of a serving run. Nones when no
    feedback flowed (the shared-schema rule: the fields are always
    present, null when the plane is dark)."""
    with _lock:
        results = list(_last_results.values())
        lag_p99 = _lag_p99_locked()
    aucs = [r["live"]["auc"] for r in results
            if not r.get("thin")
            and math.isfinite(r["live"].get("auc", float("nan")))]
    covs = [r["coverage"]["coverage"] for r in results
            if r["coverage"].get("coverage") is not None]
    return {"aucLive": (round(min(aucs), 6) if aucs else None),
            "feedbackCoverage": (round(min(covs), 4)
                                 if covs else None),
            "labelLagP99Ms": lag_p99}


# -- fork boundary / artifacts ------------------------------------------------

def state_snapshot() -> dict:
    """Serializable joined-quality state — what a host-pool child ships
    back beside its metric snapshot. Carries the
    window sketch, the coverage tallies and the recent lags; the join
    RING does not travel (an unjoined prediction's feedback arrives in
    the process that parked it)."""
    with _lock:
        servables = {}
        for name, win in _windows.items():
            if not win.total:
                continue
            servables[name] = {
                "sketch": win.window_sketch().to_json(),
                "coverage": dict(_coverage_locked(name))}
        return {"servables": servables,
                "lags": [round(v, 3) for v in _lags]}


def merge_state(snap: dict) -> None:
    """Fold a child's :func:`state_snapshot` into this process — the
    quality twin of :meth:`MetricsRegistry.merge`; merged sketches land
    in the open window slice, so they are window-visible
    immediately."""
    for name, entry in (snap or {}).get("servables", {}).items():
        sketch = entry.get("sketch")
        with _lock:
            win = _window_for_locked(name)
            if sketch:
                win.merge(sketch)
            cov = _coverage_locked(name)
            for key, val in (entry.get("coverage") or {}).items():
                if key in cov:
                    cov[key] += int(val)
    with _lock:
        for lag in (snap or {}).get("lags", ()):
            _lags.append(float(lag))


def reseed_child() -> None:
    """Reset quality state in a freshly forked host-pool child WITHOUT
    touching the inherited lock (a parent-process thread may hold it at fork
    time — the metrics.reseed_child contract): the child's snapshot
    must hold only child-produced joins. The installed BASELINES are
    kept — read-only reference data, and keeping them means a child's
    windows seed from the same score grid as the parent's, so the fold
    back is bin-exact."""
    global _lock, _windows, _ring, _evicted, _coverage, _lags
    global _last_eval, _last_results
    _lock = make_lock("observability.evaluation")
    _windows = {}
    _ring = OrderedDict()
    _evicted = OrderedDict()
    _coverage = {}
    _lags = deque(maxlen=1024)
    _last_eval = {}
    _last_results = {}
    # _tracked/_baselines stay: read-only reference data (see above)


def clear() -> None:
    """Drop all live quality state (tests)."""
    with _lock:
        _tracked.clear()
        _baselines.clear()
        _missing.clear()
        _windows.clear()
        _ring.clear()
        _evicted.clear()
        _coverage.clear()
        _lags.clear()
        _last_eval.clear()
        _last_results.clear()


def dump_state(trace_dir: str) -> Optional[str]:
    """Write this process's quality state as ``quality-<pid>.json``
    (``quality-p<k>-<pid>.json`` in a multi-process runtime —
    exporters.artifact_suffix) beside the metrics snapshots
    (exporters.dump_metrics calls this when the module is loaded);
    returns the path, or None when there is nothing to write."""
    with _lock:
        names = sorted(set(_windows) | set(_baselines) | set(_missing))
        if not names:
            return None
        doc = {"version": 1, "lagP99Ms": _lag_p99_locked(),
               "servables": {}}
        for name in names:
            win = _windows.get(name)
            base = _baselines.get(name)
            doc["servables"][name] = {
                "sketch": (win.window_sketch().to_json()
                           if win is not None else None),
                "coverage": dict(_coverage_locked(name)),
                "baseline": (base.to_json()
                             if base is not None else None),
                "results": _last_results.get(name)}
    from flink_ml_tpu_torch.observability.exporters import artifact_suffix

    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"quality-{artifact_suffix()}.json")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, default=str)
    os.replace(tmp, path)
    return path
