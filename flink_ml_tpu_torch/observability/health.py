"""Model-health telemetry: convergence series, non-finite sentinels,
divergence classification and the serving-path metrics.

The port of the fit half and the host-side serving helpers of
``flink_ml_tpu/observability/health.py``, under the same env switches,
metric names and events:

- **Always on** (``FLINK_ML_TPU_HEALTH`` unset or truthy): the cheap
  host-side guard over a fit's *final* state (:func:`guard_final_state`),
  raising the terminal :class:`NonFiniteState` so a supervised fit fails
  at once instead of restarting into the same NaN.
  ``FLINK_ML_TPU_HEALTH=0`` disables the layer.
- **Armed** (a trace dir is configured, or ``FLINK_ML_TPU_HEALTH`` is
  truthy): the fits compute one float32 convergence row a round
  (:func:`convergence_row`: loss, update norm, parameter norm) or a
  centre shift on the device, keep the rows on the device, and fetch them
  with a transfer the fit makes anyway (its final state, or a segment's
  boundary) — no host wait of their own. The series land as labeled
  ``ml.health`` histograms and ``ml.convergence`` span events; divergence
  (non-finite, or a norm exploding over a window) emits ``ml.health``
  events. Unarmed, a fit computes no health tensor at all.

The serving helpers (:func:`observe_serving` and its siblings) are pure
host code that the servables' ``_served`` wrapper and the micro-batcher
call. :func:`main` is the ``flink-ml-tpu-torch-trace health`` view of a
trace dir (:func:`health_summary`, :func:`render_health`): ``--check``
exits 3 when an ``ml.health`` event is present, 2 on empty artifacts.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from flink_ml_tpu_torch.common.locks import make_lock
from flink_ml_tpu_torch.common.metrics import ML_GROUP, metrics
from flink_ml_tpu_torch.observability import tracing
from flink_ml_tpu_torch.resilience.policy import NonFiniteState

__all__ = [
    "HEALTH_ENV",
    "HEALTH_EVENT",
    "CONVERGENCE_EVENT",
    "VALUE_BUCKETS",
    "COUNT_BUCKETS",
    "SUMMARY_BUCKETS",
    "NonFiniteState",
    "armed",
    "guard_enabled",
    "finite_sentinel",
    "convergence_row",
    "health_row",
    "record_fit_series",
    "classify_divergence",
    "report_divergence",
    "check_fit",
    "guard_final_state",
    "ConvergenceListener",
    "SAMPLE_ENV",
    "observe_serving",
    "observe_serving_error",
    "observe_serving_rejected",
    "observe_serving_shards",
    "serving_inflight",
    "summarize_values",
    "trace_sample_rate",
    "trace_sampled",
]

#: "0" disables the whole layer (guard + series); any other non-empty
#: value force-arms the rich series telemetry even without a trace dir
HEALTH_ENV = "FLINK_ML_TPU_HEALTH"

#: window (epochs) and growth factor for the exploding-norm classifier
WINDOW_ENV = "FLINK_ML_TPU_HEALTH_WINDOW"
FACTOR_ENV = "FLINK_ML_TPU_HEALTH_FACTOR"
#: absolute norm floor below which growth is never flagged (early
#: training legitimately grows norms from ~0 by large ratios)
FLOOR_ENV = "FLINK_ML_TPU_HEALTH_FLOOR"

#: instant-event names in the trace (docs/observability.md)
HEALTH_EVENT = "ml.health"
CONVERGENCE_EVENT = "ml.convergence"

#: magnitude-shaped histogram bounds for losses/norms (the default
#: DEFAULT_BUCKETS are latency-shaped and would flatten a loss curve)
VALUE_BUCKETS = (1e-8, 1e-6, 1e-4, 1e-3, 1e-2, 0.1, 0.25, 0.5, 1.0, 2.5,
                 5.0, 10.0, 100.0, 1e4, 1e6, 1e9, 1e12)

#: row-count-shaped bounds for serving batch sizes
COUNT_BUCKETS = (1.0, 8.0, 32.0, 128.0, 512.0, 2048.0, 8192.0, 65536.0,
                 1048576.0)

#: prediction/probability-shaped bounds for the windowed value
#: distributions :func:`summarize_values` records — symmetric around 0
#: with fine structure in [0, 1] (probabilities, 0/1 predictions) and
#: coarse decades outward (margins, regression outputs)
SUMMARY_BUCKETS = (-1e6, -1e3, -10.0, -1.0, -0.1, 0.0, 0.1, 0.25, 0.5,
                   0.75, 0.9, 1.0, 10.0, 1e3, 1e6)

#: probabilistic request-trace sampling rate for the serving seam
#: (0..1; default 1.0 — every request, turn it down under load)
SAMPLE_ENV = "FLINK_ML_TPU_TRACE_SAMPLE"

#: sliding-window horizon for the serving metrics: covers the default
#: SLO burn windows (observability/slo.py, up to 300 s) at 10-second
#: slice granularity
SERVING_HORIZON_S = 900.0
SERVING_SLICES = 90

#: at most this many ml.convergence span events per fit (stride-sampled,
#: first/last always kept) — a 10k-epoch host loop must not bloat the
#: trace; the registry histograms still see every epoch
MAX_CONVERGENCE_EVENTS = 256

#: the canonical convergence-series names (column order of
#: :func:`convergence_row`)
SERIES_NAMES = ("loss", "updateNorm", "paramNorm")

#: series the exploding-norm classifier inspects, in preference order
_NORM_SERIES = ("paramNorm", "centerShift", "updateNorm")


def guard_enabled() -> bool:
    """The always-on tier: the final-state non-finite guard (and the
    NonFiniteState raise). Off only with ``FLINK_ML_TPU_HEALTH=0``."""
    return os.environ.get(HEALTH_ENV, "") != "0"


def armed() -> bool:
    """The rich tier: the fits compute and record their per-round
    series. On when a trace dir is configured (the series have somewhere
    to land) or ``FLINK_ML_TPU_HEALTH`` is truthy."""
    env = os.environ.get(HEALTH_ENV, "")
    if env == "0":
        return False
    return bool(env) or tracing.tracer.enabled


def _window() -> int:
    try:
        return max(1, int(os.environ.get(WINDOW_ENV, "5")))
    except ValueError:
        return 5


def _factor() -> float:
    try:
        return float(os.environ.get(FACTOR_ENV, "1e3"))
    except ValueError:
        return 1e3


def _floor() -> float:
    try:
        return float(os.environ.get(FLOOR_ENV, "1e6"))
    except ValueError:
        return 1e6


# -- device-side helpers (plain torch on the tensors' own device) ------------

def finite_sentinel(*leaves) -> torch.Tensor:
    """Fold tensor leaves into ONE boolean 0-dim tensor: True iff every
    element of every leaf is finite. Plain torch on the leaves' device;
    the caller fetches only the scalar, with a transfer it makes anyway."""
    acc = None
    for leaf in leaves:
        ok = torch.all(torch.isfinite(torch.as_tensor(leaf)))
        acc = ok if acc is None else torch.logical_and(acc, ok.to(acc.device))
    return torch.ones((), dtype=torch.bool) if acc is None else acc


def convergence_row(loss, prev_params: torch.Tensor,
                    new_params: torch.Tensor):
    """One round's health sample as a float32 ``(3,)`` row on the
    parameters' device — ``[loss, ||new-prev||, ||new||]`` — plus its
    finite fold (one scalar: a NaN/Inf anywhere in the parameters poisons
    the norms, so the row's ``isfinite`` covers loss and every parameter
    element). A Python-float loss enters as float32, so nothing promotes
    the row to float64."""
    row = health_row(loss, prev_params, new_params)
    return row, torch.all(torch.isfinite(row))


def health_row(loss, prev_params: torch.Tensor,
               new_params: torch.Tensor) -> torch.Tensor:
    """The row of :func:`convergence_row` alone, in four small operations
    (a round of a fit computes one, so its host cost is the point)."""
    if not isinstance(loss, torch.Tensor):
        loss = torch.tensor(float(loss), dtype=torch.float32,
                            device=new_params.device)
    return torch.stack([
        loss.reshape(()).to(torch.float32),
        torch.linalg.vector_norm(new_params - prev_params).to(torch.float32),
        torch.linalg.vector_norm(new_params).to(torch.float32)])


# -- host-side recording ------------------------------------------------------

def _health_group():
    return metrics.group(ML_GROUP, "health")


def record_fit_series(algo: str, series: Dict[str, Sequence[float]],
                      epoch0: int = 0,
                      labels: Optional[Dict[str, str]] = None) -> None:
    """Record per-epoch convergence series for one fit: each named
    series becomes a labeled ``ml.health`` histogram (every epoch) and
    the epochs become ``ml.convergence`` span events (stride-sampled
    past :data:`MAX_CONVERGENCE_EVENTS`) on the current span so
    ``mltrace health`` can render the curve from the artifacts alone.
    Non-finite values are skipped by the histograms (bucket math cannot
    hold them) but ride into the events verbatim.

    ``labels`` (e.g. ``{"shard": "3", "device": "3"}`` from the mesh
    telemetry layer, docs/observability.md "Distributed telemetry")
    ride onto every histogram/gauge key and convergence event, so a
    per-replica series stays attributable through registry merges."""
    group = _health_group()
    named = {k: list(v) for k, v in series.items() if v is not None}
    if not named:
        return
    key_labels = {"algo": algo, **(labels or {})}
    length = max(len(v) for v in named.values())
    for name, values in named.items():
        hist = group.histogram(name, buckets=VALUE_BUCKETS,
                               labels=key_labels)
        last = None
        for v in values:
            v = float(v)
            if math.isfinite(v):
                hist.observe(v)
                last = v
        if last is not None:
            group.gauge(f"last_{name}", last, labels=key_labels)
    group.gauge("epochs", epoch0 + length, labels=key_labels)
    if not tracing.tracer.enabled:
        return
    stride = max(1, -(-length // MAX_CONVERGENCE_EVENTS))
    for i in range(length):
        if i % stride and i != length - 1:
            continue
        attrs = {"algo": algo, "epoch": epoch0 + i, **(labels or {})}
        for name, values in named.items():
            if i < len(values):
                attrs[name] = float(values[i])
        tracing.tracer.event(CONVERGENCE_EVENT, **attrs)


def classify_divergence(series: Dict[str, Sequence[float]],
                        finite: bool = True,
                        window: Optional[int] = None,
                        factor: Optional[float] = None):
    """``("non-finite" | "exploding-norm", epoch_index)`` or ``None``.

    Non-finite wins: the ``finite`` flag (the in-program sentinel) or
    any non-finite value in any series. Exploding norm: the first norm
    series present (:data:`_NORM_SERIES` order) grew by more than
    ``factor`` over a trailing ``window`` epochs while already above
    the absolute floor — a drift alarm for fits still technically
    finite."""
    named = {k: list(v) for k, v in series.items() if v is not None}
    bad_epoch = None
    for values in named.values():
        for i, v in enumerate(values):
            if not math.isfinite(float(v)):
                bad_epoch = i if bad_epoch is None else min(bad_epoch, i)
                break
    if bad_epoch is not None:
        return "non-finite", bad_epoch
    if not finite:
        length = max((len(v) for v in named.values()), default=0)
        return "non-finite", max(length - 1, 0)
    w = window if window is not None else _window()
    f = factor if factor is not None else _factor()
    floor = _floor()
    for name in _NORM_SERIES:
        values = named.get(name)
        if not values:
            continue
        for i in range(w, len(values)):
            now, then = float(values[i]), float(values[i - w])
            if now > floor and now > f * max(then, floor / f):
                return "exploding-norm", i
        break
    return None


def report_divergence(algo: str, kind: str,
                      epoch: Optional[int] = None, **detail) -> None:
    """Emit the ``ml.health`` divergence event + labeled counter, and
    trip the flight recorder — the divergence that precedes a terminal
    :class:`NonFiniteState` is exactly the moment the convergence-series
    spans and recent metrics still explain what blew up."""
    _health_group().counter("divergences",
                            labels={"algo": algo, "kind": kind})
    attrs = {"algo": algo, "kind": kind}
    if epoch is not None:
        attrs["epoch"] = int(epoch)
    attrs.update(detail)
    tracing.tracer.event(HEALTH_EVENT, **attrs)
    try:
        from flink_ml_tpu_torch.observability import flightrecorder

        payload = dict(attrs)
        # the event's "kind" (non-finite / exploding-norm) must not
        # collide with the incident's own kind parameter
        payload["divergence"] = payload.pop("kind")
        flightrecorder.record_incident("divergence", **payload)
    except Exception:  # noqa: BLE001 — recording must never mask the
        # divergence verdict (the caller may be about to raise on it)
        pass


def check_fit(algo: str, series: Dict[str, Sequence[float]],
              finite: bool = True, epoch0: int = 0,
              raise_nonfinite: bool = True):
    """The fit-side health tail: record the convergence series, classify
    divergence, report any finding, and raise the terminal
    :class:`NonFiniteState` on a non-finite verdict (unless the layer is
    disabled or ``raise_nonfinite`` is False). Returns the
    classification (``(kind, epoch)`` or ``None``)."""
    record_fit_series(algo, series, epoch0=epoch0)
    cls = classify_divergence(series, finite=finite)
    if cls is None:
        return None
    kind, epoch = cls
    report_divergence(algo, kind, epoch=epoch0 + epoch)
    if kind == "non-finite" and raise_nonfinite and guard_enabled():
        raise NonFiniteState(algo, epoch=epoch0 + epoch)
    return cls


def guard_final_state(algo: str, *leaves, loss=None) -> None:
    """The always-on tier: a cheap non-finite check over host arrays the
    fit already fetched (final coefficients, final mean loss) — no
    device sync, no series. Raises :class:`NonFiniteState` and emits the
    ``ml.health`` event when anything is non-finite."""
    if not guard_enabled():
        return
    bad = loss is not None and not math.isfinite(float(loss))
    for leaf in leaves:
        if leaf is not None and not bool(np.all(np.isfinite(
                np.asarray(leaf, np.float64)))):
            bad = True
    if bad:
        report_divergence(algo, "non-finite")
        raise NonFiniteState(algo)


class ConvergenceListener:
    """Health recorder for host-driven iteration modes: per epoch,
    ``extract(carry, epoch) -> {series_name: value}`` pulls the health
    scalars from the carry. Extraction LAGS one epoch, as in the JAX
    package: each boundary reads the *previous* epoch's carry and the last
    carry flushes at termination. Host values (floats) are checked at
    once, and a non-finite sample fails the fit at that boundary; device
    values (tensors, what :meth:`for_params` and :meth:`for_centroids`
    extract) stay on the device and are fetched together, in one
    transfer, at termination, so the listener adds no host wait to a
    round. Duck-types
    :class:`~flink_ml_tpu_torch.iteration.iteration.IterationListener`."""

    def __init__(self, algo: str, extract):
        self.algo = algo
        self._extract = extract
        self.series: Dict[str, List[float]] = {}
        self.finite = True
        self._done = False
        self._pending = None  # (epoch, carry) not yet extracted
        self._device_rows: List[dict] = []  # extracted, still on the device

    def _record(self, epoch, carry) -> None:
        vals = self._extract(carry, epoch)
        if any(isinstance(v, torch.Tensor) for v in vals.values()):
            self._device_rows.append(vals)
            return
        self._append(vals)

    def _append(self, vals) -> None:
        fin = True
        for name, v in vals.items():
            v = float(v)
            self.series.setdefault(name, []).append(v)
            fin = fin and math.isfinite(v)
        if not fin:
            self.finite = False
            self._done = True
            check_fit(self.algo, self.series, finite=False)

    def _drain(self) -> None:
        rows, self._device_rows = self._device_rows, []
        if not rows:
            return
        names = list(rows[0])
        table = torch.stack([
            torch.stack([torch.as_tensor(r[name]).reshape(()).to(
                torch.float32) for name in names]) for r in rows])
        for values in table.cpu().numpy():  # the one fetch
            if self._done:
                break
            self._append(dict(zip(names, values)))

    def on_epoch_watermark_incremented(self, epoch, carry) -> None:
        pending, self._pending = self._pending, (epoch, carry)
        if pending is not None:
            self._record(*pending)

    def on_iteration_terminated(self, carry) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            self._record(*pending)
        self._drain()
        if not self._done:
            self._done = True
            check_fit(self.algo, self.series, finite=self.finite)

    def on_restart(self, attempt, error) -> None:
        pass

    def on_recovered(self, attempt) -> None:
        pass

    # -- canonical extracts (one definition for every host-mode fit) --------
    @classmethod
    def for_params(cls, algo: str, init_params) -> "ConvergenceListener":
        """For carries shaped ``(params, ..., mean_loss, ...)`` (the SGD
        host rounds): records loss, ``‖Δparams‖`` against the previous
        epoch and ``‖params‖``, computed on the carry's device."""
        prev = {"c": torch.as_tensor(init_params)}

        def extract(carry, epoch):
            c = carry[0]
            row = health_row(carry[2], prev["c"].to(c.device), c)
            prev["c"] = c
            return {"loss": row[0], "updateNorm": row[1],
                    "paramNorm": row[2]}

        return cls(algo, extract)

    @classmethod
    def for_centroids(cls, algo: str,
                      init_centroids) -> "ConvergenceListener":
        """For carries shaped ``(centroids, ...)`` (the Lloyd host
        rounds): records the Frobenius center shift per epoch, computed on
        the carry's device."""
        prev = {"c": torch.as_tensor(init_centroids)}

        def extract(carry, epoch):
            c = carry[0]
            shift = torch.linalg.vector_norm(c - prev["c"].to(c.device))
            prev["c"] = c
            return {"centerShift": shift}

        return cls(algo, extract)


# -- serving-path metrics -----------------------------------------------------

def trace_sample_rate() -> float:
    """The request-span sampling rate from ``FLINK_ML_TPU_TRACE_SAMPLE``
    (clamped to [0, 1]; default 1.0 — unparseable values fall back to
    the default rather than silently disabling tracing)."""
    raw = os.environ.get(SAMPLE_ENV)
    if raw is None or raw == "":
        return 1.0
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        return 1.0


def trace_sampled() -> bool:
    """One Bernoulli draw at the configured sampling rate — the serving
    seam's per-request span decision (0 and 1 skip the RNG)."""
    rate = trace_sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    import random

    return random.random() < rate


_inflight: Dict[str, int] = {}
_inflight_lock = make_lock("observability.health.inflight")


def serving_inflight(servable: str, delta: int) -> int:
    """Track concurrent in-flight transforms per servable as the
    ``ml.serving inFlight{servable=}`` gauge (clamped at 0 — a lone
    decrement from an unbalanced error path must not go negative).
    Returns the new value."""
    with _inflight_lock:
        value = max(0, _inflight.get(servable, 0) + int(delta))
        _inflight[servable] = value
    metrics.group(ML_GROUP, "serving").gauge(
        "inFlight", value, labels={"servable": servable})
    return value


def observe_serving_error(servable: str, exception: str,
                          latency_ms: float) -> None:
    """Record one FAILED servable transform: the windowed
    ``errors{servable=}`` counter (the error-rate SLO numerator), a
    per-exception-class ``errorsByClass{servable=,exception=}``
    counter, and the failure latency as an ``errorMs`` histogram —
    kept apart from ``transformMs`` so fast-failing requests cannot
    flatter the success latency distribution."""
    group = metrics.group(ML_GROUP, "serving")
    labels = {"servable": servable}
    group.windowed_counter("errors", horizon_s=SERVING_HORIZON_S,
                           slices=SERVING_SLICES, labels=labels).inc()
    group.counter("errorsByClass",
                  labels={"servable": servable, "exception": exception})
    group.histogram("errorMs", labels=labels).observe(latency_ms)


def observe_serving_rejected(servable: str, reason: str) -> None:
    """Record one request shed by admission control (deadline expired
    in queue, queue full, shape outside the bucket table — serving/
    batcher.py) as the windowed ``rejected{servable=,reason=}`` counter.
    Kept apart from ``errors``: shed load is the server *protecting* its
    SLO, and a loadgen verdict must be able to tell the two apart."""
    metrics.group(ML_GROUP, "serving").windowed_counter(
        "rejected", horizon_s=SERVING_HORIZON_S, slices=SERVING_SLICES,
        labels={"servable": servable, "reason": reason}).inc()


def summarize_values(servable: str, name: str, values) -> None:
    """Record a distribution summary for one batch of numeric values:
    the ``<name>Min/Max/Mean/FiniteFraction`` gauges in ``ml.serving``
    (labeled by servable — per-batch, last-write-wins: the cumulative
    Prometheus view, byte-identical to before) PLUS a **windowed**
    ``<name>Values`` histogram (common/metrics.py WindowedHistogram,
    :data:`SUMMARY_BUCKETS`), so ``/slo``, ``/drift`` and the drift
    evaluator (observability/drift.py) can read the *recent* value
    distribution instead of whatever batch happened to write the gauges
    last — one early outlier batch no longer poisons the only record of
    the distribution for the process lifetime. A batch with non-finite
    values emits an ``ml.health`` ``non-finite-<name>`` event; nothing
    ever raises from here."""
    group = metrics.group(ML_GROUP, "serving")
    labels = {"servable": servable}
    try:
        vals = np.asarray(list(values), np.float64)
    except (TypeError, ValueError):
        return  # non-scalar column (vectors): no summary
    if vals.ndim != 1 or vals.size == 0:
        return
    finite = np.isfinite(vals)
    frac = float(finite.mean())
    fv = vals[finite]
    group.gauge(f"{name}FiniteFraction", frac, labels=labels)
    if fv.size:
        group.gauge(f"{name}Min", float(fv.min()), labels=labels)
        group.gauge(f"{name}Max", float(fv.max()), labels=labels)
        group.gauge(f"{name}Mean", float(fv.mean()), labels=labels)
        hist = group.windowed_histogram(
            f"{name}Values", buckets=SUMMARY_BUCKETS,
            horizon_s=SERVING_HORIZON_S, slices=SERVING_SLICES,
            labels=labels)
        for v in fv:
            hist.observe(float(v))
    if frac < 1.0:
        report_divergence(servable, f"non-finite-{name}",
                          fraction=round(frac, 6), rows=int(vals.size))


def observe_serving_shards(servable: str, counts, device_ids) -> None:
    """Record one mesh-sharded serving dispatch's per-device row split
    (serving/batcher.py → servable/lr.py sharded twin): the real rows
    each device's slice of the padded bucket holds as
    ``ml.serving shardRows{servable=,device=}`` gauges plus one
    ``shardImbalance{servable=}`` gauge (max/mean over the per-device
    counts; 1.0 = perfectly balanced, N = all real rows on one of N
    devices). The per-tick serving twin of the training-side
    ``ml.shard rows`` series — deliberately without the straggler
    detector, since a partially-filled bucket loading shard 0 first is
    the dispatch contract, not a straggler."""
    group = metrics.group(ML_GROUP, "serving")
    counts = [int(c) for c in counts]
    for dev, rows in zip(device_ids, counts):
        group.gauge("shardRows", rows,
                    labels={"servable": servable, "device": str(dev)})
    mean = sum(counts) / max(len(counts), 1)
    imbalance = (max(counts) / mean) if mean > 0 else 0.0
    group.gauge("shardImbalance", round(imbalance, 4),
                labels={"servable": servable})


def observe_serving(servable: str, rows: int, latency_ms: float,
                    predictions=None) -> None:
    """Record one servable ``transform`` into ``ml.serving``: windowed
    latency + row-count histograms and transform/row counters (labeled
    by servable — cumulative views unchanged, so merges and Prometheus
    keep working while the SLO engine reads sliding windows) and, when
    a numeric prediction column is available, its
    :func:`summarize_values` distribution summary. Non-finite
    predictions emit an ``ml.health`` event but never fail the serving
    call."""
    group = metrics.group(ML_GROUP, "serving")
    labels = {"servable": servable}
    group.windowed_counter("transforms", horizon_s=SERVING_HORIZON_S,
                           slices=SERVING_SLICES, labels=labels).inc()
    group.windowed_counter("rowsTotal", horizon_s=SERVING_HORIZON_S,
                           slices=SERVING_SLICES,
                           labels=labels).inc(int(rows))
    # registering the errors window here (no increment) keeps the
    # error-rate SLO's numerator and denominator on the same windowed
    # source even before the first failure
    group.windowed_counter("errors", horizon_s=SERVING_HORIZON_S,
                           slices=SERVING_SLICES, labels=labels)
    group.windowed_histogram("transformMs",
                             horizon_s=SERVING_HORIZON_S,
                             slices=SERVING_SLICES,
                             labels=labels).observe(latency_ms)
    group.windowed_histogram("rows", buckets=COUNT_BUCKETS,
                             horizon_s=SERVING_HORIZON_S,
                             slices=SERVING_SLICES,
                             labels=labels).observe(float(rows))
    if predictions is not None:
        summarize_values(servable, "prediction", predictions)


_LABEL_RE = None


def _parse_labels(label_str: str) -> Dict[str, str]:
    """Inverse of metrics.metric_key's label rendering. Unescaping is
    ONE pass over ``\\.`` pairs — sequential str.replace cannot decode
    this grammar (``a\\nb`` with a literal backslash encodes to
    ``a\\\\nb``; replacing ``\\n`` first would turn the escaped
    backslash + ``n`` into a real newline)."""
    global _LABEL_RE
    import re
    if _LABEL_RE is None:
        _LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
    out = {}
    for k, v in _LABEL_RE.findall(label_str or ""):
        out[k] = re.sub(
            r"\\(.)", lambda m: {"n": "\n"}.get(m.group(1), m.group(1)),
            v)
    return out


# -- the `flink-ml-tpu-torch-trace health` view --------------------------------

def _fmtv(v) -> str:
    if v is None:
        return "-"
    try:
        f = float(v)
    except (TypeError, ValueError):
        return str(v)
    if math.isnan(f):
        return "nan"
    if abs(f) >= 1e5 or (f != 0 and abs(f) < 1e-3):
        return f"{f:.3e}"
    return f"{f:.4g}"


def health_summary(spans: List[dict],
                   snapshot: Dict[str, dict]) -> dict:
    """Structured model-health view of a trace dir: per-fit convergence
    tables (from ``ml.convergence`` events, grouped per trace+algo),
    the ``ml.health`` divergence timeline, and the ``ml.serving``
    summary from the metrics snapshot."""
    fits: Dict[tuple, dict] = {}
    health_events: List[dict] = []
    for sp in spans:
        for ev in sp.get("events", ()):
            attrs = ev.get("attrs", {})
            if ev.get("name") == CONVERGENCE_EVENT:
                key = (sp.get("trace"), attrs.get("algo", "?"))
                fit = fits.setdefault(key, {
                    "algo": attrs.get("algo", "?"),
                    "trace": sp.get("trace"),
                    "epochs": []})
                row = {k: attrs[k] for k in attrs if k != "algo"}
                fit["epochs"].append(row)
            elif ev.get("name") == HEALTH_EVENT:
                health_events.append({"ts_us": ev.get("ts_us", 0),
                                      "attrs": attrs})
    fit_rows = []
    for fit in fits.values():
        epochs = sorted(fit["epochs"],
                        key=lambda r: r.get("epoch", 0))
        row = {"algo": fit["algo"], "trace": fit["trace"],
               "epochs": len(epochs), "series": {}}
        names = {k for e in epochs for k in e if k != "epoch"}
        for name in sorted(names):
            vals = [float(e[name]) for e in epochs if name in e]
            finite = [v for v in vals if math.isfinite(v)]
            row["series"][name] = {
                "first": vals[0] if vals else None,
                "last": vals[-1] if vals else None,
                "min": min(finite) if finite else None,
                "nonfinite": len(vals) - len(finite)}
        fit_rows.append(row)
    fit_rows.sort(key=lambda r: r["algo"])
    health_events.sort(key=lambda e: e["ts_us"])

    serving = {}
    sgroup = snapshot.get(f"{ML_GROUP}.serving", {})
    for key, value in sgroup.get("counters", {}).items():
        name = key.partition("{")[0]
        servable = _parse_labels(key).get("servable", "?")
        serving.setdefault(servable, {})[name] = value
    from flink_ml_tpu_torch.common.metrics import histogram_quantile
    for key, hist in sgroup.get("histograms", {}).items():
        name = key.partition("{")[0]
        servable = _parse_labels(key).get("servable", "?")
        row = serving.setdefault(servable, {})
        if name == "transformMs" and hist.get("count"):
            row["transformMs_p50"] = histogram_quantile(hist, 0.5)
            row["transformMs_p99"] = histogram_quantile(hist, 0.99)
    for key, value in sgroup.get("gauges", {}).items():
        name = key.partition("{")[0]
        servable = _parse_labels(key).get("servable", "?")
        serving.setdefault(servable, {})[name] = value

    divergences = {}
    hgroup = snapshot.get(f"{ML_GROUP}.health", {})
    for key, value in hgroup.get("counters", {}).items():
        if key.partition("{")[0] == "divergences":
            labels = _parse_labels(key)
            divergences[f"{labels.get('algo', '?')}/"
                        f"{labels.get('kind', '?')}"] = value

    return {"fits": fit_rows, "health_events": health_events,
            "serving": serving, "divergences": divergences}


def render_health(summary: dict) -> str:
    out = []
    fits = summary["fits"]
    out.append(f"{len(fits)} fit(s) with convergence telemetry, "
               f"{len(summary['health_events'])} health event(s)")
    for fit in fits:
        out.append("")
        out.append(f"fit {fit['algo']}  ({fit['epochs']} epoch sample(s))")
        out.append(f"  {'series':<14} {'first':>12} {'last':>12} "
                   f"{'min':>12} {'non-finite':>11}")
        for name, st in fit["series"].items():
            out.append(
                f"  {name:<14} {_fmtv(st['first']):>12} "
                f"{_fmtv(st['last']):>12} {_fmtv(st['min']):>12} "
                f"{st['nonfinite']:>11}")
    if summary["health_events"]:
        out.append("")
        out.append("health event timeline:")
        t0 = summary["health_events"][0]["ts_us"]
        for ev in summary["health_events"]:
            attrs = " ".join(f"{k}={v}" for k, v in ev["attrs"].items())
            out.append(f"  +{(ev['ts_us'] - t0) / 1000.0:>10.3f} ms  "
                       f"{HEALTH_EVENT}  {attrs}")
    if summary["divergences"]:
        out.append("")
        out.append("divergence counters:")
        for key, value in sorted(summary["divergences"].items()):
            out.append(f"  {key}: {value}")
    if summary["serving"]:
        out.append("")
        out.append("serving metrics:")
        for servable, row in sorted(summary["serving"].items()):
            out.append(f"  {servable}:")
            for name in ("transforms", "rowsTotal", "transformMs_p50",
                         "transformMs_p99", "predictionMin",
                         "predictionMean", "predictionMax",
                         "predictionFiniteFraction"):
                if name in row:
                    out.append(f"    {name}: {_fmtv(row[name])}")
    return "\n".join(out)


def _json_safe(obj):
    """Recursively replace non-finite floats with their string names so
    the structure serializes as STRICT JSON (the text format has no
    NaN/Infinity tokens)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj).replace("inf", "Infinity").replace(
            "nan", "NaN")
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def main(argv=None) -> int:
    """``flink-ml-tpu-torch-trace health <dir>`` — model-health view of a
    trace directory (``--json`` is strict JSON: non-finite floats render
    as the strings "NaN"/"Infinity"/"-Infinity"). ``--check`` exits 3
    (the sweep's correctness class) when any ``ml.health`` event is
    present, 2 on unreadable/empty artifacts."""
    import argparse
    import json
    import sys

    from flink_ml_tpu_torch.observability.exporters import (
        read_metrics,
        read_spans,
        resolve_trace_dir,
    )

    parser = argparse.ArgumentParser(
        prog="flink-ml-tpu-torch-trace health",
        description="Model-health view of a FLINK_ML_TPU_TRACE_DIR: "
                    "per-fit convergence, divergence events, serving "
                    "metrics.")
    parser.add_argument("trace_dir")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    parser.add_argument("--check", action="store_true",
                        help="exit 3 when a health event is present, "
                             "2 on empty/unreadable artifacts")
    parser.add_argument("--latest", action="store_true",
                        help="treat TRACE_DIR as a root and pick the "
                             "newest trace dir under it")
    args = parser.parse_args(argv)

    try:
        args.trace_dir = resolve_trace_dir(args.trace_dir, args.latest)
        spans = read_spans(args.trace_dir)
    except OSError as e:
        print(f"flink-ml-tpu-torch-trace health: cannot read "
              f"{args.trace_dir}: {e}", file=sys.stderr)
        return 2
    snapshot = read_metrics(args.trace_dir)
    if args.check and not spans and not snapshot:
        print(f"flink-ml-tpu-torch-trace health: no artifacts in "
              f"{args.trace_dir}", file=sys.stderr)
        return 2
    summary = health_summary(spans, snapshot)
    from flink_ml_tpu_torch.observability.exporters import pipe_guard

    with pipe_guard():  # `... | head` closing the pipe is not an error
        if args.json:
            # strict-JSON output: json.dumps would render float('nan')
            # as the bare non-standard `NaN` token — unparseable by jq
            # et al. exactly when a fit diverged, which is this view's
            # whole point. Non-finite floats become strings.
            print(json.dumps(_json_safe(summary), indent=2, default=str))
        else:
            print(render_health(summary))
    if args.check and summary["health_events"]:
        print(f"flink-ml-tpu-torch-trace health: "
              f"{len(summary['health_events'])} health event(s) present",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
