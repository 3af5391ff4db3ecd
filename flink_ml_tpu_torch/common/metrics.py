"""ML metrics and profiling hooks.

The port of ``flink_ml_tpu/common/metrics.py`` (ref parity:
flink-ml-servable-core/.../common/metrics/MLMetrics.java — metric group names
(``ml`` / ``model``) and the model ``timestamp`` / ``version`` gauges used by
online models, OnlineStandardScalerModel.java:202-210). The registry, its
snapshot format, the group and bucket constants and the Prometheus-ready key
rendering are the JAX package's, so a snapshot either package writes merges
into the other's; the profiler hook wraps ``torch.profiler`` where the JAX
package wraps ``jax.profiler``.

Beyond the reference (docs/observability.md): metrics carry optional
**labels** and **histograms** so per-epoch / per-site history survives a
fit instead of collapsing into a last-value gauge, the registry is
thread-safe under concurrent stages, and :meth:`MetricsRegistry.merge`
folds host-pool child snapshots into the driver registry (the reference's
per-subtask metric aggregation, done by Flink's JobManager there).

Labeled metrics render their key in Prometheus label syntax
(``name{site="epoch"}``) so a snapshot is one string-split away from text
exposition (observability/exporters.py).

Live serving telemetry (docs/observability.md "Live telemetry & SLOs")
adds **sliding windows** on top of the cumulative primitives:
:class:`WindowedHistogram` keeps a ring of bucket-snapshot slices so
"p99 over the last 60 seconds" is answerable from a running process,
and :class:`WindowedCounter` gives rates/deltas over the same horizon.
Both preserve the cumulative view — ``snapshot`` / Prometheus
exposition / :meth:`MetricsRegistry.merge` are byte-identical to the
plain classes, so the fork-boundary merge and every artifact reader
keep working unchanged.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Dict, Optional

from flink_ml_tpu_torch.common import locks

ML_GROUP = "ml"
MODEL_GROUP = "model"
TIMESTAMP_GAUGE = "timestamp"
VERSION_GAUGE = "version"

#: default histogram bucket upper bounds — latency-shaped (ms); callers
#: with a different unit (bytes, counts) pass their own ``buckets``
DEFAULT_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0)

#: fraction-shaped bounds (0..1] for ratio histograms — batch fill and
#: padding waste in the serving micro-batcher (serving/batcher.py),
#: where the latency-shaped defaults would collapse every observation
#: into the first bucket
RATIO_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                 0.95, 1.0)


def _escape_label(value) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def metric_key(name: str, labels: Optional[Dict[str, str]] = None) -> str:
    """``name`` or ``name{k="v",...}`` (sorted keys, Prometheus syntax,
    values escaped) — THE rendering of a labeled metric identity;
    exporters and merge rely on every writer agreeing on it."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


def check_histogram_snapshot(key, snap: dict,
                             expected_buckets=None) -> None:
    """Validate a histogram snapshot's bucket layout BEFORE any fold:
    ``buckets``/``counts`` must be equal-length numeric sequences with
    sorted bounds, and — when ``expected_buckets`` is given — the bounds
    must match it exactly. Raises ValueError naming ``key`` (pass None
    for a bare histogram). One shared checker so every merge path
    (:meth:`Histogram.merge_snapshot`, :meth:`MetricGroup.check_snapshot`,
    :meth:`MetricsRegistry.merge`) rejects a drifted or malformed
    snapshot loudly instead of folding it partially — a short ``counts``
    array used to fold silently and a long one blew up mid-merge."""
    where = f"histogram {key!r}" if key is not None else "histogram"
    buckets = snap.get("buckets")
    counts = snap.get("counts")
    if (not isinstance(buckets, (list, tuple))
            or not isinstance(counts, (list, tuple))):
        raise ValueError(f"{where}: malformed snapshot — buckets/counts "
                         f"must be sequences, got {type(buckets).__name__}"
                         f"/{type(counts).__name__}")
    try:
        bounds = tuple(float(b) for b in buckets)
    except (TypeError, ValueError):
        raise ValueError(
            f"{where}: non-numeric bucket bounds {list(buckets)!r}")
    if len(bounds) != len(counts):
        raise ValueError(
            f"{where}: bucket layout mismatch — {len(bounds)} bound(s) "
            f"vs {len(counts)} count(s)")
    try:
        for c in counts:
            int(c)
        float(snap.get("sum", 0.0))
        int(snap.get("count", 0))
    except (TypeError, ValueError):
        # validate the fold's inputs HERE, before any mutation — a junk
        # count that only failed inside _merge_locked would leave the
        # histogram partially folded
        raise ValueError(
            f"{where}: non-numeric counts/sum/count in snapshot")
    if list(bounds) != sorted(bounds):
        # constructing a Histogram from these would silently re-sort the
        # bounds while the counts stay in snapshot order — misaligned
        raise ValueError(
            f"{where}: unsorted bucket bounds {list(bounds)}")
    if expected_buckets is not None and bounds != tuple(expected_buckets):
        raise ValueError(
            f"{where} bucket mismatch: {list(bounds)} "
            f"vs {list(expected_buckets)}")


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics): ``counts[i]``
    tallies observations <= ``buckets[i]``; an implicit +Inf bucket is
    ``count``. Thread-safe."""

    __slots__ = ("buckets", "counts", "sum", "count", "_lock")

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def _observe_locked(self, value: float) -> None:
        self.sum += value
        self.count += 1
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                self.counts[i] += 1

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._observe_locked(value)

    def snapshot(self) -> dict:
        with self._lock:
            return {"buckets": list(self.buckets),
                    "counts": list(self.counts),
                    "sum": self.sum, "count": self.count}

    def quantile(self, q: float) -> float:
        """Estimated ``q`` quantile (see :func:`histogram_quantile` for
        the interpolation rule and the explicit edge-case contract:
        ValueError outside [0, 1], NaN when empty, 0.0 at q=0, clamp to
        the last finite bound past it)."""
        return histogram_quantile(self.snapshot(), q)

    def _merge_locked(self, snap: dict) -> None:
        for i, c in enumerate(snap["counts"]):
            self.counts[i] += int(c)
        # .get: a snapshot missing sum/count merges as zeros instead of
        # escaping with a KeyError mid-merge (callers catch ValueError)
        self.sum += float(snap.get("sum", 0.0))
        self.count += int(snap.get("count", 0))

    def merge_snapshot(self, snap: dict) -> None:
        """Fold a child histogram snapshot in (bucket layout must match —
        both sides derive it from the same instrumentation site;
        :func:`check_histogram_snapshot` rejects drift loudly)."""
        check_histogram_snapshot(None, snap, self.buckets)
        with self._lock:
            self._merge_locked(snap)


def histogram_quantile(snapshot: dict, q: float) -> float:
    """Estimate the ``q`` (0..1) quantile from a cumulative-bucket
    histogram snapshot — Prometheus ``histogram_quantile`` semantics:
    linear interpolation within the winning bucket (from 0 below the
    first bound), observations past the last finite bound clamp to it.

    Edge cases are explicit contracts, not bucket-math fallout:

    - ``q`` outside ``[0, 1]`` (including NaN) raises ``ValueError`` —
      a malformed quantile is a caller bug, never a silent estimate;
    - an empty histogram (or a snapshot without buckets) returns NaN —
      the artifact-diff tooling (observability/diff.py) must
      distinguish 'no samples' from 0;
    - ``q == 0`` returns 0.0, the implicit lower bound of the first
      bucket (matching the interpolate-from-zero rule above);
    - ``q == 1`` interpolates to the upper bound of the last bucket
      holding observations; observations past the last finite bound
      (the implicit +Inf bucket) clamp to that last finite bound —
      a single-bucket histogram therefore answers every ``q > 0`` with
      a value in ``(0, bound]``."""
    q = float(q)
    if not 0.0 <= q <= 1.0:  # NaN fails both comparisons and lands here
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = int(snapshot.get("count", 0))
    buckets = snapshot.get("buckets", ())
    if total <= 0 or not buckets:
        return float("nan")
    if q == 0.0:
        return 0.0
    target = q * total
    counts = snapshot.get("counts", ())
    prev_count, prev_bound = 0, 0.0
    for bound, count in zip(buckets, counts):
        if count >= target:
            if count == prev_count:
                return float(bound)
            frac = (target - prev_count) / (count - prev_count)
            return prev_bound + (float(bound) - prev_bound) * frac
        prev_count, prev_bound = count, float(bound)
    return float(buckets[-1])


#: default sliding-window horizon / slice count for windowed metrics —
#: 15 minutes at 10-second granularity covers the default SLO burn
#: windows (observability/slo.py) while keeping the ring ≤ ~91 entries
DEFAULT_HORIZON_S = 900.0
DEFAULT_SLICES = 90


class WindowedHistogram(Histogram):
    """Sliding-window view on top of a cumulative histogram.

    A ring of **bucket-snapshot slices**: every ``horizon_s / slices``
    seconds (lazily, on the next observe/merge/query — no timer thread)
    the cumulative bucket state is pushed onto the ring; a window query
    subtracts the newest ring entry at least ``window_s`` old from the
    current cumulative state, yielding a cumulative-bucket snapshot of
    just the observations inside the window (so
    :func:`histogram_quantile` applies unchanged). Window edges are
    slice-granular by design.

    The cumulative view is untouched: :meth:`snapshot`, Prometheus
    exposition and :meth:`merge_snapshot` behave exactly like the base
    class, so registry merges (host-pool children) and artifact readers
    need no changes — and counts merged from a child land in the
    *current* slice, i.e. they appear in the driver's windowed view at
    merge time. ``clock`` is injectable for deterministic tests.
    Thread-safe."""

    __slots__ = ("horizon_s", "_slice_s", "_clock", "_ring",
                 "_last_slice", "_t0")

    def __init__(self, buckets=DEFAULT_BUCKETS,
                 horizon_s: float = DEFAULT_HORIZON_S,
                 slices: int = DEFAULT_SLICES, clock=time.monotonic):
        super().__init__(buckets)
        if horizon_s <= 0 or int(slices) < 1:
            raise ValueError("horizon_s must be > 0 and slices >= 1")
        self.horizon_s = float(horizon_s)
        self._slice_s = self.horizon_s / int(slices)
        self._clock = clock
        self._ring = collections.deque()  # (t, counts, sum, count)
        now = clock()
        self._t0 = now
        self._last_slice = now

    def _rotate_locked(self, now: float) -> None:
        if now - self._last_slice < self._slice_s:
            return
        # anything observed after the current slice ended would have
        # rotated first, so the cumulative state is unchanged since then
        # — stamping the entry at the slice end (not ``now``) keeps a
        # dormant histogram's stale observations out of future windows
        t = min(now, self._last_slice + self._slice_s)
        self._ring.append((t, tuple(self.counts), self.sum, self.count))
        self._last_slice = now
        cutoff = now - self.horizon_s
        # keep ONE entry at/past the full horizon as the baseline
        while len(self._ring) >= 2 and self._ring[1][0] <= cutoff:
            self._ring.popleft()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self._rotate_locked(self._clock())
            self._observe_locked(value)

    def merge_snapshot(self, snap: dict) -> None:
        check_histogram_snapshot(None, snap, self.buckets)
        with self._lock:
            self._rotate_locked(self._clock())
            self._merge_locked(snap)

    def window_snapshot(self, window_s: Optional[float] = None) -> dict:
        """Cumulative-bucket snapshot of the observations inside the
        last ``window_s`` seconds (default, and upper bound: the full
        horizon) — same shape as :meth:`snapshot` plus ``window_s``
        (requested) and ``elapsed_s`` (actually covered, shorter early
        in the histogram's life)."""
        w = self.horizon_s if window_s is None \
            else min(float(window_s), self.horizon_s)
        with self._lock:
            now = self._clock()
            self._rotate_locked(now)
            cutoff = now - w
            base = None
            for entry in reversed(self._ring):
                if entry[0] <= cutoff:
                    base = entry
                    break
            if base is None:  # younger than the window: zeros baseline
                bt, bcounts, bsum, bcount = (
                    self._t0, (0,) * len(self.buckets), 0.0, 0)
            else:
                bt, bcounts, bsum, bcount = base
            return {"buckets": list(self.buckets),
                    "counts": [c - b for c, b in
                               zip(self.counts, bcounts)],
                    "sum": self.sum - bsum,
                    "count": self.count - bcount,
                    "window_s": w,
                    "elapsed_s": max(now - bt, 0.0)}

    def window_quantile(self, q: float,
                        window_s: Optional[float] = None) -> float:
        """``q`` quantile over the sliding window (NaN when the window
        holds no observations — same contract as
        :func:`histogram_quantile`)."""
        return histogram_quantile(self.window_snapshot(window_s), q)

    def window_rate(self, window_s: Optional[float] = None) -> float:
        """Observations per second over the sliding window (0.0 before
        anything lands)."""
        snap = self.window_snapshot(window_s)
        elapsed = snap.get("elapsed_s") or 0.0
        if elapsed <= 0.0:
            return 0.0
        return snap["count"] / elapsed


class WindowedCounter:
    """Sliding-window view over ONE (possibly labeled) counter of a
    :class:`MetricGroup`. The group's plain counter stays THE cumulative
    value — snapshots, merges and Prometheus exposition are untouched;
    this object only keeps timestamped baselines of it, so increments a
    host-pool child folded in through :meth:`MetricsRegistry.merge`
    show up in the window too. Obtain via
    :meth:`MetricGroup.windowed_counter`; thread-safe."""

    __slots__ = ("horizon_s", "_slice_s", "_clock", "_ring",
                 "_last_slice", "_last_seen", "_initial", "_t0",
                 "_read", "_inc", "_lock")

    def __init__(self, read, inc, horizon_s: float = DEFAULT_HORIZON_S,
                 slices: int = DEFAULT_SLICES, clock=time.monotonic):
        if horizon_s <= 0 or int(slices) < 1:
            raise ValueError("horizon_s must be > 0 and slices >= 1")
        self.horizon_s = float(horizon_s)
        self._slice_s = self.horizon_s / int(slices)
        self._clock = clock
        self._read = read   # () -> current cumulative value
        self._inc = inc     # (n) -> new cumulative value
        self._ring = collections.deque()  # (t, cumulative)
        self._lock = threading.Lock()
        now = clock()
        self._t0 = now
        self._last_slice = now
        # pre-existing counts must not appear in any window: they are
        # both the backdating watermark and the no-ring-entry baseline
        self._initial = self._last_seen = int(read())

    def _rotate_locked(self, now: float) -> None:
        if now - self._last_slice < self._slice_s:
            return
        cur = int(self._read())
        t = min(now, self._last_slice + self._slice_s)
        if cur == self._last_seen:
            # dormant since the last boundary: backdate the stamp so
            # stale counts never re-enter a fresh window
            self._ring.append((t, cur))
        else:
            # the counter moved outside inc() — a plain counter() call
            # or a registry merge. We only know the old value held at
            # the last boundary and the new one holds now: stamp both,
            # so the delta stays window-visible from the merge onward
            self._ring.append((t, self._last_seen))
            self._ring.append((max(now, t), cur))
        self._last_seen = cur
        self._last_slice = now
        cutoff = now - self.horizon_s
        while len(self._ring) >= 2 and self._ring[1][0] <= cutoff:
            self._ring.popleft()

    def inc(self, n: int = 1) -> int:
        """Increment the underlying group counter (rotating the window
        ring first, so the boundary excludes this increment)."""
        with self._lock:
            self._rotate_locked(self._clock())
            value = int(self._inc(n))
            # accounted for at inc time: the next rotation may backdate
            # its boundary stamp safely (no merge/raw-counter movement)
            self._last_seen = max(self._last_seen, value)
        return value

    @property
    def value(self) -> int:
        """The cumulative value (the group's plain counter)."""
        return int(self._read())

    def window_delta(self, window_s: Optional[float] = None) -> int:
        """Increments inside the last ``window_s`` seconds (default,
        and upper bound: the horizon)."""
        w = self.horizon_s if window_s is None \
            else min(float(window_s), self.horizon_s)
        with self._lock:
            now = self._clock()
            self._rotate_locked(now)
            cutoff = now - w
            # no entry old enough → the window reaches past this view's
            # birth: baseline at the CONSTRUCTION value, never 0, so
            # counts that pre-date the windowed view stay out of it
            base = self._initial
            for entry in reversed(self._ring):
                if entry[0] <= cutoff:
                    base = entry[1]
                    break
            return int(self._read()) - base

    def window_rate(self, window_s: Optional[float] = None) -> float:
        """Increments per second over the sliding window."""
        w = self.horizon_s if window_s is None \
            else min(float(window_s), self.horizon_s)
        with self._lock:
            now = self._clock()
            self._rotate_locked(now)
            cutoff = now - w
            bt, base = self._t0, self._initial  # see window_delta
            for entry in reversed(self._ring):
                if entry[0] <= cutoff:
                    bt, base = entry
                    break
            elapsed = max(now - bt, 0.0)
            if elapsed <= 0.0:
                return 0.0
            return (int(self._read()) - base) / elapsed


class MetricGroup:
    def __init__(self, name: str):
        self.name = name
        self._gauges: Dict[str, float] = {}
        self._counters: Dict[str, int] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._windowed_counters: Dict[str, WindowedCounter] = {}
        self._lock = threading.Lock()

    def gauge(self, name: str, value,
              labels: Optional[Dict[str, str]] = None) -> None:
        with self._lock:
            self._gauges[metric_key(name, labels)] = value

    def counter(self, name: str, increment: int = 1,
                labels: Optional[Dict[str, str]] = None) -> int:
        key = metric_key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + increment
            return self._counters[key]

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS,
                  labels: Optional[Dict[str, str]] = None) -> Histogram:
        """The histogram registered under ``name`` (+labels), created on
        first use. ``buckets`` only applies at creation."""
        key = metric_key(name, labels)
        with self._lock:
            hist = self._histograms.get(key)
            if hist is None:
                hist = self._histograms[key] = Histogram(buckets)
            return hist

    def windowed_histogram(self, name: str, buckets=DEFAULT_BUCKETS,
                           horizon_s: float = DEFAULT_HORIZON_S,
                           slices: int = DEFAULT_SLICES,
                           labels: Optional[Dict[str, str]] = None
                           ) -> WindowedHistogram:
        """The :class:`WindowedHistogram` registered under ``name``
        (+labels), created on first use. A plain histogram already
        registered under the key (e.g. a child snapshot merged before
        the driver's first live observation) is upgraded in place — its
        cumulative state folds into the new window's current slice."""
        key = metric_key(name, labels)
        with self._lock:
            hist = self._histograms.get(key)
            if isinstance(hist, WindowedHistogram):
                return hist
            wh = WindowedHistogram(
                buckets if hist is None else hist.buckets,
                horizon_s=horizon_s, slices=slices)
            if hist is not None:
                wh.merge_snapshot(hist.snapshot())
            self._histograms[key] = wh
            return wh

    def windowed_counter(self, name: str,
                         horizon_s: float = DEFAULT_HORIZON_S,
                         slices: int = DEFAULT_SLICES,
                         labels: Optional[Dict[str, str]] = None
                         ) -> WindowedCounter:
        """The :class:`WindowedCounter` view over counter ``name``
        (+labels), created on first use. Increment through its
        :meth:`~WindowedCounter.inc` (or keep using :meth:`counter` —
        the plain counter stays the single cumulative source of truth;
        this object only adds window baselines over it)."""
        key = metric_key(name, labels)
        with self._lock:
            wc = self._windowed_counters.get(key)
            if wc is None:
                wc = self._windowed_counters[key] = WindowedCounter(
                    read=lambda: self._counters.get(key, 0),
                    inc=lambda n: self.counter(name, n, labels),
                    horizon_s=horizon_s, slices=slices)
            return wc

    def windowed_counter_items(self):
        """``(key, WindowedCounter)`` pairs registered on this group —
        the SLO engine's enumeration seam (observability/slo.py)."""
        with self._lock:
            return list(self._windowed_counters.items())

    def histogram_items(self):
        """``(key, Histogram)`` pairs registered on this group —
        includes :class:`WindowedHistogram` instances. The fleet beacon
        writer's enumeration seam (observability/fleet.py)."""
        with self._lock:
            return list(self._histograms.items())

    def get_gauge(self, name: str,
                  labels: Optional[Dict[str, str]] = None):
        with self._lock:
            return self._gauges.get(metric_key(name, labels))

    def get_counter(self, name: str,
                    labels: Optional[Dict[str, str]] = None) -> int:
        with self._lock:
            return self._counters.get(metric_key(name, labels), 0)

    def snapshot(self) -> dict:
        with self._lock:
            return {"gauges": dict(self._gauges),
                    "counters": dict(self._counters),
                    "histograms": {k: h.snapshot()
                                   for k, h in self._histograms.items()}}

    def merge_snapshot(self, snap: dict) -> None:
        """Fold a child group snapshot in: counters and histograms add,
        gauges last-write-wins (the child wrote later than the parent's
        pre-fork value by construction). All-or-nothing: histogram
        bucket mismatches are detected by :meth:`check_snapshot` BEFORE
        any key is folded, so a drifted snapshot never leaves the group
        half-merged (counters updated, histograms not)."""
        self.check_snapshot(snap)
        for key, value in snap.get("gauges", {}).items():
            with self._lock:
                self._gauges[key] = value
        for key, inc in snap.get("counters", {}).items():
            with self._lock:
                self._counters[key] = self._counters.get(key, 0) + int(inc)
        for key, hsnap in snap.get("histograms", {}).items():
            self.histogram(key, buckets=hsnap["buckets"]
                           ).merge_snapshot(hsnap)

    def check_snapshot(self, snap: dict) -> None:
        """Raise ValueError if merging ``snap`` would fail — histogram
        bucket drift against an existing series, or a malformed bucket
        layout (short/long/unsorted/non-numeric) that would previously
        fold partially or blow up mid-merge. Called before any mutation
        so merges are all-or-nothing; see
        :func:`check_histogram_snapshot` for the full contract."""
        for key, hsnap in snap.get("histograms", {}).items():
            with self._lock:
                existing = self._histograms.get(key)
            check_histogram_snapshot(
                key, hsnap,
                existing.buckets if existing is not None else None)


class MetricsRegistry:
    """Process-local metric registry; groups address as 'ml.model'.
    Thread-safe: concurrent stages may create/write groups freely."""

    def __init__(self):
        self._groups: Dict[str, MetricGroup] = {}
        self._lock = threading.Lock()

    def group(self, *path: str) -> MetricGroup:
        key = ".".join(path)
        with self._lock:
            grp = self._groups.get(key)
            if grp is None:
                grp = self._groups[key] = MetricGroup(key)
            return grp

    def model_group(self) -> MetricGroup:
        return self.group(ML_GROUP, MODEL_GROUP)

    def report_model(self, version: int, timestamp_ms: int = None) -> None:
        """The ml.model version/timestamp gauges (ref: MLMetrics usage)."""
        group = self.model_group()
        group.gauge(VERSION_GAUGE, version)
        group.gauge(TIMESTAMP_GAUGE,
                    timestamp_ms if timestamp_ms is not None
                    else int(time.time() * 1000))

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            groups = list(self._groups.items())
        return {name: g.snapshot() for name, g in groups}

    def group_items(self):
        """``(name, MetricGroup)`` pairs currently registered — the
        enumeration seam for live readers that need the group objects
        (windowed views), not just :meth:`snapshot` data."""
        with self._lock:
            return list(self._groups.items())

    def merge(self, snapshot: Dict[str, dict]) -> None:
        """Fold another registry's :meth:`snapshot` into this one — how
        host-pool child registries reach the driver (common/hostpool.py
        ships each child's snapshot back beside its shard result).
        All-or-nothing: every group is validated before any is folded,
        so a drifted snapshot is rejected whole, never half-merged."""
        groups = [(self.group(*name.split(".")), gsnap)
                  for name, gsnap in snapshot.items()]
        for grp, gsnap in groups:
            grp.check_snapshot(gsnap)
        for grp, gsnap in groups:
            grp.merge_snapshot(gsnap)

    def clear(self) -> None:
        """Drop every group (thread-safe; for same-process use — a
        forked child must use :meth:`reseed_child` instead)."""
        with self._lock:
            self._groups.clear()

    def reseed_child(self) -> None:
        """Reset this registry in a freshly forked child WITHOUT touching
        the inherited locks: a driver thread may have held
        ``_lock`` (or any group's lock) at fork time, and that mutex now
        has no owner thread in the child — acquiring it (as ``clear``
        would) deadlocks until the host-pool deadline SIGKILLs the
        worker. Post-fork the child is single-threaded, so plain
        reassignment is safe."""
        self._lock = threading.Lock()
        self._groups = {}  # torchlint: disable=unguarded-shared-state -- single-threaded post-fork; the stale guard was just replaced above


#: default process-wide registry
metrics = MetricsRegistry()


#: env var holding a directory; when set, every Estimator.fit /
#: AlgoOperator.transform records a torch.profiler trace there (api/stage.py)
PROFILE_DIR_ENV = "FLINK_ML_TPU_PROFILE_DIR"

_trace_active = False  # one profiler window at a time, as in the JAX package
# the seam lock (common/locks.py): coarse, name-visible to the
# watchdog; the per-Histogram/group micro-locks above stay bare —
# the watchdog mirrors INTO them, so instrumenting them would
# measure the measurer
_trace_lock = locks.make_lock("common.metrics.profile")


def claim_profiler() -> bool:
    """Atomically claim the process-wide single-trace slot. Returns True
    when the caller now owns the profiler (and must call
    :func:`release_profiler`), False when a trace is already active.
    Shared by :func:`profile` and observability/profiling.py so every
    capture path keeps to one profiler window at a time."""
    global _trace_active
    with _trace_lock:
        if _trace_active:
            return False
        _trace_active = True
        return True


def release_profiler() -> None:
    """Release the slot taken by :func:`claim_profiler` (idempotent)."""
    global _trace_active
    with _trace_lock:
        _trace_active = False


def start_trace():
    """Start a ``torch.profiler`` window over the host and, where a CUDA
    card is present, the card's kernels; returns the profiler for
    :func:`stop_trace`."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, trace_dir: str) -> str:
    """Stop ``prof`` (after the card finishes what it was given) and write
    its Chrome-format trace as ``<pid>.pt.trace.json`` in ``trace_dir``;
    returns the path."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profile(trace_dir: str = None, name: str = None):
    """Profile a region: wall-time gauge always; a torch.profiler trace
    when ``trace_dir`` is given (Chrome format: Perfetto or
    chrome://tracing). Reentrant — a region inside an already-active
    trace records only its wall-time gauge. ``name`` keys a per-region
    gauge in ``ml.profile`` alongside the generic one."""
    start = time.perf_counter()
    prof = None
    if trace_dir and claim_profiler():
        # the check and the claim are one atomic step: two concurrent
        # stages racing here would otherwise both start a profiler
        try:
            prof = start_trace()
        except BaseException:
            # roll the claim back: a failed start must not disable
            # profiling for the rest of the process
            release_profiler()
            raise
    try:
        yield
    finally:
        if prof is not None:
            try:
                stop_trace(prof, trace_dir)
            finally:
                # release the claim even when the export raises (a full
                # disk) — symmetric with the start-path rollback above
                release_profiler()
        elapsed_ms = (time.perf_counter() - start) * 1000.0
        metrics.group(ML_GROUP).gauge("lastProfiledRegionMs", elapsed_ms)
        if name:
            metrics.group(ML_GROUP, "profile").gauge(f"{name}LastMs",
                                                     elapsed_ms)
