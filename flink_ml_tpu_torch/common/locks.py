"""Named lock seam + the runtime lock-order / hold-time watchdog.

The port of ``flink_ml_tpu/common/locks.py``, the same env switches, lock
names, metrics and ``locks-<suffix>.json`` artifact.

Every coarse-grained package lock is created through
:func:`make_lock` / :func:`make_condition` instead of calling
``threading.Lock()`` directly. Unarmed, the factories return the bare
``threading`` primitives — zero hot-path cost, nothing wrapped. Armed
(:data:`LOCKCHECK_ENV` truthy **at lock-creation time**), they return
instrumented locks that report every acquire/release to a process-wide
watchdog which

- builds a cross-thread acquisition-order graph over lock *names*
  (two ``MicroBatcher`` instances share one discipline); a cycle in
  that graph is a potential deadlock → ``ml.lock`` tracer event
  (``kind=cycle``) + the ``ml.lock lockCycles`` counter;
- records per-lock hold-time histograms, mirrored into
  ``ml.lock holdMs{lock=}`` at artifact-dump points, with a long-hold
  threshold (:data:`HOLD_MS_ENV`, default 500 ms) that fires an
  ``ml.lock`` event (``kind=long-hold``) + ``longHolds{lock=}``;
- dumps its graph as ``locks-<suffix>.json`` beside the metrics
  snapshots (hooked from ``exporters.dump_metrics`` the same way the
  drift sketches are), which ``flink-ml-tpu-trace locks`` reads
  (exit 4 on cycle/long-hold, 2 on broken artifacts); that reader is
  the JAX package's until the port's CLI lands.

Design constraints (mirrors the PR-15 ``droppedSpans`` precedent):

- the watchdog's own mutex is a **bare** ``threading.Lock`` and is
  never held while calling out into metrics or the tracer — the
  instrumented locks those subsystems would re-enter must not recurse
  into the watchdog;
- for the same reason the metric/tracer *internals* (per-``Histogram``
  micro-locks, the tracer's span-sink lock) stay bare: the watchdog
  emits through them, so instrumenting them would measure the
  measurer;
- hot-path accounting lands in plain watchdog-internal structures;
  registry histograms/counters are only touched at
  :func:`mirror_metrics` time (dump points), as deltas.

Instrumented locks are **non-reentrant** (plain ``Lock`` inside, also
under a ``Condition``) — package locks are used non-reentrantly, and a
reentrant acquire under the watchdog is a bug worth deadlocking on in a
chaos job rather than masking.

This module also owns :func:`install_thread_excepthook` — the package
``threading.excepthook`` that turns a silently-dying daemon thread
(registry watcher, batcher tick, metrics server) into an
``ml.thread crashed{thread=}`` counter + tracer event.

This module imports nothing from the package at module level so that
``common/metrics.py`` (and everything above it) can import the seam
without a cycle; metrics/tracing are imported lazily on the armed
emission paths only.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

#: arming env var — read at LOCK-CREATION time (set it before the
#: process imports/constructs the runtime, like every other trace-time
#: selection in this package)
LOCKCHECK_ENV = "FLINK_ML_TPU_LOCKCHECK"

#: long-hold threshold in milliseconds (float), default 500
HOLD_MS_ENV = "FLINK_ML_TPU_LOCK_HOLD_MS"

DEFAULT_LONG_HOLD_MS = 500.0

#: hold-time bucket bounds — the latency-shaped defaults of
#: common/metrics.py, duplicated here (not imported) to keep this
#: module import-free; ``check_histogram_snapshot`` would reject drift
#: loudly at merge time if the two ever diverged
HOLD_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0)

#: locks-state artifacts in a trace dir (one per traced process),
#: sibling of the metrics-*.json snapshots
LOCKS_GLOB = "locks-*.json"

_FALSY = ("", "0", "false", "no", "off")

#: long-hold records kept verbatim (the histograms keep the full tally)
_LONG_HOLD_CAP = 200


def lockcheck_armed() -> bool:
    return os.environ.get(LOCKCHECK_ENV, "").strip().lower() not in _FALSY


def long_hold_threshold_ms() -> float:
    raw = os.environ.get(HOLD_MS_ENV, "")
    try:
        value = float(raw)
    except ValueError:
        return DEFAULT_LONG_HOLD_MS
    return value if value > 0 else DEFAULT_LONG_HOLD_MS


class _Watchdog:
    """Process-wide acquisition-order graph + hold-time accounting.

    Invariant: ``_mu`` (a bare lock) is never held across a call into
    metrics or tracing — see the module docstring.
    """

    def __init__(self):
        self._mu = threading.Lock()
        self._tls = threading.local()
        #: (outer_name, inner_name) -> acquisition count
        self._edges: Dict[Tuple[str, str], int] = {}
        #: recorded cycles (lock-name paths, first == last), deduped
        self._cycles: List[List[str]] = []
        self._cycle_keys = set()
        #: name -> {"counts", "sum", "count", "max_ms"}
        self._holds: Dict[str, dict] = {}
        self._long_holds: List[dict] = []
        self._long_hold_total = 0
        self._acquires: Dict[str, int] = {}
        # deltas already folded into the metrics registry
        self._mirrored_holds: Dict[str, dict] = {}
        self._mirrored_cycles = 0
        self._mirrored_long: Dict[str, int] = {}
        self._long_by_lock: Dict[str, int] = {}

    # -- per-thread held stack ------------------------------------------------
    def _held_stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def held_names(self) -> List[str]:
        """Lock names the CALLING thread currently holds (tests)."""
        return [name for name, _t0 in self._held_stack()]

    # -- hot path -------------------------------------------------------------
    def note_acquired(self, name: str) -> None:
        held = self._held_stack()
        cycle: Optional[List[str]] = None
        with self._mu:
            self._acquires[name] = self._acquires.get(name, 0) + 1
            for outer, _t0 in held:
                if outer == name:
                    continue
                key = (outer, name)
                self._edges[key] = self._edges.get(key, 0) + 1
                if self._edges[key] == 1:
                    path = self._find_cycle_locked(outer, name)
                    if path is not None:
                        sig = frozenset(zip(path, path[1:]))
                        if sig not in self._cycle_keys:
                            self._cycle_keys.add(sig)
                            self._cycles.append(path)
                            cycle = path
        held.append((name, time.monotonic()))
        if cycle is not None:
            self._emit_cycle(cycle)

    def note_released(self, name: str) -> None:
        held = self._held_stack()
        t0 = None
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                t0 = held[i][1]
                del held[i]
                break
        if t0 is None:  # release without a recorded acquire: ignore
            return
        hold_ms = (time.monotonic() - t0) * 1000.0
        threshold = long_hold_threshold_ms()
        with self._mu:
            rec = self._holds.get(name)
            if rec is None:
                rec = self._holds[name] = {
                    "counts": [0] * len(HOLD_BUCKETS),
                    "sum": 0.0, "count": 0, "max_ms": 0.0}
            rec["sum"] += hold_ms
            rec["count"] += 1
            rec["max_ms"] = max(rec["max_ms"], hold_ms)
            for i, bound in enumerate(HOLD_BUCKETS):
                if hold_ms <= bound:
                    rec["counts"][i] += 1
            if hold_ms >= threshold:
                self._long_hold_total += 1
                self._long_by_lock[name] = \
                    self._long_by_lock.get(name, 0) + 1
                if len(self._long_holds) < _LONG_HOLD_CAP:
                    self._long_holds.append(
                        {"lock": name, "hold_ms": round(hold_ms, 3)})
        if hold_ms >= threshold:
            self._emit_long_hold(name, hold_ms, threshold)

    def _find_cycle_locked(self, outer: str, inner: str
                           ) -> Optional[List[str]]:
        """A path ``outer -> inner -> ... -> outer`` through the edge
        graph (the new edge just closed it), or None."""
        succ: Dict[str, List[str]] = {}
        for (a, b) in self._edges:
            succ.setdefault(a, []).append(b)
        stack = [(inner, [outer, inner])]
        seen = {inner}
        while stack:
            node, path = stack.pop()
            for nxt in succ.get(node, ()):
                if nxt == outer:
                    return path + [outer]
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # -- emission (never under _mu) ------------------------------------------
    def _emit_cycle(self, path: List[str]) -> None:
        try:
            from flink_ml_tpu_torch.observability.tracing import tracer

            tracer.event("ml.lock", kind="cycle",
                         cycle=" -> ".join(path))
        except Exception:  # telemetry must never take down the caller
            pass

    def _emit_long_hold(self, name: str, hold_ms: float,
                        threshold: float) -> None:
        try:
            from flink_ml_tpu_torch.observability.tracing import tracer

            tracer.event("ml.lock", kind="long-hold", lock=name,
                         holdMs=round(hold_ms, 3),
                         thresholdMs=threshold)
        except Exception:
            pass

    # -- dump-point mirroring & state ----------------------------------------
    def mirror_metrics(self) -> None:
        """Fold accounting deltas since the last call into the metrics
        registry (``ml.lock`` group) — called at artifact-dump points,
        never per acquire."""
        with self._mu:
            hold_deltas: Dict[str, dict] = {}
            for name, rec in self._holds.items():
                prev = self._mirrored_holds.get(
                    name, {"counts": [0] * len(HOLD_BUCKETS),
                           "sum": 0.0, "count": 0})
                delta_count = rec["count"] - prev["count"]
                if delta_count <= 0:
                    continue
                hold_deltas[name] = {
                    "buckets": list(HOLD_BUCKETS),
                    "counts": [c - p for c, p in
                               zip(rec["counts"], prev["counts"])],
                    "sum": rec["sum"] - prev["sum"],
                    "count": delta_count,
                }
                self._mirrored_holds[name] = {
                    "counts": list(rec["counts"]),
                    "sum": rec["sum"], "count": rec["count"]}
            cycle_delta = len(self._cycles) - self._mirrored_cycles
            self._mirrored_cycles = len(self._cycles)
            long_deltas: Dict[str, int] = {}
            for name, n in self._long_by_lock.items():
                d = n - self._mirrored_long.get(name, 0)
                if d > 0:
                    long_deltas[name] = d
                    self._mirrored_long[name] = n
        if not hold_deltas and not cycle_delta and not long_deltas:
            return
        try:
            from flink_ml_tpu_torch.common.metrics import ML_GROUP, metrics

            group = metrics.group(ML_GROUP, "lock")
            for name, snap in hold_deltas.items():
                group.histogram("holdMs", buckets=HOLD_BUCKETS,
                                labels={"lock": name}).merge_snapshot(snap)
            if cycle_delta > 0:
                group.counter("lockCycles", cycle_delta)
            for name, d in long_deltas.items():
                group.counter("longHolds", d, labels={"lock": name})
        except Exception:
            pass

    def state_snapshot(self) -> dict:
        with self._mu:
            return {
                "threshold_ms": long_hold_threshold_ms(),
                "acquires": dict(self._acquires),
                "edges": [[a, b, n] for (a, b), n
                          in sorted(self._edges.items())],
                "cycles": [list(p) for p in self._cycles],
                "holds": {name: {"counts": list(rec["counts"]),
                                 "sum": rec["sum"],
                                 "count": rec["count"],
                                 "max_ms": rec["max_ms"]}
                          for name, rec in sorted(self._holds.items())},
                "long_holds": list(self._long_holds),
                "long_hold_total": self._long_hold_total,
            }


_watchdog = _Watchdog()


def watchdog() -> _Watchdog:
    """The process-wide watchdog (instrumented locks look it up per
    call, so :func:`reseed_child` can swap it atomically)."""
    return _watchdog


class _InstrumentedLock:
    """``threading.Lock`` wrapper reporting to the watchdog.

    Provides ``_is_owned`` so ``threading.Condition`` uses ownership
    tracking instead of its probe-acquire fallback (which would record
    a phantom acquire/release pair per ``wait``/``notify``); the
    Condition default ``_release_save``/``_acquire_restore`` call our
    ``release``/``acquire``, so a ``wait()`` correctly closes one
    hold-time interval and opens another on wakeup.
    """

    __slots__ = ("name", "_lock", "_owner")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._owner: Optional[int] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._owner = threading.get_ident()
            _watchdog.note_acquired(self.name)
        return got

    def release(self) -> None:
        # record while still the owner: the hold interval must close
        # before another thread can open its own
        self._owner = None
        _watchdog.note_released(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def _is_owned(self) -> bool:
        return (self._lock.locked()
                and self._owner == threading.get_ident())

    def __enter__(self) -> "_InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover
        state = "locked" if self._lock.locked() else "unlocked"
        return f"<InstrumentedLock {self.name!r} {state}>"


def make_lock(name: str):
    """A named package lock: bare ``threading.Lock`` unarmed, watchdog-
    instrumented when :data:`LOCKCHECK_ENV` is set (at creation time)."""
    if lockcheck_armed():
        _register_exit_dump()
        return _InstrumentedLock(name)
    return threading.Lock()


def make_condition(name: str):
    """A named package condition variable; armed, its inner lock is
    instrumented so ``with cond:`` / ``cond.wait()`` report to the
    watchdog. NOTE: the armed inner lock is non-reentrant (plain
    ``Lock``), unlike the bare default (``RLock``) — package conditions
    are used non-reentrantly."""
    if lockcheck_armed():
        _register_exit_dump()
        return threading.Condition(lock=_InstrumentedLock(name))
    return threading.Condition()


# -- exit dump ---------------------------------------------------------------
# An armed process must leave its locks-*.json even when its entry point
# never reaches exporters.dump_metrics (a script driving iterate_bounded
# directly, with no stage wrapper in the call chain). The artifact name
# is per-process stable, so this overwrites — never duplicates — a dump
# the exporter already wrote.
_atexit_mu = threading.Lock()
_atexit_registered = False


def _register_exit_dump() -> None:
    global _atexit_registered
    with _atexit_mu:
        if _atexit_registered:
            return
        _atexit_registered = True
    import atexit

    atexit.register(_dump_at_exit)


def _dump_at_exit() -> None:
    trace_dir = os.environ.get("FLINK_ML_TPU_TRACE_DIR")
    if not trace_dir:
        return
    try:
        os.makedirs(trace_dir, exist_ok=True)
        dump_state(trace_dir)
    except Exception:  # interpreter teardown: never raise
        pass


# -- artifact dump (exporters.dump_metrics hook) ------------------------------
def mirror_metrics() -> None:
    _watchdog.mirror_metrics()


def state_snapshot() -> dict:
    return _watchdog.state_snapshot()


def dump_state(trace_dir: str) -> Optional[str]:
    """Write ``locks-<suffix>.json`` (acquisition graph, cycles, hold
    stats) into ``trace_dir`` and mirror the lock metrics into the
    registry — called by ``exporters.dump_metrics`` whenever this
    module is loaded, a no-op when the watchdog saw no locks (unarmed
    runs dump nothing). Returns the path written, or None."""
    snap = state_snapshot()
    if not snap["acquires"]:
        return None
    mirror_metrics()
    from flink_ml_tpu_torch.observability.exporters import artifact_suffix

    path = os.path.join(trace_dir, f"locks-{artifact_suffix()}.json")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path


def reseed_child() -> None:
    """Fork boundary (resilience/hostpool ``_child_main``): a parent
    thread may have held the watchdog's internal mutex (or left stale
    held-stacks) at fork time — replace the whole watchdog so the child
    starts from a clean, unlocked graph."""
    global _watchdog
    _watchdog = _Watchdog()


# -- package threading.excepthook --------------------------------------------
_hook_mu = threading.Lock()
_hook_installed = False


def install_thread_excepthook() -> None:
    """Idempotently install a ``threading.excepthook`` that records a
    crashing thread as ``ml.thread crashed{thread=}`` + an ``ml.thread``
    tracer event before chaining to the previously-installed hook — a
    daemon thread (registry watcher, batcher tick, metrics server)
    must not die silently. Armed at the stage/serving seams."""
    global _hook_installed
    with _hook_mu:
        if _hook_installed:
            return
        prev = threading.excepthook

        def _hook(args, _prev=prev):
            if args.exc_type is not SystemExit:
                name = getattr(args.thread, "name", None) or "unknown"
                exc = getattr(args.exc_type, "__name__",
                              str(args.exc_type))
                try:
                    from flink_ml_tpu_torch.common.metrics import (
                        ML_GROUP,
                        metrics,
                    )

                    metrics.group(ML_GROUP, "thread").counter(
                        "crashed", labels={"thread": name})
                except Exception:
                    pass
                try:
                    from flink_ml_tpu_torch.observability.tracing import tracer

                    tracer.event("ml.thread", kind="crashed",
                                 thread=name, exception=exc)
                except Exception:
                    pass
            _prev(args)

        threading.excepthook = _hook
        _hook_installed = True
