"""Span-based tracing: trace/span ids, parent links, attributes, events.

The port of ``flink_ml_tpu/observability/tracing.py``, as it is: the same
env switches, span record schema and ``spans-<pid>.jsonl`` file names, so
either package's readers read a trace dir the other wrote.

The reference delegates run visibility to Flink's web UI (SURVEY.md §5);
here the runtime is this process, so the trace is a first-class artifact:
every instrumented seam (api/stage.py fit/transform, the iteration epoch
loop, checkpoint save/restore, the host pool, the resilience supervisor,
the benchmark runner) opens a :class:`Span` through the process-wide
:data:`tracer`, and finished spans stream to JSON-lines files under
``FLINK_ML_TPU_TRACE_DIR`` — one file per process, merged by the readers
(observability/exporters.py, the ``flink-ml-tpu-trace`` CLI).

Context propagation is thread-local (a span opened on one thread never
implicitly parents a span on another) — crossing a boundary is explicit
through a :class:`TraceContext`, a serializable (trace id, span id)
pair:

- **threads/queues**: capture :func:`current_context` on the producing
  thread, carry it with the work item (a Future, a ``queue.Queue``
  element — serving/batcher.py does both), and open the consuming span
  with ``span(..., parent=ctx)`` (a child) or ``span(...,
  links=[ctx])`` (an explicit ``follows_from`` link: the handoff edge
  of a span DAG, rendered by ``flink-ml-tpu-trace path``); a linked
  root span adopts the first link's trace id so the whole causal chain
  shares ONE trace;
- **fork** (common/hostpool.py): the dispatching span's context is
  captured pre-fork and frozen by :func:`Tracer.reseed_child` as the
  child's remote parent, while the sink re-points at the child's own
  ``spans-<pid>.jsonl`` — child spans nest under the dispatching span
  when the files merge at collect time;
- **processes** (parallel/distributed.py): the launcher serializes a
  context into ``FLINK_ML_TPU_TRACE_PARENT``; every child's root spans
  join that trace, so the merged ``spans-p<k>-*.jsonl`` artifacts of a
  multi-process run stitch into ONE trace.

When no trace dir is armed (env or :meth:`Tracer.configure`), ``span``
returns a shared no-op context manager — one dict lookup of overhead —
so the instrumentation stays compiled into production paths, same policy
as resilience.faults.

This composes with (does not replace) the ``FLINK_ML_TPU_PROFILE_DIR``
torch.profiler hook (common/metrics.py) and the in-program device profile
(observability/profiling.py): the profiler captures the card's kernels,
the tracer the host-side structure around them.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

#: env var holding a directory; when set, instrumented seams emit spans
#: as ``spans-<pid>.jsonl`` files there (docs/observability.md)
TRACE_DIR_ENV = "FLINK_ML_TPU_TRACE_DIR"

#: env var holding a serialized :class:`TraceContext`
#: (``<trace_id>:<span_id>``; the span half may be empty) — how a
#: launched child process (parallel/distributed.py) inherits its
#: parent's trace id: the child's ROOT spans join that trace instead of
#: minting their own, so merged per-process artifacts stitch into one
TRACE_PARENT_ENV = "FLINK_ML_TPU_TRACE_PARENT"

#: default capacity of the recent-span ring (the live ``/spans/recent``
#: endpoint and the flight recorder's span evidence —
#: observability/flightrecorder.py); override with
#: ``FLINK_ML_TPU_TRACE_RING``
RECENT_SPANS = 256

#: env var overriding the ring capacity (a bigger ring = more incident
#: evidence, more resident memory); read once per Tracer construction /
#: ``reseed_child``
RING_ENV = "FLINK_ML_TPU_TRACE_RING"


def ring_capacity() -> int:
    """The recent-span ring capacity: ``FLINK_ML_TPU_TRACE_RING`` when
    set to a positive integer, else :data:`RECENT_SPANS` (garbage or
    non-positive values fall back rather than disarming the flight
    recorder's evidence ring)."""
    raw = os.environ.get(RING_ENV)
    if raw:
        try:
            n = int(raw)
            if n > 0:
                return n
        except ValueError:
            pass
    return RECENT_SPANS


_id_counter = itertools.count(1)
_id_lock = threading.Lock()


def _new_id() -> str:
    """Process-unique span/trace id: pid + monotonic counter. ids only
    need to be unique within one trace dir; embedding the pid keeps
    forked children (which inherit the counter) from colliding."""
    with _id_lock:
        n = next(_id_counter)
    return f"{os.getpid():x}-{n:x}"


class TraceContext:
    """A serializable span coordinate: ``(trace_id, span_id)``.

    THE currency of cross-boundary causality: capture it where work is
    produced (:func:`current_context`), carry it with the work item (a
    Future, a queue element, a pickled fork payload, an env var), and
    spend it where the work is consumed — as ``parent=`` (the consumer
    is *inside* the producer) or ``links=[...]`` (the consumer *follows
    from* the producer: a queue handoff, a batch serving many requests,
    a controller cycle chained across steps). ``span_id`` may be None:
    a trace-only context (what :func:`fresh_context` mints for process
    launchers) adopts the trace without claiming a parent span."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return f"TraceContext({self.trace_id}, {self.span_id})"

    def __eq__(self, other):
        return (isinstance(other, TraceContext)
                and self.trace_id == other.trace_id
                and self.span_id == other.span_id)

    def to_dict(self) -> dict:
        return {"trace": self.trace_id, "span": self.span_id}

    @classmethod
    def from_dict(cls, d: dict) -> "TraceContext":
        return cls(str(d["trace"]), d.get("span") or None)

    def to_header(self) -> str:
        """``<trace_id>:<span_id>`` — the env-var / wire spelling
        (ids are hex+dash, so ``:`` can never appear inside one)."""
        return f"{self.trace_id}:{self.span_id or ''}"

    @classmethod
    def from_header(cls, header: str) -> Optional["TraceContext"]:
        """Parse the ``to_header`` spelling; malformed input returns
        None — a corrupt env var must never sink span creation."""
        if not header or ":" not in header:
            return None
        trace_id, _, span_id = header.partition(":")
        if not trace_id.strip():
            return None
        return cls(trace_id.strip(), span_id.strip() or None)


class Span:
    """One timed region. ``ts_us`` is wall-clock epoch microseconds (what
    Chrome trace-event ``ts`` wants); duration is measured on the
    monotonic clock. ``links`` are explicit ``follows_from`` edges to
    other spans (by :class:`TraceContext`): the DAG edges parent links
    cannot express — queue handoffs, batches serving many requests —
    consumed by ``flink-ml-tpu-trace path``."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "ts_us",
                 "dur_us", "attrs", "events", "links", "_t0")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], attrs: Dict,
                 links: Optional[List[TraceContext]] = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.ts_us = time.time_ns() // 1000
        self.dur_us = None
        self.attrs = dict(attrs)
        self.events: List[dict] = []
        self.links = [ctx for ctx in (links or ())
                      if ctx is not None and ctx.span_id is not None]
        self._t0 = time.perf_counter_ns()

    def set_attribute(self, key: str, value) -> None:
        self.attrs[key] = value

    def add_event(self, name: str, **attrs) -> None:
        self.events.append({"name": name,
                            "ts_us": time.time_ns() // 1000,
                            "attrs": attrs})

    def add_link(self, ctx: Optional[TraceContext]) -> None:
        """Attach a ``follows_from`` link after the span opened (e.g.
        the handoff context only becomes known mid-span)."""
        if ctx is not None and ctx.span_id is not None:
            self.links.append(ctx)

    def finish(self) -> None:
        self.dur_us = (time.perf_counter_ns() - self._t0) // 1000

    def to_record(self, pid: int, tid: int) -> dict:
        record = {"type": "span", "name": self.name,
                  "trace": self.trace_id, "id": self.span_id,
                  "parent": self.parent_id, "ts_us": self.ts_us,
                  "dur_us": self.dur_us, "pid": pid, "tid": tid,
                  "attrs": self.attrs, "events": self.events}
        if self.links:
            record["links"] = [{"trace": ctx.trace_id,
                                "span": ctx.span_id,
                                "kind": "follows_from"}
                               for ctx in self.links]
        return record


class _NoopSpan:
    """Shared do-nothing span/context-manager for the disarmed tracer."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attribute(self, key, value):
        pass

    def add_event(self, name, **attrs):
        pass

    def add_link(self, ctx):
        pass


_NOOP = _NoopSpan()


class _ActiveSpan:
    """Context manager pairing a real Span with its tracer."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self):
        return self.span

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.span.set_attribute("error", exc_type.__name__)
        self._tracer._end(self.span)
        return False


class Tracer:
    """Process-wide tracer with thread-local context propagation."""

    def __init__(self):
        self._tls = threading.local()
        self._configured_dir: Optional[str] = None
        self._sink = None           # open file handle, lazily created
        self._sink_pid = None       # pid the sink belongs to (fork guard)
        self._sink_path = None      # path it writes (re-arm guard)
        self._sink_lock = threading.Lock()
        # a frozen TraceContext parent inherited across fork / attached
        # from a launcher's env (see TRACE_PARENT_ENV)
        self._remote_parent: Optional[TraceContext] = None
        # the recent-span ring: the live /spans/recent endpoint AND the
        # flight recorder's span evidence (observability/
        # flightrecorder.py). keep_recent arms it without a trace dir
        # (observability/server.py); with a dir armed it fills as a side
        # effect of writing — the ring must already hold history when an
        # incident fires, so it cannot wait to be asked
        self.keep_recent = False
        self.recent = collections.deque(maxlen=ring_capacity())
        #: spans evicted from the full ring since process start — the
        #: flight recorder's evidence-window pressure, mirrored into
        #: the ``ml.tracing droppedSpans`` counter by
        #: :meth:`mirror_dropped` (artifact/incident dump points, not
        #: per span)
        self.dropped_spans = 0
        self._drop_mirrored = 0

    # -- arming --------------------------------------------------------------
    @property
    def trace_dir(self) -> Optional[str]:
        return self._configured_dir or os.environ.get(TRACE_DIR_ENV)

    @property
    def enabled(self) -> bool:
        return bool(self.trace_dir)

    @property
    def active(self) -> bool:
        """Spans are being recorded somewhere: to the trace dir
        (``enabled``) and/or to the in-memory recent ring for the live
        telemetry endpoint (``keep_recent``)."""
        return self.enabled or self.keep_recent

    def configure(self, trace_dir: Optional[str]) -> None:
        """Programmatic arming (tests, embedding); ``None`` reverts to
        the environment."""
        self.shutdown()
        self._configured_dir = trace_dir

    def shutdown(self) -> None:
        """Close the sink (spans already written stay on disk)."""
        with self._sink_lock:
            if self._sink is not None:
                try:
                    self._sink.close()
                except OSError:
                    pass
                self._sink = None
                self._sink_pid = None
        self._configured_dir = None

    # -- context -------------------------------------------------------------
    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def root(self) -> Optional[Span]:
        """The outermost open span on this thread (the fit/transform
        root) — where run-wide attributes like the mesh topology belong."""
        stack = self._stack()
        return stack[0] if stack else None

    def current_context(self) -> Optional[TraceContext]:
        """The current span's :class:`TraceContext` (None with no open
        span) — what a producer captures before handing work to another
        thread, process or queue."""
        cur = self.current()
        if cur is None:
            return None
        return TraceContext(cur.trace_id, cur.span_id)

    def attach_context(self, ctx: Optional[TraceContext]) -> None:
        """Pin a remote parent: root spans of THIS process (any thread
        with an empty stack) become children of ``ctx`` — the
        programmatic twin of :data:`TRACE_PARENT_ENV`, and what
        :meth:`reseed_child` installs after a fork."""
        self._remote_parent = ctx

    def _env_parent(self) -> Optional[TraceContext]:
        return TraceContext.from_header(
            os.environ.get(TRACE_PARENT_ENV, ""))

    def span(self, name: str, parent: Optional[TraceContext] = None,
             links: Optional[List[TraceContext]] = None, **attrs):
        """Open a span under the current one (or as a new trace root).
        Use as a context manager; yields the :class:`Span`.

        ``parent`` overrides the thread-local context: the span becomes
        a child of that (possibly remote) span — how a consumer thread
        re-enters the producer's trace. ``links`` attach explicit
        ``follows_from`` edges; a span with neither a local nor an
        explicit parent adopts the first link's trace id, so a causal
        chain built purely from handoffs still shares one trace. With
        no context at all, a root span joins the process-wide remote
        parent (fork reseed / :data:`TRACE_PARENT_ENV`) before minting
        a fresh trace."""
        if not self.active:
            return _NOOP
        stack = self._stack()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif stack:
            top = stack[-1]
            trace_id, parent_id = top.trace_id, top.span_id
        else:
            remote = self._remote_parent or self._env_parent()
            if remote is not None:
                trace_id, parent_id = remote.trace_id, remote.span_id
            elif links:
                first = next((c for c in links if c is not None), None)
                trace_id = (first.trace_id if first is not None
                            else _new_id())
                parent_id = None
            else:
                trace_id, parent_id = _new_id(), None
        sp = Span(name, trace_id, _new_id(), parent_id, attrs,
                  links=links)
        stack.append(sp)
        return _ActiveSpan(self, sp)

    def event(self, name: str, **attrs) -> None:
        """Record an instant event on the current span; with no span
        open, emit a standalone zero-duration span carrying it — the
        event must reach the trace either way (a supervisor restart
        outside any fit still matters)."""
        if not self.active:
            return
        cur = self.current()
        if cur is not None:
            cur.add_event(name, **attrs)
            return
        with self.span(f"event:{name}") as sp:
            sp.add_event(name, **attrs)

    def _end(self, sp: Span) -> None:
        sp.finish()
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        else:  # out-of-order exit: drop it from wherever it sits
            try:
                stack.remove(sp)
            except ValueError:
                pass
        record = sp.to_record(os.getpid(), threading.get_ident())
        from flink_ml_tpu_torch.observability.exporters import (
            safe_process_label)

        proc = safe_process_label()
        if proc is not None:
            # attribution for multi-process trace merges: same-pid span
            # records from different hosts must not fold into one process
            record["process"] = proc
        # the ring fills whenever spans are recorded at all (not just
        # under keep_recent): it is the flight recorder's evidence of
        # "what ran before the incident", which must exist BEFORE the
        # incident asks for it. deque.append is thread-safe; a bounded
        # deque evicts silently, so evictions are tallied here — a
        # plain int increment, NOT a registry-lock hit per span on the
        # always-on serving path; mirror_dropped() folds the tally
        # into the ml.tracing droppedSpans counter at artifact-dump /
        # incident-dump / scrape points
        if (self.recent.maxlen is not None
                and len(self.recent) >= self.recent.maxlen):
            self.dropped_spans += 1
        self.recent.append(record)
        self._write(record)

    def mirror_dropped(self) -> int:
        """Fold ring evictions tallied since the last call into the
        ``ml.tracing droppedSpans`` counter — called where the number
        becomes visible (metrics dumps, incident bundles), never per
        span. Returns the cumulative eviction count."""
        delta = self.dropped_spans - self._drop_mirrored
        if delta > 0:
            try:
                from flink_ml_tpu_torch.common.metrics import ML_GROUP, metrics

                metrics.group(ML_GROUP, "tracing").counter(
                    "droppedSpans", delta)
                self._drop_mirrored += delta
            except Exception:  # noqa: BLE001 — accounting must never
                # sink the dump it rides on
                pass
        return self.dropped_spans

    # -- sink ----------------------------------------------------------------
    def span_file(self) -> Optional[str]:
        d = self.trace_dir
        if not d:
            return None
        # multi-process runtimes prefix the process index
        # (spans-p<k>-<pid>.jsonl): two hosts can share a pid, and the
        # shared trace dir must keep their streams apart
        from flink_ml_tpu_torch.observability.exporters import artifact_suffix

        return os.path.join(d, f"spans-{artifact_suffix()}.jsonl")

    def _write(self, record: dict) -> None:
        path = self.span_file()
        if path is None:
            return
        line = json.dumps(record, default=str) + "\n"
        with self._sink_lock:
            if self._sink is not None and self._sink_pid != os.getpid():
                # forked child inherited the parent's handle: abandon it
                # (closing could flush into the parent's file)
                self._sink = None
            elif self._sink is not None and self._sink_path != path:
                # the trace dir was re-armed mid-process: follow it
                try:
                    self._sink.close()
                except OSError:
                    pass
                self._sink = None
            if self._sink is None:
                os.makedirs(os.path.dirname(path), exist_ok=True)
                self._sink = open(path, "a", encoding="utf-8")
                self._sink_pid = os.getpid()
                self._sink_path = path
            self._sink.write(line)
            self._sink.flush()  # line-per-span: nothing buffered at fork
                                # or os._exit time

    # -- fork boundary -------------------------------------------------------
    def reseed_child(self, parent: Optional[TraceContext] = None) -> None:
        """Called in a freshly forked host-pool child: freeze the
        dispatching span as a remote parent link, drop the inherited
        context/sink, and point writes at this pid's own span file. The
        child's spans then merge under the dispatching parent span at
        collect time.

        ``parent`` is the context the dispatcher captured PRE-fork
        (common/hostpool.py passes it); falling back to the inherited
        thread-local stack covers embedders that fork without capturing
        one — but only sees the forking thread's context."""
        if parent is None:
            parent = self.current_context()
        self._remote_parent = parent
        self._tls = threading.local()
        # the child is single-threaded here, and the inherited
        # _sink_lock may have been snapshotted HELD by a parent thread
        # — taking it could deadlock; it is replaced two lines down
        self._sink = None  # torchlint: disable=unguarded-shared-state -- single-threaded post-fork; the guard itself is stale and replaced below
        self._sink_pid = None  # torchlint: disable=unguarded-shared-state -- single-threaded post-fork; the guard itself is stale and replaced below
        self._sink_path = None  # torchlint: disable=unguarded-shared-state -- single-threaded post-fork; the guard itself is stale and replaced below
        self._sink_lock = threading.Lock()
        # the live endpoint is driver-only (observability/server.py) and
        # the child's incident evidence merges through its own span
        # file: the ring restarts empty
        self.keep_recent = False
        self.recent = collections.deque(maxlen=ring_capacity())
        self.dropped_spans = 0
        self._drop_mirrored = 0


#: default process-wide tracer
tracer = Tracer()


def span(name: str, **attrs):
    """Module-level convenience: ``tracer.span`` on the default tracer."""
    return tracer.span(name, **attrs)


def event(name: str, **attrs) -> None:
    """Module-level convenience: ``tracer.event`` on the default tracer."""
    tracer.event(name, **attrs)


def current_context() -> Optional[TraceContext]:
    """Module-level convenience: the default tracer's current context."""
    return tracer.current_context()


def context_of(sp) -> Optional[TraceContext]:
    """The :class:`TraceContext` of a span yielded by :func:`span`
    (None for the disarmed no-op span) — capture it INSIDE the ``with``
    block; the ids stay valid after the span closes."""
    span_id = getattr(sp, "span_id", None)
    if span_id is None:
        return None
    return TraceContext(sp.trace_id, span_id)


def fresh_context() -> TraceContext:
    """Mint a trace-only context (no parent span): what a process
    launcher (parallel/distributed.py) exports through
    :data:`TRACE_PARENT_ENV` when it has no open span of its own, so
    every launched child still joins ONE shared trace."""
    return TraceContext(_new_id(), None)


def maybe_dump_root_metrics() -> None:
    """Snapshot the process registry into the trace dir when the tracer
    is armed and no span remains open (an outermost span just closed) —
    the shared tail of every instrumented entry point (stage wrappers,
    the benchmark runner), so the trace dir is inspectable without the
    process."""
    if tracer.enabled and tracer.current() is None:
        from flink_ml_tpu_torch.observability.exporters import dump_metrics

        dump_metrics(tracer.trace_dir)
