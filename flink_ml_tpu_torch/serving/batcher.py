"""Async micro-batching dispatcher: many callers, one device dispatch
per tick — pipelined.

The port of ``flink_ml_tpu/serving/batcher.py``. The synchronous servable
path (servable/api.py) is one caller, one ``transform``, one dispatch —
fine for a notebook, hopeless for traffic. This module puts a queue in
front of any :class:`~flink_ml_tpu_torch.servable.api.TransformerServable`:

- **submit** enqueues a request (a DataFrame) with a deadline and
  returns a future; admission control rejects immediately
  (:class:`~flink_ml_tpu_torch.servable.api.RejectedRequest`) when the
  queue (including rows already drained into the pipeline) is full or the
  request cannot fit any batch bucket — shed load, never unbounded
  latency;
- the **pad/enqueue stage** drains whole requests once the oldest has
  waited ``window_ms`` or the largest bucket fills, drops requests whose
  deadline expired in queue, **pads** the concatenated rows up to the
  smallest bucket that fits (``buckets``, a small fixed table of batch
  shapes; pad rows come from a per-(schema, bucket) template cache —
  the ``paddingReuse`` counter) — so steady-state serving presents the
  device with a closed set of batch shapes that warmup
  (serving/warmup.py) has run before the first request. It is host work
  only: no CUDA call and no synchronisation;
- the **device stage** takes prepared batches over a
  depth-``pipeline_depth`` handoff (default 1 — host padding of tick N+1
  overlaps device compute of tick N), resolves the servable ONCE per
  tick, re-checks deadlines, names the servable's card as its thread's
  current CUDA device (PyTorch's current device is per thread) and issues
  ONE ``transform`` on the batch: the batch's host-to-device copy, the
  product and the fetch of the dots all run on this thread;
- results split back per request, futures resolve from the fetch side,
  and in-flight requests pin the servable they were dispatched with — a
  model hot-swap (serving/registry.py) between device ticks never yanks
  a batch mid-flight.

Telemetry: ``queueDepth`` / ``batchFill`` / ``paddingWaste`` gauges,
per-request ``queueMs`` / ``batchMs`` windowed histograms and fill/waste
distributions in ``ml.serving``, ``serving.pad`` + ``serving.batch`` spans
per tick (sharing a ``tick`` attr — overlapping spans ARE the pipelining
proof), and a ``/serving`` route (observability/server.py) exposing queue
depth, the bucket table, pipeline depth and the active model version.
Causal tracing: every sampled request anchors a ``serving.submit`` span
on the caller's thread whose
:class:`~flink_ml_tpu_torch.observability.tracing.TraceContext` rides the
request through the admission queue AND the pad→device handoff — the
tick's pad/batch spans record explicit ``follows_from`` links back to the
requests they serve (and the batch to the pad that prepared it), and a
``serving.resolve`` span in the request's own trace closes the
submit→pad→batch→resolve chain. While it runs, the batcher writes a
``serving`` fleet beacon (observability/fleet.py). Mesh-sharded dispatch:
given a mesh of N > 1 shards, the servable splits each bucket that N
divides by rows over the shards (servable/lr.py) and records the real rows
each shard held.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional, Tuple

import torch

from flink_ml_tpu_torch.common.locks import (
    install_thread_excepthook,
    make_condition,
)
from flink_ml_tpu_torch.common.metrics import ML_GROUP, RATIO_BUCKETS, metrics
from flink_ml_tpu_torch.device import name_thread_device
from flink_ml_tpu_torch.observability import profiling, tracing
from flink_ml_tpu_torch.observability.health import (
    COUNT_BUCKETS,
    SERVING_HORIZON_S,
    SERVING_SLICES,
    observe_serving_rejected,
    trace_sampled,
)
from flink_ml_tpu_torch.servable.api import (
    DataFrame,
    RejectedRequest,
    TransformerServable,
    serving_name,
)

__all__ = ["DEFAULT_BUCKET_ROWS", "BUCKETS_ENV", "WINDOW_ENV",
           "DEADLINE_ENV", "QUEUE_ENV", "BatcherConfig", "MicroBatcher"]

#: default batch-shape table (rows) — covers singleton pings through
#: bulk scoring with <= 2x padding waste per bucket step
DEFAULT_BUCKET_ROWS = (1, 8, 32, 128)

#: deployment env vars (docs/serving.md): comma-separated bucket row
#: counts ("none" disables bucketing), batch window ms, default request
#: deadline ms ("none" disables), admission queue bound in rows
BUCKETS_ENV = "FLINK_ML_TPU_SERVE_BUCKETS"
WINDOW_ENV = "FLINK_ML_TPU_SERVE_WINDOW_MS"
DEADLINE_ENV = "FLINK_ML_TPU_SERVE_DEADLINE_MS"
QUEUE_ENV = "FLINK_ML_TPU_SERVE_MAX_QUEUE_ROWS"
PIPELINE_ENV = "FLINK_ML_TPU_SERVE_PIPELINE_DEPTH"


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    """Micro-batcher tuning knobs (env-independent: the serving scripts
    map FLINK_ML_TPU_SERVE_* env vars onto this, docs/serving.md).

    ``buckets=None`` disables bucketing/padding — every tick dispatches
    the exact drained row count: a batch shape the warmup never ran per
    distinct size, the configuration the negative tests exercise, not a
    production mode.
    """

    #: sorted row-count bucket table; None disables bucketing
    buckets: Optional[Tuple[int, ...]] = DEFAULT_BUCKET_ROWS
    #: max time (ms) the oldest queued request waits for batch fill
    window_ms: float = 5.0
    #: admission bound: queued rows beyond this are rejected queue-full
    max_queue_rows: int = 4096
    #: default per-request deadline (ms) from enqueue to dispatch;
    #: None = requests never expire in queue
    deadline_ms: Optional[float] = 1000.0
    #: cap on rows drained per tick without bucketing (with bucketing
    #: the largest bucket is the cap)
    max_batch_rows: int = 1024
    #: dispatcher pipelining: depth of the pad→device handoff queue.
    #: 0 runs the single-thread dispatcher (pad and dispatch serialized
    #: on one loop — the pre-pipeline behavior); the default 1 lets the
    #: pad stage prepare tick N+1 while the device stage computes
    #: tick N, overlapping host padding with device compute
    pipeline_depth: int = 1

    def __post_init__(self):
        if self.buckets is not None:
            b = tuple(int(x) for x in self.buckets)
            if not b or any(x <= 0 for x in b) or list(b) != sorted(set(b)):
                raise ValueError(
                    f"buckets must be sorted unique positive row "
                    f"counts, got {self.buckets!r}")
            object.__setattr__(self, "buckets", b)
        if self.window_ms < 0:
            raise ValueError("window_ms must be >= 0")
        if self.max_queue_rows <= 0 or self.max_batch_rows <= 0:
            raise ValueError("queue/batch row bounds must be > 0")
        if self.pipeline_depth < 0:
            raise ValueError("pipeline_depth must be >= 0")

    @classmethod
    def from_env(cls, **overrides) -> "BatcherConfig":
        """Config from the FLINK_ML_TPU_SERVE_* env vars (unset fields
        keep their defaults; keyword ``overrides`` win over env). A
        malformed value raises ValueError naming the variable — a
        mistyped deployment knob must fail loudly at startup, not serve
        with silent defaults."""
        import os

        def read(env, parse, key):
            raw = os.environ.get(env)
            if raw is None or key in overrides:
                return
            try:
                overrides[key] = parse(raw)
            except ValueError as e:
                raise ValueError(f"{env}={raw!r}: {e}") from e

        def parse_buckets(raw):
            if raw.strip().lower() in ("", "none", "off"):
                return None
            return tuple(int(b) for b in raw.split(","))

        def parse_optional_ms(raw):
            if raw.strip().lower() in ("", "none"):
                return None
            return float(raw)

        read(BUCKETS_ENV, parse_buckets, "buckets")
        read(WINDOW_ENV, float, "window_ms")
        read(DEADLINE_ENV, parse_optional_ms, "deadline_ms")
        read(QUEUE_ENV, int, "max_queue_rows")
        read(PIPELINE_ENV, int, "pipeline_depth")
        return cls(**overrides)

    @property
    def max_bucket(self) -> int:
        return (self.buckets[-1] if self.buckets
                else self.max_batch_rows)

    def bucket_for(self, rows: int) -> int:
        """Smallest bucket holding ``rows`` (== ``rows`` unbucketed)."""
        if self.buckets is None:
            return rows
        for b in self.buckets:
            if rows <= b:
                return b
        return rows  # caller enforces rows <= max_bucket at admission


def _row_signature(row) -> tuple:
    """Per-value shape fingerprint of one row — the pad-template cache
    key component the declared schema cannot provide (a ``vector``
    DataType is dimension-less): type name plus element count where one
    is discoverable."""
    sig = []
    for v in row.values:
        size = None
        try:
            if hasattr(v, "size"):
                size = int(v.size() if callable(v.size) else v.size)
            elif hasattr(v, "__len__"):
                size = len(v)
        except Exception:  # noqa: BLE001 — a fingerprint, not a parser
            size = None
        sig.append((type(v).__name__, size))
    return tuple(sig)


class _Request:
    __slots__ = ("df", "rows", "n", "schema", "future", "t_enqueue",
                 "deadline_s", "seq", "ctx")

    def __init__(self, df: DataFrame, deadline_ms: Optional[float]):
        self.df = df
        self.rows = df.collect()
        self.n = len(self.rows)
        # cached once at submit: the per-tick schema comparison is a
        # tuple identity check instead of a fresh column_names list
        # copy per request per tick
        self.schema = tuple(df.column_names)
        self.future: Future = Future()
        self.t_enqueue = time.perf_counter()
        self.deadline_s = (None if deadline_ms is None
                           else self.t_enqueue + deadline_ms / 1000.0)
        #: per-batcher request ordinal — the ``req=`` attr joining this
        #: request's serving.submit span to its serving.resolve span
        #: (observability/path.py)
        self.seq: Optional[int] = None
        #: the request's TraceContext (its serving.submit span, itself
        #: a child of whatever span the CALLER had open) — rides the
        #: Future to the device stage so the tick's serving.pad/
        #: serving.batch spans can link back follows_from, and the
        #: resolve span re-enters the caller's trace
        self.ctx = None


class _Prepared:
    """One padded batch, handed from the pad stage to the device stage.
    Everything the device dispatch needs travels here so the device
    thread never touches the admission queue."""

    __slots__ = ("requests", "batch_df", "bucket", "n_real", "pad",
                 "fill", "waste", "tick", "reused", "total_rows",
                 "pad_ctx")

    def __init__(self, requests, batch_df, bucket, n_real, pad, fill,
                 waste, tick, reused):
        self.requests = requests
        self.batch_df = batch_df
        self.bucket = bucket
        self.n_real = n_real
        self.pad = pad
        self.fill = fill
        self.waste = waste
        self.tick = tick
        self.reused = reused
        self.total_rows = 0  # drained-row accounting, set by the pad stage
        #: the serving.pad span's TraceContext, riding the pad→device
        #: queue handoff so the device stage's serving.batch span can
        #: record the follows_from edge (observability/tracing.py)
        self.pad_ctx = None


class _StageCall:
    """A function to run on the thread that dispatches device work (the
    warmup's seam, serving/warmup.py), with the future its caller waits
    on."""

    __slots__ = ("fn", "future")

    def __init__(self, fn: Callable[[], object]):
        self.fn = fn
        self.future: Future = Future()

    def run(self) -> None:
        try:
            self.future.set_result(self.fn())
        except Exception as e:  # noqa: BLE001 — the caller re-raises
            self.future.set_exception(e)


class MicroBatcher:
    """The dispatcher: a pad/enqueue stage draining an
    admission-controlled queue into padded, bucketed batches, and a
    device stage issuing one dispatch per batch — connected by a
    depth-``pipeline_depth`` handoff so host padding of tick N+1
    overlaps device compute of tick N (``pipeline_depth=0`` collapses
    both stages onto one thread, the pre-pipeline behavior).

    ``target`` is the servable itself, a zero-arg provider callable, or
    anything with an ``active`` attribute (a
    :class:`~flink_ml_tpu_torch.serving.registry.ModelRegistry`) — resolved
    ONCE per device tick, so a hot-swap lands between batches, never
    inside one.

    ``mesh`` (optional) is asserted on the resolved servable each device
    tick (``set_mesh``, idempotent): buckets its shard count divides are
    served row-sharded over it."""

    def __init__(self, target, config: Optional[BatcherConfig] = None,
                 mesh=None):
        self.config = config or BatcherConfig()
        self._mesh = mesh
        self._target = target  # for /serving status (version/canary)
        if isinstance(target, TransformerServable):
            self._provider = lambda: target
        elif hasattr(target, "resolve"):
            # the registry's per-tick routing seam: active, or the
            # canary for its traffic fraction (docs/ops.md) — resolving
            # once per tick keeps in-flight batches on one version
            self._provider = target.resolve
        elif hasattr(target, "active"):
            self._provider = lambda: target.active
        elif callable(target):
            self._provider = target
        else:
            raise TypeError(
                f"target must be a servable, a provider callable, or "
                f"have .active; got {type(target).__name__}")
        # append-right / pop-left only: deque keeps the dispatcher's
        # drain O(1) per request while it holds the condition lock
        self._queue = collections.deque()
        self._queued_rows = 0
        # rows drained by the pad stage but not yet resolved by the
        # device stage: admission counts them, or the pipeline would
        # quietly extend max_queue_rows by a tick per handoff slot
        self._inflight_rows = 0
        self._cond = make_condition("serving.batcher")
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        self._device_thread: Optional[threading.Thread] = None
        self._handoff: Optional[queue.Queue] = None
        self._ticks = 0
        self._tick_seq = 0
        # next() on itertools.count is atomic under the GIL — submit
        # runs on arbitrary caller threads before taking the cond lock
        self._req_counter = itertools.count()
        self._served_requests = 0
        self._prev_status = None
        # functions waiting to run on the dispatching thread when there is
        # no device thread (pipeline_depth=0): the pad stage runs them
        self._calls: List[_StageCall] = []
        # the CUDA device this batcher's dispatching thread has named
        self._bound_device: Optional[torch.device] = None
        # pad-template cache, keyed by (schema, type key, bucket): the
        # duplicated-row values each tick's padding appends, extracted
        # once instead of re-copied from the tail request every tick
        self._pad_templates: dict = {}
        self._group = metrics.group(ML_GROUP, "serving")

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "MicroBatcher":
        if self._thread is not None:
            return self
        # a crashing tick/device daemon must surface in telemetry
        install_thread_excepthook()
        # under the cond: a submitter thread racing a restart must see
        # either the old True (and get rejected) or the new False —
        # never a torn interleaving with its own queue append
        with self._cond:
            self._stopping = False
        if self.config.pipeline_depth > 0:
            self._handoff = queue.Queue(
                maxsize=self.config.pipeline_depth)
            self._device_thread = threading.Thread(
                target=self._run_device,
                name="flink-ml-tpu-batcher-dev", daemon=True)
            self._device_thread.start()
        self._thread = threading.Thread(target=self._run,
                                        name="flink-ml-tpu-batcher",
                                        daemon=True)
        self._thread.start()
        # the live /serving route reflects THIS runtime while it runs;
        # the previous provider (a batcher we run alongside, e.g. a
        # benchmark sweep next to the main runtime) is restored on stop
        from flink_ml_tpu_torch.observability import server

        self._prev_status = server.get_serving_status()
        server.set_serving_status(self.status)
        # join the fleet telemetry plane while serving: periodic
        # beacons carry this replica's windowed queueMs/batchMs slices
        # and load row (observability/fleet.py; no-op when no fleet
        # dir resolves)
        try:
            from flink_ml_tpu_torch.observability import fleet

            self._fleet_token = fleet.start_beacon(role="serving")
        except Exception:
            self._fleet_token = None
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the dispatcher; with ``drain`` (default) queued requests
        are dispatched first, otherwise they are rejected ``shutdown``."""
        thread = self._thread
        if thread is None:
            return
        with self._cond:
            self._stopping = True
            if not drain:
                for req in self._queue:
                    self._reject(req, "shutdown")
                self._queue.clear()
                self._queued_rows = 0
            self._cond.notify_all()
        thread.join(timeout=30.0)
        self._thread = None
        # the pad stage put its sentinel on exit; wait for the device
        # stage to finish whatever was already in the handoff (a
        # prepared batch is in flight — it completes, never rejects)
        if self._device_thread is not None:
            self._device_thread.join(timeout=30.0)
            self._device_thread = None
            self._handoff = None
        from flink_ml_tpu_torch.observability import server

        # only clear OUR registration (a later-started batcher may have
        # taken the /serving route over), handing back to whoever held
        # it when we started
        server.clear_serving_status(self.status, self._prev_status)
        self._prev_status = None
        try:
            from flink_ml_tpu_torch.observability import fleet

            fleet.stop_beacon(getattr(self, "_fleet_token", None))
            self._fleet_token = None
        except Exception:
            pass

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def run_on_stage(self, fn: Callable[[], object],
                     timeout: float = 60.0):
        """Run ``fn()`` on the thread that dispatches this batcher's device
        work (the device stage, or the pad stage at ``pipeline_depth=0``)
        between ticks, and return its result — how warmup pays a thread's
        first-use costs (PyTorch keeps its cuBLAS handles per thread)
        where the real ticks will run. The batcher must be running."""
        call = _StageCall(fn)
        with self._cond:
            if self._stopping or self._thread is None:
                raise RuntimeError("run_on_stage needs a running batcher")
            if self._handoff is None:
                self._calls.append(call)
                self._cond.notify_all()
        if self._handoff is not None:
            self._handoff.put(call)
        return call.future.result(timeout=timeout)

    def _bind_device(self, servable) -> None:
        """Name the servable's CUDA device as the dispatching thread's
        current device before its tick (a no-op for a host servable and
        once the thread has named it): the current device is per thread,
        and this thread must not inherit whatever another thread set."""
        self._bound_device = name_thread_device(
            getattr(servable, "device", None), self._bound_device)

    # -- admission -----------------------------------------------------------
    def submit(self, df: DataFrame, deadline_ms=...) -> Future:
        """Enqueue one request; returns a future resolving to the
        transformed DataFrame. Rejections (queue full, too large for
        every bucket, shutdown, deadline expired in queue) surface as
        :class:`~flink_ml_tpu_torch.servable.api.RejectedRequest` raised by
        ``future.result()`` — and are counted windowed per reason."""
        if deadline_ms is ...:
            deadline_ms = self.config.deadline_ms
        req = _Request(df, deadline_ms)
        req.seq = next(self._req_counter)
        # the continuous-evaluation join key (observability/
        # evaluation.py): callers read it off the future and hand it
        # back with the delayed ground-truth label
        # (evaluation.record_feedback) — the same ordinal the causal
        # trace carries as ``req=``
        req.future.request_id = req.seq
        if tracing.tracer.enabled and trace_sampled():
            # the request's causal anchor: a near-instant span on the
            # CALLER's thread — child of whatever span the caller has
            # open — whose context rides the request to the dispatcher
            # so the tick's pad/batch spans link back follows_from and
            # the resolve span closes the submit→pad→batch→resolve
            # chain in ONE trace (docs/observability.md "Causal
            # tracing"). Opened BEFORE admission: the context must be
            # attached before the pad stage can see the request, and a
            # rejected request keeps its anchor too. Gated on
            # ``enabled`` (an armed trace dir — the debugging/incident
            # investigation mode), NOT on the always-on ring: the
            # per-request chain serializes spans onto the device
            # thread, and the ring-only production shape must stay
            # within the serve_bench traceOverheadPct budget. Sampled
            # with the serving.request spans
            # (FLINK_ML_TPU_TRACE_SAMPLE).
            with tracing.tracer.span("serving.submit", req=req.seq,
                                     rows=req.n) as sp:
                req.ctx = tracing.context_of(sp)
        cfg = self.config
        with self._cond:
            if self._stopping or self._thread is None:
                self._reject(req, "shutdown")
                return req.future
            if req.n == 0:
                # nothing to batch — and the pad logic needs at least
                # one real row to duplicate
                self._reject(req, "empty")
                return req.future
            if cfg.buckets is not None and req.n > cfg.max_bucket:
                self._reject(req, "too-large")
                return req.future
            if (self._queued_rows + self._inflight_rows + req.n
                    > cfg.max_queue_rows):
                self._reject(req, "queue-full")
                return req.future
            self._queue.append(req)
            self._queued_rows += req.n
            self._group.gauge("queueDepth", self._queued_rows)
            self._cond.notify_all()
        return req.future

    def _reject(self, req: _Request, reason: str) -> None:
        name = self._label()
        observe_serving_rejected(name, reason)
        tracing.tracer.event("serving.rejected", servable=name,
                             reason=reason, rows=req.n)
        req.future.set_exception(RejectedRequest(name, reason))

    def _label(self) -> str:
        try:
            servable = self._provider()
        except Exception:  # noqa: BLE001 — labeling must never raise
            servable = None
        return (serving_name(servable) if servable is not None
                else "unbound")

    # -- pad/enqueue stage ---------------------------------------------------
    def _run(self) -> None:
        cfg = self.config
        window_s = cfg.window_ms / 1000.0
        try:
            while True:
                batch: List[_Request] = []
                with self._cond:
                    while (not self._queue and not self._stopping
                           and not self._calls):
                        self._cond.wait()
                    calls, self._calls = self._calls, []
                    if not calls and not self._queue and self._stopping:
                        return
                for call in calls:
                    call.run()
                if calls:
                    continue
                with self._cond:
                    # fill-or-window: dispatch early only when the
                    # LARGEST bucket's worth of rows is queued (any
                    # smaller fill threshold would defeat batching —
                    # one row "fills" bucket 1), else when the oldest
                    # request's window lapses; window_ms is therefore
                    # the latency bound a partially-filled batch pays
                    while (self._queue
                           and self._queued_rows < cfg.max_bucket
                           and not self._stopping):
                        remaining = (self._queue[0].t_enqueue + window_s
                                     - time.perf_counter())
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=remaining)
                    if not self._queue:
                        continue
                    total = 0
                    while (self._queue
                           and total + self._queue[0].n
                           <= cfg.max_bucket):
                        req = self._queue.popleft()
                        total += req.n
                        batch.append(req)
                    if not batch:
                        # head request alone exceeds the cap (unbucketed
                        # mode — bucketed admission already rejected it)
                        req = self._queue.popleft()
                        total = req.n
                        self._reject(req, "too-large")
                    else:
                        self._inflight_rows += total
                    self._queued_rows -= total
                    self._group.gauge("queueDepth", self._queued_rows)
                if not batch:
                    continue
                tick = self._tick_seq
                self._tick_seq += 1
                try:
                    prepared = self._prepare(batch, tick)
                except Exception as e:  # noqa: BLE001 — a pad-stage bug
                    # must fail ITS batch, never kill the loop
                    for req in batch:
                        if not req.future.done():
                            req.future.set_exception(e)
                    self._release_inflight(total)
                    continue
                if prepared is None:
                    self._release_inflight(total)
                    continue
                prepared.total_rows = total
                if self._handoff is not None:
                    # depth-bounded, blocking: while the device stage
                    # computes tick N, at most ``pipeline_depth``
                    # prepared ticks wait here — backpressure, not an
                    # unbounded prepared-batch backlog
                    self._handoff.put(prepared)
                else:
                    self._dispatch_guarded(prepared)
        finally:
            if self._handoff is not None:
                self._handoff.put(None)  # sentinel: pad stage is done

    def _prepare(self, batch: List[_Request],
                 tick: int) -> Optional[_Prepared]:
        """Pad stage: deadline/schema vetting + bucket padding — all
        host work, no device touch, so it overlaps the device stage's
        compute of the previous tick. Rejections resolve immediately
        from here; accepted requests travel in the returned
        :class:`_Prepared`."""
        cfg = self.config
        now = time.perf_counter()
        live: List[_Request] = []
        for req in batch:
            if req.deadline_s is not None and now > req.deadline_s:
                self._reject(req, "deadline")
            else:
                live.append(req)
        if not live:
            return None
        schema = live[0].schema
        rows: List = []
        kept: List[_Request] = []
        for req in live:
            if req.schema != schema:
                self._reject(req, "schema")
                continue
            kept.append(req)
            rows.extend(req.rows)
        if not kept:
            return None
        n_real = len(rows)
        bucket = cfg.bucket_for(n_real)
        # pad by duplicating a row: same shapes, discarded output. An
        # exact bucket fit (and every unbucketed tick, where the
        # "bucket" IS the drained row count) pads nothing — pinned by
        # the tick-drain boundary tests.
        pad = bucket - n_real
        reused = 0
        # the tick follows from the requests it drained: explicit
        # follows_from links to each request's submit context — with no
        # local parent the pad span adopts the first link's trace id,
        # so a single-request tick shares the request's trace outright
        link_ctxs = [req.ctx for req in kept if req.ctx is not None]
        pad_ctx = None
        with tracing.tracer.span("serving.pad", tick=tick,
                                 bucket=bucket, rows=n_real,
                                 requests=len(kept), pad=pad,
                                 links=link_ctxs or None) as pad_sp:
            pad_ctx = tracing.context_of(pad_sp)
            if pad:
                types = kept[0].df.data_types
                # the value-shape signature rides the key: the declared
                # DataType carries no dimension ("vector" is dim-less),
                # so a hot-swap changing the feature dim must MISS —
                # a stale different-dim template would fail every
                # padded tick after the swap
                key = (schema,
                       tuple((t.basic, t.shape) for t in types),
                       _row_signature(rows[-1]), bucket)
                template = self._pad_templates.get(key)
                if template is None:
                    if len(self._pad_templates) >= 32:
                        self._pad_templates.clear()
                    template = (type(rows[-1]), list(rows[-1].values))
                    self._pad_templates[key] = template
                else:
                    reused = pad
                row_cls, values = template
                for _ in range(pad):
                    rows.append(row_cls(list(values)))
            else:
                types = kept[0].df.data_types
            batch_df = DataFrame(list(schema), list(types), rows)
        # drift seam (observability/drift.py): pad rows are DUPLICATES
        # appended at the tail — sketching them would overweight one
        # row and inflate the sample floor with dependent copies; the
        # _served wrapper slices features/predictions to this count
        batch_df.drift_real_rows = n_real
        # quality seam (observability/evaluation.py): the per-request
        # row layout of this batch, so the _served wrapper can park
        # each request's scores in the feedback-join ring under its
        # ``req`` ordinal — pad rows sit past the segments' sum
        batch_df.request_segments = tuple((req.seq, req.n)
                                          for req in kept)
        fill = n_real / bucket if bucket else 1.0
        waste = pad / bucket if bucket else 0.0
        prepared = _Prepared(kept, batch_df, bucket, n_real, pad, fill,
                             waste, tick, reused)
        prepared.pad_ctx = pad_ctx
        return prepared

    def _release_inflight(self, rows: int) -> None:
        # called the moment the device stage takes a batch over: rows
        # actively dispatching stop counting against max_queue_rows
        # (matching the single-thread dispatcher, where drained rows
        # left the admission window at drain) — only rows queued,
        # padding, or waiting in the handoff occupy it
        with self._cond:
            self._inflight_rows = max(0, self._inflight_rows - rows)

    def _dispatch_guarded(self, prepared: _Prepared) -> None:
        """One device tick, from either stage layout: release the
        admission window (the batch is actively dispatching now) and
        run the dispatch — a dispatch bug fails ITS batch's futures,
        never the loop that called it."""
        self._release_inflight(prepared.total_rows)
        try:
            self._dispatch_device(prepared)
        except Exception as e:  # noqa: BLE001 — see docstring
            for req in prepared.requests:
                if not req.future.done():
                    req.future.set_exception(e)

    # -- device stage --------------------------------------------------------
    def _run_device(self) -> None:
        while True:
            prepared = self._handoff.get()
            if prepared is None:
                return
            if isinstance(prepared, _StageCall):
                prepared.run()
                continue
            self._dispatch_guarded(prepared)

    def _dispatch_device(self, prep: _Prepared) -> None:
        # FLINK_ML_TPU_PROFILE_CAPTURE=1 arms a device profile spanning
        # the next N dispatch ticks (observability/profiling.py); the
        # unarmed steady state pays one env read
        profiling.batch_tick()
        kept = prep.requests
        now = time.perf_counter()
        # deadlines re-checked HERE, not just at pad time: a request
        # whose deadline lapsed while its tick waited in the pipeline
        # handoff was never dispatched in time — the accounting stays
        # honest even though its rows ride the padded batch (the
        # shapes are fixed; only its result assignment is skipped)
        live: List[_Request] = []
        for req in kept:
            if req.deadline_s is not None and now > req.deadline_s:
                self._reject(req, "deadline")
            else:
                live.append(req)
        if not live:
            return
        servable = self._provider()
        if servable is None:
            for req in live:
                self._reject(req, "no-model")
            return
        if self._mesh is not None and hasattr(servable, "set_mesh"):
            # idempotent per tick: a hot-swapped candidate gets the
            # mesh before its first batch
            servable.set_mesh(self._mesh)
        self._bind_device(servable)
        name = serving_name(servable)
        labels = {"servable": name}
        for req in live:
            # queue time runs to DEVICE dispatch, not to pad time —
            # a tick waiting in the pipeline handoff is still queueing
            self._group.windowed_histogram(
                "queueMs", horizon_s=SERVING_HORIZON_S,
                slices=SERVING_SLICES, labels=labels).observe(
                    (now - req.t_enqueue) * 1000.0)
        t0 = time.perf_counter()
        # the causal edges of this tick: the pad span whose prepared
        # batch crossed the pipeline handoff, plus every request this
        # batch serves — the links satellite-fixing "pad/batch carry
        # only tick=": a request's latency now decomposes from the DAG
        batch_links = [prep.pad_ctx] if prep.pad_ctx is not None else []
        batch_links += [req.ctx for req in live if req.ctx is not None]
        batch_ctx = None
        with tracing.tracer.span("serving.batch", servable=name,
                                 bucket=prep.bucket, rows=prep.n_real,
                                 requests=len(kept), tick=prep.tick,
                                 pipeline_depth=self.config
                                 .pipeline_depth,
                                 links=batch_links or None) as batch_sp:
            batch_ctx = tracing.context_of(batch_sp)
            try:
                out = servable.transform(prep.batch_df)
            except Exception as e:  # noqa: BLE001 — the batch fails,
                # per-request; the _served seam already counted it once
                for req in live:
                    if not req.future.done():
                        req.future.set_exception(e)
                return
        batch_ms = (time.perf_counter() - t0) * 1000.0
        self._record_tick(labels, prep.bucket, prep.n_real, prep.pad,
                          prep.fill, prep.waste, batch_ms, len(live),
                          prep.reused)
        # futures resolve from the fetch side: the results are on host
        # before any caller's latency clock stops. Offsets walk ALL of
        # the tick's requests — a deadline-rejected one still occupies
        # its row slice of the padded batch
        out_rows = out.collect()
        names, types = out.column_names, out.data_types
        offset = 0
        for req in kept:
            if not req.future.done():
                result = DataFrame(
                    names, types, out_rows[offset:offset + req.n])
                if req.ctx is not None:
                    # close the request's causal chain: a resolve span
                    # in the REQUEST's trace (child of its submit span)
                    # following from the batch that computed it — the
                    # last segment `flink-ml-tpu-trace path` attributes
                    with tracing.tracer.span(
                            "serving.resolve", parent=req.ctx,
                            links=([batch_ctx] if batch_ctx is not None
                                   else None),
                            req=req.seq, tick=prep.tick, rows=req.n):
                        req.future.set_result(result)
                else:
                    req.future.set_result(result)
            offset += req.n

    def _record_tick(self, labels, bucket, n_real, pad, fill, waste,
                     batch_ms, n_requests, reused: int = 0) -> None:
        grp = self._group
        self._ticks += 1
        self._served_requests += n_requests
        grp.counter("batches", labels={**labels, "bucket": str(bucket)})
        if pad:
            grp.counter("padRows", pad, labels=labels)
        if reused:
            # pad rows built from the cached per-(schema, bucket)
            # template instead of re-extracting the tail request's row
            grp.counter("paddingReuse", reused, labels=labels)
        grp.gauge("batchFill", round(fill, 4), labels=labels)
        grp.gauge("paddingWaste", round(waste, 4), labels=labels)
        grp.histogram("batchFillFrac", buckets=RATIO_BUCKETS,
                      labels=labels).observe(fill)
        grp.histogram("paddingWasteFrac", buckets=RATIO_BUCKETS,
                      labels=labels).observe(waste)
        grp.histogram("batchRows", buckets=COUNT_BUCKETS,
                      labels=labels).observe(float(n_real))
        grp.windowed_histogram("batchMs", horizon_s=SERVING_HORIZON_S,
                               slices=SERVING_SLICES,
                               labels=labels).observe(batch_ms)

    # -- live status (the /serving route) ------------------------------------
    def status(self) -> dict:
        """Live runtime status for the ``/serving`` endpoint route."""
        with self._cond:
            depth_rows = self._queued_rows
            depth_requests = len(self._queue)
            inflight = self._inflight_rows
        cfg = self.config
        return {
            "servable": self._label(),
            "queue": {"rows": depth_rows, "requests": depth_requests,
                      "pipeline_rows": inflight,
                      "max_rows": cfg.max_queue_rows},
            "buckets": (list(cfg.buckets) if cfg.buckets is not None
                        else None),
            "window_ms": cfg.window_ms,
            "deadline_ms": cfg.deadline_ms,
            "ticks": self._ticks,
            "served_requests": self._served_requests,
            "running": self._thread is not None,
            "pipeline_depth": cfg.pipeline_depth,
            "mesh_devices": self.mesh_device_count(),
            "sharded_dispatch": self.sharded_dispatch(),
            "model_version": getattr(self._target, "version", None),
            "canary": self._canary_status(),
        }

    def _canary_status(self):
        """Canary version/fraction from a registry target (None when
        the target has no canary seam or no canary is live) — the
        rollout's live surface on the ``/serving`` route."""
        version = getattr(self._target, "canary_version", None)
        if version is None:
            return None
        return {"version": version,
                "fraction": getattr(self._target, "canary_fraction",
                                    None)}

    def mesh_device_count(self) -> int:
        """Data shards of the dispatch mesh (1 without one; a JAX mesh's
        devices) — provenance for the ``/serving`` route."""
        return self._mesh.size if self._mesh is not None else 1

    def sharded_dispatch(self) -> bool:
        """True when ticks can shard: the data-shard count decides, as
        the servable's routing does."""
        return self.mesh_device_count() > 1
