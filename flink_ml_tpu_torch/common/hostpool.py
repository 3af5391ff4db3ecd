"""Fork-based row-shard parallelism for host-bound (string/sparse) ops.

The port of ``flink_ml_tpu/common/hostpool.py`` (ref: flink-ml-lib
feature/stringindexer/StringIndexer.java:117-142 — per-task counts,
DataStreamUtils.reduce merge): split the row range into shards, fork a
worker per shard, merge the per-shard results in the parent.

Why raw ``os.fork`` and not multiprocessing:

- **Zero-copy scatter.** Workers read the input arrays through
  copy-on-write fork pages — a 10M×100 token matrix is never pickled or
  copied out. Only the (much smaller) per-shard results travel back,
  over a pipe.
- **No interpreter teardown in the child.** Children exit with
  ``os._exit``, skipping atexit handlers, so nothing of the parent's
  CUDA context or thread pools is torn down from a child.
- **No pool daemon threads** in the parent.

**The fork rule.** The pool forks whenever it is called, also after CUDA
is up in the parent and after torch's intra-op (OpenMP) threads have run.
A forked child may not touch CUDA (the context does not survive a fork),
and may not run a torch CPU op either (GNU libgomp's thread pool is not
fork-safe: the child can wedge on it). So a worker function is
numpy-only: it reads host arrays and returns host arrays, and never
reaches torch or CUDA. Every caller in the port keeps device work in the
parent, before or after the map.

Failure semantics: any worker that dies (non-zero exit, unpicklable
result, crash) fails the whole map with the worker's traceback; callers
run serially only via ``min_rows`` gating, never on silent partial
results. A worker that *wedges* (never writes, never exits) is SIGKILLed
once its per-child deadline expires and the map fails with a retryable
:class:`~flink_ml_tpu_torch.resilience.policy.WorkerTimeout` naming the
worker. Chaos sites: ``hostpool-child`` (a worker raises
``InjectedFault``) and ``hostpool-hang`` (a worker wedges), both decided
in the parent before the fork.
"""

import io
import os
import pickle
import signal
import struct
import time
import traceback

import numpy as np

from flink_ml_tpu_torch.resilience import faults
from flink_ml_tpu_torch.resilience.policy import InjectedFault, WorkerTimeout

__all__ = ["host_parallelism", "map_row_shards", "shard_bounds",
           "child_deadline_s"]

#: result-stream framing: u8 status (0 ok / 1 error), u64 payload length
_HDR = struct.Struct("<BQ")


def child_deadline_s() -> float:
    """Per-child wall deadline for forked workers. Default 600s — far
    above any sane shard (shards are ≤ SHARD_CAP_ROWS) yet finite, so a
    wedged child is killed instead of hanging the driver forever.
    Override with FLINK_ML_TPU_HOST_TIMEOUT_S (<= 0 disables)."""
    env = os.environ.get("FLINK_ML_TPU_HOST_TIMEOUT_S")
    if env is not None:
        try:
            return float(env)
        except ValueError:
            pass
    return 600.0


def host_parallelism() -> int:
    """Worker count for host-bound fan-out.  Defaults to the reference's
    benchmark parallelism (8) capped by the machine; override with
    FLINK_ML_TPU_HOST_PARALLELISM (0 or 1 disables forking)."""
    env = os.environ.get("FLINK_ML_TPU_HOST_PARALLELISM")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            pass
    return max(1, min(8, os.cpu_count() or 1))


def shard_bounds(n_rows: int, workers: int):
    """Even [lo, hi) row ranges, first shards taking the remainder."""
    base, rem = divmod(n_rows, workers)
    bounds, lo = [], 0
    for i in range(workers):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _child_main(fn, lo, hi, wfd, chaos_action=None, parent_ctx=None):
    status, payload = 0, None
    # fork re-seed: the child's spans go to its
    # own spans-<pid>.jsonl parented to the dispatching span — the
    # TraceContext the parent captured PRE-fork (race-free against
    # other driver threads mutating their own span stacks) — and
    # its registry restarts empty so the end-of-shard snapshot shipped
    # back holds only child-produced metrics. reseed_child (NOT clear):
    # inherited locks may be held by a driver thread that doesn't exist
    # in the child, so they must be replaced, never acquired
    from flink_ml_tpu_torch.common import locks
    from flink_ml_tpu_torch.common.metrics import metrics
    from flink_ml_tpu_torch.observability import tracing

    # the lock watchdog first: its internal mutex may itself have been
    # forked held, and the reseeded tracer/metrics below acquire
    # watchdog-instrumented locks when lockcheck is armed
    locks.reseed_child()
    tracing.tracer.reseed_child(parent_ctx)
    metrics.reseed_child()
    # the live telemetry endpoint is driver-only: if the parent armed
    # one, close the inherited listener fd and pin it shut in the child
    # (only when the module is already loaded — don't pay its import)
    import sys as _sys

    _srv = _sys.modules.get("flink_ml_tpu_torch.observability.server")
    if _srv is not None:
        _srv.reseed_child()
    # drift sketches fold across the fork exactly like the metric
    # registry: reseed so the child's snapshot holds only its own
    # sketches. Gated on the module being loaded — in practice the
    # observability package import chain loads it, but this must not
    # break if an embedding strips that import
    _drift = _sys.modules.get("flink_ml_tpu_torch.observability.drift")
    if _drift is not None:
        _drift.reseed_child()
    # quality sketches (observability/evaluation.py) ride the same
    # fold: child-joined labels ship home beside the metric snapshot
    _qual = _sys.modules.get("flink_ml_tpu_torch.observability.evaluation")
    if _qual is not None:
        _qual.reseed_child()
    # device profiling is driver-only (the single profiler slot belongs
    # to the parent): pin capture shut in the child and replace
    # its module lock rather than acquire it — same gating as above
    _prof = _sys.modules.get("flink_ml_tpu_torch.observability.profiling")
    if _prof is not None:
        _prof.reseed_child()
    try:
        if chaos_action is not None:
            # decided in the PARENT pre-fork so the schedule counter
            # survives; the child only acts it out, reporting the real
            # scheduled call number so failures correlate with the plan
            kind, count = chaos_action
            if kind == "hang":
                # injected wedge: exercises the deadline/SIGKILL path
                while True:
                    time.sleep(3600)
            raise InjectedFault("hostpool-child", count,
                                {"rows": (lo, hi)})
        with tracing.tracer.span("hostpool.child", rows_lo=lo,
                                 rows_hi=hi):
            result = fn(lo, hi)
        envelope = {"result": result, "metrics": metrics.snapshot()}
        # re-check: fn may have imported the drift module itself
        _drift = _sys.modules.get("flink_ml_tpu_torch.observability.drift")
        if _drift is not None:
            dsnap = _drift.state_snapshot()
            if dsnap.get("servables"):
                envelope["drift"] = dsnap
        _qual = _sys.modules.get(
            "flink_ml_tpu_torch.observability.evaluation")
        if _qual is not None:
            qsnap = _qual.state_snapshot()
            if qsnap.get("servables"):
                envelope["quality"] = qsnap
        payload = pickle.dumps(envelope,
                               protocol=pickle.HIGHEST_PROTOCOL)
    except BaseException:  # noqa: BLE001 — report the traceback, then _exit
        status = 1
        payload = traceback.format_exc().encode("utf-8", "replace")
    try:
        with io.FileIO(wfd, "w") as f:
            f.write(_HDR.pack(status, len(payload)))
            f.write(payload)
            f.flush()
    finally:
        os._exit(status)


#: shards are additionally capped at this many rows so one shard's
#: temporaries stay cache/page friendly (the JAX package measured a
#: 10M-row shard 5-10x slower per row than 1M-row pieces; callers merge
#: per-shard results, so extra shards are transparent)
SHARD_CAP_ROWS = 1 << 20


def map_row_shards(fn, n_rows: int, *, workers: int = None,
                   min_rows: int = 1 << 17,
                   shard_cap: int = SHARD_CAP_ROWS,
                   timeout_s: float = None):
    """Run ``fn(lo, hi)`` over even row shards of ``[0, n_rows)`` in
    forked workers — a sliding window with at most ``workers`` live
    children, refilled as each finishes (no end-of-wave barrier); return
    the per-shard results in shard order.

    ``shard_cap`` bounds each shard's rows (default ``SHARD_CAP_ROWS``)
    so one shard's temporaries stay page/cache friendly; there may be
    many more shards than workers.  ``fn`` must be host-numpy only (no
    torch, no CUDA — the fork rule of the module docstring) and close
    over whatever input arrays it needs; fork shares them copy-on-write.  Small inputs (below
    ``min_rows``), a single worker, or a platform without fork run the
    shards inline in the parent — so callers need exactly one code path.

    ``timeout_s`` is the per-child deadline (None → ``child_deadline_s``
    env default; <= 0 disables): a child past it is SIGKILLed and the map
    raises a retryable :class:`WorkerTimeout` naming the worker.
    """
    from flink_ml_tpu_torch.observability import tracing

    workers = host_parallelism() if workers is None else workers
    small = n_rows < max(min_rows, 2)
    n_shards = 1 if small else max(
        min(workers, n_rows // max(1, min_rows // 2)),
        -(-n_rows // max(1, shard_cap)))
    shards = shard_bounds(n_rows, max(1, n_shards))
    if workers <= 1 or small or not hasattr(os, "fork"):
        with tracing.tracer.span("hostpool.map", n_rows=n_rows,
                                 shards=len(shards), mode="inline"):
            return [fn(lo, hi) for lo, hi in shards]
    if timeout_s is None:
        timeout_s = child_deadline_s()
    with tracing.tracer.span("hostpool.map", n_rows=n_rows,
                             shards=len(shards), workers=workers,
                             mode="fork"):
        return _fork_sliding(fn, shards, workers, timeout_s)


class _Child:
    """One forked worker: pid, shard index, reader, an incremental
    payload buffer (children stream results while others still run) and
    the wall deadline after which the parent gives up on it."""

    __slots__ = ("pid", "idx", "reader", "buf", "header", "deadline")

    def __init__(self, pid, idx, rfd, deadline):
        self.pid, self.idx = pid, idx
        self.reader = io.FileIO(rfd, "r")
        self.buf = bytearray()
        self.header = None  # (status, length) once parsed
        self.deadline = deadline  # monotonic seconds, or None


def _finalize(child):
    """Parse a finished child's stream → its unpickled result, folding
    the child's metric-registry snapshot into the driver registry on the
    way (the collect-time merge: what a worker counted is kept)."""
    if child.header is None:
        raise RuntimeError(
            "host-pool worker died before reporting a result")
    status, length = child.header
    payload = bytes(child.buf)
    if status != 0:
        raise RuntimeError("host-pool worker failed:\n"
                           + payload.decode("utf-8", "replace"))
    if len(payload) < length:
        raise RuntimeError("host-pool worker result truncated")
    envelope = pickle.loads(payload)
    snap = envelope.get("metrics")
    if snap:
        from flink_ml_tpu_torch.common.metrics import metrics

        try:
            metrics.merge(snap)
        except ValueError:
            # a bucket-drift snapshot must not fail the map — but it
            # must not vanish either: count + log the drop so the
            # missing child metrics are explainable from the driver
            import logging

            metrics.group("ml", "hostpool").counter(
                "droppedChildSnapshots")
            logging.getLogger(__name__).warning(
                "dropping worker %d metric snapshot (bucket drift)",
                child.idx, exc_info=True)
    dsnap = envelope.get("drift")
    if dsnap:
        from flink_ml_tpu_torch.observability import drift

        try:
            drift.merge_state(dsnap)
        except ValueError:
            import logging

            metrics.group("ml", "hostpool").counter(
                "droppedChildDriftSnapshots")
            logging.getLogger(__name__).warning(
                "dropping worker %d drift snapshot (bin mismatch)",
                child.idx, exc_info=True)
    qsnap = envelope.get("quality")
    if qsnap:
        from flink_ml_tpu_torch.observability import evaluation

        try:
            evaluation.merge_state(qsnap)
        except ValueError:
            import logging

            metrics.group("ml", "hostpool").counter(
                "droppedChildQualitySnapshots")
            logging.getLogger(__name__).warning(
                "dropping worker %d quality snapshot (bin mismatch)",
                child.idx, exc_info=True)
    return envelope["result"]


def _reap(pid, grace_s: float = 5.0) -> None:
    """waitpid with a bounded grace period: a child that closed its pipe
    but never exits gets SIGKILLed instead of blocking the driver."""
    end = time.monotonic() + grace_s
    while True:
        done, _ = os.waitpid(pid, os.WNOHANG)
        if done:
            return
        if time.monotonic() >= end:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            os.waitpid(pid, 0)
            return
        time.sleep(0.01)


def _fork_sliding(fn, shards, workers, timeout_s=None):
    """Sliding-window scheduler: at most ``workers`` live children; as
    each child's stream closes it is reaped and the next shard forks —
    no end-of-wave barrier idling workers when len(shards) is not a
    multiple of ``workers``. Results return in shard order. Each child
    carries a wall deadline (``timeout_s``); the select loop wakes at the
    earliest one and a child past it is SIGKILLed → WorkerTimeout."""
    import selectors

    sel = selectors.DefaultSelector()
    live = {}          # fd -> _Child
    results = [None] * len(shards)
    next_shard = 0
    forked_pids, reaped = [], set()
    bounded = timeout_s is not None and timeout_s > 0

    def fork_next():
        nonlocal next_shard
        lo, hi = shards[next_shard]
        # chaos decisions happen PRE-fork in the parent: the schedule
        # counter must advance in the surviving process, and the child
        # merely performs the chosen action
        chaos_action = None
        crash_count = faults.decide("hostpool-child")
        if crash_count:
            chaos_action = ("crash", crash_count)
        else:
            hang_count = faults.decide("hostpool-hang")
            if hang_count:
                chaos_action = ("hang", hang_count)
        # the dispatching span's context, captured on THIS thread
        # before the fork: the child's spans parent to it explicitly
        # instead of inferring from the inherited thread-locals
        from flink_ml_tpu_torch.observability import tracing

        parent_ctx = tracing.tracer.current_context()
        rfd, wfd = os.pipe()
        pid = os.fork()
        if pid == 0:  # child: never returns
            os.close(rfd)
            for other_fd in list(live):
                os.close(other_fd)
            _child_main(fn, lo, hi, wfd, chaos_action, parent_ctx)
        os.close(wfd)
        deadline = time.monotonic() + timeout_s if bounded else None
        child = _Child(pid, next_shard, rfd, deadline)
        live[rfd] = child
        sel.register(child.reader, selectors.EVENT_READ, child)
        forked_pids.append(pid)
        next_shard += 1

    def kill_expired():
        now = time.monotonic()
        for child in live.values():
            if child.deadline is not None and now >= child.deadline:
                try:
                    os.kill(child.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                os.waitpid(child.pid, 0)
                reaped.add(child.pid)
                lo, hi = shards[child.idx]
                from flink_ml_tpu_torch.observability import tracing

                tracing.tracer.event("hostpool.timeout",
                                     worker=child.idx,
                                     timeout_s=timeout_s,
                                     rows_lo=lo, rows_hi=hi)
                raise WorkerTimeout(child.idx, timeout_s, rows=(lo, hi))

    try:
        while next_shard < len(shards) and len(live) < workers:
            fork_next()
        while live:
            wait = None
            if bounded:
                wait = max(0.0, min(c.deadline for c in live.values())
                           - time.monotonic())
            ready = sel.select(wait)
            # enforce deadlines EVERY iteration: busy siblings keep
            # select() returning early, and only checking on an empty
            # select would let a wedged child outlive its deadline for
            # as long as the others keep streaming
            kill_expired()
            if not ready:
                continue
            for key, _ in ready:
                child = key.data
                chunk = child.reader.read(1 << 20)
                if chunk:
                    child.buf.extend(chunk)
                    if child.header is None and \
                            len(child.buf) >= _HDR.size:
                        child.header = _HDR.unpack_from(child.buf)
                        del child.buf[:_HDR.size]
                    continue
                # EOF: child done — reap, finalize, refill the window
                sel.unregister(child.reader)
                del live[child.reader.fileno()]
                child.reader.close()
                _reap(child.pid)
                reaped.add(child.pid)
                results[child.idx] = _finalize(child)
                if next_shard < len(shards):
                    fork_next()
        return results
    finally:
        # close pipes first (a worker blocked on a full pipe gets EPIPE
        # and exits), then SIGKILL + reap every un-waited child — on the
        # WorkerTimeout path some siblings may themselves be wedged, and
        # a plain waitpid on one of those would hang the very teardown
        # that exists to prevent hangs
        for child in live.values():
            try:
                sel.unregister(child.reader)
            except Exception:
                pass
            try:
                child.reader.close()
            except OSError:
                pass
        for pid in forked_pids:
            if pid not in reaped:
                try:
                    _reap(pid, grace_s=1.0)
                except ChildProcessError:
                    pass
