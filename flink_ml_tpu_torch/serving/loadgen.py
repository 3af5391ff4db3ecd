"""Load generator: closed/open-loop request driving with exact latency
accounting — the serving twin of the fit benchmark harness.

The port of ``flink_ml_tpu/serving/loadgen.py``. One request-driving code
path for everything that throws traffic at a servable: the card's smoke
run (``chip_smoke.py``) and the runtime tests call :func:`run_loadgen`
with a ``submit`` callable — either
``MicroBatcher.submit`` (futures; the batched path) or a bare
``servable.transform`` (the per-request baseline; wrapped into a
worker-thread future automatically) — and a ``frame_factory(i)``
producing the i-th request frame (the caller controls the row-size
mix).

Two loops:

- **closed** — ``concurrency`` workers, each keeping exactly one
  request outstanding: offered load adapts to capacity, the classic
  saturation probe;
- **open** — requests issue on a fixed ``rps`` schedule regardless of
  completions (capped by ``max_outstanding`` so an overloaded target
  sheds into rejections rather than an unbounded client backlog): the
  SLO-relevant regime, where queueing delay is visible.

Every request is classified ``ok`` / ``rejected``
(:class:`~flink_ml_tpu_torch.servable.api.RejectedRequest` — shed load) /
``error`` (anything else), with per-class exact latency samples; the
result dict carries p50/p90/p99/mean/max over the OK samples plus
achieved and offered rates, ready for a BASELINE-style JSON record.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional

from flink_ml_tpu_torch.common.locks import make_lock
from flink_ml_tpu_torch.servable.api import RejectedRequest

__all__ = ["LoadGenConfig", "percentiles", "run_loadgen"]


@dataclasses.dataclass(frozen=True)
class LoadGenConfig:
    """One load run. ``mode`` is ``"closed"`` or ``"open"``."""

    mode: str = "closed"
    #: total requests to issue
    requests: int = 100
    #: closed loop: concurrent workers (1 = strictly sequential)
    concurrency: int = 4
    #: open loop: offered request rate (requests/second)
    rps: float = 200.0
    #: open loop: issue cap — pending completions beyond this make the
    #: generator skip (count as ``skipped``) instead of queueing
    #: forever. One harvest thread per outstanding request, so the
    #: effective cap is min(max_outstanding, 64) — sized for the
    #: process-local targets this loadgen drives; a non-zero ``skipped``
    #: in the result means the offered schedule was NOT sustained
    max_outstanding: int = 64
    #: per-request completion timeout
    timeout_s: float = 30.0

    def __post_init__(self):
        if self.mode not in ("closed", "open"):
            raise ValueError(f"mode must be closed|open, got {self.mode!r}")
        if self.requests <= 0 or self.concurrency <= 0:
            raise ValueError("requests and concurrency must be > 0")
        if self.mode == "open" and self.rps <= 0:
            raise ValueError("open loop needs rps > 0")


def percentiles(samples_ms: List[float]) -> dict:
    """Exact order-statistic latency summary (nearest-rank) — the
    loadgen holds every sample, so no bucket interpolation error."""
    if not samples_ms:
        return {"p50": None, "p90": None, "p99": None, "mean": None,
                "max": None}
    s = sorted(samples_ms)
    n = len(s)

    def rank(q: float) -> float:
        return round(s[min(n - 1, max(0, int(q * n + 0.5) - 1))], 3)

    return {"p50": rank(0.50), "p90": rank(0.90), "p99": rank(0.99),
            "mean": round(sum(s) / n, 3), "max": round(s[-1], 3)}


class _Collector:
    def __init__(self):
        self.lock = make_lock("serving.loadgen.stats")
        self.ok_ms: List[float] = []
        self.rejected: dict = {}
        self.errors: dict = {}
        self.rows_ok = 0

    def record(self, t0: float, outcome, rows: int) -> None:
        ms = (time.perf_counter() - t0) * 1000.0
        with self.lock:
            if outcome is None:
                self.ok_ms.append(ms)
                self.rows_ok += rows
            elif isinstance(outcome, RejectedRequest):
                key = outcome.reason
                self.rejected[key] = self.rejected.get(key, 0) + 1
            else:
                key = type(outcome).__name__
                self.errors[key] = self.errors.get(key, 0) + 1


def _as_future(submit: Callable, frame) -> "Future":
    out = submit(frame)
    if isinstance(out, Future):
        return out
    done: Future = Future()
    done.set_result(out)
    return done


def run_loadgen(submit: Callable, frame_factory: Callable[[int], object],
                cfg: Optional[LoadGenConfig] = None,
                tick: Optional[Callable[[int], None]] = None,
                feedback: Optional[Callable[[int, object, Future],
                                            None]] = None) -> dict:
    """Drive ``cfg.requests`` requests through ``submit`` and return
    the result record. ``submit(frame)`` may return a Future (the
    micro-batcher) or the transformed frame directly (a bare
    ``transform`` — run in loadgen worker threads so closed-loop
    concurrency still applies). ``tick(i)`` (optional) runs after every
    completed request — the smoke's scrape-while-serving hook.
    ``feedback(i, frame, fut)`` (optional) runs after every request
    that completed OK — the delayed-ground-truth hook: the batcher
    stamps ``fut.request_id`` at submit, so a labeled caller can call
    :func:`~flink_ml_tpu_torch.observability.evaluation.record_feedback`
    with it and close the prediction↔label join. Feedback exceptions
    are swallowed (the label plane must never fail the load run)."""
    cfg = cfg or LoadGenConfig()
    collector = _Collector()
    completed = [0]
    done_lock = make_lock("serving.loadgen.done")
    tick_errors: List[BaseException] = []

    def finish(i: int, t0: float, fut: Future, frame) -> None:
        rows = frame.num_rows() if hasattr(frame, "num_rows") else 0
        try:
            fut.result(timeout=cfg.timeout_s)
            collector.record(t0, None, rows)
            if feedback is not None:
                try:
                    feedback(i, frame, fut)
                except Exception:  # noqa: BLE001 — see docstring
                    pass
        except Exception as e:  # noqa: BLE001 — classification IS the job
            collector.record(t0, e, rows)
        if tick is not None:
            with done_lock:
                completed[0] += 1
                n = completed[0]
            try:
                tick(n)
            except BaseException as e:  # noqa: BLE001 — ticks run on
                # worker threads, where a raised SystemExit/assertion
                # would silently kill ONE worker and strand its share of
                # the run; collect and re-raise from the caller's thread
                with done_lock:
                    tick_errors.append(e)

    t_start = time.perf_counter()
    if cfg.mode == "closed":
        counter = [0]
        counter_lock = make_lock("serving.loadgen.counter")

        def worker() -> None:
            while True:
                with counter_lock:
                    if counter[0] >= cfg.requests:
                        return
                    i = counter[0]
                    counter[0] += 1
                frame = frame_factory(i)
                t0 = time.perf_counter()
                try:
                    fut = _as_future(submit, frame)
                except Exception as e:  # noqa: BLE001 — a submit-time
                    # raise (sync transform) classifies like a future
                    fut = Future()
                    fut.set_exception(e)
                finish(i, t0, fut, frame)

        threads = [threading.Thread(target=worker, daemon=True,
                                    name=f"loadgen-{w}")
                   for w in range(min(cfg.concurrency, cfg.requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        skipped = 0
    else:
        # open loop: fixed-rate issue schedule; completions harvest on a
        # pool so a slow target never stalls the schedule. The
        # semaphore bound EQUALS the pool size: each harvest thread
        # blocks on one completion, so a larger semaphore would let
        # issues queue invisibly inside the executor and report a
        # sustained schedule the target never actually saw
        interval = 1.0 / cfg.rps
        workers = min(64, cfg.max_outstanding)
        outstanding = threading.Semaphore(workers)
        skipped = 0
        with ThreadPoolExecutor(
                max_workers=workers,
                thread_name_prefix="loadgen") as pool:
            for i in range(cfg.requests):
                target_t = t_start + i * interval
                delay = target_t - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                if not outstanding.acquire(blocking=False):
                    skipped += 1
                    continue
                frame = frame_factory(i)

                # submit runs on the pool too: a synchronous target
                # (bare transform) must not stall the issue schedule
                def issue(i=i, frame=frame):
                    t0 = time.perf_counter()
                    try:
                        fut = _as_future(submit, frame)
                    except Exception as e:  # noqa: BLE001 — see above
                        fut = Future()
                        fut.set_exception(e)
                    try:
                        finish(i, t0, fut, frame)
                    finally:
                        outstanding.release()

                pool.submit(issue)
    wall_s = max(time.perf_counter() - t_start, 1e-9)
    if tick_errors:
        raise tick_errors[0]

    ok = len(collector.ok_ms)
    rejected = sum(collector.rejected.values())
    errors = sum(collector.errors.values())
    return {
        "mode": cfg.mode,
        "requests": cfg.requests,
        "ok": ok,
        "rejected": rejected,
        "rejectedByReason": dict(collector.rejected),
        "errors": errors,
        "errorsByClass": dict(collector.errors),
        "skipped": skipped,
        "rows_ok": collector.rows_ok,
        "wall_s": round(wall_s, 4),
        "offered_rps": (round(cfg.rps, 2) if cfg.mode == "open"
                        else round(cfg.requests / wall_s, 2)),
        "throughput_rps": round(ok / wall_s, 2),
        "rows_per_s": round(collector.rows_ok / wall_s, 2),
        "latency_ms": percentiles(collector.ok_ms),
    }
