"""Supervised execution: retry with backoff around a checkpointed fit.

The port of ``flink_ml_tpu/resilience/supervisor.py`` (ref: Flink's
fixed-delay restart strategy and JobManager-driven restore).
``run_supervised(fn, mgr, policy)`` re-enters any checkpoint-aware unit of
work (an estimator's fit with a ``CheckpointManager``, or a bare
``run_segmented`` driver) after retryable failures. Recovery is the
checkpoint layer's: on re-entry the iteration restores the newest checkpoint
that passes integrity validation, so the supervisor only classifies, backs
off, sweeps crash debris and tries again. The ``ml.resilience`` metrics and
trace events of the JAX package come with the port's observability slice.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Sequence

from flink_ml_tpu_torch.resilience.policy import (
    TERMINAL,
    RestartsExhausted,
    RetryPolicy,
)

logger = logging.getLogger(__name__)


def _notify(listeners: Sequence, event: str, *args) -> None:
    # a listener failing during recovery notification must not mask the
    # recovery itself: log and continue
    for lst in listeners:
        hook = getattr(lst, event, None)
        if hook is None:
            continue
        try:
            hook(*args)
        except Exception:  # noqa: BLE001 — see above
            logger.warning("resilience listener %r.%s failed",
                           lst, event, exc_info=True)


def run_supervised(fn: Callable[[], object],
                   mgr=None,
                   policy: Optional[RetryPolicy] = None,
                   listeners: Sequence = (),
                   sleep: Callable[[float], None] = time.sleep):
    """Run ``fn()`` under ``policy``; return its result.

    On a failure classified RETRYABLE, sleep the policy's backoff, sweep the
    checkpoint manager's orphaned ``ckpt-*.tmp`` dirs and re-invoke ``fn``,
    up to ``policy.max_restarts`` times within ``policy.deadline_s``.
    TERMINAL failures (a device fault among them) propagate unchanged;
    exhausting the budget raises :class:`RestartsExhausted` chaining the
    last failure. The listeners' ``on_restart(attempt, error)`` and
    ``on_recovered(attempt)`` hooks hear of restarts and recovery.

    ``fn`` must be re-runnable from its own entry point: each attempt builds
    its carry afresh and restores from the newest *valid* checkpoint (or
    starts fresh when none survives).
    """
    policy = policy or RetryPolicy()
    deadline = (time.monotonic() + policy.deadline_s
                if policy.deadline_s is not None else None)
    attempt = 0  # completed restarts so far
    while True:
        try:
            result = fn()
        except Exception as e:  # noqa: BLE001 — classified right below
            if policy.classify(e) == TERMINAL:
                raise
            if attempt >= policy.max_restarts:
                raise RestartsExhausted(
                    attempt, "restart budget exhausted") from e
            attempt += 1
            delay = policy.backoff(attempt)
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise RestartsExhausted(
                        attempt - 1,
                        f"deadline budget ({policy.deadline_s:g}s) "
                        "exhausted", budget="deadline") from e
                delay = min(delay, remaining)
            logger.warning(
                "supervised run failed (%s: %s); restart %d/%d in %.3gs",
                type(e).__name__, e, attempt, policy.max_restarts, delay)
            _notify(listeners, "on_restart", attempt, e)
            if mgr is not None and hasattr(mgr, "sweep_orphans"):
                # a crash between makedirs and the atomic rename leaves a
                # ckpt-*.tmp corpse; clear it before the next attempt
                mgr.sweep_orphans()
            if delay > 0:
                sleep(delay)
            continue
        if attempt:
            _notify(listeners, "on_recovered", attempt)
            logger.info("supervised run recovered after %d restart(s)",
                        attempt)
        return result
