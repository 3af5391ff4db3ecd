"""Failure taxonomy and retry/backoff policy.

The port of ``flink_ml_tpu/resilience/policy.py`` (ref: Flink's
RestartStrategies.fixedDelayRestart: a bounded restart count, a fixed or
growing delay, and a restore from the newest checkpoint). Infrastructure
errors (an injected fault, an I/O error) are retried from the newest valid
checkpoint; programming and validation errors (ValueError, TypeError, ...)
propagate at once.

What the port adds to the JAX package's taxonomy: a fault of the CUDA card
poisons the process's CUDA context, so a retry in the same process fails
again and burns the whole restart budget. ``torch.AcceleratorError`` (a
kernel that faulted, an illegal address) and the port's own
:class:`KernelLaunchError` and :class:`KernelBuildError` are therefore
terminal, although they are ``RuntimeError``\\ s, which stay retryable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Type

import torch

RETRYABLE = "retryable"
TERMINAL = "terminal"


class RetryableFailure(Exception):
    """Marker base: failures that a restart from the newest valid
    checkpoint can plausibly cure (transient infra, injected chaos)."""


class TerminalFailure(Exception):
    """Marker base: failures no restart can cure (validation errors,
    exhausted budgets, device faults)."""


class WorkerTimeout(RetryableFailure):
    """A host-pool child exceeded its deadline and was killed (retryable:
    the retried map starts its workers afresh)."""

    def __init__(self, worker_index: int, timeout_s: float,
                 rows: Optional[Tuple[int, int]] = None):
        self.worker_index = worker_index
        self.timeout_s = timeout_s
        self.rows = rows
        span = f" (rows [{rows[0]}, {rows[1]}))" if rows else ""
        super().__init__(
            f"host-pool worker {worker_index}{span} exceeded its "
            f"{timeout_s:g}s deadline and was killed")


class WorkerLost(RetryableFailure):
    """A training peer of a multi-process fit stopped participating
    (retryable: the restart budget bounds how many losses a fit absorbs)."""

    def __init__(self, process_index: Optional[int], reason: str = "",
                 timeout_s: Optional[float] = None):
        self.process_index = process_index
        self.timeout_s = timeout_s
        who = (f"process {process_index}" if process_index is not None
               else "an unidentified process")
        tail = f": {reason}" if reason else ""
        after = (f" after {timeout_s:g}s" if timeout_s is not None else "")
        super().__init__(f"worker lost ({who}){after}{tail}")


class InjectedFault(RetryableFailure):
    """Raised by the chaos harness (``resilience/faults.py``) at an
    instrumented site; always retryable: recovery is what is under test."""

    def __init__(self, site: str, count: int, detail: dict = None):
        self.site = site
        self.count = count
        self.detail = dict(detail or {})
        super().__init__(f"injected fault at {site!r} (call #{count})")


class RestartsExhausted(TerminalFailure):
    """The supervisor ran out of restart budget; the last underlying failure
    rides along as ``__cause__``. ``budget`` names which bound tripped:
    ``"restart"`` or ``"deadline"``."""

    def __init__(self, attempts: int, reason: str, budget: str = "restart"):
        self.attempts = attempts
        self.budget = budget
        super().__init__(
            f"gave up after {attempts} restart(s): {reason}")


class NonFiniteState(TerminalFailure):
    """A fit's numeric state (loss or parameters) went NaN/Inf.

    Terminal: divergence is deterministic, so a restart replays the same
    batch schedule into the same overflow. Raised by the final-state guard
    (``observability/health.py``)."""

    def __init__(self, algo: str, epoch: Optional[int] = None,
                 detail: str = ""):
        self.algo = algo
        self.epoch = epoch
        where = f" at epoch {epoch}" if epoch is not None else ""
        tail = f" ({detail})" if detail else ""
        super().__init__(
            f"{algo} diverged to a non-finite state{where}{tail}")


class CandidateRejected(TerminalFailure):
    """A candidate model failed a hot-swap health check (corrupt data,
    non-finite parameters, a failing probe). Terminal: re-validating the
    same snapshot reproduces the same rejection."""

    def __init__(self, model: str, version, reason: str, detail: str = ""):
        self.model = model
        self.version = version
        self.reason = reason
        tail = f": {detail}" if detail else ""
        super().__init__(
            f"candidate {model}@v{version} rejected ({reason}){tail}")


class KernelBuildError(TerminalFailure, RuntimeError):
    """``nvcc`` is missing or failed to build a kernel source: the same
    source fails the same way on a retry."""


class KernelLaunchError(TerminalFailure, RuntimeError):
    """A hand-written kernel did not launch or reported a CUDA error. The
    CUDA context may be poisoned, so no retry in this process can succeed."""


#: device faults of this PyTorch build (``torch.AcceleratorError`` where it
#: exists): the CUDA context is poisoned after one
_DEVICE_FAULTS: Tuple[Type[BaseException], ...] = tuple(
    t for t in (getattr(torch, "AcceleratorError", None),) if t is not None)

#: failures that indicate a bug, invalid input or a poisoned device: a retry
#: replays the same computation into the same wall. NotImplementedError and
#: the device faults are RuntimeErrors, so they are checked before the
#: retryable RuntimeError rule.
_DEFAULT_TERMINAL: Tuple[Type[BaseException], ...] = (
    TerminalFailure, NotImplementedError, ValueError, TypeError,
    AssertionError, AttributeError, KeyError, IndexError, ZeroDivisionError,
) + _DEVICE_FAULTS


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Restart budget + exponential backoff + failure classification.

    ``classify`` precedence: the policy's explicit ``terminal`` types, then
    its explicit ``retryable`` types, then the marker bases and the default
    terminal taxonomy above. Everything else is RETRYABLE: OS and I/O
    errors, other runtime errors, memory pressure
    (``torch.cuda.OutOfMemoryError`` leaves the context usable) and
    unrecognized Exception subclasses.
    """

    #: restarts after the first attempt (0 = fail fast, never retry)
    max_restarts: int = 3
    #: delay before restart i (1-based): backoff_s * multiplier**(i-1),
    #: capped at max_backoff_s
    backoff_s: float = 0.1
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 30.0
    #: total wall budget across all restarts (None = unbounded)
    deadline_s: Optional[float] = None
    #: extra exception types, consulted before the default taxonomy
    retryable: Tuple[Type[BaseException], ...] = ()
    terminal: Tuple[Type[BaseException], ...] = ()

    def __post_init__(self):
        if self.max_restarts < 0:
            raise ValueError("max_restarts must be >= 0")
        if self.backoff_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff delays must be >= 0")
        if self.backoff_multiplier < 1.0:
            raise ValueError("backoff_multiplier must be >= 1")

    def classify(self, exc: BaseException) -> str:
        if isinstance(exc, self.terminal):
            return TERMINAL
        if isinstance(exc, self.retryable):
            return RETRYABLE
        # the marker beats the taxonomy: InjectedFault et al. stay
        # retryable no matter what else they subclass
        if isinstance(exc, RetryableFailure):
            return RETRYABLE
        if isinstance(exc, _DEFAULT_TERMINAL):
            return TERMINAL
        return RETRYABLE

    def backoff(self, restart: int) -> float:
        """Delay in seconds before 1-based restart number ``restart``."""
        if restart <= 0:
            return 0.0
        delay = self.backoff_s * self.backoff_multiplier ** (restart - 1)
        return min(delay, self.max_backoff_s)
