"""Fault-tolerant execution: the failure taxonomy and retry policy
(:mod:`policy`), the supervised-fit driver (:mod:`supervisor`) and the
deterministic fault-injection harness (:mod:`faults`). The port of
``flink_ml_tpu/resilience`` (ref: Flink's RestartStrategies and checkpoint
restore)."""

from flink_ml_tpu_torch.resilience.policy import (  # noqa: F401
    RETRYABLE,
    TERMINAL,
    CandidateRejected,
    InjectedFault,
    KernelBuildError,
    KernelLaunchError,
    NonFiniteState,
    RestartsExhausted,
    RetryableFailure,
    RetryPolicy,
    TerminalFailure,
    WorkerLost,
    WorkerTimeout,
)
from flink_ml_tpu_torch.resilience.supervisor import run_supervised  # noqa: F401

__all__ = [
    "RETRYABLE",
    "TERMINAL",
    "CandidateRejected",
    "InjectedFault",
    "KernelBuildError",
    "KernelLaunchError",
    "NonFiniteState",
    "RestartsExhausted",
    "RetryableFailure",
    "RetryPolicy",
    "TerminalFailure",
    "WorkerLost",
    "WorkerTimeout",
    "run_supervised",
]
