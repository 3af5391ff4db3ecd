"""Shared model plumbing.

The port's ``IterationRuntimeMixin`` of ``flink_ml_tpu/models/common.py``
and the final-state non-finite guard of
``flink_ml_tpu/observability/health.py``. This slice runs every iterative
fit as one all-device program: host-driven rounds, listeners, checkpoints
and supervised restarts come with the iteration and resilience slices, and
asking for them raises instead of being ignored.
"""

from __future__ import annotations

import numpy as np


class NonFiniteState(RuntimeError):
    """A fit's final state holds NaN or Inf (the JAX package's
    ``resilience.policy.NonFiniteState``, a terminal failure)."""

    def __init__(self, algo: str):
        self.algo = algo
        super().__init__(f"{algo}: non-finite model state after the fit")


def guard_final_state(algo: str, *leaves) -> None:
    """Raises :class:`NonFiniteState` when any host array holds NaN or Inf."""
    for leaf in leaves:
        if leaf is not None and not np.all(np.isfinite(np.asarray(leaf))):
            raise NonFiniteState(algo)


class IterationRuntimeMixin:
    """Runtime (non-Param) iteration knobs shared by iterative estimators.
    Only the all-device mode exists in this slice of the port."""

    _iteration_config = None

    def set_iteration_config(self, config, listeners=()):
        """Accepts a config that asks for the all-device program only;
        host rounds, listeners, checkpoints and per-round init raise."""
        wants_host = bool(listeners) or (config is not None and (
            getattr(config, "mode", "device") != "device"
            or getattr(config, "checkpoint_interval", 0) != 0
            or getattr(config, "checkpoint_manager", None) is not None
            or getattr(config, "per_round_init", None) is not None))
        if wants_host:
            raise NotImplementedError(
                "host-driven rounds, iteration listeners and checkpoints "
                "come with the iteration slice of the port; this slice "
                "runs the all-device program only")
        self._iteration_config = config
        return self

    def set_retry_policy(self, policy):
        raise NotImplementedError(
            "supervised restarts come with the resilience slice of the port")
