"""The always-on final-state guard of a fit.

The port's copy of ``guard_final_state`` of
``flink_ml_tpu/observability/health.py`` and of the terminal
``NonFiniteState`` of ``flink_ml_tpu/resilience/policy.py``: a cheap
non-finite check over host arrays a fit has already fetched. The health
series, divergence events and their telemetry come with the observability
slice of the port.
"""

from __future__ import annotations

import math

import numpy as np


class NonFiniteState(RuntimeError):
    """A fit's final state holds NaN or Inf (a terminal failure)."""

    def __init__(self, algo: str):
        self.algo = algo
        super().__init__(f"{algo}: non-finite model state after the fit")


def guard_final_state(algo: str, *leaves, loss=None) -> None:
    """Raises :class:`NonFiniteState` when the loss or any host array holds
    NaN or Inf."""
    bad = loss is not None and not math.isfinite(float(loss))
    for leaf in leaves:
        if leaf is not None and not np.all(np.isfinite(np.asarray(leaf))):
            bad = True
    if bad:
        raise NonFiniteState(algo)
