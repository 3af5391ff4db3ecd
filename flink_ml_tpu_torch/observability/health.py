"""The always-on final-state guard of a fit.

The port's copy of ``guard_final_state`` of
``flink_ml_tpu/observability/health.py``: a cheap non-finite check over
host arrays a fit has already fetched. It raises the terminal
:class:`NonFiniteState` of ``resilience/policy.py`` (re-exported here), so a
supervised fit that diverges fails at once instead of restarting. The health
series, divergence events and their telemetry come with the observability
slice of the port.
"""

from __future__ import annotations

import math

import numpy as np

from flink_ml_tpu_torch.resilience.policy import NonFiniteState

__all__ = ["NonFiniteState", "guard_final_state"]


def guard_final_state(algo: str, *leaves, loss=None) -> None:
    """Raises :class:`NonFiniteState` when the loss or any host array holds
    NaN or Inf."""
    bad = loss is not None and not math.isfinite(float(loss))
    for leaf in leaves:
        if leaf is not None and not np.all(np.isfinite(np.asarray(leaf))):
            bad = True
    if bad:
        raise NonFiniteState(algo)
