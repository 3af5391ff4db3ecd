"""Termination criteria helpers.

The port of ``flink_ml_tpu/iteration/termination.py`` (ref:
flink-ml-core/.../common/iteration/{TerminateOnMaxIter.java:34,
TerminateOnMaxIterOrTol.java:34, ForwardInputsOfLastRound.java:34}):
predicate factories for ``iterate_bounded``'s ``terminate`` argument. Each
predicate returns a 0-dim bool tensor on the carry's device and never calls
``.item()``, so the device loop keeps it as a mask without waiting for the
device.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def terminate_on_max_iter(max_iter: int) -> Callable:
    """Pure round-count bound (ref: TerminateOnMaxIter), for symmetry; the
    same as passing ``max_iter`` to iterate_bounded."""
    def predicate(carry: Any, epoch) -> torch.Tensor:
        return torch.as_tensor(epoch + 1 >= max_iter)
    return predicate


def terminate_on_max_iter_or_tol(tol: float,
                                 loss_fn: Callable[[Any], Any] = None
                                 ) -> Callable:
    """Stop when the carry's loss drops below tol (ref:
    TerminateOnMaxIterOrTol; the maxIter half is the driver's bound).
    ``loss_fn`` extracts the loss from the carry (default: the carry itself,
    or its 'loss' entry for dict carries)."""
    def predicate(carry: Any, epoch) -> torch.Tensor:
        loss = (loss_fn(carry) if loss_fn is not None
                else (carry["loss"] if isinstance(carry, dict) else carry))
        return torch.as_tensor(loss) < tol
    return predicate


def terminate_on_empty_round(count_fn: Callable[[Any], Any]) -> Callable:
    """Stop when a round processed zero records (ref:
    SharedProgressAligner.EpochStatus.isTerminated,
    SharedProgressAligner.java:277-292). ``count_fn`` extracts the round's
    record count from the carry."""
    def predicate(carry: Any, epoch) -> torch.Tensor:
        return torch.as_tensor(count_fn(carry)) == 0
    return predicate


def forward_inputs_of_last_round(final_carry: Any,
                                 extract: Callable[[Any], Any] = None):
    """The final carry is the last round's value (ref:
    ForwardInputsOfLastRound); this helper documents the mapping."""
    return extract(final_carry) if extract is not None else final_carry
