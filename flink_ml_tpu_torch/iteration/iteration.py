"""Bounded iteration driver.

The port of ``flink_ml_tpu/iteration/iteration.py``. Ref parity map:

- ``Iterations.iterate_bounded_streams_until_termination``
  (Iterations.java:149) → :func:`iterate_bounded`.
- ``IterationBody.process`` (IterationBody.java:54) → the ``body`` callable
  ``body(carry, epoch) -> carry``; ``epoch`` is a Python int in every mode.
- ``IterationListener.onEpochWatermarkIncremented / onIterationTerminated``
  → :class:`IterationListener` callbacks (host mode).
- Termination (SharedProgressAligner.java:277-292 + TerminateOnMaxIterOrTol)
  → ``max_iter`` plus an optional ``terminate(carry, epoch)`` predicate.
- ALL_ROUND vs PER_ROUND lifecycles → the carry persists across rounds, or
  ``per_round_init`` resets part of it each epoch (host mode).

Two choices of the port, where the JAX package compiles a ``while_loop``:

- **Device loop and segments.** The rounds run as a Python loop over device
  tensors. A ``terminate`` stop is a mask: each round's carry is
  ``torch.where(active, new, old)`` leaf by leaf, and the stop and the epoch
  count stay 0-dim device tensors, the idiom of ``sgd_rounds`` in
  ``ops/optimizer.py``. Rounds after the stop run and are discarded, so the
  host never waits for the device inside a segment, and the result equals
  the host loop's. The device loop turns host leaves of the initial carry
  into tensors on the carry's device: the ``device`` argument when given,
  else the device of its first tensor leaf, else the default device (the
  card), as the JAX package's loop puts them on its default device.
- **Segment boundary.** A segment ends with one stacked int32 tensor
  ``[epoch, stop]``, fetched by :func:`read_boundary` with one ``.cpu()``:
  the JAX package's fused boundary. Its unfused path (one transfer per
  scalar, ``FLINK_ML_TPU_SEGMENT_FUSION=0``) gives the same bits and is not
  carried over.

A torch carry is never updated in place: every round returns new tensors,
so listeners may hold lagged carries and a supervised retry never meets a
consumed one (the JAX package's donation has no counterpart here). The
``ml.iteration`` metrics, tracing spans, mesh statistics and elastic hooks
of the JAX drivers come with the port's observability and multi-process
slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from flink_ml_tpu_torch.device import DeviceLike, resolve_device
from flink_ml_tpu_torch.iteration.checkpoint import tree_flatten
from flink_ml_tpu_torch.resilience import faults

Carry = Any
Body = Callable[[Carry, int], Carry]
Terminate = Callable[[Carry, int], Any]  # -> bool scalar (tensor or host)


def read_boundary(boundary) -> list:
    """The host values of a segment boundary, ``[epoch, stop]`` stacked in
    one int32 tensor: one ``.cpu()``, the one device→host transfer of a
    boundary. Returns numpy scalars in order."""
    if isinstance(boundary, torch.Tensor):
        boundary = boundary.cpu().numpy()
    return list(np.asarray(boundary))


@dataclasses.dataclass
class IterationConfig:
    """Ref: iteration/IterationConfig.java + the driver knobs."""

    #: "device": rounds as one loop over device tensors, no host waits;
    #: "host": one round at a time with listeners, checkpoints and
    #: data-dependent host logic between rounds.
    mode: str = "device"

    #: checkpoint every N epochs (0 = never). Device mode runs N-round
    #: segments with a snapshot between them; host mode snapshots between
    #: rounds.
    checkpoint_interval: int = 0
    checkpoint_manager: Optional[Any] = None

    #: host mode: reset part of the carry each round (PER_ROUND lifecycle).
    per_round_init: Optional[Callable[[Carry, int], Carry]] = None

    def __post_init__(self):
        if self.mode not in ("device", "host"):
            raise ValueError(
                f"IterationConfig.mode must be 'device' or 'host', "
                f"got {self.mode!r}")


class IterationListener:
    """Ref: iteration/IterationListener.java, with the restart and recovery
    events of Flink's restart strategy (sent by
    ``resilience.supervisor.run_supervised``, not by the drivers)."""

    def on_epoch_watermark_incremented(self, epoch: int, carry: Carry) -> None:
        pass

    def on_iteration_terminated(self, carry: Carry) -> None:
        pass

    def on_restart(self, attempt: int, error: BaseException) -> None:
        """A supervised run failed retryably; restart ``attempt`` (1-based)
        is about to re-enter from the newest valid checkpoint."""

    def on_recovered(self, attempt: int) -> None:
        """A supervised run completed after ``attempt`` restart(s)."""


def iterate_bounded(initial_carry: Carry,
                    body: Body,
                    max_iter: int,
                    terminate: Optional[Terminate] = None,
                    config: IterationConfig = None,
                    listeners: Sequence[IterationListener] = (),
                    jit_round: bool = True,
                    device: DeviceLike = None) -> Carry:
    """Run ``body`` for up to ``max_iter`` epochs; stop early when
    ``terminate(carry, epoch)`` is true. Returns the final carry.

    ``jit_round=False`` declares the body plain host code (numpy, scipy):
    such bodies always take the host loop, and their stop is read at once.
    ``device`` is where the device modes put the carry's host leaves; by
    default the device of its first tensor leaf, else the card.
    """
    config = config or IterationConfig()
    seg = device_checkpoint_segment(config, listeners)
    if jit_round and seg:
        return _segmented_device_loop(initial_carry, body, max_iter,
                                      terminate, config, seg, device)
    if jit_round and not needs_host_loop(config, listeners):
        return _device_loop(initial_carry, body, max_iter, terminate, device)
    return _host_loop(initial_carry, body, max_iter, terminate, config,
                      listeners, jit_round)


def needs_host_loop(config: Optional[IterationConfig],
                    listeners: Sequence[IterationListener] = ()) -> bool:
    """True when any configured behavior requires host-driven rounds. The
    single source of truth for the device/host dispatch; algorithm fast
    paths check :func:`device_checkpoint_segment` first, then this."""
    if config is None:
        return bool(listeners)
    return bool(listeners) or config.mode == "host" \
        or config.checkpoint_interval != 0 \
        or config.checkpoint_manager is not None \
        or config.per_round_init is not None


def device_checkpoint_segment(
        config: Optional[IterationConfig],
        listeners: Sequence[IterationListener] = ()) -> int:
    """K (the checkpoint interval) when the only host hook is interval
    checkpointing and the mode is "device": the iteration then runs as
    K-round device segments with the carry snapshotted between them. 0 when
    the configuration needs per-round host hooks (listeners,
    per_round_init, mode="host") or asks for no checkpoints."""
    if config is None or listeners:
        return 0
    if (config.mode != "device" or config.per_round_init is not None
            or config.checkpoint_manager is None
            or config.checkpoint_interval <= 0):
        return 0
    return config.checkpoint_interval


def run_segmented(run_segment, initial_carry, max_iter: int, K: int, mgr):
    """Drive ``run_segment(carry, epoch0, limit) -> (carry, epoch, stop)``
    in K-round chunks with a checkpoint at every K-round boundary: the
    shared segment driver of the generic iteration and of fits that build
    their own segments (SGD). ``run_segment`` fetches its boundary through
    :func:`read_boundary` and returns host values.

    The cadence matches the host loop: a snapshot lands after every K
    completed rounds, except at the final boundary of a run that completes,
    whose snapshot ``mgr.clear()`` would delete at once. An early stop
    mid-segment saves nothing, and a completed run clears its checkpoints.
    A restore off the K-grid (a snapshot of another interval or mode)
    realigns at the first segment, so later boundaries checkpoint on-grid.
    """
    carry, epoch = initial_carry, 0
    restored = mgr.restore(carry)
    if restored is not None:
        carry, epoch = restored
    stop = False
    while epoch < max_iter and not stop:
        # realign to the K-grid so `epoch % K == 0` keeps firing after an
        # off-phase restore
        limit = min(epoch + K - epoch % K, max_iter)
        carry, e, s = run_segment(carry, epoch, limit)
        epoch, stop = int(e), bool(s)
        # chaos site: the segment boundary is this mode's epoch boundary
        faults.inject("epoch-boundary", epoch=epoch)
        done = epoch >= max_iter or stop
        if epoch % K == 0 and not done:
            mgr.save(carry, epoch)
    mgr.clear()
    return carry


def _carry_device(carry, device: DeviceLike) -> torch.device:
    """``device`` when the caller names one; else the device of the
    carry's first tensor leaf; else the default device (the card)."""
    if device is not None:
        return torch.device(device)
    leaves, _ = tree_flatten(carry)
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return resolve_device(None)


def _as_tensors(carry, device: torch.device):
    """The carry with every host leaf made a tensor on ``device``."""
    leaves, treedef = tree_flatten(carry)
    return treedef.unflatten([
        leaf if isinstance(leaf, torch.Tensor)
        else torch.as_tensor(np.asarray(leaf), device=device)
        for leaf in leaves])


def _where(active: torch.Tensor, new, old):
    """``torch.where(active, new, old)`` leaf by leaf over two carries."""
    new_leaves, treedef = tree_flatten(new)
    old_leaves, _ = tree_flatten(old)
    return treedef.unflatten([torch.where(active, n, o)
                              for n, o in zip(new_leaves, old_leaves)])


def _device_rounds(carry, body, terminate, epoch0: int, limit: int,
                   device: torch.device):
    """Rounds ``[epoch0, limit)`` with the stop as a mask → (carry, epoch,
    stop), epoch an int32 and stop a bool 0-dim tensor on ``device``.
    Termination is evaluated after each round on the just-completed epoch,
    as in the host loop, so every mode gives the same result."""
    if terminate is None:
        for epoch in range(epoch0, limit):
            carry = body(carry, epoch)
        return (carry, torch.full((), limit, dtype=torch.int32, device=device),
                torch.zeros((), dtype=torch.bool, device=device))
    count = torch.full((), epoch0, dtype=torch.int32, device=device)
    stop = torch.zeros((), dtype=torch.bool, device=device)
    for epoch in range(epoch0, limit):
        new = body(carry, epoch)
        active = torch.logical_not(stop)
        carry = _where(active, new, carry)
        count = count + active.to(torch.int32)
        done = torch.as_tensor(terminate(new, epoch), device=device)
        stop = torch.logical_or(stop, torch.logical_and(active, done))
    return carry, count, stop


def _segmented_device_loop(initial_carry, body, max_iter, terminate, config,
                           K: int, device: DeviceLike = None):
    """Device-mode iteration with interval checkpointing: K-round device
    segments, the carry snapshotted between them, one boundary fetch each.
    The same rounds as :func:`_device_loop`, so the same result."""
    device = _carry_device(initial_carry, device)

    def run_segment(carry, epoch0, limit):
        carry, epoch, stop = _device_rounds(carry, body, terminate, epoch0,
                                            limit, device)
        vals = read_boundary(torch.stack([epoch, stop.to(torch.int32)]))
        return carry, int(vals[0]), bool(vals[1])

    return run_segmented(run_segment, _as_tensors(initial_carry, device),
                         max_iter, K, config.checkpoint_manager)


def _device_loop(initial_carry, body, max_iter, terminate,
                 device: DeviceLike = None):
    """Every round as one loop over device tensors, with no host wait (the
    K = max_iter case of the segmented loop, without its boundary fetch)."""
    device = _carry_device(initial_carry, device)
    carry, _, _ = _device_rounds(_as_tensors(initial_carry, device), body,
                                 terminate, 0, max_iter, device)
    return carry


def _host_loop(initial_carry, body, max_iter, terminate, config, listeners,
               jit_round: bool = True):
    """Host-driven rounds with listener and checkpoint hooks.

    A round's stop stays on the device while the listeners and the
    checkpoint run; then one fetch reads it, the only host wait of a round
    beyond what a listener or a save asks for. With ``jit_round=False`` the
    body is plain host code and its stop is read at once."""
    carry = initial_carry
    start_epoch = 0
    mgr = config.checkpoint_manager
    if mgr is not None:
        restored = mgr.restore(carry)
        if restored is not None:
            carry, start_epoch = restored

    for epoch in range(start_epoch, max_iter):
        if config.per_round_init is not None:
            carry = config.per_round_init(carry, epoch)
        carry = body(carry, epoch)
        stop = terminate(carry, epoch) if terminate is not None else False
        if not jit_round:
            stop = bool(stop)
        faults.inject("epoch-boundary", epoch=epoch)
        for lst in listeners:
            lst.on_epoch_watermark_incremented(epoch, carry)
        if mgr is not None and config.checkpoint_interval and \
                (epoch + 1) % config.checkpoint_interval == 0:
            mgr.save(carry, epoch + 1)
        if bool(stop):
            break
    for lst in listeners:
        lst.on_iteration_terminated(carry)
    if mgr is not None:
        # the iteration completed: discard its checkpoints so a later run
        # against the same manager starts fresh (the reference likewise
        # discards checkpoints on job success); a crash skips this
        mgr.clear()
    return carry


class Iterations:
    """Namespace parity with iteration/Iterations.java."""

    iterate_bounded_streams_until_termination = staticmethod(iterate_bounded)
