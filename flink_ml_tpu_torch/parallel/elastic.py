"""Elastic multi-process training: survive the loss of a worker mid-fit.

The port of ``flink_ml_tpu/parallel/elastic.py:106-616``. A multi-process
fit (``distributed.py``) runs in lockstep: one process stops answering and
every survivor wedges in its next collective. This module turns that into a
supervised, observable recovery:

**Detection.** A collective deadline (``FLINK_ML_TPU_COLLECTIVE_TIMEOUT_S``):
the iteration drivers guard their boundary fetches through
:func:`guard_fetch`, which waits for the device on a watchdog thread and,
past the deadline, reads the per-process heartbeats (fleet beacons, beaten
at every epoch boundary by :func:`on_boundary`) to name the stale process,
raising a retryable :class:`~flink_ml_tpu_torch.resilience.policy.WorkerLost`
instead of hanging. The launcher's processes also take the deadline as
their process group's timeout (``distributed.init_distributed``), since a
gloo collective blocks the calling thread itself.

**Recovery.** :func:`run_elastic` drives a launched fit through
``resilience.run_supervised``: when a child dies by a signal (killed, or
grace-killed after wedging), the driver names the first such death, shrinks
the world by one and relaunches the survivors as a smaller mesh; the
children resume from the newest v2 checkpoint manifest with their 1/N
slices re-placed across the changed N (:class:`ElasticCheckpointManager`:
``repad_dim0`` and :func:`repad_or_rescale`). Below ``min_processes`` the
elastic budget is spent: ``RestartsExhausted(budget="elastic")``.

**Partial participation.** :class:`RoundParticipation` drops a shard whose
previous round missed ``FLINK_ML_TPU_ROUND_DEADLINE_MS`` (its include flag
goes to 0 and ``collective.renormalized_sum`` rescales the others), with
the staleness bound that readmits it after ``max_staleness`` drops; a round
never drops every shard.

Telemetry rides ``ml.elastic``: ``participation{round=}`` gauges,
``droppedContributions{shard=}``, ``workerLost``, ``relaunches`` and
``collectiveTimeouts`` counters, a ``processCount`` gauge, and
``elastic.worker-lost`` / ``elastic.relaunch`` / ``elastic.participation``
/ ``elastic.chaos`` trace events. :func:`provenance` feeds
``elasticEvents`` and ``participationMin`` to the benchmark rows
(``update_sharding.provenance``) and to the fleet beacons.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from flink_ml_tpu_torch.common.metrics import ML_GROUP, metrics
from flink_ml_tpu_torch.iteration.checkpoint import (
    CheckpointManager, CorruptCheckpoint, repad_leading, tree_flatten)
from flink_ml_tpu_torch.observability import tracing
from flink_ml_tpu_torch.parallel import distributed
from flink_ml_tpu_torch.resilience import faults
from flink_ml_tpu_torch.resilience.policy import (RestartsExhausted,
                                                  RetryPolicy, WorkerLost)

#: env mapping, the JAX package's names
COLLECTIVE_TIMEOUT_ENV = "FLINK_ML_TPU_COLLECTIVE_TIMEOUT_S"
ROUND_DEADLINE_ENV = "FLINK_ML_TPU_ROUND_DEADLINE_MS"
HEARTBEAT_DIR_ENV = "FLINK_ML_TPU_HEARTBEAT_DIR"
#: which process index the worker-loss / worker-hang chaos sites strike
#: (every process advances the same schedule; only the victim acts)
CHAOS_VICTIM_ENV = "FLINK_ML_TPU_CHAOS_VICTIM"
#: how long a worker-hang victim stalls (default: 3x the deadline)
CHAOS_HANG_ENV = "FLINK_ML_TPU_CHAOS_HANG_S"
#: set by run_elastic in every child: the 0-based attempt index
ATTEMPT_ENV = "FLINK_ML_TPU_ELASTIC_ATTEMPT"

__all__ = [
    "COLLECTIVE_TIMEOUT_ENV", "ROUND_DEADLINE_ENV", "HEARTBEAT_DIR_ENV",
    "CHAOS_VICTIM_ENV", "CHAOS_HANG_ENV", "ATTEMPT_ENV",
    "collective_timeout_s", "round_deadline_ms", "beat", "stale_processes",
    "on_boundary", "guard_fetch", "wait_with_deadline",
    "RoundParticipation", "repad_or_rescale", "ElasticCheckpointManager",
    "run_elastic", "provenance", "reset_stats",
]

#: fit-scoped elastic provenance (reset per benchmark run)
_STATS = {"workerLost": 0, "relaunches": 0, "droppedRounds": 0,
          "participationMin": 1.0}


def _elastic_group():
    return metrics.group(ML_GROUP, "elastic")


def _event(name: str, **attrs) -> None:
    """A trace event; telemetry must never sink the recovery it
    describes."""
    try:
        tracing.tracer.event(name, **attrs)
    except Exception:  # noqa: BLE001
        pass


def _env_float(name: str) -> Optional[float]:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return None
    try:
        return float(raw)
    except ValueError:
        import logging

        logging.getLogger(__name__).warning(
            "%s=%r is not a number; ignoring it", name, raw)
        return None


def collective_timeout_s() -> Optional[float]:
    """The collective deadline in seconds, or None (detection off, the
    default: a deadline only makes sense where a peer can die)."""
    val = _env_float(COLLECTIVE_TIMEOUT_ENV)
    return val if val and val > 0 else None


def round_deadline_ms() -> Optional[float]:
    """The straggler round deadline in ms, or None (actuator off)."""
    val = _env_float(ROUND_DEADLINE_ENV)
    return val if val and val > 0 else None


# -- heartbeats: a heartbeat is a fleet beacon --------------------------------

def _hb_dir() -> Optional[str]:
    return os.environ.get(HEARTBEAT_DIR_ENV) or None


def beat(epoch: Optional[int] = None) -> None:
    """Write this process's liveness stamp, a fleet beacon
    (``observability/fleet.py``, atomic replace). No-op without
    ``FLINK_ML_TPU_HEARTBEAT_DIR``; never raises."""
    base = _hb_dir()
    if not base:
        return
    try:
        from flink_ml_tpu_torch.observability import fleet

        fleet.write_beacon(base, role="trainer", epoch=epoch)
    except Exception:  # noqa: BLE001 — liveness must not sink the fit
        pass


def stale_processes(timeout_s: float,
                    num_processes: Optional[int] = None) -> List[int]:
    """Process indices whose beacon is missing or older than
    ``timeout_s`` (``fleet.stale_member_indices``); empty without a
    heartbeat dir (the caller then reports an unidentified loss)."""
    base = _hb_dir()
    if not base:
        return []
    from flink_ml_tpu_torch.observability import fleet

    n = (num_processes if num_processes is not None
         else distributed.process_count())
    return fleet.stale_member_indices(base, timeout_s,
                                      num_processes=int(n))


# -- detection ----------------------------------------------------------------

def _block_until_ready(tree) -> None:
    """Wait for the device work behind every CUDA tensor of ``tree``."""
    leaves, _ = tree_flatten(tree)
    devices = {leaf.device for leaf in leaves
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


def wait_with_deadline(tree, timeout_s: float, what: str = "collective"):
    """Block until ``tree``'s device work is done, but give up after
    ``timeout_s``: the wait runs on a watchdog thread, and a missed
    deadline reads the heartbeats to name the dead peer and raises
    :class:`WorkerLost` (retryable). An error of the wait itself is raised
    on the caller's thread."""
    box = {}
    done = threading.Event()

    def work():
        try:
            _block_until_ready(tree)
        except Exception as e:  # noqa: BLE001 — re-raised on the caller
            box["err"] = e
        done.set()

    threading.Thread(target=work, daemon=True,
                     name="flink-ml-tpu-collective-watchdog").start()
    if not done.wait(timeout_s):
        stale = stale_processes(timeout_s)
        idx = stale[0] if stale else None
        _STATS["workerLost"] += 1
        _elastic_group().counter("collectiveTimeouts")
        _event("elastic.worker-lost", process=idx, timeout_s=timeout_s,
               what=what)
        raise WorkerLost(idx, f"{what} deadline exceeded",
                         timeout_s=timeout_s)
    if "err" in box:
        raise box["err"]
    return tree


def guard_fetch(tree, what: str = "boundary"):
    """The iteration drivers' hook: :func:`wait_with_deadline` when the
    collective deadline is armed, else the tree as it is (one env read)."""
    timeout = collective_timeout_s()
    if timeout is None:
        return tree
    return wait_with_deadline(tree, timeout, what=what)


# -- the boundary hook --------------------------------------------------------

def _chaos_probe(epoch: Optional[int]) -> None:
    """The ``worker-loss`` and ``worker-hang`` fault sites
    (``resilience/faults.py``). Only in a multi-process runtime: a SIGKILL
    site must never fire in a single-process run. Every process advances
    the same schedule; only the victim (``FLINK_ML_TPU_CHAOS_VICTIM``,
    default 1) acts: it kills itself, or stalls past the deadline."""
    if distributed.process_count() <= 1:
        return
    raw = os.environ.get(CHAOS_VICTIM_ENV, "").strip()
    victim = int(raw) if raw.lstrip("-").isdigit() else 1
    if faults.decide("worker-loss"):
        if distributed.process_index() == victim:
            _event("elastic.chaos", site="worker-loss", epoch=epoch,
                   process=victim)
            os.kill(os.getpid(), signal.SIGKILL)
    if faults.decide("worker-hang"):
        if distributed.process_index() == victim:
            hang = _env_float(CHAOS_HANG_ENV)
            if hang is None:
                hang = 3.0 * (collective_timeout_s() or 40.0)
            _event("elastic.chaos", site="worker-hang", epoch=epoch,
                   process=victim, hang_s=hang)
            time.sleep(hang)


def on_boundary(epoch: Optional[int] = None) -> None:
    """Called by the iteration drivers at every epoch or segment boundary:
    beat the heartbeat and consult the worker-loss / worker-hang sites.
    Unarmed (no heartbeat dir, no chaos plan) it costs two env reads."""
    beat(epoch)
    if faults.active_plan() is not None:
        _chaos_probe(epoch)


# -- partial participation ----------------------------------------------------

class RoundParticipation:
    """Straggler-aware round inclusion with JiT-style staleness bookkeeping
    (arXiv:2208.09740): :meth:`decide` gives the per-shard 0/1 include
    vector of a round from the previous round's readiness timings
    (:meth:`observe`); a shard slower than the deadline is dropped for one
    round, and after ``max_staleness`` consecutive drops it is readmitted.
    A round never drops every shard."""

    def __init__(self, n_shards: int, deadline_ms: Optional[float] = None,
                 max_staleness: int = 3):
        self.n_shards = int(n_shards)
        self.deadline_ms = (deadline_ms if deadline_ms is not None
                            else round_deadline_ms())
        self.max_staleness = int(max_staleness)
        self._last_ms: Optional[np.ndarray] = None
        self._staleness = np.zeros(self.n_shards, dtype=np.int64)
        self.rounds = 0
        self.dropped_rounds = 0
        self.participation_min = 1.0

    def observe(self, ready_ms: Sequence[float]) -> None:
        """Record this round's per-shard readiness (ms), which decides the
        next round; also feeds the skew detector (``ml.skew`` events)."""
        vals = np.asarray(list(ready_ms), dtype=np.float64)
        if vals.shape != (self.n_shards,):
            raise ValueError(
                f"expected {self.n_shards} per-shard timings, got "
                f"shape {vals.shape}")
        self._last_ms = vals
        try:
            from flink_ml_tpu_torch.observability import meshstats

            meshstats.detect_skew("elastic-round", vals.tolist())
        except Exception:  # noqa: BLE001
            pass

    def decide(self, round_idx: int) -> np.ndarray:
        """The include vector (float 0/1, length ``n_shards``) of this
        round; records ``ml.elastic participation{round=}`` and
        ``droppedContributions{shard=}`` and, when a shard is dropped, an
        ``elastic.participation`` event."""
        include = np.ones(self.n_shards, dtype=np.float64)
        if self.deadline_ms and self._last_ms is not None:
            slow = self._last_ms > float(self.deadline_ms)
            drop = slow & (self._staleness < self.max_staleness)
            if drop.all():  # never drop every shard
                drop[:] = False
            include[drop] = 0.0
            self._staleness = np.where(drop, self._staleness + 1, 0)
        else:
            self._staleness[:] = 0
        self.rounds += 1
        participating = int(include.sum())
        fraction = participating / self.n_shards
        self.participation_min = min(self.participation_min, fraction)
        _STATS["participationMin"] = min(_STATS["participationMin"],
                                         fraction)
        group = _elastic_group()
        group.gauge("participation", participating,
                    labels={"round": str(int(round_idx))})
        if participating < self.n_shards:
            self.dropped_rounds += 1
            _STATS["droppedRounds"] += 1
            dropped = [int(k) for k in np.flatnonzero(include == 0.0)]
            for k in dropped:
                group.counter("droppedContributions",
                              labels={"shard": str(k)})
            _event("elastic.participation", round=int(round_idx),
                   participating=participating, dropped=dropped,
                   staleness_max=int(self._staleness.max()))
        return include


# -- checkpoints across a changed shard count ---------------------------------

def repad_or_rescale(host: np.ndarray, target_shape) -> np.ndarray:
    """One carry leaf re-placed across a changed shard count.

    Float state (coefficients, the sharded moments) carries the update
    sharding's inert dim-0 zero padding: trimmed or re-extended
    (``checkpoint.repad_leading``). A 1-D integer leaf whose entries are
    all equal is per-shard round-robin progress (the SGD carry's window
    offsets): its global position is ``offset * n_old``, and the new
    world's per-shard offset is that over ``n_new``, exact when ``n_new``
    divides it; otherwise the checkpoint does not fit the new world
    (:class:`CorruptCheckpoint`, routed to quarantine and fallback)."""
    target_shape = tuple(int(s) for s in target_shape)
    if (tuple(host.shape) == target_shape or host.ndim != 1
            or len(target_shape) != 1
            or not np.issubdtype(host.dtype, np.integer)):
        return repad_leading(host, target_shape)
    n_old, n_new = host.shape[0], target_shape[0]
    if n_old == 0 or n_new == 0:
        return repad_leading(host, target_shape)
    if np.any(host != host[0]):
        raise CorruptCheckpoint(
            f"per-shard integer progress {host.tolist()} is not uniform"
            f" — cannot re-place {n_old} shards onto {n_new}")
    progress = int(host[0]) * n_old
    if progress % n_new:
        raise CorruptCheckpoint(
            f"per-shard progress {int(host[0])} x {n_old} shards does "
            f"not divide across {n_new} shards")
    return np.full(target_shape, progress // n_new, dtype=host.dtype)


def _host_tree(tree):
    """The tree with every leaf a host array: a sharded leaf as its global
    view (an all-gather over the ranks, so every process must call this in
    lockstep), a tensor through ``.cpu()``."""
    from flink_ml_tpu_torch.iteration.checkpoint import _host_leaf

    leaves, treedef = tree_flatten(tree)
    return treedef.unflatten([_host_leaf(leaf) for leaf in leaves])


class ElasticCheckpointManager(CheckpointManager):
    """Checkpoints that survive a mesh over processes and a changed
    process count.

    Save: every process gathers the carry's sharded leaves to the host (in
    lockstep, as the iteration drivers call ``save``), and only process 0
    writes the shared directory: one v2 manifest, no write races.

    Restore: every process reads the same manifest; leaves re-place across
    a changed N (``repad_dim0`` on by default, :func:`repad_or_rescale`)
    and land on the template's layout, each process keeping its own
    shards' slices (``Sharded.like_global``)."""

    def __init__(self, base_dir: str, keep: int = 2,
                 repad_dim0: bool = True):
        super().__init__(base_dir, keep=keep, repad_dim0=repad_dim0)

    def save(self, carry, epoch: int, extras=None) -> str:
        host = _host_tree(carry)
        if distributed.process_index() != 0:
            return os.path.join(self.base_dir, f"ckpt-{epoch:08d}")
        return super().save(host, epoch, extras=extras)

    def clear(self) -> None:
        if distributed.process_index() == 0:
            super().clear()

    def _repad(self, host: np.ndarray, target_shape) -> np.ndarray:
        return repad_or_rescale(host, target_shape)


# -- recovery: the supervised relaunch driver ---------------------------------

def run_elastic(argv: Sequence[str], num_processes: int,
                min_processes: int = 1, local_devices: int = 1,
                env: Optional[dict] = None, timeout: float = 900.0,
                policy: Optional[RetryPolicy] = None, listeners=(),
                heartbeat_dir: Optional[str] = None,
                child_grace_s: float = 30.0,
                device: str = "cuda") -> List[dict]:
    """Drive a launched multi-process fit elastically: on worker loss,
    rebuild smaller and resume.

    Each attempt launches ``argv`` at the current world size through
    ``distributed.launch`` (``device``, the per-child grace). A child that
    dies by a signal is a :class:`WorkerLost`: the first such death is the
    victim (later ones are the launcher's grace-kills of its wedged
    siblings), the world shrinks by one and ``run_supervised`` retries
    (backoff, restart and deadline budgets, ``on_restart`` listeners); the
    next attempt's children build the smaller mesh and resume from the
    shared checkpoint dir (the worker program owns that). A nonzero exit
    without a signal death is an ordinary retryable failure at the same
    world size. Below ``min_processes`` the elastic budget is spent:
    :class:`RestartsExhausted` with ``budget="elastic"``, as when the
    supervisor's own budget runs out while losses continue. Every child
    gets ``FLINK_ML_TPU_ELASTIC_ATTEMPT`` and, with ``heartbeat_dir``, a
    heartbeat dir of its own attempt. Returns the successful attempt's
    launch records."""
    from flink_ml_tpu_torch.resilience.supervisor import run_supervised

    if int(num_processes) < int(min_processes):
        raise ValueError(
            f"num_processes={num_processes} < min_processes="
            f"{min_processes}")
    state = {"n": int(num_processes), "attempt": 0}

    def attempt() -> List[dict]:
        n = state["n"]
        attempt_idx = state["attempt"]
        state["attempt"] += 1
        child_env = dict(env or {})
        child_env[ATTEMPT_ENV] = str(attempt_idx)
        if heartbeat_dir:
            # a dead process's stale beat must not haunt the next world
            child_env[HEARTBEAT_DIR_ENV] = os.path.join(
                heartbeat_dir, f"attempt-{attempt_idx}")
        group = _elastic_group()
        group.gauge("processCount", n)
        if attempt_idx:
            _STATS["relaunches"] += 1
            group.counter("relaunches")
            _event("elastic.relaunch", attempt=attempt_idx, processes=n)
        records = distributed.launch(
            argv, n, local_devices=local_devices, env=child_env,
            timeout=timeout, child_grace_s=child_grace_s, device=device)
        failed = [r for r in records if r["returncode"] != 0]
        if not failed:
            return records
        signaled = [r for r in failed if r["returncode"] < 0]
        if not signaled:
            raise RuntimeError(
                f"elastic attempt {attempt_idx}: {len(failed)} of {n} "
                f"processes failed (rc={failed[0]['returncode']}) "
                f"without a signal death:\n{failed[0]['stderr'][-2000:]}")
        first = min(signaled,
                    key=lambda r: (r.get("exitOrder") is None,
                                   r.get("exitOrder") or 0))
        dead = first["process"]
        _STATS["workerLost"] += 1
        group.counter("workerLost")
        _event("elastic.worker-lost", process=dead,
               returncode=first["returncode"], processes=n)
        if n - 1 < int(min_processes):
            raise RestartsExhausted(
                attempt_idx,
                f"elastic budget exhausted: lost process {dead} at "
                f"world size {n}, floor is min_processes="
                f"{min_processes}", budget="elastic")
        state["n"] = n - 1
        raise WorkerLost(
            dead, f"child killed by signal {-first['returncode']} at "
                  f"world size {n}")

    try:
        return run_supervised(attempt, policy=policy, listeners=listeners)
    except RestartsExhausted as e:
        if e.budget == "elastic":
            raise
        raise RestartsExhausted(
            e.attempts, "elastic restart budget exhausted",
            budget="elastic") from e


# -- provenance ---------------------------------------------------------------

def provenance() -> dict:
    """``elasticEvents`` (worker losses + relaunches + straggler-dropped
    rounds this run) and ``participationMin`` (the worst round
    participation; 1.0 when no round dropped a shard)."""
    events = (_STATS["workerLost"] + _STATS["relaunches"]
              + _STATS["droppedRounds"])
    return {"elasticEvents": int(events),
            "participationMin": float(_STATS["participationMin"])}


def reset_stats() -> None:
    """Zero the fit-scoped elastic stats (the benchmark runner calls this
    beside ``update_sharding.reset_last``)."""
    _STATS.update(workerLost=0, relaunches=0, droppedRounds=0,
                  participationMin=1.0)
