"""Versioned model registry: atomic hot-swap from checkpointed model
data, with integrity + health vetting and rollback.

The port of ``flink_ml_tpu/serving/registry.py`` on the port's checkpoint
manager (iteration/checkpoint.py). Checkpoints of both packages are the
same bytes, so a model either package publishes is adopted by either
package's registry, with its drift and quality baselines.

The reference's signature capability is unbounded iteration — models
that keep training while serving (OnlineLogisticRegression's
model-version broadcast). This module is the serving half of that
handoff, in the "Just-in-Time Aggregation" shape (arXiv:2208.09740):
the trainer publishes model snapshots asynchronously, the server folds
each one in with no global barrier — requests never stop.

- **publish** (:func:`publish_model`, trainer side): model arrays land
  as iteration/checkpoint.py checkpoints — v2 manifests with per-leaf
  sha256 digests, fsync-before-atomic-rename — under a watch directory,
  one ``ckpt-<version>`` per model version.
- **watch** (:meth:`ModelRegistry.poll`, or the background watcher
  thread): the newest unseen version is validated against its manifest
  (:func:`~flink_ml_tpu_torch.iteration.checkpoint.load_validated` — a
  bit-flipped snapshot is quarantined ``*.corrupt`` and never loaded),
  its leaves checked finite, loaded into a candidate servable, and
  **probed**: one synthetic transform whose PR 5
  prediction-distribution gauges (``ml.serving *FiniteFraction``) must
  read 1.0 — a NaN-producing candidate is rejected before it ever sees
  a request.
- **swap**: on pass, the candidate (labeled ``<model>@v<N>`` via
  ``serving_name``, so spans/histograms/SLOs split by version) becomes
  :attr:`ModelRegistry.active` in one atomic assignment. The
  micro-batcher resolves the provider once per tick, so in-flight
  batches complete on the version they were dispatched with. On ANY
  failure the registry **rolls back** by construction — the serving
  version was never replaced — records ``swapRejected{model=,reason=}``
  + a ``serving.swap.rejected`` event, and remembers the version so a
  bad candidate is not re-probed every poll
  (:class:`~flink_ml_tpu_torch.resilience.policy.CandidateRejected` is
  terminal: the same snapshot re-validates to the same verdict).
- **canary** (:meth:`ModelRegistry.set_canary` /
  :meth:`~ModelRegistry.resolve`, the ops controller's rollout seam,
  serving/controller.py): a probed candidate can ride beside ``active``
  at a traffic fraction — :meth:`resolve` (what the micro-batcher calls
  each tick) returns the canary for that share of ticks — and is either
  **promoted** (:meth:`~ModelRegistry.promote_canary`, the committed
  swap) or dropped.
- **rollback** (:meth:`ModelRegistry.rollback`): first-class demotion —
  re-activates the prior adopted version from the in-process history
  WITHOUT re-probe (it already served healthily; re-validating it could
  only lose time while a bad version keeps serving), remembers the
  demoted version so the watcher never re-adopts it, records
  ``rollbacks{model=,reason=}`` + a ``serving.rollback`` event, and
  forgets the demoted version's live drift state
  (:func:`~flink_ml_tpu_torch.observability.drift.forget_servable`) so a
  later re-canary of the same model seeds fresh windows instead of
  inheriting the stale violated ones.

The watcher thread is supervised: an exception escaping the poll loop
restarts it with exponential backoff (counted
``watcherRestarts{model=}``) instead of silently killing hot-swap for
the rest of the process.

The canary and rollback seams are the ops controller's
(serving/controller.py), and a rollback records a ``rollback`` incident
bundle (observability/flightrecorder.py).
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from flink_ml_tpu_torch.common.locks import (
    install_thread_excepthook,
    make_lock,
)
from flink_ml_tpu_torch.common.metrics import ML_GROUP, metrics
from flink_ml_tpu_torch.iteration.checkpoint import (
    CheckpointManager,
    CorruptCheckpoint,
    list_checkpoint_names,
    load_validated,
    quarantine_checkpoint,
)
from flink_ml_tpu_torch.observability import tracing
from flink_ml_tpu_torch.resilience import faults
from flink_ml_tpu_torch.resilience.policy import (
    CandidateRejected,
    RetryableFailure,
)
from flink_ml_tpu_torch.servable.api import serving_name

__all__ = ["publish_model", "ModelRegistry"]

#: adopted (version, servable) pairs kept for :meth:`ModelRegistry
#: .rollback` — v(N-1) must be re-activatable without touching disk
HISTORY_KEEP = 4


def publish_model(watch_dir: str, leaves, version: int,
                  keep: int = 8, baseline=None,
                  quality_baseline=None) -> str:
    """Trainer-side publish: write model ``leaves`` (a list/pytree of
    arrays) as checkpoint version ``version`` under ``watch_dir`` —
    v2 manifest, fsynced, atomically renamed — and return the published
    path. The serving registry's watcher picks it up on its next poll.

    ``baseline`` (a :class:`~flink_ml_tpu_torch.observability.drift
    .DriftBaseline`, typically the fitted model's ``drift_baseline``
    captured by the traced-fit seam) is serialized as
    ``drift-baseline.json`` beside the manifest inside the same atomic
    rename, so the watcher installs the *matching* training-time
    distribution summary with every hot-swap; publishing without one is
    fine — drift evaluation then reports ``source: missing``.

    ``quality_baseline`` (a :class:`~flink_ml_tpu_torch.observability
    .evaluation.QualityBaseline`, the fitted model's
    ``quality_baseline`` captured at fit time from training-set scores
    vs labels) rides the same atomic rename as
    ``quality-baseline.json`` — the live-AUC reference the continuous
    evaluation plane judges this version against."""
    manager = CheckpointManager(watch_dir, keep=keep)
    extras = {}
    if baseline is not None:
        from flink_ml_tpu_torch.observability import drift

        extras[os.path.splitext(drift.BASELINE_FILENAME)[0]] = \
            baseline.to_json()
    if quality_baseline is not None:
        from flink_ml_tpu_torch.observability import evaluation

        extras[os.path.splitext(evaluation.BASELINE_FILENAME)[0]] = \
            quality_baseline.to_json()
    return manager.save(leaves, int(version), extras=extras or None)


class ModelRegistry:
    """Watches a publish directory and hot-swaps validated, healthy
    model versions into :attr:`active`.

    ``loader(leaves, version)`` builds a servable from validated host
    arrays; ``probe`` (optional, a zero-arg factory of a small request
    DataFrame) gates every candidate behind one real transform plus the
    prediction-distribution finite check. ``health_check`` (optional,
    ``servable -> bool``) adds a custom gate — return falsy or raise to
    reject. ``mesh`` (optional) is asserted on every candidate before
    its probe, so a candidate is probed on the dispatch it will serve
    with."""

    def __init__(self, watch_dir: str,
                 loader: Callable[[List[np.ndarray], int], object],
                 model: str = "model",
                 probe: Optional[Callable[[], object]] = None,
                 health_check: Optional[Callable[[object], bool]] = None,
                 poll_interval_s: float = 1.0,
                 mesh=None):
        self.watch_dir = watch_dir
        self.model = model
        self._loader = loader
        self._probe = probe
        self._health_check = health_check
        #: dispatch mesh asserted on every candidate BEFORE its probe
        self._mesh = mesh
        self.poll_interval_s = float(poll_interval_s)
        self._lock = make_lock("serving.registry")
        self._active = None
        self._version: Optional[int] = None
        self._rejected: set = set()
        #: versions a rollout owner (the ops controller) has claimed:
        #: the watcher must not adopt them directly — they go through
        #: the staged canary path instead (docs/ops.md)
        self._held: set = set()
        #: adopted (version, servable) pairs, newest last — rollback's
        #: source of truth for "the prior version", capped HISTORY_KEEP
        self._history: List[Tuple[int, object]] = []
        #: (servable, version) riding beside active at _canary_fraction
        self._canary: Optional[Tuple[object, int]] = None
        self._canary_fraction = 0.0
        # seeded: a fixed seed makes the canary tick split reproducible
        # for tests; production cares only about the long-run fraction
        self._canary_rng = random.Random(0)
        self._watcher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._group = metrics.group(ML_GROUP, "serving")

    # -- the serving side ----------------------------------------------------
    @property
    def active(self):
        """The committed serving servable (None before the first
        successful swap). One atomic read — safe from any thread."""
        return self._active  # torchlint: disable=unguarded-shared-state -- one atomic reference read; swaps replace the object under the lock

    @property
    def version(self) -> Optional[int]:
        return self._version  # torchlint: disable=unguarded-shared-state -- one atomic int read; the serving path tolerates a stale version

    @property
    def canary_version(self) -> Optional[int]:
        canary = self._canary  # torchlint: disable=unguarded-shared-state -- one atomic tuple read, unpacked from the local snapshot
        return canary[1] if canary is not None else None

    @property
    def canary_fraction(self) -> float:
        return self._canary_fraction if self._canary is not None else 0.0  # torchlint: disable=unguarded-shared-state -- per-tick routing reads a snapshot; a stale fraction skews one tick

    def resolve(self):
        """The servable for ONE dispatch tick: the canary for
        ``canary_fraction`` of ticks, the committed ``active`` for the
        rest. THE provider seam the micro-batcher prefers over
        ``active`` — a staged rollout needs per-tick routing, and the
        batcher already resolves once per tick so in-flight batches
        complete on the version they were dispatched with."""
        canary = self._canary  # torchlint: disable=unguarded-shared-state -- resolve snapshots the canary tuple once; ticks tolerate staleness
        if canary is not None:
            fraction = self._canary_fraction  # torchlint: disable=unguarded-shared-state -- a stale fraction mis-routes at most the current tick
            if fraction >= 1.0 or (fraction > 0.0
                                   and self._canary_rng.random()
                                   < fraction):
                return canary[0]
        return self._active  # torchlint: disable=unguarded-shared-state -- fallback is the same atomic read the active property makes

    # -- candidate discovery -------------------------------------------------
    def _published_versions(self) -> List[int]:
        return [int(name[len("ckpt-"):])
                for name in list_checkpoint_names(self.watch_dir)]

    def published_versions(self) -> List[int]:
        """Versions currently published under the watch dir — how the
        ops controller picks the next free version number."""
        return self._published_versions()

    def record_rejection(self, version: int, reason: str,
                         detail: str = "") -> None:
        """Remember ``version`` as rejected (the watcher never
        re-probes it) and record the ``swapRejected{model=,reason=}``
        counter + event — the one rejection bookkeeping path, shared by
        :meth:`poll` and callers driving :meth:`load_candidate`
        themselves (serving/controller.py)."""
        with self._lock:
            self._rejected.add(int(version))
        self._group.counter(
            "swapRejected",
            labels={"model": self.model, "reason": reason})
        tracing.tracer.event("serving.swap.rejected",
                             model=self.model, version=int(version),
                             reason=reason, detail=detail)

    def hold_version(self, version: int) -> None:
        """Claim ``version`` for a staged rollout: :meth:`poll` skips
        it, so a running watcher cannot adopt it directly while the
        ops controller canaries it. Released by :meth:`release_version`
        (and implicitly by rollback/drop, which condemn or free it)."""
        with self._lock:
            self._held.add(int(version))

    def release_version(self, version: int) -> None:
        with self._lock:
            self._held.discard(int(version))

    def poll(self) -> bool:
        """One watcher step: consider published versions newer than the
        serving one, newest first; adopt the first that validates and
        passes health checks. Returns True when a swap happened. Never
        raises on a bad candidate — rejection is recorded, the serving
        version keeps serving (rollback by construction). Versions
        held for a staged rollout (:meth:`hold_version`) or currently
        riding as the canary are skipped — adopting them here would
        bypass the ramp and bake gates."""
        # one consistent snapshot of the swap state; the dir scan and
        # the adopt work run lock-free on the copies
        with self._lock:
            current = self._version
            canary = self._canary
            rejected = set(self._rejected)
            held = set(self._held)
        canary_version = canary[1] if canary is not None else None
        fresh = [v for v in self._published_versions()
                 if (current is None or v > current)
                 and v not in rejected
                 and v not in held
                 and v != canary_version]
        for version in reversed(fresh):
            try:
                self._adopt(version)
                return True
            except CandidateRejected as e:
                reason, detail = e.reason, str(e)
            except RetryableFailure as e:
                # transient (an injected canary-probe/model-swap fault,
                # an I/O hiccup mid-load): the snapshot itself is not
                # condemned — do NOT remember it; the next poll sees the
                # same version as a fresh candidate and retries
                self._group.counter(
                    "swapRetried", labels={"model": self.model})
                tracing.tracer.event("serving.swap.retry",
                                     model=self.model, version=version,
                                     error=type(e).__name__,
                                     detail=str(e))
                return False
            except Exception as e:  # noqa: BLE001 — the never-raises
                # contract: ANY failure between load and swap (a loader
                # returning a __slots__ object that rejects the
                # serving_name assignment, a gauge scan tripping on
                # junk) is a rejected candidate, recorded and
                # remembered — never a crashed watcher or a re-probe
                # loop
                reason = "internal-error"
                detail = f"{type(e).__name__}: {e}"
            self.record_rejection(version, reason, detail)
        return False

    def _adopt(self, version: int) -> None:
        # the registry-adopt rung of the boot ladder (a no-op once the
        # process marked ready — steady-state adoptions are not boot)
        from flink_ml_tpu_torch.observability import profiling

        with profiling.boot_phase("registry-adopt"):
            candidate = self.load_candidate(version)
            self._commit(candidate, version)

    def load_candidate(self, version: int):
        """Validate, load, baseline-install and probe published version
        ``version`` WITHOUT swapping it in — the canary entry point
        (serving/controller.py). Raises
        :class:`~flink_ml_tpu_torch.resilience.policy.CandidateRejected`
        (terminal — the data is what it is) on a bad candidate, or a
        retryable failure (e.g. an injected ``canary-probe`` fault) the
        caller's policy may re-enter."""
        ckpt_dir = os.path.join(self.watch_dir, f"ckpt-{version:08d}")
        try:
            leaves, epoch = load_validated(ckpt_dir)
        except CorruptCheckpoint as e:
            # rename-to-*.corrupt keeps the evidence AND stops the
            # watcher from revalidating the same torn snapshot forever
            quarantine_checkpoint(ckpt_dir, str(e))
            raise CandidateRejected(self.model, version, "corrupt",
                                    str(e)) from e
        for i, leaf in enumerate(leaves):
            arr = np.asarray(leaf)
            if (np.issubdtype(arr.dtype, np.floating)
                    and not np.isfinite(arr).all()):
                raise CandidateRejected(
                    self.model, version, "non-finite",
                    f"leaf_{i} has non-finite values")
        try:
            candidate = self._loader(leaves, epoch)
        except Exception as e:  # noqa: BLE001 — a loader crash is a
            # rejected candidate, never a crashed server
            raise CandidateRejected(self.model, version, "load-error",
                                    f"{type(e).__name__}: {e}") from e
        if self._mesh is not None and hasattr(candidate, "set_mesh"):
            candidate.set_mesh(self._mesh)
        candidate.serving_name = f"{self.model}@v{version}"
        # install the baseline BEFORE the probe: the probe's transform
        # runs through the _served seam, which creates the candidate's
        # live drift window — it must be seeded with the baseline's bin
        # edges at creation, not auto-range its own
        self._install_baseline(candidate.serving_name, ckpt_dir,
                               version)
        try:
            self._probe_candidate(candidate, version)
        except CandidateRejected:
            # a rejected candidate's versioned name never serves —
            # drop its drift state so it cannot linger as "missing"
            self._forget_baseline(candidate.serving_name)
            raise
        except RetryableFailure:
            # transient: the baseline stays installed — the retry will
            # re-probe through the same seeded window
            raise
        except Exception:
            self._forget_baseline(candidate.serving_name)
            raise
        return candidate

    def _commit(self, candidate, version: int) -> None:
        """The committed swap: one atomic assignment, history recorded.
        The ``model-swap`` chaos site fires here — an injected fault is
        retryable (nothing was mutated yet; the caller or the next poll
        re-enters)."""
        faults.inject("model-swap", model=self.model, version=version)
        with self._lock:
            previous = self._version
            self._active = candidate
            self._version = version
            if self._canary is not None and self._canary[1] == version:
                # promoting the riding canary: it stops being a canary
                self._canary = None
                self._canary_fraction = 0.0
            if self._history and self._history[-1][0] == version:
                # re-commit of the newest version (a retried swap):
                # replace, never duplicate — rollback() pops exactly
                # one entry per demotion
                self._history[-1] = (version, candidate)
            else:
                self._history.append((version, candidate))
            del self._history[:-HISTORY_KEEP]
        self._group.gauge("modelVersion", version,
                          labels={"model": self.model})
        self._group.counter("swaps", labels={"model": self.model})
        tracing.tracer.event("serving.swap", model=self.model,
                             version=version,
                             previous=previous if previous is not None
                             else "none")

    # -- canary rollout (the ops controller's seams) --------------------------
    def set_canary(self, candidate, version: int,
                   fraction: float = 0.0) -> None:
        """Install a probed candidate as the canary at ``fraction`` of
        dispatch ticks (:meth:`resolve`); ``active`` keeps serving the
        rest. Promote with :meth:`promote_canary`, demote with
        :meth:`rollback` (or :meth:`drop_canary` without condemning the
        version)."""
        if not 0.0 <= float(fraction) <= 1.0:
            raise ValueError("canary fraction must be in [0, 1]")
        with self._lock:
            self._canary = (candidate, int(version))
            self._canary_fraction = float(fraction)
        self._group.gauge("canaryVersion", int(version),
                          labels={"model": self.model})
        self._group.gauge("canaryFraction", float(fraction),
                          labels={"model": self.model})
        tracing.tracer.event("serving.canary", model=self.model,
                             version=int(version),
                             fraction=float(fraction))

    def set_canary_fraction(self, fraction: float) -> None:
        """Ramp the live canary's traffic share (a stage boundary)."""
        if not 0.0 <= float(fraction) <= 1.0:
            raise ValueError("canary fraction must be in [0, 1]")
        with self._lock:
            if self._canary is None:
                raise ValueError("no canary to ramp")
            self._canary_fraction = float(fraction)
            version = self._canary[1]
        self._group.gauge("canaryFraction", float(fraction),
                          labels={"model": self.model})
        tracing.tracer.event("serving.canary.ramp", model=self.model,
                             version=version,
                             fraction=float(fraction))

    def promote_canary(self) -> int:
        """Commit the canary as the serving version (THE swap of a
        staged rollout); returns the promoted version. Retryable on an
        injected ``model-swap`` fault — nothing is mutated until the
        commit."""
        canary = self._canary  # torchlint: disable=unguarded-shared-state -- snapshot-then-commit: _commit takes the lock before mutating
        if canary is None:
            raise ValueError("no canary to promote")
        candidate, version = canary
        self._commit(candidate, version)
        self._group.gauge("canaryFraction", 0.0,
                          labels={"model": self.model})
        self._group.gauge("canaryVersion", 0,
                          labels={"model": self.model})
        return version

    def drop_canary(self, reason: str = "dropped") -> Optional[int]:
        """Remove the canary WITHOUT condemning its version (e.g. the
        controller shutting down mid-ramp); returns the dropped version
        (None when no canary was live). The version stays adoptable —
        use :meth:`rollback` to also remember it as bad."""
        with self._lock:
            canary, self._canary = self._canary, None
            self._canary_fraction = 0.0
            if canary is not None:
                # a dropped canary's version is free again — including
                # for the watcher, which the hold/canary guards kept
                # away from it
                self._held.discard(canary[1])
        if canary is None:
            return None
        self._group.gauge("canaryFraction", 0.0,
                          labels={"model": self.model})
        self._group.gauge("canaryVersion", 0,  # 0 = none (v start at 1)
                          labels={"model": self.model})
        tracing.tracer.event("serving.canary.drop", model=self.model,
                             version=canary[1], reason=reason)
        return canary[1]

    def rollback(self, reason: str = "regression") -> Optional[int]:
        """First-class rollback: demote the newest adopted (or canary)
        version and re-activate the prior one from the in-process
        history WITHOUT re-probe — it already served healthily, and a
        re-probe would only keep a bad version serving longer. The
        demoted version is remembered (never re-adopted by the
        watcher), its live drift state is forgotten
        (:func:`~flink_ml_tpu_torch.observability.drift.forget_servable`) so
        a later re-canary seeds fresh windows, and the demotion is
        recorded ``rollbacks{model=,reason=}`` + a ``serving.rollback``
        event. Returns the version now serving.

        Raises ValueError (terminal) when there is no prior version to
        re-activate; retryable on an injected ``model-rollback`` fault
        (nothing is mutated before the injection point)."""
        faults.inject("model-rollback", model=self.model, reason=reason)
        with self._lock:
            if self._canary is not None:
                # mid-ramp demotion: active was never replaced — the
                # prior version IS the serving one; drop + condemn
                bad_version = self._canary[1]
                self._canary = None
                self._canary_fraction = 0.0
                restored = self._version
            else:
                if len(self._history) < 2:
                    raise ValueError(
                        f"no prior {self.model} version to roll back "
                        f"to (history: "
                        f"{[v for v, _ in self._history]})")
                bad_version = self._history[-1][0]
                self._history.pop()
                restored, self._active = self._history[-1]
                self._version = restored
            self._rejected.add(bad_version)
            self._held.discard(bad_version)
        self._group.counter(
            "rollbacks", labels={"model": self.model, "reason": reason})
        if restored is not None:
            self._group.gauge("modelVersion", restored,
                              labels={"model": self.model})
        self._group.gauge("canaryFraction", 0.0,
                          labels={"model": self.model})
        self._group.gauge("canaryVersion", 0,
                          labels={"model": self.model})
        tracing.tracer.event("serving.rollback", model=self.model,
                             demoted=bad_version,
                             restored=(restored if restored is not None
                                       else "none"),
                             reason=reason)
        try:
            # a rollback IS an incident: the evidence that condemned
            # the demoted version is in the span ring / windowed
            # metrics RIGHT NOW and rotates away — freeze it
            # (observability/flightrecorder.py; debounced, capped,
            # no-op without an armed trace dir)
            from flink_ml_tpu_torch.observability import flightrecorder

            flightrecorder.record_incident(
                "rollback", model=self.model, demoted=bad_version,
                restored=restored, reason=reason)
        except Exception:  # noqa: BLE001 — recording must never undo
            # the rollback that just protected serving
            pass
        # a demoted version's windows hold exactly the violated samples
        # that condemned it — a later re-canary of the same model must
        # seed fresh ones, not inherit the stale verdict
        self._forget_baseline(f"{self.model}@v{bad_version}")
        return restored

    def _install_baseline(self, serving_name: str, ckpt_dir: str,
                          version: int) -> None:
        """Install the drift baseline published beside this version's
        manifest (observability/drift.py), keyed by the VERSIONED
        serving name — so requests still in flight on the previous
        version keep comparing against the previous baseline. Runs
        BEFORE the candidate probe (whose transform creates the live
        window that must seed from these bin edges); a missing or
        unreadable baseline records ``source: missing`` / a
        ``baselineMissing`` counter and NEVER blocks the swap."""
        try:
            from flink_ml_tpu_torch.observability import drift
        except ImportError:  # pragma: no cover — drift rides the pkg
            return
        baseline = None
        try:
            baseline = drift.load_baseline_file(
                os.path.join(ckpt_dir, drift.BASELINE_FILENAME))
        except ValueError as e:
            tracing.tracer.event("serving.baseline.invalid",
                                 model=self.model, version=version,
                                 detail=str(e))
        if baseline is not None:
            # the registry's published version is the authoritative one
            # (the fit-side capture may carry the trainer's own counter)
            baseline.version = int(version)
        try:
            drift.install_baseline(serving_name, baseline)
        except Exception:  # noqa: BLE001 — telemetry must never undo
            # a committed swap
            pass
        if baseline is None:
            self._group.counter("baselineMissing",
                                labels={"model": self.model})
        self._install_quality_baseline(serving_name, ckpt_dir, version)

    def _install_quality_baseline(self, serving_name: str,
                                  ckpt_dir: str, version: int) -> None:
        """Same contract as :meth:`_install_baseline`, for the quality
        baseline (``quality-baseline.json``, observability/
        evaluation.py) — the training-set AUC reference the canary
        verdict's quality stage compares live AUC against. Missing is
        fine (evaluation reports ``source: missing``); never blocks."""
        try:
            from flink_ml_tpu_torch.observability import evaluation
        except ImportError:  # pragma: no cover — rides the pkg
            return
        baseline = None
        try:
            baseline = evaluation.load_baseline_file(
                os.path.join(ckpt_dir, evaluation.BASELINE_FILENAME))
        except ValueError as e:
            tracing.tracer.event("serving.quality_baseline.invalid",
                                 model=self.model, version=version,
                                 detail=str(e))
        if baseline is not None:
            baseline.version = int(version)
        try:
            evaluation.install_baseline(serving_name, baseline)
        except Exception:  # noqa: BLE001 — telemetry must never undo
            # a committed swap
            pass
        if baseline is None:
            self._group.counter("qualityBaselineMissing",
                                labels={"model": self.model})

    def _forget_baseline(self, serving_name: str) -> None:
        try:
            from flink_ml_tpu_torch.observability import drift

            drift.forget_servable(serving_name)
        except Exception:  # noqa: BLE001 — cleanup only; the rejection
            # (the real verdict) must propagate unchanged
            pass
        try:
            from flink_ml_tpu_torch.observability import evaluation

            evaluation.forget_servable(serving_name)
        except Exception:  # noqa: BLE001 — see above
            pass

    def _probe_candidate(self, candidate, version: int) -> None:
        # the chaos site fires OUTSIDE the rejection-conversion blocks:
        # an injected probe fault is transient infrastructure
        # (retryable), not a verdict on the candidate's data
        faults.inject("canary-probe", model=self.model, version=version)
        if self._probe is not None:
            try:
                candidate.transform(self._probe())
            except Exception as e:  # noqa: BLE001 — see _adopt
                raise CandidateRejected(
                    self.model, version, "probe-error",
                    f"{type(e).__name__}: {e}") from e
            # the probe transform just wrote this candidate's
            # prediction-distribution gauges (observability/health.py,
            # labeled by its serving_name) — the ready-made
            # accept/reject signal: anything non-finite rejects
            snap = self._group.snapshot().get("gauges", {})
            label = f'servable="{serving_name(candidate)}"'
            for key, value in snap.items():
                if "FiniteFraction" in key and label in key \
                        and float(value) < 1.0:
                    raise CandidateRejected(
                        self.model, version, "probe-non-finite",
                        f"{key} = {value}")
        if self._health_check is not None:
            try:
                verdict = self._health_check(candidate)
            except Exception as e:  # noqa: BLE001 — see _adopt
                raise CandidateRejected(
                    self.model, version, "health-check",
                    f"{type(e).__name__}: {e}") from e
            if not verdict:
                raise CandidateRejected(self.model, version,
                                        "health-check")

    # -- background watcher --------------------------------------------------
    def start_watcher(self) -> "ModelRegistry":
        if self._watcher is not None:
            return self
        # a crashing watcher must surface in telemetry, not die mute
        install_thread_excepthook()
        self._stop.clear()
        self._watcher = threading.Thread(
            target=self._watch_supervised,
            name="flink-ml-tpu-model-watcher", daemon=True)
        self._watcher.start()
        return self

    def _watch_supervised(self) -> None:
        """The watcher thread's real target: re-enter the poll loop
        with exponential backoff when an exception escapes it. Without
        this, one transient failure (a listdir ENOENT while the publish
        dir is being recreated, an event sink hiccup) would kill
        hot-swap silently for the rest of the process — the server keeps
        serving, new versions just never arrive."""
        restarts = 0
        while not self._stop.is_set():
            entered = time.monotonic()
            try:
                self._watch()
                return  # _stop was set: clean shutdown
            except Exception as e:  # noqa: BLE001 — ANY escape restarts
                if time.monotonic() - entered >= 60.0:
                    # a healthy stretch forgives the burst: unrelated
                    # one-off blips days apart must not escalate the
                    # backoff to the 30s cap for the process lifetime
                    restarts = 0
                restarts += 1
                self._group.counter("watcherRestarts",
                                    labels={"model": self.model})
                tracing.tracer.event("serving.watcher.restart",
                                     model=self.model,
                                     restarts=restarts,
                                     error=type(e).__name__,
                                     detail=str(e))
                # backoff from the poll cadence, capped at 30s — the
                # RetryPolicy curve without importing a fit-scoped
                # budget (the watcher must retry forever)
                delay = min(
                    max(self.poll_interval_s, 0.05)
                    * min(2.0 ** (restarts - 1), 64.0), 30.0)
                if self._stop.wait(delay):
                    return

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self.poll()

    def stop(self) -> None:
        if self._watcher is None:
            return
        self._stop.set()
        self._watcher.join(timeout=10.0)
        self._watcher = None

    def __enter__(self) -> "ModelRegistry":
        return self.start_watcher()

    def __exit__(self, *exc) -> None:
        self.stop()
