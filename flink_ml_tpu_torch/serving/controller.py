"""Self-healing ops controller: the closed train→serve→observe loop.

The port of ``flink_ml_tpu/serving/controller.py``: the same state
machine, triggers, events, counters and CLI verdicts, so the same traffic
and chaos plan walk both packages through the same transitions, and
either package's :func:`controller_summary` reads the other's trace dir.
The retrain seam runs the caller's refit on the card: in threaded mode
(:meth:`OpsController.start`) the controller's thread first names the
serving version's CUDA device as its current device (PyTorch keeps the
current device, and the cuBLAS handles, per thread), and a device fault
in a refit (``torch.AcceleratorError``, ``KernelLaunchError``,
``KernelBuildError``) is TERMINAL — the cycle ends ``failed`` after one
attempt with the active version untouched.

Everything below this module already exists as a dashboard — drift
verdicts against fit-time baselines (observability/drift.py), windowed
SLO burn rates (observability/slo.py), online FTRL with a warm-start
seam (models/online.py), atomic publish + probe-gated hot-swap
(serving/registry.py). This module is the actuator that connects them:
a supervised control loop that watches its own telemetry and reacts —
the continuous train-and-serve workload the reference's online
algorithms exist for, run with the partial-participation resilience
posture of "Just-in-Time Aggregation for Federated Learning"
(arXiv:2208.09740): every stage tolerates injected failure and the loop
converges back to a healthy serving state.

State machine (docs/ops.md has the diagram)::

    watching ──trigger (drift/SLO violation on the active version)──▶
    retraining ──▶ publishing ──▶ canary ──▶ ramping ──▶ baking ──▶
    watching                                    │           │
         ▲                                      ▼           ▼
         └────────────────────────────── rolling-back ◀─────┘

- **watching**: evaluate the active version's drift verdict
  (:func:`~flink_ml_tpu_torch.observability.drift.evaluate`), its
  continuous-evaluation quality verdict
  (:func:`~flink_ml_tpu_torch.observability.evaluation.evaluate` — live AUC
  from joined ground truth vs the published quality baseline) and any
  configured SLOs; a violation starts a cycle.
- **retraining**: the caller's ``retrain`` callable (typically an FTRL
  ``warm_start`` refit on recent traffic) under
  :func:`~flink_ml_tpu_torch.resilience.supervisor.run_supervised` — an
  injected/transient failure is RETRYABLE with backoff, a
  :class:`~flink_ml_tpu_torch.resilience.policy.NonFiniteState` (diverged
  refit) is TERMINAL and ends the cycle ``failed`` with the active
  version untouched.
- **publishing**: :func:`~flink_ml_tpu_torch.serving.registry.publish_model`
  with the refit's FRESH drift baseline — the new version is compared
  against the distribution it was actually trained on.
- **canary**: :meth:`~flink_ml_tpu_torch.serving.registry.ModelRegistry
  .load_candidate` — validate + probe without swapping.
  :class:`~flink_ml_tpu_torch.resilience.policy.CandidateRejected` is
  terminal (``rejected`` outcome; rollback by construction — the
  serving version was never replaced).
- **ramping**: the canary rides at ``ramp_stages`` traffic fractions
  (:meth:`~flink_ml_tpu_torch.serving.registry.ModelRegistry.resolve`); each
  stage must serve ``stage_min_requests`` and read healthy on the
  canary's error/drift/latency/finite gauges before the next; the last
  stage promotes (the committed swap).
- **baking**: post-swap observation on the SAME gauges; a regression
  triggers :meth:`~flink_ml_tpu_torch.serving.registry.ModelRegistry
  .rollback` — v(N-1) re-activates WITHOUT re-probe, the demoted
  version is remembered and its drift windows forgotten.
- **rolling-back**: supervised like every other step (the
  ``model-rollback`` chaos site fires inside); the cycle ends
  ``rolled-back`` — the loop did its job, a bad candidate never kept
  serving.

Telemetry: every transition/cycle lands an ``ml.controller`` instant
event + ``transitions{model=,from=,to=}`` / ``cycles{model=,outcome=}``
counters, steps run inside ``controller.*`` spans, the live state
serves on the ``/controller`` route (observability/server.py) and the
artifacts render through ``python -m flink_ml_tpu_torch.serving.controller
<dir> [--check]`` (the port's trace CLI is each module's :func:`main`
until its dispatcher is ported; exit 4 when the loop did not end
healthy, 2 on missing telemetry — the gate of phase 14 of
``chip_smoke.py``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from flink_ml_tpu_torch.common.locks import make_lock
from flink_ml_tpu_torch.common.metrics import ML_GROUP, metrics
from flink_ml_tpu_torch.device import name_thread_device
from flink_ml_tpu_torch.observability import tracing
from flink_ml_tpu_torch.resilience import faults
from flink_ml_tpu_torch.resilience.policy import (
    CandidateRejected,
    RestartsExhausted,
    RetryPolicy,
)
from flink_ml_tpu_torch.resilience.supervisor import run_supervised
from flink_ml_tpu_torch.serving.registry import publish_model

__all__ = [
    "WATCHING", "RETRAINING", "PUBLISHING", "CANARY", "RAMPING",
    "BAKING", "ROLLING_BACK", "STATES", "OUTCOMES",
    "CONTROLLER_EVENT", "EXIT_OK", "EXIT_INVALID", "EXIT_UNHEALTHY",
    "ControllerConfig", "OpsController", "main",
]

# -- states / outcomes --------------------------------------------------------

WATCHING = "watching"
RETRAINING = "retraining"
PUBLISHING = "publishing"
CANARY = "canary"
RAMPING = "ramping"
BAKING = "baking"
ROLLING_BACK = "rolling-back"

STATES = (WATCHING, RETRAINING, PUBLISHING, CANARY, RAMPING, BAKING,
          ROLLING_BACK)

#: cycle outcomes, the ``cycles{model=,outcome=}`` counter's label set:
#: ``swapped`` (healthy candidate promoted and baked), ``rolled-back``
#: (bad candidate demoted — the loop worked), ``rejected`` (candidate
#: failed the probe; the serving version was never replaced) and
#: ``failed`` (a step failed terminally; the loop gave the cycle up —
#: the only outcome ``--check`` treats as unhealthy)
OUTCOMES = ("swapped", "rolled-back", "rejected", "failed")

#: instant-event name for controller transitions/cycles in the trace
CONTROLLER_EVENT = "ml.controller"

EXIT_OK = 0
EXIT_INVALID = 2
#: the CLI's unhealthy exit — same class as slo/drift's violation 4
EXIT_UNHEALTHY = 4

_ENV_PREFIX = "FLINK_ML_TPU_OPS_"


def _env(name: str) -> str:
    return _ENV_PREFIX + name


# -- configuration ------------------------------------------------------------

@dataclasses.dataclass
class ControllerConfig:
    """Knobs of the control loop; every field has an env twin
    (``FLINK_ML_TPU_OPS_*``, :meth:`from_env` — docs/ops.md table)."""

    #: watcher cadence of the background thread (step mode ignores it)
    check_interval_s: float = 5.0
    #: canary traffic fractions ramped pre-swap, ascending; empty →
    #: promote straight after the probe and rely on the bake stage
    ramp_stages: Tuple[float, ...] = (0.25, 0.5, 1.0)
    #: requests the canary must serve in a stage before its verdict
    stage_min_requests: int = 50
    #: requests the promoted version must serve before the cycle ends
    bake_min_requests: int = 50
    #: threaded mode: a stage/bake starved of traffic past this passes
    #: with a ``no-evidence-timeout`` note instead of wedging the loop
    stage_timeout_s: float = 120.0
    #: canary/bake error-ratio bound (errors / (errors + transforms))
    max_error_ratio: float = 0.02
    #: optional canary/bake p-quantile latency bound (None = skip)
    latency_threshold_ms: Optional[float] = None
    latency_quantile: float = 0.99
    latency_window_s: float = 60.0
    #: consult the continuous-evaluation verdict (observability/
    #: evaluation.py — live AUC vs the published quality baseline) as a
    #: canary/bake stage; thresholds are evaluation's own
    #: ``FLINK_ML_TPU_QUALITY_*`` knobs. Only bites when a quality
    #: baseline was published with the candidate — versions published
    #: without one skip the stage (``source: missing``)
    quality_gate: bool = True
    #: quiet period after a finished cycle before the next trigger
    cooldown_s: float = 10.0
    #: retry/backoff budget for each supervised step (retrain, publish,
    #: canary adopt, swap, rollback)
    policy: RetryPolicy = dataclasses.field(
        default_factory=lambda: RetryPolicy(max_restarts=4,
                                            backoff_s=0.05,
                                            max_backoff_s=2.0))
    #: extra SLOs evaluated as triggers beside the drift verdict
    slos: Optional[Sequence] = None

    def __post_init__(self):
        stages = tuple(float(f) for f in self.ramp_stages)
        if any(not 0.0 < f <= 1.0 for f in stages):
            raise ValueError("ramp_stages fractions must be in (0, 1]")
        if list(stages) != sorted(stages):
            raise ValueError("ramp_stages must be ascending")
        self.ramp_stages = stages
        if self.stage_min_requests < 1 or self.bake_min_requests < 1:
            raise ValueError("stage/bake min_requests must be >= 1")
        if not 0.0 <= self.max_error_ratio <= 1.0:
            raise ValueError("max_error_ratio must be in [0, 1]")
        if not 0.0 < self.latency_quantile <= 1.0:
            # fail at construction, not inside a live canary verdict
            # (a percent-style 99 would wedge every rollout mid-ramp)
            raise ValueError("latency_quantile must be in (0, 1] — "
                             "a fraction, not a percentage")
        if self.latency_window_s <= 0.0:
            raise ValueError("latency_window_s must be positive")

    @classmethod
    def from_env(cls, **overrides) -> "ControllerConfig":
        """Build from ``FLINK_ML_TPU_OPS_*`` (unset → field default);
        explicit ``overrides`` win. Malformed values raise ValueError —
        an ops misconfiguration must fail loudly at start, not steer a
        live rollout."""
        def read(env, parse, key):
            raw = os.environ.get(_env(env))
            if raw is not None and key not in overrides:
                try:
                    overrides[key] = parse(raw)
                except ValueError as e:
                    raise ValueError(
                        f"{_env(env)}={raw!r}: {e}") from e

        def parse_stages(raw):
            raw = raw.strip()
            if not raw:
                return ()
            return tuple(float(p) for p in raw.split(","))

        read("INTERVAL_S", float, "check_interval_s")
        read("STAGES", parse_stages, "ramp_stages")
        read("STAGE_MIN_REQUESTS", int, "stage_min_requests")
        read("BAKE_MIN_REQUESTS", int, "bake_min_requests")
        read("STAGE_TIMEOUT_S", float, "stage_timeout_s")
        read("MAX_ERROR_RATIO", float, "max_error_ratio")
        read("LATENCY_MS", float, "latency_threshold_ms")
        read("LATENCY_QUANTILE", float, "latency_quantile")
        read("LATENCY_WINDOW_S", float, "latency_window_s")
        read("COOLDOWN_S", float, "cooldown_s")

        def parse_bool(raw):
            lowered = raw.strip().lower()
            if lowered in ("1", "true", "yes", "on"):
                return True
            if lowered in ("0", "false", "no", "off"):
                return False
            raise ValueError("expected a boolean (1/0/true/false)")

        read("QUALITY_GATE", parse_bool, "quality_gate")
        return cls(**overrides)


# -- the controller -----------------------------------------------------------

class OpsController:
    """The supervised control loop over a
    :class:`~flink_ml_tpu_torch.serving.registry.ModelRegistry`.

    ``retrain(trigger)`` is the caller's refit seam: given the trigger
    dict (``reasons``, ``servable``, ``version``), return
    ``(leaves, baseline)`` — the model arrays to publish and the fresh
    :class:`~flink_ml_tpu_torch.observability.drift.DriftBaseline` captured
    on the data it refit over — or ``(leaves, baseline,
    quality_baseline)`` to also publish the fit-time
    :class:`~flink_ml_tpu_torch.observability.evaluation.QualityBaseline`
    that arms the canary's live-AUC quality stage (or a bare
    ``leaves`` list; publishing without baselines degrades the NEXT
    cycle's drift trigger to ``source: missing`` and skips the quality
    stage). Typically an
    :meth:`~flink_ml_tpu_torch.models.online.OnlineLogisticRegression
    .warm_start` FTRL fit on recent traffic.

    Drive it synchronously (:meth:`step` — deterministic, what the
    chaos smoke and tests use) or as a background thread
    (:meth:`start`/:meth:`stop`, ``check_interval_s`` cadence). The
    loop itself is supervised: an escaping step bug is counted
    (``stepErrors{model=}``), backed off and re-entered — the
    controller must outlive any single bad evaluation.
    """

    def __init__(self, registry, retrain: Callable,
                 config: Optional[ControllerConfig] = None):
        self.registry = registry
        self.model = registry.model
        self._retrain_fn = retrain
        self.config = config or ControllerConfig()
        self.state = WATCHING
        self.cycle = 0
        #: [(from, to, reason, cycle)] — the deterministic transition
        #: log the chaos smoke compares across same-seed runs
        self.transitions: List[dict] = []
        self._outcomes: Dict[str, int] = {}
        self._trigger: Optional[dict] = None
        self._pending: dict = {}
        self._cooldown_until = 0.0
        self._cycle_t0: Optional[float] = None
        # the live cycle's trace: the step span where the trigger fired
        # mints it (its ml.drift/ml.slo trigger events are INSIDE that
        # span), every later step of the cycle links follows_from to
        # the previous step's context and adopts the same trace id —
        # one retrain→publish→canary→…→watching cycle reads as ONE
        # trace chained across steps (docs/observability.md)
        self._cycle_ctx = None
        self._thread: Optional[threading.Thread] = None
        self._bound_device = None
        self._stop = threading.Event()
        self._lock = make_lock("serving.controller")
        self._group = metrics.group(ML_GROUP, "controller")
        # the /controller route reflects this controller from
        # construction — step-driven controllers (tests, the smoke)
        # never start the thread but are just as live
        from flink_ml_tpu_torch.observability import server

        server.set_controller_status(self.status)

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "OpsController":
        """Run the loop on a daemon thread (``check_interval_s``
        cadence while watching)."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="flink-ml-tpu-ops-controller",
            daemon=True)
        self._thread.start()
        # join the fleet telemetry plane: the controller's beacon
        # carries its recent ml.controller events and gauges
        # (observability/fleet.py; no-op when no fleet dir resolves)
        try:
            from flink_ml_tpu_torch.observability import fleet

            self._fleet_token = fleet.start_beacon(role="controller")
        except Exception:
            self._fleet_token = None
        return self

    def stop(self) -> None:
        """Stop the thread (if running) and release the ``/controller``
        provider; a canary left mid-ramp is dropped (NOT condemned) —
        an unsupervised canary must not keep taking traffic."""
        thread = self._thread
        if thread is not None:
            self._stop.set()
            thread.join(timeout=30.0)
            self._thread = None
        try:
            from flink_ml_tpu_torch.observability import fleet

            fleet.stop_beacon(getattr(self, "_fleet_token", None))
            self._fleet_token = None
        except Exception:
            pass
        from flink_ml_tpu_torch.observability import server

        server.clear_controller_status(self.status)
        if self.registry.canary_version is not None:
            self.registry.drop_canary("controller-stopped")
            self._transition(WATCHING, "controller-stopped")
        version = self._pending.get("version")
        if version is not None:
            # a cycle abandoned between publish and adopt must not
            # keep its version held against the watcher forever
            self.registry.release_version(version)

    def __enter__(self) -> "OpsController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        errors = 0
        while not self._stop.is_set():
            try:
                # the refit launches its kernels from this thread: name
                # the serving version's card first, as the batcher's
                # device thread does (serving/batcher.py)
                self._bound_device = name_thread_device(
                    getattr(self.registry.active, "device", None),
                    self._bound_device)
                self.step()
                errors = 0
            except Exception as e:  # noqa: BLE001 — the loop survives
                # its own bugs: count, back off, re-enter
                errors += 1
                self._group.counter("stepErrors",
                                    labels={"model": self.model})
                tracing.tracer.event(CONTROLLER_EVENT, kind="step-error",
                                     model=self.model,
                                     error=type(e).__name__,
                                     detail=str(e))
            idle = self.state == WATCHING
            delay = (self.config.check_interval_s if idle else 0.05)
            if errors:
                delay = max(delay,
                            min(0.1 * 2.0 ** (errors - 1), 30.0))
            if self._stop.wait(delay):
                return

    # -- the state machine ----------------------------------------------------
    def step(self) -> str:
        """Advance the machine by at most one transition; returns the
        (possibly unchanged) state. Synchronous and deterministic given
        deterministic traffic/verdicts — what chaos drives and tests
        step."""
        with self._lock:
            in_cycle = self.state != WATCHING
            links = ([self._cycle_ctx]
                     if (in_cycle and self._cycle_ctx is not None)
                     else None)
            with tracing.tracer.span("controller.step",
                                     model=self.model,
                                     state=self.state,
                                     links=links) as sp:
                handler = {
                    WATCHING: self._step_watching,
                    RETRAINING: self._step_retraining,
                    PUBLISHING: self._step_publishing,
                    CANARY: self._step_canary,
                    RAMPING: self._step_ramping,
                    BAKING: self._step_baking,
                    ROLLING_BACK: self._step_rolling_back,
                }[self.state]
                handler()
                ctx = tracing.context_of(sp)
            if self.state != WATCHING:
                # a cycle is (still) live: the NEXT step chains to this
                # one. The step that triggered it (watching → retraining)
                # mints the cycle trace — its trigger events ride along
                self._cycle_ctx = ctx
            elif not in_cycle or self._trigger is None:
                # back in watching with no cycle pending: the chain is
                # closed (the finishing step still linked to its
                # predecessor above)
                self._cycle_ctx = None
            return self.state

    def _transition(self, to: str, reason: str = "") -> None:
        frm = self.state
        self.state = to
        self.transitions.append({"from": frm, "to": to,
                                 "reason": reason, "cycle": self.cycle})
        self._group.counter("transitions",
                            labels={"model": self.model, "from": frm,
                                    "to": to})
        tracing.tracer.event(CONTROLLER_EVENT, kind="transition",
                             model=self.model, cycle=self.cycle,
                             reason=reason,
                             **{"from": frm, "to": to})

    def _finish_cycle(self, outcome: str, reason: str = "") -> None:
        self._outcomes[outcome] = self._outcomes.get(outcome, 0) + 1
        self._group.counter("cycles", labels={"model": self.model,
                                              "outcome": outcome})
        if self._cycle_t0 is not None:
            self._group.histogram("cycleMs", labels={
                "model": self.model}).observe(
                (time.monotonic() - self._cycle_t0) * 1000.0)
        tracing.tracer.event(CONTROLLER_EVENT, kind="cycle",
                             model=self.model, cycle=self.cycle,
                             outcome=outcome, reason=reason)
        version = self._pending.get("version")
        if version is not None and outcome != "failed":
            # the rollout owns the version no longer: promoted versions
            # are the serving one, rejected/rolled-back ones are
            # remembered — either way the watcher guard can lift. A
            # "failed" cycle is different: its version may sit on disk
            # neither vetted nor condemned (e.g. the canary budget
            # exhausted on transient probe failures) — it STAYS held,
            # or the watcher would adopt un-ramped exactly the
            # candidate this controller declined to promote
            self.registry.release_version(version)
        self._pending = {}
        self._trigger = None
        self._cycle_t0 = None
        self._cooldown_until = time.monotonic() + self.config.cooldown_s
        self._transition(WATCHING, f"{outcome}: {reason}" if reason
                         else outcome)

    # -- watching -------------------------------------------------------------
    def _active_name(self) -> Optional[str]:
        active = self.registry.active
        if active is None:
            return None
        from flink_ml_tpu_torch.servable.api import serving_name

        return serving_name(active)

    def _step_watching(self) -> None:
        if time.monotonic() < self._cooldown_until:
            return
        name = self._active_name()
        if name is None:
            return  # nothing serving yet — nothing to heal
        reasons = self._check_trigger(name)
        if not reasons:
            return
        self.cycle += 1
        self._cycle_t0 = time.monotonic()
        self._trigger = {"reasons": reasons, "servable": name,
                         "version": self.registry.version}
        tracing.tracer.event(CONTROLLER_EVENT, kind="trigger",
                             model=self.model, cycle=self.cycle,
                             servable=name, reasons=";".join(reasons))
        self._transition(RETRAINING, ";".join(reasons))

    def _check_trigger(self, name: str) -> List[str]:
        reasons: List[str] = []
        from flink_ml_tpu_torch.observability import drift

        if drift.enabled():
            verdict = drift.evaluate(name)
            if verdict["drifted"]:
                reasons.append(
                    f"drift:{','.join(verdict['drifted'])}")
        if self.config.quality_gate:
            # the continuous-evaluation twin of the drift trigger:
            # joined ground truth says the ACTIVE version's live AUC
            # fell below the floor / under the published baseline —
            # concept drift the feature sketches cannot see
            from flink_ml_tpu_torch.observability import evaluation

            if evaluation.enabled():
                q = evaluation.evaluate(name)
                if q["degraded"]:
                    reasons.append(
                        f"quality:{','.join(q['over'])}")
        if self.config.slos:
            from flink_ml_tpu_torch.observability import slo as slo_mod

            for v in slo_mod.evaluate_slos(self.config.slos,
                                           emit=True):
                if not v["ok"]:
                    reasons.append(f"slo:{v['slo']}")
        return reasons

    # -- retraining / publishing ----------------------------------------------
    def _step_retraining(self) -> None:
        trigger = dict(self._trigger or {})

        def retrain_once():
            faults.inject("controller-retrain", model=self.model)
            return self._retrain_fn(trigger)

        try:
            with tracing.tracer.span("controller.retrain",
                                     model=self.model,
                                     cycle=self.cycle):
                t0 = time.monotonic()
                out = run_supervised(retrain_once,
                                     policy=self.config.policy)
                self._group.histogram("retrainMs", labels={
                    "model": self.model}).observe(
                    (time.monotonic() - t0) * 1000.0)
        except Exception as e:  # noqa: BLE001 — terminal taxonomy or
            # an exhausted budget: the cycle fails, the active version
            # keeps serving
            self._finish_cycle("failed",
                               f"retrain: {type(e).__name__}: {e}")
            return
        quality_baseline = None
        if isinstance(out, tuple) and len(out) == 3:
            leaves, baseline, quality_baseline = out
        elif isinstance(out, tuple) and len(out) == 2:
            leaves, baseline = out
        else:
            leaves, baseline = out, None
        self._group.counter("retrains", labels={"model": self.model})
        self._pending = {"leaves": leaves, "baseline": baseline,
                         "quality_baseline": quality_baseline}
        self._transition(PUBLISHING, "retrained")

    def _step_publishing(self) -> None:
        published = self.registry.published_versions()
        current = self.registry.version or 0
        version = max(published + [current]) + 1
        leaves = self._pending["leaves"]
        baseline = self._pending["baseline"]
        quality_baseline = self._pending.get("quality_baseline")
        # claim the version BEFORE it exists on disk: a running watcher
        # thread must never adopt the candidate directly and bypass the
        # canary/ramp/bake gates (released when the cycle finishes)
        self.registry.hold_version(version)
        self._pending["version"] = version

        def publish_once():
            faults.inject("controller-publish", model=self.model,
                          version=version)
            return publish_model(self.registry.watch_dir, leaves,
                                 version, baseline=baseline,
                                 quality_baseline=quality_baseline)

        try:
            with tracing.tracer.span("controller.publish",
                                     model=self.model, version=version):
                run_supervised(publish_once, policy=self.config.policy)
        except Exception as e:  # noqa: BLE001 — see _step_retraining
            self._finish_cycle("failed",
                               f"publish: {type(e).__name__}: {e}")
            return
        self._transition(CANARY, f"published v{version}")

    # -- canary / ramping / baking --------------------------------------------
    def _step_canary(self) -> None:
        version = self._pending["version"]

        def adopt_once():
            # the canary-probe chaos site fires inside the registry's
            # probe; injected faults surface retryable here
            return self.registry.load_candidate(version)

        try:
            with tracing.tracer.span("controller.canary",
                                     model=self.model, version=version):
                candidate = run_supervised(adopt_once,
                                           policy=self.config.policy)
        except CandidateRejected as e:
            # terminal bad candidate: remember it (the watcher must not
            # re-adopt), count the rejection, end the cycle — the
            # serving version was never replaced (rollback by
            # construction)
            self.registry.record_rejection(version, e.reason, str(e))
            self._finish_cycle("rejected", str(e))
            return
        except Exception as e:  # noqa: BLE001 — exhausted budget or an
            # unexpected terminal failure: same safety, the active
            # version keeps serving
            self._finish_cycle("failed",
                               f"canary: {type(e).__name__}: {e}")
            return
        self.registry.set_canary(candidate, version, fraction=0.0)
        self._pending["stage"] = 0
        self._transition(RAMPING, f"canary v{version} probed")

    def _counts_for(self, name: str,
                    snap: Optional[dict] = None) -> Dict[str, float]:
        if snap is None:
            snap = metrics.group(ML_GROUP, "serving").snapshot()
        counters = snap.get("counters", {})
        from flink_ml_tpu_torch.observability.slo import _match_key

        def total(metric):
            return sum(int(v) for k, v in counters.items()
                       if _match_key(k, metric, {"servable": name}))

        return {"transforms": total("transforms"),
                "errors": total("errors")}

    def _canary_verdict(self, name: str, since: Dict[str, float],
                        min_requests: int,
                        deadline: float) -> Tuple[str, str]:
        """(status, detail): ``thin`` (insufficient evidence — wait),
        ``regressed`` or ``healthy``. Gauge order mirrors severity:
        non-finite predictions, error ratio, drift, quality (live AUC
        vs the published quality baseline), latency."""
        # ONE registry snapshot serves the counts and the gauge scan —
        # the verdict runs every step of a rollout
        snap = metrics.group(ML_GROUP, "serving").snapshot()
        now_counts = self._counts_for(name, snap)
        served = now_counts["transforms"] - since["transforms"]
        errors = now_counts["errors"] - since["errors"]
        if served + errors < min_requests:
            if time.monotonic() < deadline:
                return "thin", f"{int(served + errors)} request(s)"
            # starved of traffic: no evidence of regression is not
            # evidence of health, but wedging the rollout forever is
            # worse — proceed, loudly
            tracing.tracer.event(CONTROLLER_EVENT,
                                 kind="no-evidence-timeout",
                                 model=self.model, servable=name)
            return "healthy", "no-evidence-timeout"
        gauges = snap.get("gauges", {})
        # the registry probe's idiom: the prediction-distribution
        # gauges, labeled by the versioned serving name
        label = f'servable="{name}"'
        for key, value in gauges.items():
            if "FiniteFraction" in key and label in key:
                try:
                    if float(value) < 1.0:
                        return "regressed", f"non-finite: {key}={value}"
                except (TypeError, ValueError):
                    continue
        total = served + errors
        ratio = errors / total if total else 0.0
        if ratio > self.config.max_error_ratio:
            return "regressed", (f"error-ratio {ratio:.4f} > "
                                 f"{self.config.max_error_ratio:g}")
        from flink_ml_tpu_torch.observability import drift

        if drift.enabled():
            verdict = drift.evaluate(name)
            if verdict["drifted"]:
                return "regressed", (
                    f"drift: {','.join(verdict['drifted'])}")
            series = verdict.get("series", {})
            if verdict.get("source") == "baseline" and (
                    not series
                    or all(row.get("thin") for row in series.values())):
                # a baseline exists but the live window is below the
                # drift sample floor: "no drift" is absence of
                # evidence, not evidence of health — keep watching
                # (bounded by the same stage deadline)
                if time.monotonic() < deadline:
                    return "thin", "drift window below sample floor"
                tracing.tracer.event(CONTROLLER_EVENT,
                                     kind="no-evidence-timeout",
                                     model=self.model, servable=name)
        if self.config.quality_gate:
            from flink_ml_tpu_torch.observability import evaluation

            if evaluation.enabled():
                q = evaluation.evaluate(name)
                if q["degraded"]:
                    base_auc = (q["baseline"] or {}).get("auc")
                    vs = (f" vs baseline {base_auc:.4f}"
                          if base_auc is not None
                          and math.isfinite(base_auc) else "")
                    return "regressed", (
                        f"quality: {','.join(q['over'])} (live auc "
                        f"{q['live']['auc']:.4f}{vs})")
                if q["source"] == "baseline" and q["thin"]:
                    # the drift precedent again: a published quality
                    # baseline with too few joined labels is absence of
                    # evidence — wait for feedback, bounded by the same
                    # stage deadline (labels are delayed by nature)
                    if time.monotonic() < deadline:
                        return "thin", "quality window below label floor"
                    tracing.tracer.event(CONTROLLER_EVENT,
                                         kind="no-evidence-timeout",
                                         model=self.model, servable=name)
        if self.config.latency_threshold_ms is not None:
            p = self._latency_quantile(name)
            if p is not None and p > self.config.latency_threshold_ms:
                return "regressed", (
                    f"latency p{self.config.latency_quantile * 100:g} "
                    f"{p:.1f}ms > "
                    f"{self.config.latency_threshold_ms:g}ms")
        return "healthy", f"{int(served)} request(s)"

    def _latency_quantile(self, name: str) -> Optional[float]:
        from flink_ml_tpu_torch.common.metrics import histogram_quantile
        from flink_ml_tpu_torch.observability.slo import _RegistrySource

        snap, _src = _RegistrySource(metrics).hist_window(
            f"{ML_GROUP}.serving", "transformMs",
            {"servable": name}, self.config.latency_window_s)
        if not snap or not snap.get("count"):
            return None
        value = histogram_quantile(snap, self.config.latency_quantile)
        return None if math.isnan(value) else value

    def _canary_name(self) -> str:
        return f"{self.model}@v{self._pending['version']}"

    def _step_ramping(self) -> None:
        stages = self.config.ramp_stages
        i = self._pending.get("stage", 0)
        name = self._canary_name()
        if i >= len(stages):
            # every stage passed (or none configured): promote — THE
            # committed swap, supervised (model-swap chaos site inside)
            version = self._pending["version"]
            try:
                with tracing.tracer.span("controller.swap",
                                         model=self.model,
                                         version=version):
                    run_supervised(self.registry.promote_canary,
                                   policy=self.config.policy)
            except Exception as e:  # noqa: BLE001 — could not commit:
                # demote the canary rather than leave it half-rolled
                self._transition(ROLLING_BACK,
                                 f"swap: {type(e).__name__}: {e}")
                return
            self._pending["bake_since"] = self._counts_for(name)
            self._pending["bake_deadline"] = (
                time.monotonic() + self.config.stage_timeout_s)
            self._transition(BAKING, f"v{version} promoted")
            return
        if self._pending.get("stage_set") != i:
            self.registry.set_canary_fraction(stages[i])
            self._pending["stage_set"] = i
            self._pending["stage_since"] = self._counts_for(name)
            self._pending["stage_deadline"] = (
                time.monotonic() + self.config.stage_timeout_s)
            return  # judge on a later step, once traffic flowed
        status, detail = self._canary_verdict(
            name, self._pending["stage_since"],
            self.config.stage_min_requests,
            self._pending["stage_deadline"])
        if status == "thin":
            return
        if status == "regressed":
            self._transition(ROLLING_BACK,
                             f"stage {stages[i]:g}: {detail}")
            return
        tracing.tracer.event(CONTROLLER_EVENT, kind="stage-pass",
                             model=self.model, fraction=stages[i],
                             detail=detail)
        self._pending["stage"] = i + 1

    def _step_baking(self) -> None:
        name = self._canary_name()
        status, detail = self._canary_verdict(
            name, self._pending["bake_since"],
            self.config.bake_min_requests,
            self._pending["bake_deadline"])
        if status == "thin":
            return
        if status == "regressed":
            self._transition(ROLLING_BACK, f"bake: {detail}")
            return
        self._finish_cycle("swapped",
                           f"v{self._pending['version']} healthy "
                           f"({detail})")

    # -- rolling back ---------------------------------------------------------
    @staticmethod
    def _short_reason(detail: str) -> str:
        """Fold a verdict detail into the small ``reason`` label set of
        ``rollbacks{model=,reason=}`` — labels must stay low-cardinality
        (common/metrics.py)."""
        for token in ("quality", "drift", "error-ratio", "non-finite",
                      "latency", "swap"):
            if token in detail:
                return token
        return "regression"

    def _step_rolling_back(self) -> None:
        detail = (self.transitions[-1]["reason"]
                  if self.transitions else "regression")
        reason = self._short_reason(detail)

        def rollback_once():
            # the model-rollback chaos site fires inside the registry
            return self.registry.rollback(reason=reason)

        try:
            with tracing.tracer.span("controller.rollback",
                                     model=self.model):
                restored = run_supervised(rollback_once,
                                          policy=self.config.policy)
        except RestartsExhausted:
            # a rollback MUST land: stay in this state and re-enter on
            # the next step rather than leaving a condemned version
            # serving
            self._group.counter("rollbackRetries",
                                labels={"model": self.model})
            return
        except Exception as e:  # noqa: BLE001 — truly terminal (e.g.
            # no prior version to restore): give the cycle up loudly
            self._finish_cycle("failed",
                               f"rollback: {type(e).__name__}: {e}")
            return
        self._finish_cycle("rolled-back",
                           f"restored v{restored} ({reason})")

    # -- live status ----------------------------------------------------------
    def status(self) -> dict:
        """Live state for the ``/controller`` route."""
        canary_version = self.registry.canary_version
        return {
            "model": self.model,
            "state": self.state,
            "cycle": self.cycle,
            "active_version": self.registry.version,
            "canary": (None if canary_version is None else
                       {"version": canary_version,
                        "fraction": self.registry.canary_fraction}),
            "trigger": self._trigger,
            "outcomes": dict(self._outcomes),
            "transitions": self.transitions[-20:],
            "running": self._thread is not None,
        }


# -- artifacts view / CLI -----------------------------------------------------

def controller_summary(spans: List[dict],
                       snapshot: Dict[str, dict]) -> dict:
    """Structured controller view from trace artifacts: the
    ``ml.controller`` event timeline + counters, per model."""
    events = []
    for sp in spans:
        for ev in sp.get("events", ()):
            if ev.get("name") == CONTROLLER_EVENT:
                events.append({"ts_us": ev.get("ts_us", 0),
                               **ev.get("attrs", {})})
    events.sort(key=lambda e: e["ts_us"])
    models: Dict[str, dict] = {}
    for ev in events:
        row = models.setdefault(ev.get("model", "?"), {
            "cycles": {}, "transitions": [], "triggers": 0,
            "last_state": None})
        kind = ev.get("kind")
        if kind == "transition":
            row["transitions"].append(ev)
            row["last_state"] = ev.get("to")
        elif kind == "cycle":
            outcome = ev.get("outcome", "?")
            row["cycles"][outcome] = row["cycles"].get(outcome, 0) + 1
        elif kind == "trigger":
            row["triggers"] += 1
    ctrl = snapshot.get(f"{ML_GROUP}.controller", {})
    serving = snapshot.get(f"{ML_GROUP}.serving", {})

    def counter_total(group: dict, prefix: str) -> int:
        return sum(int(v) for k, v in
                   group.get("counters", {}).items()
                   if k == prefix or k.startswith(prefix + "{"))

    return {
        "models": models,
        "events": len(events),
        "counters": {
            "transitions": counter_total(ctrl, "transitions"),
            "cycles": counter_total(ctrl, "cycles"),
            "retrains": counter_total(ctrl, "retrains"),
            "stepErrors": counter_total(ctrl, "stepErrors"),
            "rollbacks": counter_total(serving, "rollbacks"),
            "swapRejected": counter_total(serving, "swapRejected"),
            "watcherRestarts": counter_total(serving,
                                             "watcherRestarts"),
        },
    }


def render_controller(summary: dict) -> str:
    out = [f"{summary['events']} ml.controller event(s)"]
    c = summary["counters"]
    out.append(f"  retrains {c['retrains']}  rollbacks "
               f"{c['rollbacks']}  swap-rejected {c['swapRejected']}  "
               f"watcher-restarts {c['watcherRestarts']}  step-errors "
               f"{c['stepErrors']}")
    for model, row in sorted(summary["models"].items()):
        outcomes = ", ".join(f"{k}={v}" for k, v in
                             sorted(row["cycles"].items())) or "none"
        out.append("")
        out.append(f"model {model}: {row['triggers']} trigger(s), "
                   f"cycles: {outcomes}, last state: "
                   f"{row['last_state'] or '-'}")
        if row["transitions"]:
            t0 = row["transitions"][0]["ts_us"]
            for ev in row["transitions"]:
                reason = ev.get("reason", "")
                out.append(
                    f"  +{(ev['ts_us'] - t0) / 1000.0:>10.3f} ms  "
                    f"{ev.get('from', '?'):>12} -> "
                    f"{ev.get('to', '?'):<12} {reason}".rstrip())
    return "\n".join(out)


def check_verdict(summary: dict) -> List[str]:
    """Reasons the artifacts read unhealthy (empty = healthy): a cycle
    that ended ``failed``, or a controller whose LAST recorded state is
    not ``watching`` — the loop must always converge back to watching,
    whatever was injected along the way."""
    problems = []
    for model, row in sorted(summary["models"].items()):
        failed = row["cycles"].get("failed", 0)
        if failed:
            problems.append(f"{model}: {failed} failed cycle(s)")
        if row["last_state"] not in (None, WATCHING):
            problems.append(f"{model}: ended in state "
                            f"{row['last_state']!r} (not watching)")
    return problems


def main(argv=None) -> int:
    """``flink-ml-tpu-trace controller <dir>`` — render the controller
    timeline from trace artifacts; ``--check`` exits
    :data:`EXIT_UNHEALTHY` (4) when the loop did not end healthy,
    :data:`EXIT_INVALID` (2) on missing/broken artifacts."""
    import argparse
    import sys

    from flink_ml_tpu_torch.observability.exporters import (
        pipe_guard,
        read_metrics,
        read_spans,
        resolve_trace_dir,
    )

    parser = argparse.ArgumentParser(
        prog="flink-ml-tpu-trace controller",
        description="Ops-controller timeline and verdicts from a "
                    "FLINK_ML_TPU_TRACE_DIR's artifacts "
                    "(docs/ops.md).")
    parser.add_argument("trace_dir")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    parser.add_argument("--check", action="store_true",
                        help="exit 4 unless every controller ended "
                             "healthy (no failed cycles, last state "
                             "watching), 2 on missing telemetry")
    parser.add_argument("--latest", action="store_true",
                        help="treat TRACE_DIR as a root and pick the "
                             "newest trace dir under it")
    args = parser.parse_args(argv)

    try:
        trace_dir = resolve_trace_dir(args.trace_dir, args.latest)
        spans = read_spans(trace_dir)
        snapshot = read_metrics(trace_dir)
    except OSError as e:
        print(f"flink-ml-tpu-trace controller: cannot read "
              f"{args.trace_dir}: {e}", file=sys.stderr)
        return EXIT_INVALID
    summary = controller_summary(spans, snapshot or {})
    if not summary["events"] and not summary["counters"]["transitions"]:
        print(f"flink-ml-tpu-trace controller: no controller "
              f"telemetry in {trace_dir}", file=sys.stderr)
        return EXIT_INVALID
    problems = check_verdict(summary)
    with pipe_guard():
        if args.json:
            print(json.dumps({"trace_dir": trace_dir,
                              "summary": summary,
                              "healthy": not problems,
                              "problems": problems}, indent=2,
                             default=str))
        else:
            print(render_controller(summary))
            if problems:
                print()
                print("UNHEALTHY: " + "; ".join(problems))
    if args.check and problems:
        print(f"flink-ml-tpu-trace controller: {'; '.join(problems)}",
              file=sys.stderr)
        return EXIT_UNHEALTHY
    return EXIT_OK


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
