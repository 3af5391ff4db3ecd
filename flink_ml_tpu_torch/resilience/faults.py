"""Deterministic, seeded fault injection (chaos harness).

The port of ``flink_ml_tpu/resilience/faults.py``. Instrumented sites call
:func:`inject` (raise in place) or :func:`decide` (the caller applies the
fault itself). With no active plan both are near-free no-ops, so the hooks
stay in production paths.

Activation, in precedence order:

1. Programmatic: ``with faults.chaos(seed=7, rate=0.2): ...`` or an
   explicit per-site schedule ``chaos(at={"checkpoint-save": [2]})``
   (fault exactly the 2nd save of the process/context).
2. Environment: ``FLINK_ML_TPU_CHAOS=1`` plus optional
   ``FLINK_ML_TPU_CHAOS_SEED`` (default 0), ``FLINK_ML_TPU_CHAOS_RATE``
   (default 0.05), ``FLINK_ML_TPU_CHAOS_SITES`` (comma list, default all)
   and ``FLINK_ML_TPU_CHAOS_AT`` ("site:count,site:count" explicit
   schedule, overrides the rate): the same variables as the JAX package.

Determinism: a decision is a pure function of (seed, site, per-site call
count): ``random.Random(f"{seed}:{site}:{count}")`` uses the version-2
string seeding (SHA-512 based), so a seed gives the same fault schedule in
every process, on every platform and in both packages.

Injection sites of the port: ``checkpoint-save`` (entry of
``CheckpointManager.save``), ``checkpoint-publish`` (after the tmp dir is
written, before the atomic rename), ``epoch-boundary`` (host rounds and
device segment boundaries), and the serving registry's ``canary-probe``
(entry of a candidate's probe; transient, the candidate is not condemned),
``model-swap`` (the swap commit, before the atomic assignment) and
``model-rollback`` (entry of ``ModelRegistry.rollback``), and the ops
controller's ``controller-retrain`` (each retrain attempt, before the
caller's refit) and ``controller-publish`` (each publish attempt)
(serving/controller.py). The JAX package's other sites name layers that
later slices port.
"""

from __future__ import annotations

import contextlib
import logging
import os
import random
from typing import Dict, Iterable, Optional, Sequence

from flink_ml_tpu_torch.common.locks import make_lock
from flink_ml_tpu_torch.resilience.policy import InjectedFault

#: the ops-loop subset (serving/controller.py + registry canary/swap/
#: rollback seams) — what a chaos drive of the ops loop arms
CONTROLLER_SITES = ("controller-retrain", "controller-publish",
                    "canary-probe", "model-swap", "model-rollback")

_ENV_FLAG = "FLINK_ML_TPU_CHAOS"
_ENV_SEED = "FLINK_ML_TPU_CHAOS_SEED"
_ENV_RATE = "FLINK_ML_TPU_CHAOS_RATE"
_ENV_SITES = "FLINK_ML_TPU_CHAOS_SITES"
_ENV_AT = "FLINK_ML_TPU_CHAOS_AT"

_OFF = ("", "0", "false", "False", "off", "no")


class FaultPlan:
    """A deterministic schedule of faults.

    ``at`` maps site → iterable of 1-based call counts to fault (an explicit
    schedule; sites absent from ``at`` never fault). Without ``at``, every
    enabled site faults its k-th call whenever the seeded hash of (seed,
    site, k) lands below ``rate``.
    """

    def __init__(self, seed: int = 0, rate: float = 0.0,
                 at: Optional[Dict[str, Iterable[int]]] = None,
                 sites: Optional[Sequence[str]] = None):
        self.seed = int(seed)
        self.rate = float(rate)
        self.at = (None if at is None
                   else {s: frozenset(int(c) for c in counts)
                         for s, counts in at.items()})
        self.sites = None if sites is None else frozenset(sites)
        self._counts: Dict[str, int] = {}
        self._lock = make_lock("resilience.faults.plan")

    def decide(self, site: str) -> int:
        """Count this call; return the (1-based) call number when it should
        fault, else 0."""
        with self._lock:
            count = self._counts.get(site, 0) + 1
            self._counts[site] = count
        if self.sites is not None and site not in self.sites:
            return 0
        if self.at is not None:
            return count if count in self.at.get(site, ()) else 0
        if self.rate <= 0.0:
            return 0
        r = random.Random(f"{self.seed}:{site}:{count}").random()
        return count if r < self.rate else 0


_active: Optional[FaultPlan] = None  # programmatic plan (beats env)
_suppress = 0
_env_key = None
_env_plan: Optional[FaultPlan] = None
_state_lock = make_lock("resilience.faults.state")


def _parse_at(spec: str) -> Dict[str, list]:
    at: Dict[str, list] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        site, _, count = part.rpartition(":")
        if not site or not count.lstrip("-").isdigit():
            # a typo in the env var must not become a ValueError inside
            # whichever production call first consults the plan (which a
            # policy would then classify TERMINAL): warn and skip
            logging.getLogger(__name__).warning(
                "%s: ignoring malformed entry %r (want site:count)",
                _ENV_AT, part)
            continue
        at.setdefault(site, []).append(int(count))
    return at


def env_armed() -> bool:
    """True when the FLINK_ML_TPU_CHAOS environment arms the harness."""
    flag = os.environ.get(_ENV_FLAG)
    return flag is not None and flag not in _OFF


def reset_env_plan() -> None:
    """Drop the cached environment plan (and its per-site counters), so the
    next armed call builds a fresh schedule."""
    global _env_key, _env_plan
    with _state_lock:
        _env_key = None
        _env_plan = None


def _plan_from_env() -> Optional[FaultPlan]:
    global _env_key, _env_plan
    if not env_armed():
        # observing the disarmed state invalidates the cache, so a later
        # re-arm starts a fresh schedule instead of resuming stale counters
        if _env_key is not None:
            reset_env_plan()
        return None
    key = tuple(os.environ.get(k) for k in
                (_ENV_FLAG, _ENV_SEED, _ENV_RATE, _ENV_SITES, _ENV_AT))
    with _state_lock:
        if key != _env_key:
            _env_key = key
            _env_plan = FaultPlan(
                seed=int(key[1] or 0),
                rate=float(key[2] or 0.05),
                sites=(None if not key[3]
                       else [s.strip() for s in key[3].split(",")]),
                at=_parse_at(key[4]) if key[4] else None)
        return _env_plan


def active_plan() -> Optional[FaultPlan]:
    """The plan injections consult right now, or None (chaos off)."""
    if _suppress:
        return None
    if _active is not None:
        return _active
    return _plan_from_env()


def decide(site: str) -> int:
    """Count a call at ``site``; nonzero (the call number) when the caller
    should apply a fault itself, 0 otherwise."""
    plan = active_plan()
    return plan.decide(site) if plan is not None else 0


def inject(site: str, **detail) -> None:
    """Raise :class:`InjectedFault` when the active plan schedules a fault
    for this call at ``site``; no-op otherwise."""
    count = decide(site)
    if count:
        raise InjectedFault(site, count, detail)


@contextlib.contextmanager
def chaos(seed: int = 0, rate: float = 0.0, at=None, sites=None,
          plan: Optional[FaultPlan] = None):
    """Activate a programmatic plan for the dynamic extent of the block
    (overrides any environment plan); yields the plan."""
    global _active
    new = plan if plan is not None else FaultPlan(seed=seed, rate=rate,
                                                 at=at, sites=sites)
    prev, _active = _active, new
    try:
        yield new
    finally:
        _active = prev


@contextlib.contextmanager
def suppressed():
    """Disable all injection for the block (clean baselines while ambient,
    env-armed chaos is on)."""
    global _suppress
    _suppress += 1
    try:
        yield
    finally:
        _suppress -= 1
