"""The port's ops controller, held against the JAX package's.

Modelled on tests/test_controller.py (its 32 cases) and the controller
cycle case of tests/test_causaltrace.py. The registry seams and the
controller's configuration, route and CLI run once per package (the
``pkg`` fixture) with the same assertions. The deterministic ``step()``
scenarios (the happy swap, a NaN candidate rejected, a terminal retrain,
bake and mid-ramp rollbacks, chaos at every site, a seeded chaos plan,
rollback exhaustion, a stop during canary) run in both packages on the
same traffic and the same fault plan, and must give identical transition
logs, cycle outcomes and ``ml.controller`` counters. Each package's
``controller_summary`` reads the other's trace dir to the same summary.

Port-only: the controller thread names the serving version's CUDA device
before its first step (recorded with a fake device on the CPU), and a
device fault in a retrain ends the cycle ``failed`` after one attempt.

Every wait is bounded; servers bind port 0 and stop in teardown.
"""

import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the conftest pins it to the CPU)

PKGS = ("jax", "torch")
_NS = {}


def _namespace(name):
    if name in _NS:
        return _NS[name]
    if name == "jax":
        from flink_ml_tpu import serving
        from flink_ml_tpu.common import metrics as metrics_mod
        from flink_ml_tpu.linalg.vectors import DenseVector
        from flink_ml_tpu.observability import (drift, evaluation,
                                                exporters, server, tracing)
        from flink_ml_tpu.resilience import RetryPolicy, faults, policy
        from flink_ml_tpu.servable import api
        from flink_ml_tpu.serving import controller
    else:
        from flink_ml_tpu_torch import serving
        from flink_ml_tpu_torch.common import metrics as metrics_mod
        from flink_ml_tpu_torch.linalg.vectors import DenseVector
        from flink_ml_tpu_torch.observability import (drift, evaluation,
                                                      exporters, server,
                                                      tracing)
        from flink_ml_tpu_torch.resilience import (RetryPolicy, faults,
                                                   policy)
        from flink_ml_tpu_torch.servable import api
        from flink_ml_tpu_torch.serving import controller

    class ConstServable(api.TransformerServable):
        """Host servable predicting leaves[0][0] for every row — cheap,
        deterministic and version-distinguishable."""

        features_col = "features"
        prediction_col = "pred"

        def __init__(self, value):
            super().__init__()
            self.value = float(value)

        def transform(self, df):
            df.add_column("pred", api.DataTypes.DOUBLE,
                          [self.value] * df.num_rows())
            return df

    def frame(rows, value=1.0):
        return api.DataFrame(["features"], [api.DataTypes.vector()],
                             [api.Row([DenseVector(np.full(3, value))])
                              for _ in range(rows)])

    ns = types.SimpleNamespace(
        name=name, serving=serving, controller=controller, api=api,
        drift=drift, evaluation=evaluation, exporters=exporters,
        server=server, tracing=tracing, faults=faults, policy=policy,
        RetryPolicy=RetryPolicy, metrics=metrics_mod.metrics,
        ML_GROUP=metrics_mod.ML_GROUP, ConstServable=ConstServable,
        frame=frame)
    _NS[name] = ns
    return ns


@pytest.fixture(params=PKGS)
def pkg(request):
    return _namespace(request.param)


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv("FLINK_ML_TPU_METRICS_PORT", raising=False)
    monkeypatch.delenv("FLINK_ML_TPU_DRIFT", raising=False)
    monkeypatch.delenv("FLINK_ML_TPU_TRACE_DIR", raising=False)
    for name in PKGS:
        ns = _namespace(name)
        ns.server.stop()
        ns.drift.clear()
        ns.faults.reset_env_plan()
    yield
    for name in PKGS:
        ns = _namespace(name)
        ns.server.stop()
        ns.drift.clear()
        ns.faults.reset_env_plan()
        ns.tracing.tracer.shutdown()


def const_loader(ns):
    def load(leaves, version):
        return ns.ConstServable(float(np.asarray(leaves[0]).ravel()[0]))
    return load


def make_registry(ns, tmp_path, model="lr", versions=(1,), **kwargs):
    watch = str(tmp_path / f"models-{ns.name}-{model}")
    for v in versions:
        ns.serving.publish_model(watch, [np.full(3, float(v))], v)
    reg = ns.serving.ModelRegistry(watch, const_loader(ns), model=model,
                                   probe=lambda: ns.frame(2), **kwargs)
    for v in versions:
        # ascending adoption: every published version lands in the
        # rollback history
        reg._adopt(v)
    return reg


def counters(ns, group):
    return ns.metrics.group(ns.ML_GROUP, group).snapshot()["counters"]


# -- registry: canary routing ---------------------------------------------------

def test_canary_fraction_routing_and_validation(pkg, tmp_path):
    reg = make_registry(pkg, tmp_path, model="route")
    assert reg.version == 1
    cand = pkg.ConstServable(2.0)
    cand.serving_name = "route@v2"
    with pytest.raises(ValueError):
        reg.set_canary_fraction(0.5)  # no canary live
    with pytest.raises(ValueError):
        reg.set_canary(cand, 2, fraction=1.5)
    reg.set_canary(cand, 2, fraction=0.0)
    assert reg.resolve() is reg.active
    assert reg.canary_version == 2 and reg.canary_fraction == 0.0
    reg.set_canary_fraction(1.0)
    assert reg.resolve() is cand
    reg.set_canary_fraction(0.5)
    assert {reg.resolve() for _ in range(64)} == {reg.active, cand}


def test_promote_canary_commits_and_batcher_routes(pkg, tmp_path):
    reg = make_registry(pkg, tmp_path, model="promote")
    with pytest.raises(ValueError):
        reg.promote_canary()  # nothing to promote yet
    pkg.serving.publish_model(reg.watch_dir, [np.full(3, 2.0)], 2)
    cand = reg.load_candidate(2)
    reg.set_canary(cand, 2, fraction=0.0)
    with pkg.serving.MicroBatcher(reg, pkg.serving.BatcherConfig(
            buckets=(4,), window_ms=5.0)) as batcher:
        assert batcher._provider == reg.resolve
        out = batcher.submit(pkg.frame(2)).result(timeout=10)
        assert out.collect()[0].get(1) == 1.0  # fraction 0: active v1
        reg.set_canary_fraction(1.0)
        out = batcher.submit(pkg.frame(2)).result(timeout=10)
        assert out.collect()[0].get(1) == 2.0  # the canary serves
        status = batcher.status()
        assert status["model_version"] == 1
        assert status["canary"] == {"version": 2, "fraction": 1.0}
        assert reg.promote_canary() == 2 and reg.active is cand
        assert reg.canary_version is None
        assert batcher.status()["canary"] is None


# -- registry: rollback ---------------------------------------------------------

def test_rollback_restores_prior_without_reprobe(pkg, tmp_path):
    probes = []
    watch = str(tmp_path / "models")
    pkg.serving.publish_model(watch, [np.full(3, 1.0)], 1)
    pkg.serving.publish_model(watch, [np.full(3, 2.0)], 2)
    model = f"rb2-{pkg.name}"
    reg = pkg.serving.ModelRegistry(
        watch, const_loader(pkg), model=model,
        probe=lambda: probes.append(1) or pkg.frame(2))
    reg._adopt(1)
    reg._adopt(2)
    n_probes = len(probes)
    assert reg.rollback("regressed-in-test") == 1 and reg.version == 1
    assert reg.active.value == 1.0
    assert len(probes) == n_probes, "rollback must NOT re-probe"
    assert 2 in reg._rejected
    assert not reg.poll()  # the demoted version is never re-adopted
    key = f'rollbacks{{model="{model}",reason="regressed-in-test"}}'
    assert counters(pkg, "serving").get(key) == 1


def test_rollback_forgets_demoted_drift_state(pkg, tmp_path):
    reg = make_registry(pkg, tmp_path, model="rbdrift")
    pkg.serving.publish_model(reg.watch_dir, [np.full(3, 2.0)], 2)
    reg.poll()
    assert reg.version == 2
    pkg.drift.install_baseline("rbdrift@v2", None)
    assert "rbdrift@v2" in pkg.drift.drift_report()["servables"]
    reg.rollback("drift")
    assert "rbdrift@v2" not in pkg.drift.drift_report()["servables"]


@pytest.mark.parametrize("case", ["no-history", "live-canary"])
def test_rollback_edges(pkg, tmp_path, case):
    reg = make_registry(pkg, tmp_path, model=f"rbedge-{case}")
    if case == "no-history":
        with pytest.raises(ValueError):
            reg.rollback("nothing-before-v1")
        return
    cand = pkg.ConstServable(2.0)
    cand.serving_name = f"rbedge-{case}@v2"
    reg.set_canary(cand, 2, fraction=1.0)
    assert reg.rollback("mid-ramp") == 1 and reg.version == 1
    assert reg.canary_version is None and reg.resolve() is reg.active
    assert 2 in reg._rejected


def test_poll_skips_held_and_canary_versions(pkg, tmp_path):
    reg = make_registry(pkg, tmp_path, model="held")
    reg.hold_version(2)
    pkg.serving.publish_model(reg.watch_dir, [np.full(3, 2.0)], 2)
    assert not reg.poll()  # held: skipped, not rejected
    assert reg.version == 1 and 2 not in reg._rejected
    cand = reg.load_candidate(2)
    reg.set_canary(cand, 2, fraction=0.5)
    assert not reg.poll()
    reg.promote_canary()
    reg.release_version(2)
    assert reg.version == 2 and not reg.poll()


def test_retried_swap_commit_never_duplicates_history(pkg, tmp_path):
    reg = make_registry(pkg, tmp_path, model="dup", versions=(1, 2))
    cand = pkg.ConstServable(3.0)
    cand.serving_name = "dup@v3"
    reg.set_canary(cand, 3, fraction=0.0)
    with pkg.faults.chaos(at={"model-swap": [1]}):
        with pytest.raises(pkg.policy.InjectedFault):
            reg.promote_canary()
        assert reg.canary_version == 3
        assert reg.promote_canary() == 3
    assert [v for v, _ in reg._history] == [1, 2, 3]
    assert reg.rollback("dup-check") == 2


# -- registry: chaos at the canary/swap/rollback sites ----------------------------

@pytest.mark.parametrize("site", ["canary-probe", "model-swap"])
def test_injected_adopt_fault_is_transient(pkg, tmp_path, site):
    watch = str(tmp_path / "models")
    pkg.serving.publish_model(watch, [np.full(3, 1.0)], 1)
    reg = pkg.serving.ModelRegistry(watch, const_loader(pkg),
                                    model=f"chaos-{site}",
                                    probe=lambda: pkg.frame(2))
    with pkg.faults.chaos(at={site: [1]}):
        assert not reg.poll()           # injected: transient
        assert 1 not in reg._rejected   # NOT condemned
        assert reg.version is None
        assert reg.poll()               # the next poll adopts
    assert reg.version == 1


def test_injected_rollback_fault_then_success(pkg, tmp_path):
    reg = make_registry(pkg, tmp_path, model="chaosrb", versions=(1, 2))
    with pkg.faults.chaos(at={"model-rollback": [1]}):
        with pytest.raises(pkg.policy.InjectedFault):
            reg.rollback("first-try")
        assert reg.version == 2  # nothing mutated before the site
        assert reg.rollback("second-try") == 1
    assert reg.version == 1


def test_watcher_restarts_after_poll_loop_escape(pkg, tmp_path):
    watch = str(tmp_path / "models")
    pkg.serving.publish_model(watch, [np.full(3, 1.0)], 1)
    model = f"watchrb-{pkg.name}"
    reg = pkg.serving.ModelRegistry(watch, const_loader(pkg), model=model,
                                    probe=lambda: pkg.frame(2),
                                    poll_interval_s=0.01)
    calls = {"n": 0}
    real_published = reg._published_versions

    def flaky_published():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise OSError("transient listdir failure")
        return real_published()

    reg._published_versions = flaky_published
    with reg:
        deadline = time.monotonic() + 10.0
        while reg.version != 1 and time.monotonic() < deadline:
            time.sleep(0.02)
    assert reg.version == 1
    assert counters(pkg, "serving").get(
        f'watcherRestarts{{model="{model}"}}', 0) >= 1


# -- the controller state machine -------------------------------------------------

def build_controller(ns, tmp_path, model, retrain, trigger_once=True,
                     stages=(), **cfg):
    reg = make_registry(ns, tmp_path, model=model)
    cfg.setdefault("stage_min_requests", 1)
    cfg.setdefault("bake_min_requests", 1)
    cfg.setdefault("cooldown_s", 0.0)
    cfg.setdefault("policy", ns.RetryPolicy(max_restarts=4, backoff_s=0.0))
    ctrl = ns.serving.OpsController(
        reg, retrain, ns.serving.ControllerConfig(ramp_stages=stages, **cfg))
    if trigger_once:
        fired = {"done": False}

        def check_once(name):
            if fired["done"]:
                return []
            fired["done"] = True
            return ["forced-test-trigger"]

        ctrl._check_trigger = check_once
    return reg, ctrl


def drive_cycle(ns, reg, ctrl, max_steps=30, rows=2):
    """Step until the cycle finishes, serving traffic to whichever
    servable resolve() routes (canary or active) between steps."""
    before = dict(ctrl._outcomes)
    for _ in range(max_steps):
        canary = reg._canary
        target = canary[0] if canary is not None else reg.active
        if target is not None:
            target.transform(ns.frame(rows))
        state = ctrl.step()
        if state == ns.controller.WATCHING and ctrl._outcomes != before:
            return [k for k, v in ctrl._outcomes.items()
                    if v > before.get(k, 0)][0]
    raise AssertionError(f"no cycle outcome within {max_steps} steps "
                         f"(state={ctrl.state}, {ctrl.transitions})")


def _forced_verdict(ctrl, state, detail):
    real = ctrl._canary_verdict

    def verdict(name, since, min_requests, deadline):
        if ctrl.state == state:
            return "regressed", detail
        return real(name, since, min_requests, deadline)

    ctrl._canary_verdict = verdict


def _scenario(ns, tmp_path, name, monkeypatch):
    """One deterministic step-driven scenario; returns what both packages
    must agree on, after checking the reference's expectations."""
    c = ns.controller
    model = f"scn-{name}"
    out = {}
    if name == "happy":
        def retrain(trigger):
            assert "forced-test-trigger" in trigger["reasons"]
            return [np.full(3, 9.0)], None

        reg, ctrl = build_controller(ns, tmp_path, model, retrain,
                                     stages=(0.5, 1.0))
        out["outcome"] = drive_cycle(ns, reg, ctrl)
        assert out["outcome"] == "swapped"
        assert reg.version == 2 and reg.active.value == 9.0
        assert [t["to"] for t in ctrl.transitions] == [
            c.RETRAINING, c.PUBLISHING, c.CANARY, c.RAMPING, c.BAKING,
            c.WATCHING]
    elif name == "nan":
        reg, ctrl = build_controller(
            ns, tmp_path, model, lambda t: [np.full(3, np.nan)])
        out["outcome"] = drive_cycle(ns, reg, ctrl)
        assert out["outcome"] == "rejected"
        assert reg.version == 1 and 2 in reg._rejected
    elif name == "terminal":
        def bad_retrain(trigger):
            raise ValueError("deterministic refit bug")

        reg, ctrl = build_controller(ns, tmp_path, model, bad_retrain)
        out["outcome"] = drive_cycle(ns, reg, ctrl)
        assert out["outcome"] == "failed" and reg.version == 1
    elif name in ("bake-rollback", "midramp-rollback"):
        bake = name == "bake-rollback"
        reg, ctrl = build_controller(
            ns, tmp_path, model, lambda t: ([np.full(3, 5.0)], None),
            stages=() if bake else (0.25, 1.0))
        _forced_verdict(ctrl, c.BAKING if bake else c.RAMPING,
                        "error-ratio 1.0 (forced)" if bake
                        else "drift: prediction (forced)")
        out["outcome"] = drive_cycle(ns, reg, ctrl)
        assert out["outcome"] == "rolled-back"
        assert reg.version == 1 and reg.active.value == 1.0
        assert reg.canary_version is None and 2 in reg._rejected
        reason = "error-ratio" if bake else "drift"
        assert counters(ns, "serving").get(
            f'rollbacks{{model="{model}",reason="{reason}"}}') == 1
    elif name == "chaos-every-site":
        reg, ctrl = build_controller(
            ns, tmp_path, model, lambda t: ([np.full(3, 7.0)], None),
            stages=(1.0,))
        with ns.faults.chaos(at={s: [1] for s in ns.faults.CONTROLLER_SITES}):
            out["outcome"] = drive_cycle(ns, reg, ctrl)
        assert out["outcome"] == "swapped"
        assert reg.version == 2 and reg.active.value == 7.0
    elif name == "seeded-chaos":
        # three cycles under the env-armed plan at exactly the five
        # controller sites: every cycle must still converge
        reg, ctrl = build_controller(
            ns, tmp_path, model,
            lambda t: ([np.full(3, 3.0 + ctrl.cycle)], None),
            trigger_once=False, stages=(0.25, 0.5, 1.0))
        ctrl._check_trigger = lambda name: ["forced-test-trigger"]
        monkeypatch.setenv("FLINK_ML_TPU_CHAOS", "1")
        monkeypatch.setenv("FLINK_ML_TPU_CHAOS_SEED", "11")
        monkeypatch.setenv("FLINK_ML_TPU_CHAOS_RATE", "0.2")
        monkeypatch.setenv("FLINK_ML_TPU_CHAOS_SITES",
                           ",".join(ns.faults.CONTROLLER_SITES))
        ns.faults.reset_env_plan()
        fired = {}
        real_inject = ns.faults.inject

        def counting_inject(site, **detail):
            try:
                real_inject(site, **detail)
            except ns.policy.InjectedFault:
                fired[site] = fired.get(site, 0) + 1
                raise

        monkeypatch.setattr(ns.faults, "inject", counting_inject)
        try:
            out["outcome"] = [drive_cycle(ns, reg, ctrl) for _ in range(3)]
        finally:
            for var in ("FLINK_ML_TPU_CHAOS", "FLINK_ML_TPU_CHAOS_SEED",
                        "FLINK_ML_TPU_CHAOS_RATE",
                        "FLINK_ML_TPU_CHAOS_SITES"):
                monkeypatch.delenv(var)
            ns.faults.reset_env_plan()
        assert "failed" not in out["outcome"]
        assert sum(fired.values()) >= 2, fired
        out["faults"] = fired
        out["version"] = reg.version
    elif name == "rollback-exhaustion":
        reg, ctrl = build_controller(
            ns, tmp_path, model, lambda t: ([np.full(3, 5.0)], None),
            policy=ns.RetryPolicy(max_restarts=0, backoff_s=0.0))
        _forced_verdict(ctrl, c.BAKING, "forced")
        with ns.faults.chaos(at={"model-rollback": [1]}):
            for _ in range(10):
                if ctrl.step() == c.ROLLING_BACK:
                    break
            # the first rollback attempt faults and the zero-restart
            # budget exhausts: the controller stays and re-enters
            assert ctrl.step() == c.ROLLING_BACK
            assert counters(ns, "controller").get(
                f'rollbackRetries{{model="{model}"}}', 0) >= 1
            assert ctrl.step() == c.WATCHING
        assert reg.version == 1
        out["outcome"] = dict(ctrl._outcomes)
        assert out["outcome"] == {"rolled-back": 1}
    elif name == "stop-during-canary":
        reg, ctrl = build_controller(
            ns, tmp_path, model, lambda t: ([np.full(3, 5.0)], None),
            stages=(0.25, 0.5, 1.0))
        for _ in range(6):
            if ctrl.state == c.RAMPING:
                break
            ctrl.step()
        assert reg.canary_version == 2
        ctrl.stop()
        assert reg.canary_version is None
        assert 2 not in reg._rejected, "a dropped canary is not condemned"
        out["outcome"] = ctrl.state
    elif name == "held-against-watcher":
        reg, ctrl = build_controller(
            ns, tmp_path, model, lambda t: ([np.full(3, 9.0)], None),
            stages=(1.0,))
        for _ in range(3):  # trigger → retrain → publish
            ctrl.step()
        assert ctrl.state == c.CANARY
        assert not reg.poll(), "watcher adopted the held candidate"
        out["outcome"] = drive_cycle(ns, reg, ctrl)
        assert out["outcome"] == "swapped" and reg.version == 2
        assert 2 not in reg._held
    elif name == "failed-canary-keeps-hold":
        reg, ctrl = build_controller(
            ns, tmp_path, model, lambda t: ([np.full(3, 9.0)], None),
            policy=ns.RetryPolicy(max_restarts=0, backoff_s=0.0))
        with ns.faults.chaos(at={"canary-probe": list(range(1, 12))}):
            out["outcome"] = drive_cycle(ns, reg, ctrl)
        assert out["outcome"] == "failed" and reg.version == 1
        assert 2 in reg._held and 2 not in reg._rejected
        assert not reg.poll() and reg.version == 1
        cand = ns.ConstServable(2.0)
        cand.serving_name = f"{model}@v2x"
        reg.set_canary(cand, 5, fraction=0.25)
        reg.drop_canary("test")
        assert ns.metrics.group(ns.ML_GROUP, "serving").snapshot()[
            "gauges"].get(f'canaryVersion{{model="{model}"}}') == 0
    ctrl.stop()
    out["transitions"] = ctrl.transitions
    out["counters"] = {k: v for k, v in counters(ns, "controller").items()
                       if f'model="{model}"' in k}
    return out


SCENARIOS = ["happy", "nan", "terminal", "bake-rollback",
             "midramp-rollback", "chaos-every-site", "seeded-chaos",
             "rollback-exhaustion", "stop-during-canary",
             "held-against-watcher", "failed-canary-keeps-hold"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_step_scenarios_match_jax(tmp_path, monkeypatch, name):
    got = {pkg: _scenario(_namespace(pkg), tmp_path / pkg, name,
                          monkeypatch)
           for pkg in PKGS}
    assert got["torch"]["transitions"] == got["jax"]["transitions"]
    assert got["torch"] == got["jax"]
    assert got["torch"]["counters"], "no ml.controller counters"


def test_happy_path_counters(pkg, tmp_path):
    model = f"happy-{pkg.name}"
    reg, ctrl = build_controller(
        pkg, tmp_path, model, lambda t: ([np.full(3, 9.0)], None),
        stages=(0.5, 1.0))
    assert drive_cycle(pkg, reg, ctrl) == "swapped"
    got = counters(pkg, "controller")
    assert got.get(f'retrains{{model="{model}"}}') == 1
    assert got.get(f'cycles{{model="{model}",outcome="swapped"}}') == 1
    ctrl.stop()


def test_config_from_env_and_validation(pkg, monkeypatch):
    cfg_cls = pkg.serving.ControllerConfig
    monkeypatch.setenv("FLINK_ML_TPU_OPS_STAGES", "0.1,0.9")
    monkeypatch.setenv("FLINK_ML_TPU_OPS_STAGE_MIN_REQUESTS", "7")
    monkeypatch.setenv("FLINK_ML_TPU_OPS_COOLDOWN_S", "1.5")
    monkeypatch.setenv("FLINK_ML_TPU_OPS_QUALITY_GATE", "off")
    cfg = cfg_cls.from_env()
    assert cfg.ramp_stages == (0.1, 0.9)
    assert cfg.stage_min_requests == 7 and cfg.cooldown_s == 1.5
    assert cfg.quality_gate is False
    assert cfg.policy.max_restarts == 4
    monkeypatch.setenv("FLINK_ML_TPU_OPS_STAGES", "junk")
    with pytest.raises(ValueError):
        cfg_cls.from_env()
    monkeypatch.setenv("FLINK_ML_TPU_OPS_STAGES", "0.5")
    monkeypatch.setenv("FLINK_ML_TPU_OPS_LATENCY_QUANTILE", "99")
    with pytest.raises(ValueError, match="latency_quantile"):
        cfg_cls.from_env()
    for bad, match in (({"ramp_stages": (0.5, 0.25)}, "ascending"),
                       ({"ramp_stages": (0.0,)}, "fractions"),
                       ({"max_error_ratio": 2.0}, "max_error_ratio"),
                       ({"latency_quantile": 99.0}, "latency_quantile"),
                       ({"latency_window_s": 0.0}, "latency_window_s"),
                       ({"stage_min_requests": 0}, "min_requests")):
        with pytest.raises(ValueError, match=match):
            cfg_cls(**bad)


def test_controller_route_serves_live_state(pkg, tmp_path, monkeypatch):
    monkeypatch.setenv(pkg.server.METRICS_PORT_ENV, "0")
    reg, ctrl = build_controller(pkg, tmp_path, f"route-{pkg.name}",
                                 lambda t: ([np.full(3, 2.0)], None))
    srv = pkg.server.maybe_start()
    url = f"http://127.0.0.1:{srv.port}/controller"
    with urllib.request.urlopen(url, timeout=10) as r:
        status = json.loads(r.read())["controller"]
    assert status["model"] == f"route-{pkg.name}"
    assert status["state"] == pkg.controller.WATCHING
    assert status["active_version"] == 1 and status["running"] is False
    ctrl.stop()
    with urllib.request.urlopen(url, timeout=10) as r:
        assert json.loads(r.read())["controller"] is None


def test_controller_cycle_shares_one_trace(pkg, tmp_path):
    """Every step span of one cycle shares the trigger step's trace id,
    chained follows_from to the step before."""
    d = str(tmp_path / "trace")
    pkg.tracing.tracer.configure(d)
    reg, ctrl = build_controller(pkg, tmp_path, f"trace-{pkg.name}",
                                 lambda t: ([np.full(3, 4.0)], None),
                                 stages=(1.0,))
    assert drive_cycle(pkg, reg, ctrl) == "swapped"
    ctrl.stop()
    pkg.tracing.tracer.shutdown()
    steps = [sp for sp in pkg.exporters.read_spans(d)
             if sp["name"] == "controller.step"]
    cycle = [sp for sp in steps if sp["attrs"].get("state") != "watching"
             or sp.get("links")]
    assert len(cycle) >= 5
    assert len({sp["trace"] for sp in cycle}) == 1
    assert all(sp.get("links") for sp in cycle)
    # the trigger step (still watching, unlinked) minted the cycle trace
    assert cycle[0]["trace"] in {sp["trace"] for sp in steps
                                 if not sp.get("links")}


# -- CLI and cross-package reads ----------------------------------------------------

def _traced_run(ns, tmp_path, monkeypatch, tag, run):
    trace_dir = str(tmp_path / f"trace-{ns.name}-{tag}")
    ns.metrics.clear()  # the dump holds this run's counters only
    monkeypatch.setenv("FLINK_ML_TPU_TRACE_DIR", trace_dir)
    ns.tracing.tracer.shutdown()  # re-arm against the new dir
    run()
    ns.tracing.tracer.shutdown()
    ns.exporters.dump_metrics(trace_dir)
    monkeypatch.delenv("FLINK_ML_TPU_TRACE_DIR")
    return trace_dir


def _cli_run(ns, tmp_path, kind):
    model = f"cli{kind}"

    def run():
        if kind == "happy":
            reg, ctrl = build_controller(ns, tmp_path / ns.name, model,
                                         lambda t: ([np.full(3, 2.0)],
                                                    None))
            assert drive_cycle(ns, reg, ctrl) == "swapped"
            ctrl.stop()
        elif kind == "failed":
            def bad(trigger):
                raise ValueError("terminal")

            reg, ctrl = build_controller(ns, tmp_path / ns.name, model,
                                         bad)
            assert drive_cycle(ns, reg, ctrl) == "failed"
            ctrl.stop()
        else:  # abandoned mid-cycle
            reg, ctrl = build_controller(ns, tmp_path / ns.name, model,
                                         lambda t: ([np.full(3, 2.0)],
                                                    None))
            for _ in range(4):
                ctrl.step()
            assert ctrl.state != ns.controller.WATCHING
            ns.server.clear_controller_status()
    return run


@pytest.mark.parametrize("kind,check_rc", [("happy", 0), ("failed", 4),
                                           ("abandoned", 4)])
def test_controller_cli_verdicts(pkg, tmp_path, monkeypatch, capsys, kind,
                                 check_rc):
    d = _traced_run(pkg, tmp_path, monkeypatch, kind,
                    _cli_run(pkg, tmp_path, kind))
    main = pkg.controller.main
    assert main([d]) == 0
    out = capsys.readouterr().out
    assert f"cli{kind}" in out
    assert main([d, "--check"]) == check_rc
    capsys.readouterr()
    assert main([d, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["healthy"] is (check_rc == 0)
    if kind == "happy":
        row = doc["summary"]["models"]["clihappy"]
        assert row["cycles"] == {"swapped": 1}
        assert row["last_state"] == pkg.controller.WATCHING


def test_controller_cli_empty_dir_exits_2(pkg, tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert pkg.controller.main([str(empty), "--check"]) == 2
    assert pkg.controller.main([str(tmp_path / "missing")]) == 2


def _drop_ts(summary):
    out = json.loads(json.dumps(summary))
    for row in out["models"].values():
        for ev in row["transitions"]:
            ev.pop("ts_us")
    return out


def test_controller_summary_reads_the_other_packages_trace(tmp_path,
                                                           monkeypatch):
    dirs = {}
    for name in PKGS:
        ns = _namespace(name)
        dirs[name] = _traced_run(ns, tmp_path, monkeypatch, "cross",
                                 _cli_run(ns, tmp_path, "happy"))
    summaries = {}
    for reader in PKGS:
        ex = _namespace(reader).exporters
        for writer, d in dirs.items():
            summaries[reader, writer] = _namespace(
                reader).controller.controller_summary(
                    ex.read_spans(d), ex.read_metrics(d))
    for writer in PKGS:
        assert summaries["jax", writer] == summaries["torch", writer]
    assert _drop_ts(summaries["torch", "torch"]) == _drop_ts(
        summaries["jax", "jax"])
    for reader in PKGS:
        for writer, d in dirs.items():
            assert _namespace(reader).controller.main([d, "--check"]) == 0


# -- port only: the thread that retrains --------------------------------------------

def test_controller_thread_names_the_servables_card_first(tmp_path,
                                                          monkeypatch):
    ns = _namespace("torch")
    reg, ctrl = build_controller(ns, tmp_path, "threaddev",
                                 lambda t: ([np.full(3, 2.0)], None),
                                 check_interval_s=0.01)
    reg.active.device = torch.device("cuda", 0)  # a fake card on the CPU
    order = []
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: order.append(
        ("set_device", torch.device(dev), threading.current_thread().name)))
    real_step = ctrl.step

    def step():
        order.append(("step", None, threading.current_thread().name))
        return real_step()

    ctrl.step = step
    ctrl.start()
    deadline = time.monotonic() + 10.0
    while len(order) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    ctrl.stop()
    assert order[0] == ("set_device", torch.device("cuda", 0),
                        "flink-ml-tpu-ops-controller")
    assert order[1][0] == "step"
    # named once: the later steps find the thread bound already
    assert [o[0] for o in order].count("set_device") == 1


def test_device_fault_in_retrain_fails_the_cycle_after_one_attempt(
        tmp_path):
    ns = _namespace("torch")
    attempts = []

    def retrain(trigger):
        attempts.append(1)
        raise ns.policy.KernelLaunchError("segment_reduce_sum: launch failed")

    reg, ctrl = build_controller(ns, tmp_path, "devfault", retrain)
    active = reg.active
    assert drive_cycle(ns, reg, ctrl) == "failed"
    assert len(attempts) == 1
    assert reg.version == 1 and reg.active is active
    assert "KernelLaunchError" in ctrl.transitions[-1]["reason"]
    ctrl.stop()
