"""The port's resilience layer (``flink_ml_tpu_torch/resilience``) and the
integrity of its checkpoints, mirrored from tests/test_resilience.py and
held against the JAX package where the two must agree (the failure
taxonomy, the seeded fault schedules).

- Policy: the default taxonomy, overrides, backoff and validation; the
  port's terminal additions: ``NonFiniteState``, its kernel build and launch
  errors and ``torch.AcceleratorError``.
- Supervisor: retries with backoff, terminal failures at once, the restart
  and deadline budgets, restart and recovery events, the orphan sweep.
- Checkpoints: digests, quarantine of corrupt snapshots and fallback to
  older ones, the legacy v1 manifest, the publish fault.
- Chaos: seeded and explicit plans, the environment plan, and supervised
  chaos runs of the host loop, ``run_segmented`` and the LR and KMeans fits
  that end bit-identical to a clean run of the port.
"""

import json
import os

import numpy as np
import pytest
import torch

from flink_ml_tpu.resilience import RetryPolicy as JaxRetryPolicy
from flink_ml_tpu.resilience import faults as jax_faults
from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager
from flink_ml_tpu_torch.iteration.iteration import (
    IterationConfig,
    IterationListener,
    iterate_bounded,
    run_segmented,
)
from flink_ml_tpu_torch.models.classification import LogisticRegression
from flink_ml_tpu_torch.models.clustering import KMeans
from flink_ml_tpu_torch.models.regression import LinearRegression
from flink_ml_tpu_torch.observability import health
from flink_ml_tpu_torch.ops import _build, kernels
from flink_ml_tpu_torch.resilience import (
    RETRYABLE,
    TERMINAL,
    InjectedFault,
    KernelBuildError,
    KernelLaunchError,
    NonFiniteState,
    RestartsExhausted,
    RetryPolicy,
    TerminalFailure,
    WorkerLost,
    WorkerTimeout,
    faults,
    run_supervised,
)
from flink_ml_tpu_torch.resilience import supervisor as sup

CHAOS_VARS = ("FLINK_ML_TPU_CHAOS", "FLINK_ML_TPU_CHAOS_SEED",
              "FLINK_ML_TPU_CHAOS_RATE", "FLINK_ML_TPU_CHAOS_SITES",
              "FLINK_ML_TPU_CHAOS_AT")


@pytest.fixture(autouse=True)
def _no_ambient_chaos(monkeypatch):
    """Each test opts into chaos explicitly, whether or not the environment
    armed it for the process; per-test schedules start fresh."""
    for var in CHAOS_VARS:
        monkeypatch.delenv(var, raising=False)
    faults.reset_env_plan()
    jax_faults.reset_env_plan()


# -- policy ------------------------------------------------------------------

class _Weird(Exception):
    pass


@pytest.mark.parametrize("exc,want", [
    (WorkerTimeout(3, 1.0), RETRYABLE),
    (WorkerLost(1, "gone", 2.0), RETRYABLE),
    (InjectedFault("epoch-boundary", 1), RETRYABLE),
    (OSError("pipe"), RETRYABLE),
    (RuntimeError("transient"), RETRYABLE),
    (MemoryError(), RETRYABLE),
    (_Weird(), RETRYABLE),  # unknown Exception subclasses: retryable
    (ValueError("bad shape"), TERMINAL),
    (TypeError(), TERMINAL),
    (NotImplementedError(), TERMINAL),  # despite RuntimeError
    (TerminalFailure(), TERMINAL),
    (RestartsExhausted(2, "x"), TERMINAL),
])
def test_classification_defaults_match_jax(exc, want):
    assert RetryPolicy().classify(exc) == want
    if type(exc).__module__ in ("builtins", __name__):
        # the JAX policy classifies the same built-in failures the same way
        assert JaxRetryPolicy().classify(exc) == want


@pytest.mark.parametrize("exc", [
    NonFiniteState("LogisticRegression"),
    NonFiniteState("KMeans", epoch=3, detail="loss"),
    KernelBuildError("nvcc failed building sgd_kernels.cu"),
    KernelLaunchError("sgd_batch_terms: CUDA error 700 (illegal address)"),
    torch.AcceleratorError("CUDA error: an illegal memory access"),
], ids=["non-finite", "non-finite-epoch", "build", "launch", "accelerator"])
def test_device_faults_and_divergence_are_terminal(exc):
    """A diverged fit replays into the same overflow, and a device fault
    poisons the CUDA context: no retry in the process can help. The kernel
    errors stay RuntimeErrors for callers that catch those."""
    assert RetryPolicy().classify(exc) == TERMINAL
    assert isinstance(exc, RuntimeError) or isinstance(exc, TerminalFailure)


def test_non_finite_state_keeps_the_jax_signature():
    err = NonFiniteState("KMeans", epoch=4, detail="centroids")
    assert (err.algo, err.epoch) == ("KMeans", 4)
    assert str(err) == "KMeans diverged to a non-finite state at epoch 4 " \
        "(centroids)"
    assert health.NonFiniteState is NonFiniteState


def test_build_and_launch_errors_are_the_terminal_types(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(KernelBuildError, match="nvcc not found"):
        _build._nvcc()
    with pytest.raises(KernelLaunchError, match="fits an SM"):
        kernels._blocks_on_card(0, 0, "sgd_rows_kernel")


def test_classification_policy_overrides_beat_defaults():
    p = RetryPolicy(terminal=(OSError,), retryable=(ValueError,))
    assert p.classify(OSError()) == TERMINAL
    assert p.classify(ValueError()) == RETRYABLE


def test_backoff_schedule_and_cap():
    p = RetryPolicy(backoff_s=0.5, backoff_multiplier=3.0, max_backoff_s=4.0)
    assert [p.backoff(i) for i in range(4)] == [0.0, 0.5, 1.5, 4.0]


@pytest.mark.parametrize("kwargs", [dict(max_restarts=-1),
                                    dict(backoff_multiplier=0.5),
                                    dict(backoff_s=-1.0)])
def test_policy_validation(kwargs):
    with pytest.raises(ValueError):
        RetryPolicy(**kwargs)


# -- supervisor --------------------------------------------------------------

def test_supervisor_retries_then_succeeds_with_backoff_sequence():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 4:
            raise OSError("transient")
        return 42

    policy = RetryPolicy(max_restarts=5, backoff_s=0.25,
                         backoff_multiplier=2.0)
    assert run_supervised(flaky, policy=policy, sleep=slept.append) == 42
    assert len(calls) == 4 and slept == [0.25, 0.5, 1.0]


@pytest.mark.parametrize("exc", [ValueError("bug"), NonFiniteState("x"),
                                 KernelLaunchError("CUDA error 700")])
def test_supervisor_terminal_propagates_immediately(exc):
    calls = []

    def bad():
        calls.append(1)
        raise exc

    with pytest.raises(type(exc)):
        run_supervised(bad, policy=RetryPolicy(max_restarts=5),
                       sleep=lambda s: None)
    assert len(calls) == 1


def test_supervisor_exhausts_budget_chains_cause():
    def always():
        raise OSError("down")

    with pytest.raises(RestartsExhausted) as ei:
        run_supervised(always, policy=RetryPolicy(max_restarts=2,
                                                  backoff_s=0.0),
                       sleep=lambda s: None)
    assert isinstance(ei.value.__cause__, OSError)
    assert ei.value.attempts == 2 and ei.value.budget == "restart"
    assert "restart budget" in str(ei.value)
    assert "deadline" not in str(ei.value)


def test_supervisor_deadline_budget():
    def always():
        raise OSError("down")

    with pytest.raises(RestartsExhausted, match="deadline budget") as ei:
        run_supervised(always,
                       policy=RetryPolicy(max_restarts=100, backoff_s=0.0,
                                          deadline_s=0.0),
                       sleep=lambda s: None)
    assert ei.value.budget == "deadline"
    assert "restart budget" not in str(ei.value)


class _FakeClock:
    """A monotonic clock advanced only by the supervisor's sleep."""

    def __init__(self):
        self.now = 0.0
        self.sleeps = []

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s


def test_supervisor_final_sleep_clipped_to_deadline_budget(monkeypatch):
    clock = _FakeClock()
    monkeypatch.setattr(sup.time, "monotonic", clock.monotonic)

    def always():
        raise OSError("down")

    with pytest.raises(RestartsExhausted) as ei:
        run_supervised(always,
                       policy=RetryPolicy(max_restarts=100, backoff_s=0.7,
                                          backoff_multiplier=2.0,
                                          deadline_s=1.0),
                       sleep=clock.sleep)
    assert clock.sleeps == [0.7, pytest.approx(0.3)]
    assert "deadline budget" in str(ei.value) and "1s" in str(ei.value)
    assert ei.value.attempts == 2


def test_supervisor_emits_restart_and_recovery_events():
    events = []

    class Recorder(IterationListener):
        def on_restart(self, attempt, error):
            events.append(("restart", attempt, type(error).__name__))

        def on_recovered(self, attempt):
            events.append(("recovered", attempt))

    class Broken:
        def on_restart(self, attempt, error):
            raise RuntimeError("a listener failing must not stop recovery")

    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("x")
        return "ok"

    out = run_supervised(flaky, policy=RetryPolicy(backoff_s=0.0),
                         listeners=[Broken(), Recorder()],
                         sleep=lambda s: None)
    assert out == "ok"
    assert events == [("restart", 1, "OSError"), ("restart", 2, "OSError"),
                      ("recovered", 2)]


def test_supervisor_sweeps_tmp_orphans_between_attempts(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            os.makedirs(os.path.join(mgr.base_dir, "ckpt-00000001.tmp"))
            raise OSError("crashed mid-save")
        assert not any(n.endswith(".tmp") for n in os.listdir(mgr.base_dir))
        return "ok"

    assert run_supervised(flaky, mgr=mgr, policy=RetryPolicy(backoff_s=0.0),
                          sleep=lambda s: None) == "ok"


# -- checkpoint integrity ----------------------------------------------------

def _carry():
    return (torch.arange(8, dtype=torch.float32), np.float64(1.25))


def _two_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(_carry(), 2)
    mgr.save((torch.arange(8, dtype=torch.float32) * 2, np.float64(2.5)), 4)
    return mgr


def _assert_fell_back(mgr, quarantined_name="ckpt-00000004"):
    got = mgr.restore(_carry())
    assert got is not None
    carry, epoch = got
    assert epoch == 2
    assert torch.equal(carry[0], torch.arange(8, dtype=torch.float32))
    names = os.listdir(mgr.base_dir)
    assert any(n.startswith(quarantined_name + ".corrupt") for n in names), \
        names
    assert mgr.list_checkpoints() == ["ckpt-00000002"]


def test_manifest_records_digests_dtype_shape(tmp_path):
    path = CheckpointManager(str(tmp_path / "ckpt")).save(_carry(), 3)
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    assert m["version"] == 2 and m["num_leaves"] == 2 and m["epoch"] == 3
    assert m["leaves"][0]["dtype"] == "float32"
    assert m["leaves"][0]["shape"] == [8]
    assert m["leaves"][1] == {**m["leaves"][1], "dtype": "float64",
                              "shape": []}
    assert len(m["leaves"][0]["sha256"]) == 64


def _truncate_npz(base):
    npz = os.path.join(base, "ckpt-00000004", "leaves.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)


def _remove_manifest(base):
    os.remove(os.path.join(base, "ckpt-00000004", "manifest.json"))


def _flip_a_leaf(base):
    # a valid archive with altered content: only the sha256 catches it
    npz = os.path.join(base, "ckpt-00000004", "leaves.npz")
    with np.load(npz) as z:
        leaves = {k: z[k].copy() for k in z.files}
    leaves["leaf_0"][3] += 1.0
    np.savez(npz, **leaves)


def _wrong_leaf_count(base):
    path = os.path.join(base, "ckpt-00000004", "manifest.json")
    with open(path) as f:
        m = json.load(f)
    m["num_leaves"] = 3
    with open(path, "w") as f:
        json.dump(m, f)


def _manifest_text(text):
    def corrupt(base):
        with open(os.path.join(base, "ckpt-00000004", "manifest.json"),
                  "w") as f:
            f.write(text)
    return corrupt


@pytest.mark.parametrize("corrupt", [
    _truncate_npz, _remove_manifest, _flip_a_leaf, _wrong_leaf_count,
    _manifest_text("null"),
    _manifest_text('{"num_leaves": 2, "leaves": [1, 2]}'),
    _manifest_text('{"num_leaves": 2, "version": 2, "leaves": null}'),
    _manifest_text("{not json"),
], ids=["truncated-npz", "missing-manifest", "bit-flipped-leaf",
        "leaf-count", "null-manifest", "non-dict-records", "no-epoch",
        "unparsable"])
def test_corrupt_newest_checkpoint_falls_back(tmp_path, corrupt):
    """Any corruption of the newest snapshot quarantines it and restores the
    next-older one; the recovery path never raises."""
    mgr = _two_checkpoints(tmp_path)
    corrupt(mgr.base_dir)
    _assert_fell_back(mgr)


def test_restore_all_corrupt_returns_none(tmp_path):
    mgr = _two_checkpoints(tmp_path)
    for name in list(mgr.list_checkpoints()):
        os.remove(os.path.join(mgr.base_dir, name, "manifest.json"))
    assert mgr.restore(_carry()) is None
    assert mgr.list_checkpoints() == []
    assert len([n for n in os.listdir(mgr.base_dir) if ".corrupt" in n]) == 2


def test_restore_legacy_v1_manifest(tmp_path):
    """Checkpoints without per-leaf records still restore: digest checks
    are skipped, the structure is still validated."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    path = mgr.save(_carry(), 5)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"epoch": 5, "num_leaves": 2}, f)
    got = mgr.restore(_carry())
    assert got is not None and got[1] == 5


def test_init_sweeps_orphaned_tmp_dirs(tmp_path):
    base = str(tmp_path / "ckpt")
    os.makedirs(os.path.join(base, "ckpt-00000003.tmp"))
    os.makedirs(os.path.join(base, "ckpt-00000007.tmp"))
    os.makedirs(os.path.join(base, "ckpt-00000004"))
    mgr = CheckpointManager(base)
    names = os.listdir(base)
    assert not any(n.endswith(".tmp") for n in names)
    assert "ckpt-00000004" in names
    assert mgr.sweep_orphans() == 0  # idempotent


def test_quarantined_dirs_not_listed_or_gced(tmp_path):
    mgr = _two_checkpoints(tmp_path)
    os.remove(os.path.join(mgr.base_dir, "ckpt-00000004", "manifest.json"))
    mgr.restore(_carry())
    mgr.save(_carry(), 6)
    mgr.save(_carry(), 8)
    assert mgr.list_checkpoints() == ["ckpt-00000006", "ckpt-00000008"]
    assert any(".corrupt" in n for n in os.listdir(mgr.base_dir))


@pytest.mark.parametrize("site", ["checkpoint-save", "checkpoint-publish"])
def test_save_fault_leaves_no_visible_checkpoint(tmp_path, site):
    """A crash at either save site leaves the previous checkpoint intact
    and, past the tmp write, only a sweepable orphan behind."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(_carry(), 2)
    with faults.chaos(at={site: [1]}):
        with pytest.raises(InjectedFault):
            mgr.save(_carry(), 4)
    assert mgr.list_checkpoints() == ["ckpt-00000002"]
    orphans = [n for n in os.listdir(mgr.base_dir) if n.endswith(".tmp")]
    assert len(orphans) == (site == "checkpoint-publish")
    mgr.sweep_orphans()
    assert not any(n.endswith(".tmp") for n in os.listdir(mgr.base_dir))


def test_extras_ride_inside_the_atomic_publish(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    path = mgr.save(_carry(), 2, extras={"baseline": {"psi": 0.1}})
    with open(os.path.join(path, "baseline.json")) as f:
        assert json.load(f) == {"psi": 0.1}
    assert mgr.restore(_carry())[1] == 2


# -- chaos harness -----------------------------------------------------------

@pytest.mark.parametrize("seed,rate", [(7, 0.5), (1234, 0.15), (0, 0.05)])
def test_fault_plan_schedule_matches_jax(seed, rate):
    """A seed gives the same schedule in both packages (the version-2
    string seeding), and another seed another schedule."""
    sites = ("epoch-boundary", "checkpoint-save")
    plan = faults.FaultPlan(seed=seed, rate=rate)
    ref = jax_faults.FaultPlan(seed=seed, rate=rate)
    got = [plan.decide(s) for _ in range(40) for s in sites]
    assert got == [ref.decide(s) for _ in range(40) for s in sites]
    assert any(got)
    other = faults.FaultPlan(seed=seed + 1, rate=rate)
    assert got != [other.decide(s) for _ in range(40) for s in sites]


def test_fault_plan_explicit_schedule_and_site_filter():
    with faults.chaos(at={"checkpoint-save": [2]}):
        faults.inject("checkpoint-save")  # call 1: no fault
        with pytest.raises(InjectedFault) as ei:
            faults.inject("checkpoint-save")
        assert ei.value.count == 2 and ei.value.site == "checkpoint-save"
        faults.inject("epoch-boundary")  # unlisted site never faults
    with faults.chaos(rate=1.0, sites=["epoch-boundary"]):
        faults.inject("checkpoint-save")  # filtered out
        with pytest.raises(InjectedFault):
            faults.inject("epoch-boundary")


def test_suppressed_disables_injection():
    with faults.chaos(rate=1.0):
        with faults.suppressed():
            faults.inject("epoch-boundary")
        with pytest.raises(InjectedFault):
            faults.inject("epoch-boundary")


def test_env_activation(monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_CHAOS", "1")
    monkeypatch.setenv("FLINK_ML_TPU_CHAOS_AT", "checkpoint-save:1")
    with pytest.raises(InjectedFault):
        faults.inject("checkpoint-save")
    faults.inject("checkpoint-save")  # only call 1 is scheduled
    monkeypatch.setenv("FLINK_ML_TPU_CHAOS", "0")
    faults.inject("checkpoint-save")  # off


def test_env_malformed_at_entry_ignored(monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_CHAOS", "1")
    monkeypatch.setenv("FLINK_ML_TPU_CHAOS_AT",
                       "checkpoint-save,epoch-boundary:notanint,"
                       "native-kernel:1")
    faults.inject("checkpoint-save")  # malformed entries skipped
    with pytest.raises(InjectedFault):
        faults.inject("native-kernel")


@pytest.mark.parametrize("flag,armed", [("0", False), ("false", False),
                                        ("False", False), ("off", False),
                                        ("no", False), ("", False),
                                        ("1", True), ("yes", True)])
def test_env_armed_matches_off_set(monkeypatch, flag, armed):
    monkeypatch.setenv("FLINK_ML_TPU_CHAOS", flag)
    assert faults.env_armed() is armed
    assert jax_faults.env_armed() is armed


def test_env_rearm_resets_schedule_counters(monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_CHAOS", "1")
    monkeypatch.setenv("FLINK_ML_TPU_CHAOS_AT", "native-kernel:1")
    with pytest.raises(InjectedFault):
        faults.inject("native-kernel")
    faults.inject("native-kernel")  # call #2: nothing scheduled
    monkeypatch.setenv("FLINK_ML_TPU_CHAOS", "0")
    faults.inject("native-kernel")  # the disarmed call observes the off
    monkeypatch.setenv("FLINK_ML_TPU_CHAOS", "1")
    with pytest.raises(InjectedFault):
        faults.inject("native-kernel")  # a fresh plan: call #1 again


def test_env_rate_plan_uses_seed(monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_CHAOS", "1")
    monkeypatch.setenv("FLINK_ML_TPU_CHAOS_SEED", "1234")
    monkeypatch.setenv("FLINK_ML_TPU_CHAOS_RATE", "1.0")
    with pytest.raises(InjectedFault):
        faults.inject("native-kernel")
    assert faults.active_plan().seed == 1234


# -- end-to-end recovery: the drivers ------------------------------------------

_A = np.diag([1.0, 2.0, 3.0])
_B = np.array([1.0, -2.0, 0.5])


def _gd_body(carry, epoch):
    w, _ = carry
    w = w - 0.1 * (_A @ w - _B)
    return w, np.float64(0.5 * w @ _A @ w - _B @ w)


def _gd_init():
    return np.zeros(3), np.float64(np.inf)


def _gd_expected():
    with faults.suppressed():
        return iterate_bounded(_gd_init(), _gd_body, max_iter=30,
                               jit_round=False,
                               config=IterationConfig(mode="host"))[0]


def test_host_loop_supervised_chaos_identical(tmp_path):
    expected = _gd_expected()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    cfg = IterationConfig(mode="host", checkpoint_interval=5,
                          checkpoint_manager=mgr)

    def fit_once():
        return iterate_bounded(_gd_init(), _gd_body, max_iter=30,
                               jit_round=False, config=cfg)

    with faults.chaos(at={"epoch-boundary": [12, 23],
                          "checkpoint-save": [4]}):
        got, _ = run_supervised(fit_once, mgr=mgr,
                                policy=RetryPolicy(max_restarts=5,
                                                   backoff_s=0.0),
                                sleep=lambda s: None)
    np.testing.assert_array_equal(got, expected)
    assert not mgr.list_checkpoints()


def test_host_loop_supervised_corrupt_newest_checkpoint(tmp_path):
    """Crash at a boundary and corrupt the newest snapshot: the retry
    restores the older one, quarantines the corrupt one and still ends with
    the uninterrupted result."""
    expected = _gd_expected()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    cfg = IterationConfig(mode="host", checkpoint_interval=5,
                          checkpoint_manager=mgr)
    state = {"corrupted": False}

    class CorruptAfterCrash(IterationListener):
        def on_restart(self, attempt, error):
            newest = mgr.list_checkpoints()[-1]
            os.remove(os.path.join(mgr.base_dir, newest, "manifest.json"))
            state["corrupted"] = True

    def fit_once():
        return iterate_bounded(_gd_init(), _gd_body, max_iter=30,
                               jit_round=False, config=cfg)

    with faults.chaos(at={"epoch-boundary": [14]}):
        got, _ = run_supervised(fit_once, mgr=mgr,
                                policy=RetryPolicy(max_restarts=3,
                                                   backoff_s=0.0),
                                listeners=[CorruptAfterCrash()],
                                sleep=lambda s: None)
    assert state["corrupted"]
    np.testing.assert_array_equal(got, expected)
    assert any(".corrupt" in n for n in os.listdir(mgr.base_dir))


def test_run_segmented_supervised_chaos_identical(tmp_path):
    def run_segment(carry, epoch0, limit):
        w, loss = carry
        for e in range(epoch0, limit):
            w, loss = _gd_body((w, loss), e)
        return (w, loss), limit, False

    with faults.suppressed():
        expected, _ = run_segmented(
            run_segment, _gd_init(), 30, 5,
            CheckpointManager(str(tmp_path / "clean")))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))

    def fit_once():
        return run_segmented(run_segment, _gd_init(), 30, 5, mgr)

    with faults.chaos(at={"epoch-boundary": [3], "checkpoint-save": [5],
                          "checkpoint-publish": [2]}):
        got, _ = run_supervised(fit_once, mgr=mgr,
                                policy=RetryPolicy(max_restarts=6,
                                                   backoff_s=0.0),
                                sleep=lambda s: None)
    np.testing.assert_array_equal(got, expected)
    assert not any(n.endswith(".tmp") for n in os.listdir(mgr.base_dir))


# -- end-to-end recovery: the fits ---------------------------------------------

def _lr_table(seed=42):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=(300, 5)),
                        rng.normal(size=(300, 5)) + 2]).astype(np.float32)
    y = np.concatenate([np.zeros(300), np.ones(300)]).astype(np.float32)
    return Table.from_columns(features=x, label=y)


def _km_table(seed=42):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=(100, 3)),
                        rng.normal(size=(100, 3)) + 6]).astype(np.float32)
    return Table.from_columns(features=x)


def _lr():
    return LogisticRegression(max_iter=12, global_batch_size=200,
                              learning_rate=0.1, device="cpu")


def _km():
    return KMeans(k=2, seed=7, max_iter=8, device="cpu")


class _Restarts(IterationListener):
    def __init__(self):
        self.restarts, self.recovered = [], []

    def on_restart(self, attempt, error):
        self.restarts.append((attempt, type(error).__name__))

    def on_recovered(self, attempt):
        self.recovered.append(attempt)


@pytest.mark.parametrize("model,mode,k,at", [
    ("lr", "host", 2, {"epoch-boundary": [7], "checkpoint-save": [2]}),
    ("lr", "device", 2, {"checkpoint-publish": [3], "epoch-boundary": [5]}),
    ("lr", "device", 5, {"epoch-boundary": [2]}),
    ("km", "device", 3, {"epoch-boundary": [2], "checkpoint-save": [2]}),
    ("km", "device", 3, {"epoch-boundary": [2]}),
    ("km", "host", 3, {"epoch-boundary": [4]}),
])
def test_supervised_fit_under_chaos_is_bit_identical(tmp_path, model, mode,
                                                     k, at):
    est, table = (_lr, _lr_table) if model == "lr" else (_km, _km_table)
    with faults.suppressed():
        clean = est().fit(table())
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    cfg = IterationConfig(mode=mode, checkpoint_interval=k,
                          checkpoint_manager=mgr)
    with faults.chaos(at=at):
        got = (est().set_iteration_config(cfg)
               .set_retry_policy(RetryPolicy(max_restarts=6, backoff_s=0.0))
               .fit(table()))
    if model == "lr":
        np.testing.assert_array_equal(got.coefficients, clean.coefficients)
    else:
        np.testing.assert_array_equal(got.centroids, clean.centroids)
        np.testing.assert_array_equal(got.weights, clean.weights)
    assert not mgr.list_checkpoints()


@pytest.mark.parametrize("model", ["lr", "km"])
def test_chaos_at_the_second_boundary_costs_one_restart(tmp_path, model):
    """The chip smoke's chaos run in miniature: the fit fails at its second
    segment boundary, resumes from the snapshot of the first and reports one
    restart, then its recovery."""
    est, table = (_lr, _lr_table) if model == "lr" else (_km, _km_table)
    with faults.suppressed():
        clean = est().fit(table())
    restarts = _Restarts()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    segmented = est().set_iteration_config(IterationConfig(
        checkpoint_interval=3, checkpoint_manager=mgr))
    with faults.chaos(at={"epoch-boundary": [2]}):
        # the supervisor's own entry point, so that a listener hears the
        # restart without turning the segments into host rounds
        got = run_supervised(lambda: segmented.fit(table()), mgr=mgr,
                             policy=RetryPolicy(backoff_s=0),
                             listeners=[restarts])
    assert segmented.last_execution_path.endswith("-segments")
    assert restarts.restarts == [(1, "InjectedFault")]
    assert restarts.recovered == [1]
    np.testing.assert_array_equal(
        got.coefficients if model == "lr" else got.centroids,
        clean.coefficients if model == "lr" else clean.centroids)


def test_seeded_rate_chaos_recovers_deterministically(tmp_path):
    with faults.suppressed():
        expected = _lr().fit(_lr_table()).coefficients
    for trial in range(2):
        cfg = IterationConfig(
            mode="host", checkpoint_interval=2,
            checkpoint_manager=CheckpointManager(
                str(tmp_path / f"ckpt{trial}")))
        with faults.chaos(seed=1234, rate=0.15,
                          sites=["epoch-boundary", "checkpoint-save"]):
            got = (_lr().set_iteration_config(cfg)
                   .set_retry_policy(RetryPolicy(max_restarts=20,
                                                 backoff_s=0.0))
                   .fit(_lr_table()).coefficients)
        np.testing.assert_array_equal(got, expected)


def test_supervised_fit_that_diverges_fails_after_one_attempt(monkeypatch):
    """NonFiniteState is terminal: a diverging supervised fit raises at once
    and does not burn its restarts."""
    attempts = []
    real = LinearRegression._fit_once

    def counting(self, table):
        attempts.append(1)
        return real(self, table)

    monkeypatch.setattr(LinearRegression, "_fit_once", counting)
    rng = np.random.default_rng(9)
    table = Table.from_columns(features=rng.normal(size=(64, 4)) * 1e3,
                               label=rng.normal(size=64) * 1e3)
    restarts = _Restarts()
    est = (LinearRegression(device="cpu", learning_rate=1e12, max_iter=9,
                            global_batch_size=64)
           .set_iteration_config(None, listeners=[restarts])
           .set_retry_policy(RetryPolicy(max_restarts=5, backoff_s=0.0)))
    with pytest.raises(NonFiniteState, match="LinearRegression"):
        est.fit(table)
    assert attempts == [1] and restarts.restarts == []


def test_supervised_fit_with_a_kernel_fault_fails_after_one_attempt(
        monkeypatch):
    """A kernel launch error is terminal: the supervisor never retries into
    a poisoned CUDA context, and no plain version stands in for the
    kernel."""
    calls = []

    def faulting(*args, **kwargs):
        calls.append(1)
        raise KernelLaunchError("sgd_batch_terms: CUDA error 700")

    monkeypatch.setattr(kernels, "sgd_batch_terms", faulting)
    restarts = _Restarts()
    est = (_lr().set_iteration_config(IterationConfig(mode="host"),
                                      listeners=[restarts])
           .set_retry_policy(RetryPolicy(max_restarts=5, backoff_s=0.0)))
    with pytest.raises(KernelLaunchError):
        est.fit(_lr_table())
    assert calls == [1] and restarts.restarts == []
