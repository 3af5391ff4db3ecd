"""The port's observability core on its fits, held against the JAX package.

The same numpy-seeded tables go through the JAX estimators (pinned to a
one-device mesh) and through the port with ``device="cpu"`` (the kernels'
plain versions), traced into separate directories.

- Traced-fit parity: the supervised KMeans fit of tests/test_observability
  .py:500-537 (240 × 4, k = 3, seed 7, host mode, interval 2, one fault at
  ``epoch-boundary`` 4) and an LR segment fit (K = 2, one fault at the
  second boundary) give the same multiset of (span name, parent span name)
  and of event names — less the JAX package's compile events
  (``compile.backend``, ``ml.collective.traced``), which have no eager
  counterpart — and the same counters in ``ml.iteration``,
  ``ml.checkpoint`` and ``ml.resilience``.
- Health parity, ``FLINK_ML_TPU_HEALTH=1``: the ``[loss, updateNorm,
  paramNorm]`` series of the logistic, hinge and least-square fits in the
  all-device, segment and host modes, and KMeans' ``centerShift`` series,
  match within rtol 1e-5 (atol 1e-7: float32 fits whose sums are added in
  another order); ``classify_divergence`` gives the same verdicts; a
  diverging fit raises ``NonFiniteState`` in both packages.
- Nothing armed: a fit writes no file, leaves the registry empty, and gives
  the bits of the same fit armed.
- ``sample_memory`` never initialises CUDA; the profile parser folds a
  written Chrome trace's ``cat: "kernel"`` events into per-kernel rows and
  roofline shares; a CPU capture reads ``host-fallback``.
- Cases carried over from tests/test_observability.py, test_health.py,
  test_compilestats.py and test_profiling.py against the port.
"""

import collections
import json
import math
import os
import re
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.iteration import checkpoint as jax_ckpt
from flink_ml_tpu.iteration import iteration as jax_iter
from flink_ml_tpu.linalg.vectors import DenseVector as JaxDenseVector
from flink_ml_tpu.models import online as jax_online
from flink_ml_tpu.models.classification import LinearSVC as JaxLinearSVC
from flink_ml_tpu.models.classification import (
    LogisticRegression as JaxLogisticRegression,
)
from flink_ml_tpu.models.clustering import KMeans as JaxKMeans
from flink_ml_tpu.models.regression import LinearRegression as JaxLinearRegression
from flink_ml_tpu.observability import exporters as jax_exporters
from flink_ml_tpu.observability import health as jax_health
from flink_ml_tpu.observability import tracing as jax_tracing
from flink_ml_tpu.parallel import create_mesh, set_default_mesh
from flink_ml_tpu.resilience import NonFiniteState as JaxNonFiniteState
from flink_ml_tpu.resilience import RetryPolicy as JaxRetryPolicy
from flink_ml_tpu.resilience import faults as jax_faults
from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.api.stage import Estimator, Model
from flink_ml_tpu_torch.benchmark import runner
from flink_ml_tpu_torch.common.metrics import (
    ML_GROUP,
    PROFILE_DIR_ENV,
    metrics,
)
from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager
from flink_ml_tpu_torch.iteration.iteration import (
    IterationConfig,
    iterate_bounded,
)
from flink_ml_tpu_torch.linalg.vectors import DenseVector
from flink_ml_tpu_torch.models.classification import (
    LinearSVC,
    LogisticRegression,
)
from flink_ml_tpu_torch.models.clustering import KMeans
from flink_ml_tpu_torch.models.common import IterationRuntimeMixin
from flink_ml_tpu_torch.models.online import OnlineLogisticRegression
from flink_ml_tpu_torch.models.regression import LinearRegression
from flink_ml_tpu_torch.observability import (
    compilestats,
    health,
    profiling,
)
from flink_ml_tpu_torch.observability.exporters import (
    prometheus_text,
    read_metrics,
    read_spans,
    write_chrome_trace,
)
from flink_ml_tpu_torch.observability.tracing import TRACE_DIR_ENV, tracer
from flink_ml_tpu_torch.ops import kernels
from flink_ml_tpu_torch.parallel import create_mesh as port_create_mesh
from flink_ml_tpu_torch.resilience import NonFiniteState, RetryPolicy, faults

RTOL, ATOL = 1e-5, 1e-7
CHAOS_VARS = ("FLINK_ML_TPU_CHAOS", "FLINK_ML_TPU_CHAOS_SEED",
              "FLINK_ML_TPU_CHAOS_RATE", "FLINK_ML_TPU_CHAOS_SITES",
              "FLINK_ML_TPU_CHAOS_AT")
#: JAX-package events that come from tracing and compiling XLA programs;
#: the port runs eagerly and compiles nothing per fit (ROADMAP Queue 3)
JAX_ONLY_EVENTS = {"compile.backend", "compile", "compile.cost",
                   "compile.storm", "ml.collective.traced"}
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in CHAOS_VARS + (TRACE_DIR_ENV, health.HEALTH_ENV,
                             profiling.CAPTURE_ENV, PROFILE_DIR_ENV):
        monkeypatch.delenv(var, raising=False)
    faults.reset_env_plan()
    jax_faults.reset_env_plan()
    profiling.reset()
    yield
    tracer.shutdown()
    jax_tracing.tracer.shutdown()
    profiling.reset()


@pytest.fixture
def one_device_mesh():
    set_default_mesh(create_mesh(devices=jax.devices()[:1]))
    try:
        yield
    finally:
        set_default_mesh(None)


def _events(trace_dir, name, reader=read_spans):
    return [ev for sp in reader(str(trace_dir))
            for ev in sp.get("events", ()) if ev.get("name") == name]


def _structure(trace_dir, reader):
    spans = reader(str(trace_dir))
    by_id = {s["id"]: s for s in spans}
    pairs = collections.Counter(
        (s["name"], (by_id.get(s["parent"]) or {}).get("name"))
        for s in spans)
    events = collections.Counter(
        ev["name"] for s in spans for ev in s["events"]
        if ev["name"] not in JAX_ONLY_EVENTS)
    return pairs, events


def _counters(snapshot, group):
    return (snapshot.get(group) or {}).get("counters", {})


# -- traced-fit parity ---------------------------------------------------------

def _kmeans_table(pkg_table, seed=0):
    x = np.random.default_rng(seed).normal(size=(240, 4)).astype(np.float32)
    return pkg_table.from_columns(features=x)


def _lr_table(pkg_table, seed=1, n=200, d=5, regression=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d)
    y = x @ w if regression else (x @ w + 0.3 * rng.normal(size=n) > 0)
    return pkg_table.from_columns(features=x, label=y.astype(np.float64))


def _supervised(est_cls, table, cfg_cls, mgr, policy, mode, at,
                chaos, **params):
    cfg = cfg_cls(mode=mode, checkpoint_interval=2, checkpoint_manager=mgr)
    est = (est_cls(**params).set_iteration_config(cfg)
           .set_retry_policy(policy))
    with chaos(at={"epoch-boundary": [at]}):
        return est.fit(table)


@pytest.mark.parametrize("case", ["kmeans-host", "lr-segments"])
def test_traced_supervised_fit_matches_jax(one_device_mesh, tmp_path,
                                           monkeypatch, case):
    if case == "kmeans-host":
        params, mode, at = dict(k=3, seed=7, max_iter=6), "host", 4
        classes = (JaxKMeans, KMeans)
        tables = (_kmeans_table(JaxTable), _kmeans_table(Table))
    else:
        params, mode, at = dict(max_iter=6, global_batch_size=50), "device", 2
        classes = (JaxLogisticRegression, LogisticRegression)
        tables = (_lr_table(JaxTable), _lr_table(Table))

    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "jax"))
    jax_exporters.metrics.clear()
    _supervised(classes[0], tables[0], jax_iter.IterationConfig,
                jax_ckpt.CheckpointManager(str(tmp_path / "jax-ckpt")),
                JaxRetryPolicy(max_restarts=3, backoff_s=0.0), mode, at,
                jax_faults.chaos, **params)
    jax_tracing.tracer.shutdown()
    jax_snap = jax_exporters.metrics.snapshot()

    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "port"))
    metrics.clear()
    _supervised(classes[1], tables[1], IterationConfig,
                CheckpointManager(str(tmp_path / "port-ckpt")),
                RetryPolicy(max_restarts=3, backoff_s=0.0), mode, at,
                faults.chaos, device="cpu", **params)
    tracer.shutdown()
    port_snap = metrics.snapshot()

    jax_pairs, jax_events = _structure(tmp_path / "jax",
                                       jax_exporters.read_spans)
    port_pairs, port_events = _structure(tmp_path / "port", read_spans)
    assert port_pairs == jax_pairs
    assert port_events == jax_events
    assert port_events["supervisor.restart"] == 1
    assert port_events["ml.convergence"] > 0
    for group in ("ml.iteration", "ml.checkpoint", "ml.resilience"):
        assert _counters(port_snap, group) == _counters(jax_snap, group), group
    assert _counters(port_snap, "ml.resilience")["restarts"] == 1


def test_kmeans_supervised_traced_fit_golden(tmp_path, monkeypatch):
    """tests/test_observability.py:500-537 against the port: nested
    fit → epoch → checkpoint spans, a restart event, a Chrome trace."""
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv(TRACE_DIR_ENV, str(trace_dir))
    _supervised(KMeans, _kmeans_table(Table), IterationConfig,
                CheckpointManager(str(tmp_path / "ckpt")),
                RetryPolicy(max_restarts=3, backoff_s=0.0), "host", 4,
                faults.chaos, device="cpu", k=3, seed=7, max_iter=6)
    tracer.shutdown()
    spans = read_spans(str(trace_dir))
    by_id = {s["id"]: s for s in spans}
    fit = next(s for s in spans if s["name"] == "KMeans.fit")
    epochs = [s for s in spans if s["name"] == "epoch"]
    saves = [s for s in spans if s["name"] == "checkpoint.save"]
    assert epochs and saves
    assert all(e["parent"] == fit["id"] for e in epochs)
    assert all(by_id[s["parent"]]["name"] == "epoch" for s in saves)
    assert all(s["attrs"]["bytes"] > 0 for s in saves)
    assert any(ev["name"] == "supervisor.restart"
               for s in spans for ev in s["events"])
    done = [e for e in epochs if "error" not in e["attrs"]]
    assert len(done) == len(epochs) - 1  # the faulted epoch
    assert all("host_ms" in e["attrs"] and "device_ms" in e["attrs"]
               for e in done)
    # each epoch of an attempt follows from the one before it
    linked = [ln["span"] for e in epochs for ln in e.get("links", ())]
    assert len(linked) == len(epochs) - 2  # all but each attempt's first
    assert all(by_id[i]["name"] == "epoch" for i in linked)


# -- the toy estimator of tests/test_observability.py ----------------------------

class _ToyModel(Model):
    def transform(self, *inputs):
        return inputs


class _ToyEstimator(Estimator, IterationRuntimeMixin):
    """A pure-host GD iteration: the whole fit → epoch → checkpoint →
    restart chain with no tensor."""

    def fit(self, table):
        return self._supervised_fit(lambda: self._fit_once(table))

    def _fit_once(self, table):
        A = np.diag([1.0, 2.0, 3.0])
        b = np.array([1.0, -2.0, 0.5])

        def body(carry, epoch):
            return carry - 0.1 * (A @ carry - b)

        w = iterate_bounded(np.zeros(3), body, max_iter=6, jit_round=False,
                            config=self._iteration_config,
                            listeners=self._iteration_listeners)
        model = _ToyModel(device="cpu")
        model.coefficients = w
        return model


@pytest.fixture
def traced_supervised_fit(tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv(TRACE_DIR_ENV, str(trace_dir))
    cfg = IterationConfig(mode="host", checkpoint_interval=2,
                          checkpoint_manager=CheckpointManager(
                              str(tmp_path / "ckpt")))
    est = (_ToyEstimator(device="cpu").set_iteration_config(cfg)
           .set_retry_policy(RetryPolicy(max_restarts=3, backoff_s=0.0)))
    with faults.chaos(at={"epoch-boundary": [4]}):
        model = est.fit(None)
    tracer.shutdown()
    return str(trace_dir), model


def test_traced_fit_emits_nested_chrome_trace(traced_supervised_fit,
                                              tmp_path):
    trace_dir, model = traced_supervised_fit
    spans = read_spans(trace_dir)
    by_id = {s["id"]: s for s in spans}
    fits = [s for s in spans if s["name"] == "_ToyEstimator.fit"]
    assert len(fits) == 1
    epochs = [s for s in spans if s["name"] == "epoch"]
    assert epochs and all(e["parent"] == fits[0]["id"] for e in epochs)
    saves = [s for s in spans if s["name"] == "checkpoint.save"]
    assert saves and all(by_id[s["parent"]]["name"] == "epoch"
                         for s in saves)
    restarts = [ev for s in spans for ev in s["events"]
                if ev["name"] == "supervisor.restart"]
    assert len(restarts) == 1
    assert restarts[0]["attrs"]["error"] == "InjectedFault"
    assert any(s["name"] == "checkpoint.restore" for s in spans)
    out = tmp_path / "chrome.json"
    assert write_chrome_trace(trace_dir, str(out)) == len(spans)
    events = json.loads(out.read_text())["traceEvents"]
    assert {"X", "i"} <= {e["ph"] for e in events}
    expected = _ToyEstimator(device="cpu")._fit_once(None).coefficients
    np.testing.assert_allclose(model.coefficients, expected)


def test_traced_fit_dumps_metrics_with_epoch_histograms(
        traced_supervised_fit):
    trace_dir, _ = traced_supervised_fit
    merged = read_metrics(trace_dir)
    assert merged["ml.iteration"]["histograms"][
        'epochMs{mode="host"}']["count"] >= 6
    assert merged["ml.resilience"]["counters"]["restarts"] >= 1
    prom = prometheus_text(merged)
    assert 'epochMs_bucket{mode="host",le="' in prom
    assert "checkpoint_opMs_bucket" in prom


def test_epoch_histogram_survives_fit(tmp_path):
    tracer.configure(str(tmp_path))
    try:
        before = metrics.group("ml", "iteration").histogram(
            "epochMs", labels={"mode": "host"}).snapshot()["count"]
        iterate_bounded(np.float64(0.0), lambda c, e: c + 1, max_iter=5,
                        jit_round=False, config=IterationConfig(mode="host"))
        after = metrics.group("ml", "iteration").histogram(
            "epochMs", labels={"mode": "host"}).snapshot()["count"]
    finally:
        tracer.configure(None)
    assert after - before == 5


def test_checkpoint_quarantine_event(tmp_path):
    tracer.configure(str(tmp_path / "trace"))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save((np.arange(3.0),), 2)
    (Path(mgr.base_dir) / "ckpt-00000002" / "leaves.npz").write_bytes(b"x")
    assert mgr.restore((np.zeros(3),)) is None
    tracer.configure(None)
    events = _events(tmp_path / "trace", "checkpoint.quarantine")
    assert events and events[0]["attrs"]["checkpoint"] == "ckpt-00000002"
    restore = next(s for s in read_spans(str(tmp_path / "trace"))
                   if s["name"] == "checkpoint.restore")
    assert restore["attrs"]["result"] == "fresh-start"


# -- model health: device helpers and classification --------------------------

def test_finite_sentinel_single_scalar():
    ok = health.finite_sentinel(torch.ones(4), torch.zeros((2, 2)))
    assert ok.shape == () and bool(ok) is True
    assert bool(health.finite_sentinel(torch.tensor([1.0, float("nan")]),
                                       torch.zeros(2))) is False
    assert bool(health.finite_sentinel(
        torch.ones(4), torch.tensor([[1.0, float("inf")]]))) is False


def test_convergence_row_values_float32_and_finite_fold():
    row, fin = health.convergence_row(2.0, torch.zeros(3),
                                      torch.tensor([3.0, 0.0, 4.0]))
    assert row.dtype == torch.float32  # a Python loss does not promote
    np.testing.assert_allclose(row.numpy(), [2.0, 5.0, 5.0])
    assert bool(fin) is True
    row64, _ = health.convergence_row(torch.tensor(2.0, dtype=torch.float64),
                                      torch.zeros(3, dtype=torch.float64),
                                      torch.ones(3, dtype=torch.float64))
    assert row64.dtype == torch.float32
    _, fin = health.convergence_row(2.0, torch.zeros(3),
                                    torch.tensor([float("nan"), 0.0, 4.0]))
    assert bool(fin) is False
    want, _ = jax_health.convergence_row(
        np.float32(2.0), np.zeros(3, np.float32),
        np.asarray([3.0, 0.0, 4.0], np.float32))
    np.testing.assert_array_equal(row.numpy(), np.asarray(want))


#: the divergence series of tests/test_health.py
_DIVERGENCE_CASES = [
    (({"loss": [1.0, 0.5, float("nan"), 0.1]},), {}),
    (({"loss": [1.0, 0.5]},), {"finite": False}),
    (({"paramNorm": [1.0, 10.0, 1e3, 1e5, 1e7, 1e10]},),
     {"window": 2, "factor": 1e3}),
    (({"paramNorm": [1e-6, 1e-3, 1.0, 10.0]},), {"window": 1,
                                                 "factor": 1e2}),
    (({"loss": [5.0, 4.0, 3.0]},), {}),
    (({"loss": [1.0, 2.0, 4.0, 8.0, 16.0, 32.0],
       "paramNorm": [1.0, 1e2, 1e4, 1e7, 1e9, 1e11]},), {}),
    (({"centerShift": [0.5, 0.1, float("inf")]},), {}),
]


@pytest.mark.parametrize("args,kwargs", _DIVERGENCE_CASES)
def test_classify_divergence_matches_jax(args, kwargs):
    assert health.classify_divergence(*args, **kwargs) == \
        jax_health.classify_divergence(*args, **kwargs)


def test_classify_divergence_verdicts():
    assert health.classify_divergence(
        {"loss": [1.0, 0.5, float("nan"), 0.1]}) == ("non-finite", 2)
    assert health.classify_divergence(
        {"paramNorm": [1.0, 10.0, 1e3, 1e5, 1e7, 1e10]}, window=2,
        factor=1e3) == ("exploding-norm", 4)


def test_exploding_norm_reports_without_raising():
    before = metrics.group("ml", "health").get_counter(
        "divergences", labels={"algo": "probe", "kind": "exploding-norm"})
    cls = health.check_fit(
        "probe", {"loss": [1.0, 2.0, 4.0, 8.0, 16.0, 32.0],
                  "paramNorm": [1.0, 1e2, 1e4, 1e7, 1e9, 1e11]})
    assert cls == ("exploding-norm", 5)
    assert metrics.group("ml", "health").get_counter(
        "divergences",
        labels={"algo": "probe", "kind": "exploding-norm"}) == before + 1


def test_convergence_listener_host_values_fail_fast():
    lst = health.ConvergenceListener(
        "probe", lambda carry, epoch: {"loss": carry})
    lst.on_epoch_watermark_incremented(0, 1.0)
    lst.on_epoch_watermark_incremented(1, float("nan"))  # lagged: reads 1.0
    with pytest.raises(NonFiniteState):
        lst.on_epoch_watermark_incremented(2, 0.5)  # reads the NaN
    assert lst.series["loss"][0] == 1.0 and not lst.finite


def test_convergence_listener_device_rows_fetch_once(monkeypatch):
    lst = health.ConvergenceListener.for_params("probe", torch.zeros(2))
    fetched = []
    real = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        fetched.append(tuple(self.shape))
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    for epoch in range(4):
        lst.on_epoch_watermark_incremented(
            epoch, (torch.full((2,), float(epoch + 1)), None,
                    torch.tensor(1.0 / (epoch + 1))))
    assert fetched == []  # no fetch a round
    lst.on_iteration_terminated(None)
    assert fetched == [(4, 3)]
    np.testing.assert_allclose(lst.series["paramNorm"],
                               [math.sqrt(2) * k for k in (1, 2, 3, 4)],
                               rtol=1e-6)
    np.testing.assert_allclose(lst.series["updateNorm"],
                               [math.sqrt(2)] * 4, rtol=1e-6)


# -- health series parity with the JAX package --------------------------------------

_LINEAR = {
    "logistic": (JaxLogisticRegression, LogisticRegression, False),
    "hinge": (JaxLinearSVC, LinearSVC, False),
    "least_square": (JaxLinearRegression, LinearRegression, True),
}


def _series(trace_dir, algo, reader):
    rows = sorted((ev["attrs"] for ev in _events(trace_dir, "ml.convergence",
                                                 reader)
                   if ev["attrs"]["algo"] == algo),
                  key=lambda a: a["epoch"])
    names = sorted({k for r in rows for k in r} - {"algo", "epoch"})
    return ([r["epoch"] for r in rows],
            {name: np.asarray([r[name] for r in rows]) for name in names})


def _linear_fit(est_cls, table, cfg):
    est = est_cls(max_iter=6, learning_rate=0.2, global_batch_size=64,
                  **({"device": "cpu"} if est_cls.__module__.startswith(
                      "flink_ml_tpu_torch") else {}))
    if cfg is not None:
        est.set_iteration_config(cfg)
    return est.fit(table)


def _configs(mode, tmp_path, tag):
    if mode == "device":
        return None, None
    kw = dict(mode="host") if mode == "host" else dict(checkpoint_interval=2)
    if mode == "segment":
        return (jax_iter.IterationConfig(
                    **kw, checkpoint_manager=jax_ckpt.CheckpointManager(
                        str(tmp_path / f"jax-{tag}"))),
                IterationConfig(**kw, checkpoint_manager=CheckpointManager(
                    str(tmp_path / f"port-{tag}"))))
    return jax_iter.IterationConfig(**kw), IterationConfig(**kw)


@pytest.mark.parametrize("mode", ["device", "segment", "host"])
@pytest.mark.parametrize("loss", sorted(_LINEAR))
def test_linear_health_series_match_jax(one_device_mesh, tmp_path,
                                        monkeypatch, loss, mode):
    jax_cls, port_cls, regression = _LINEAR[loss]
    monkeypatch.setenv(health.HEALTH_ENV, "1")
    jax_cfg, port_cfg = _configs(mode, tmp_path, loss)
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "jax"))
    _linear_fit(jax_cls, _lr_table(JaxTable, regression=regression), jax_cfg)
    jax_tracing.tracer.shutdown()
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "port"))
    _linear_fit(port_cls, _lr_table(Table, regression=regression), port_cfg)
    tracer.shutdown()
    algo = port_cls.__name__
    jax_epochs, want = _series(tmp_path / "jax", algo,
                               jax_exporters.read_spans)
    epochs, got = _series(tmp_path / "port", algo, read_spans)
    assert epochs == jax_epochs == list(range(6))
    assert set(got) == set(want) == {"loss", "updateNorm", "paramNorm"}
    for name in got:
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    hist = metrics.snapshot()["ml.health"]["histograms"]
    assert hist[f'loss{{algo="{algo}"}}']["count"] >= 6


@pytest.mark.parametrize("mode", ["device", "host"])
def test_kmeans_center_shift_series_matches_jax(one_device_mesh, tmp_path,
                                                monkeypatch, mode):
    monkeypatch.setenv(health.HEALTH_ENV, "1")
    jax_cfg, port_cfg = _configs(mode, tmp_path, "kmeans")
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "jax"))
    est = JaxKMeans(k=3, seed=7, max_iter=5)
    if jax_cfg is not None:
        est.set_iteration_config(jax_cfg)
    est.fit(_kmeans_table(JaxTable))
    jax_tracing.tracer.shutdown()
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "port"))
    est = KMeans(k=3, seed=7, max_iter=5, device="cpu")
    if port_cfg is not None:
        est.set_iteration_config(port_cfg)
    est.fit(_kmeans_table(Table))
    tracer.shutdown()
    jax_epochs, want = _series(tmp_path / "jax", "KMeans",
                               jax_exporters.read_spans)
    epochs, got = _series(tmp_path / "port", "KMeans", read_spans)
    assert epochs == jax_epochs == list(range(5))
    np.testing.assert_allclose(got["centerShift"], want["centerShift"],
                               rtol=RTOL, atol=ATOL)
    assert not _events(tmp_path / "port", health.HEALTH_EVENT)


def test_kmeans_segment_fit_records_the_series_too(tmp_path, monkeypatch):
    """Beyond the JAX package (which keeps only the final guard in this
    mode): the segment fit's shifts ride its final fetch."""
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "trace"))
    cfg = IterationConfig(checkpoint_interval=2, checkpoint_manager=(
        CheckpointManager(str(tmp_path / "ckpt"))))
    KMeans(k=3, seed=7, max_iter=5, device="cpu").set_iteration_config(
        cfg).fit(_kmeans_table(Table))
    tracer.shutdown()
    epochs, got = _series(tmp_path / "trace", "KMeans", read_spans)
    assert epochs == list(range(5))
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "plain"))
    KMeans(k=3, seed=7, max_iter=5, device="cpu").fit(_kmeans_table(Table))
    tracer.shutdown()
    _, plain = _series(tmp_path / "plain", "KMeans", read_spans)
    np.testing.assert_array_equal(got["centerShift"], plain["centerShift"])


def test_ftrl_loss_series_and_version_gauge_match_jax(one_device_mesh,
                                                     tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(300, 6))
    y = (x @ rng.normal(size=6) > 0) * 1.0
    coeffs = rng.normal(size=6) * 0.1
    params = dict(features_col="f", label_col="l", global_batch_size=100,
                  reg=0.05, elastic_net=0.4, alpha=0.2, beta=0.5)
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "jax"))
    jax_est = jax_online.OnlineLogisticRegression(**params)
    jax_est.set_initial_model_data(JaxTable.from_columns(
        coefficient=[JaxDenseVector(coeffs)],
        modelVersion=np.asarray([2], np.int64)))
    jax_est.fit(JaxTable.from_columns(f=x, l=y))
    jax_tracing.tracer.shutdown()
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "port"))
    est = OnlineLogisticRegression(device="cpu", **params)
    est.set_initial_model_data(Table.from_columns(
        coefficient=[DenseVector(coeffs)],
        modelVersion=np.asarray([2], np.int64)))
    est.fit(Table.from_columns(f=x, l=y))
    tracer.shutdown()
    algo = "OnlineLogisticRegression"
    jax_epochs, want = _series(tmp_path / "jax", algo,
                               jax_exporters.read_spans)
    epochs, got = _series(tmp_path / "port", algo, read_spans)
    assert epochs == jax_epochs == [0, 1, 2]  # one per global batch
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL,
                               atol=ATOL)
    assert metrics.model_group().get_gauge("version") == 2


def test_ftrl_nan_state_raises(monkeypatch):
    monkeypatch.setenv(health.HEALTH_ENV, "1")
    est = OnlineLogisticRegression(device="cpu", features_col="f",
                                   label_col="l", global_batch_size=30)
    est.set_initial_model_data(Table.from_columns(
        coefficient=[DenseVector(np.full(5, np.nan))],
        modelVersion=np.asarray([0], np.int64)))
    x = np.random.default_rng(0).normal(size=(90, 5))
    with pytest.raises(NonFiniteState):
        est.fit(Table.from_columns(f=x, l=(x[:, 0] > 0) * 1.0))


def _diverging(pkg_table):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(256, 4)).astype(np.float32)
    return pkg_table.from_columns(
        features=x, label=(x @ np.arange(1.0, 5.0)).astype(np.float32))


@pytest.mark.parametrize("armed", [True, False])
def test_diverging_fit_raises_in_both_packages(one_device_mesh, monkeypatch,
                                               armed):
    if armed:
        monkeypatch.setenv(health.HEALTH_ENV, "1")
    params = dict(max_iter=20, learning_rate=1e12, global_batch_size=64)
    with pytest.raises(JaxNonFiniteState):
        JaxLinearRegression(**params).fit(_diverging(JaxTable))
    with np.errstate(all="ignore"):
        with pytest.raises(NonFiniteState) as exc:
            LinearRegression(device="cpu", **params).fit(_diverging(Table))
    assert (exc.value.epoch is not None) == armed


def test_dense_nan_fit_raises_with_event(tmp_path, monkeypatch):
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "trace"))
    with pytest.raises(NonFiniteState):
        LinearRegression(device="cpu", max_iter=20, learning_rate=1e12,
                         global_batch_size=64).fit(_diverging(Table))
    tracer.shutdown()
    events = _events(tmp_path / "trace", health.HEALTH_EVENT)
    assert any(ev["attrs"]["kind"] == "non-finite"
               and ev["attrs"]["algo"] == "LinearRegression" for ev in events)


def test_segmented_fit_fails_at_segment_boundary(tmp_path, monkeypatch):
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "trace"))
    cfg = IterationConfig(checkpoint_interval=4, checkpoint_manager=(
        CheckpointManager(str(tmp_path / "ckpt"))))
    est = LinearRegression(device="cpu", max_iter=80, learning_rate=1e12,
                           global_batch_size=64).set_iteration_config(cfg)
    with pytest.raises(NonFiniteState) as exc:
        est.fit(_diverging(Table))
    tracer.shutdown()
    assert exc.value.epoch < 80
    segments = [s for s in read_spans(str(tmp_path / "trace"))
                if s["name"] == "segment"]
    assert len(segments) < 20 and segments[-1]["attrs"]["error"] == \
        "NonFiniteState"


def test_health_env_0_disables_layer(monkeypatch):
    monkeypatch.setenv(health.HEALTH_ENV, "0")
    with np.errstate(all="ignore"):
        model = LinearRegression(device="cpu", max_iter=20,
                                 learning_rate=1e12,
                                 global_batch_size=64).fit(_diverging(Table))
    assert not np.isfinite(model.coefficients).all()


def test_nonfinite_is_terminal_no_retries(tmp_path, monkeypatch):
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "trace"))
    est = LinearRegression(device="cpu", max_iter=20, learning_rate=1e12,
                           global_batch_size=64)
    est.set_retry_policy(RetryPolicy(max_restarts=3, backoff_s=0.0))
    before = metrics.group("ml", "resilience").get_counter("restarts")
    with pytest.raises(NonFiniteState):
        est.fit(_diverging(Table))
    assert metrics.group("ml", "resilience").get_counter(
        "restarts") == before
    assert metrics.group("ml", "resilience").get_counter("failures") >= 1


# -- nothing armed ---------------------------------------------------------------

def _all_fits(tmp_path, tag):
    seg = IterationConfig(checkpoint_interval=2, checkpoint_manager=(
        CheckpointManager(str(tmp_path / f"ckpt-{tag}-lr"))))
    host = IterationConfig(mode="host")
    out = []
    for cfg in (None, seg, host):
        est = LogisticRegression(device="cpu", max_iter=6,
                                 global_batch_size=50)
        if cfg is not None:
            est.set_iteration_config(cfg)
        out.append(est.fit(_lr_table(Table)).coefficients)
    kseg = IterationConfig(checkpoint_interval=2, checkpoint_manager=(
        CheckpointManager(str(tmp_path / f"ckpt-{tag}-km"))))
    for cfg in (None, kseg, IterationConfig(mode="host")):
        est = KMeans(k=3, seed=7, max_iter=5, device="cpu")
        if cfg is not None:
            est.set_iteration_config(cfg)
        out.append(est.fit(_kmeans_table(Table)).centroids)
    est = OnlineLogisticRegression(device="cpu", features_col="f",
                                   label_col="l", global_batch_size=50)
    est.set_initial_model_data(Table.from_columns(
        coefficient=[DenseVector(np.zeros(5))],
        modelVersion=np.asarray([0], np.int64)))
    x = np.random.default_rng(6).normal(size=(200, 5))
    out.append(est.fit(Table.from_columns(f=x, l=(x[:, 1] > 0) * 1.0))
               .coefficients)
    return out


def test_nothing_armed_writes_nothing_records_nothing_same_bits(
        tmp_path, monkeypatch):
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setattr(tempfile, "tempdir", str(work))
    metrics.clear()
    unarmed = _all_fits(tmp_path, "unarmed")
    assert metrics.snapshot() == {}
    assert os.listdir(work) == []
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "trace"))
    monkeypatch.setenv(health.HEALTH_ENV, "1")
    armed = _all_fits(tmp_path, "armed")
    tracer.shutdown()
    for a, b in zip(unarmed, armed):
        np.testing.assert_array_equal(a, b)
    snap = metrics.snapshot()
    assert {"ml.iteration", "ml.checkpoint", "ml.health",
            "ml.collective"} <= set(snap)


def test_sample_memory_never_initialises_cuda():
    assert not torch.cuda.is_initialized()
    assert compilestats.sample_memory("segment") == {}
    assert not torch.cuda.is_initialized()
    assert "ml.device" not in metrics.snapshot() or not any(
        k.startswith("hbm") for k in metrics.snapshot()["ml.device"].get(
            "gauges", {}))


# -- build and launch accounting ------------------------------------------------

@pytest.fixture
def build_accounting():
    compilestats.uninstall()
    yield
    compilestats.uninstall()


def test_builds_record_only_once_installed(build_accounting):
    before = compilestats.compile_totals()
    compilestats.note_build("probe_kernels", 1234.5, cached=False)
    assert compilestats.compile_totals() == before  # not installed
    assert compilestats.install() is False  # no compile-phase channel
    compilestats.note_build("probe_kernels", 1234.5, cached=False)
    compilestats.note_build("other_kernels", 0.0, cached=True)
    after = compilestats.compile_totals()
    assert after["count"] == before["count"] + 1
    assert after["timeMs"] == pytest.approx(before["timeMs"] + 1234.5)
    grp = metrics.group(ML_GROUP, "compile")
    assert grp.get_counter("cached", labels={"fn": "other_kernels"}) >= 1
    split = compilestats.compile_totals_split()
    assert split["phase"] == {"count": 0, "timeMs": 0.0}


def test_compile_totals_read_a_jax_snapshot_the_same_way():
    from flink_ml_tpu.observability import compilestats as jax_cs

    snap = {"ml.compile": {"gauges": {}, "counters": {}, "histograms": {
        'phaseMs{phase="backend_compile"}': {
            "buckets": [1.0], "counts": [1], "sum": 30.0, "count": 2},
        'compileMs{fn="sgd"}': {
            "buckets": [1.0], "counts": [0], "sum": 12.0, "count": 1}}}}
    assert compilestats.compile_totals_split(snap) == \
        jax_cs.compile_totals_split(snap)
    assert compilestats.compile_totals_from_snapshot(snap) == \
        jax_cs.compile_totals_from_snapshot(snap)


def test_benchmark_rows_carry_compile_totals_and_a_run_span(tmp_path,
                                                            monkeypatch):
    spec = runner.load_config(
        REPO / "flink_ml_tpu/benchmark/configs/kmeans-benchmark.json")[
        "KMeans"]
    spec["inputData"]["paramMap"].update(numValues=300, vectorDim=4)
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "trace"))
    row = runner.run_benchmark("KMeans", spec, device="cpu")
    tracer.shutdown()
    assert row["compileCount"] == 0 and row["compileTimeMs"] == 0.0
    spans = read_spans(str(tmp_path / "trace"))
    run = next(s for s in spans if s["name"] == "benchmark.run")
    assert run["parent"] is None and run["attrs"]["benchmark"] == "KMeans"
    fit = next(s for s in spans if s["name"] == "KMeans.fit")
    assert fit["parent"] == run["id"]
    assert any(p.startswith("metrics-")
               for p in os.listdir(tmp_path / "trace"))


def test_launch_cost_is_recorded_only_inside_a_traced_call(tmp_path,
                                                           monkeypatch):
    """Every wrapper's launch on the card, with its launch stubbed: counted
    always, its cost recorded only inside a traced call."""
    monkeypatch.setattr(kernels, "_is_cuda", lambda t: True)
    monkeypatch.setattr(kernels, "_launch_sgd_terms",
                        lambda x, *a: torch.zeros(2, x.shape[1] + 2))
    x, y, w, c = torch.ones(300, 7), torch.ones(300), torch.ones(300), \
        torch.zeros(7)
    kernels.reset_launch_counts()
    grp = metrics.group(ML_GROUP, "device")
    fn = {"fn": "sgd_batch_terms"}
    before = (grp.get_counter("launches", labels=fn),
              grp.get_counter("launchBytes", labels=fn))
    try:
        kernels.sgd_batch_terms(x, y, w, c, 0, 0, 100, "logistic")
        tracer.configure(str(tmp_path))
        kernels.sgd_batch_terms(x, y, w, c, 0, 0, 100, "logistic")  # no span
        with tracer.span("traced-call"):
            kernels.sgd_batch_terms(x, y, w, c, 0, 0, 100, "logistic")
            kernels.sgd_batch_terms(x, y, w, c, 100, 0, 50, "logistic")
        tracer.configure(None)
        assert kernels.launch_counts["sgd_batch_terms"] == 4
    finally:
        kernels.reset_launch_counts()
    first = kernels.launch_cost("sgd_batch_terms", lb=100, d=7)
    last = kernels.launch_cost("sgd_batch_terms", lb=50, d=7)
    assert grp.get_counter("launches", labels=fn) == before[0] + 2
    assert grp.get_counter("launchBytes", labels=fn) == \
        before[1] + first[0] + last[0]
    assert grp.get_gauge("programBytes", labels=fn) == last[0]
    assert grp.get_gauge("programFlops", labels=fn) == last[1]


@pytest.mark.parametrize("name,dims,want", [
    ("assign_nearest", dict(n=1000, k=10, d=100),
     (4 * (1000 * 100 + 10 * 100 + 10 + 1000), 2 * 1000 * 10 * 100)),
    ("lloyd_partial_sums", dict(n=1000, k=10, d=100),
     (4 * (1000 * 100 + 1000 + 10 * 100 + 10 + 10 * 101),
      2 * 1000 * 10 * 100 + 2 * 1000 * 101)),
    ("reduce_partials", dict(blocks=391, inner=1010),
     (4 * 392 * 1010, 391 * 1010)),
    ("sgd_batch_terms", dict(lb=100_000, d=100),
     (4 * (100_000 * 100 + 200_000 + 202), 4 * 100_000 * 100)),
    ("segment_reduce_sum", dict(n=1000, c=2, u=100),
     (4 * (2000 + 1000 + 200), 2000)),
    ("knn_topk_indices", dict(n=16, nt=50, d=32, k=10),
     (4 * (16 * 32 + 50 * 32 + 160), 2 * 16 * 50 * 32)),
])
def test_launch_cost_counts(name, dims, want):
    assert kernels.launch_cost(name, **dims) == want


def test_every_cuda_symbol_names_its_kernel():
    symbols = set()
    for src in (REPO / "flink_ml_tpu_torch" / "csrc").glob("*.cu"):
        text = src.read_text()
        symbols |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
            r"([A-Za-z_][A-Za-z0-9_]*)\s*\(", text))
        symbols |= set(re.findall(
            r"__launch_bounds__\([^)]*\)\s*\n?\s*([A-Za-z_][A-Za-z0-9_]*)\s*\(",
            text))
    assert symbols == set(kernels.KERNEL_SYMBOLS)
    assert set(kernels.KERNEL_SYMBOLS.values()) == set(kernels.KERNELS)


# -- collective accounting --------------------------------------------------------

def test_cross_shard_sums_are_accounted_when_traced(tmp_path, monkeypatch):
    mesh = port_create_mesh((2,), devices=["cpu"] * 2)
    table = _lr_table(Table)
    metrics.clear()
    LogisticRegression(device="cpu", mesh=mesh, max_iter=4,
                       global_batch_size=50).fit(table)
    assert "ml.collective" not in metrics.snapshot()
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "trace"))
    LogisticRegression(device="cpu", mesh=mesh, max_iter=4,
                       global_batch_size=50).fit(table)
    tracer.shutdown()
    spans = read_spans(str(tmp_path / "trace"))
    fit = next(s for s in spans if s["name"] == "LogisticRegression.fit")
    ops = collections.Counter(s["attrs"]["op"] for s in spans
                              if s["name"] == "collective.host")
    assert ops == {"all_reduce_sum": 4, "ensure_on_mesh": 2}
    assert all(s["parent"] == fit["id"] and s["attrs"]["devices"] == 2
               for s in spans if s["name"] == "collective.host")
    hist = metrics.snapshot()["ml.collective"]["histograms"]
    assert hist['opMs{devices="2",op="all_reduce_sum"}']["count"] == 4
    assert hist['payloadBytes{devices="2",op="all_reduce_sum"}'][
        "sum"] == 4 * (5 + 2) * 4


# -- the stage wrapper ---------------------------------------------------------------

def test_profile_dir_records_a_torch_trace_per_fit(tmp_path, monkeypatch):
    monkeypatch.setenv(PROFILE_DIR_ENV, str(tmp_path / "prof"))
    model = KMeans(k=3, seed=7, max_iter=2, device="cpu").fit(
        _kmeans_table(Table))
    model.transform(_kmeans_table(Table))
    for region in ("KMeans.fit", "KMeansModel.transform"):
        files = os.listdir(tmp_path / "prof" / region)
        assert any(f.endswith(".pt.trace.json") for f in files), region
    assert metrics.group(ML_GROUP, "profile").get_gauge(
        "KMeans.fitLastMs") > 0


def test_transform_opens_its_own_root_span(tmp_path, monkeypatch):
    model = KMeans(k=3, seed=7, max_iter=2, device="cpu").fit(
        _kmeans_table(Table))
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "trace"))
    model.transform(_kmeans_table(Table))
    tracer.shutdown()
    (span,) = read_spans(str(tmp_path / "trace"))
    assert span["name"] == "KMeansModel.transform"
    assert span["attrs"] == {"kind": "transform", "stage": "KMeansModel"}


# -- device profiles: parser, efficiency, capture ----------------------------------

def _kernel_event(name, dur_us, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "dur": dur_us, "ts": 1,
            "pid": 0, "tid": 7}


def _write_device_trace(path):
    events = [
        _kernel_event("void sgd_rows_kernel<0, 4, 1>(float const*, float "
                      "const*, float const*, float const*, float*, int)",
                      17.0),
        _kernel_event("sgd_combine_kernel(float const*, float*, int, int)",
                      2.5),
        _kernel_event("_Z21lloyd_partials_kernelPKfS0_S0_Pfiiiii", 300.0),
        _kernel_event("void at::native::vectorized_elementwise_kernel<4, "
                      "at::native::FillFunctor<float> >(int)", 1.0),
        _kernel_event("aten::add", 50.0, cat="cpu_op"),
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
    ]
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events}))


def test_parse_device_trace_into_kernel_rows(tmp_path):
    _write_device_trace(tmp_path / "prof" / "1.pt.trace.json")
    report = profiling.parse_profile_dir(str(tmp_path / "prof"))
    assert report["source"] == "device"
    fns = {r["fn"]: r for r in report["fns"]}
    assert set(fns) == {"sgd_batch_terms", "lloyd_partial_sums", "torch"}
    assert fns["sgd_batch_terms"]["deviceMs"] == pytest.approx(0.0195)
    assert fns["sgd_batch_terms"]["count"] == 2
    assert fns["lloyd_partial_sums"]["deviceMs"] == pytest.approx(0.3)
    ops = {(r["op"], r["fn"]) for r in report["ops"]}
    assert ("sgd_rows_kernel", "sgd_batch_terms") in ops
    assert all(r["fn"] != "host" for r in report["ops"])
    assert report["totalMs"] == pytest.approx(0.3205)


def test_efficiency_joins_window_costs_and_never_exceeds_the_roof(tmp_path):
    _write_device_trace(tmp_path / "prof" / "1.pt.trace.json")
    report = profiling.parse_profile_dir(str(tmp_path / "prof"))
    nbytes, flops = kernels.launch_cost("sgd_batch_terms", lb=100_000, d=100)
    profiling._attach_window_costs(
        report, {}, {"sgd_batch_terms": {"launches": 1, "bytes": nbytes,
                                         "flops": flops}})
    eff = profiling.efficiency_report(None, profile=report, snapshot={})
    rows = {r["fn"]: r for r in eff["fns"]}
    sgd = rows["sgd_batch_terms"]
    want = (nbytes / profiling.DEFAULT_PEAK_BW) / (0.0195 / 1000.0)
    assert sgd["bound"] == "bandwidth"
    assert sgd["utilization"] == pytest.approx(want)
    assert 0.0 < sgd["utilization"] <= 1.0
    assert sgd["boundMs"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert sgd["launches"] == 1
    # no cost recorded for the window: nothing is claimed
    assert rows["lloyd_partial_sums"]["utilization"] is None


def test_efficiency_falls_back_to_the_per_launch_gauges(tmp_path):
    _write_device_trace(tmp_path / "prof" / "1.pt.trace.json")
    report = profiling.parse_profile_dir(str(tmp_path / "prof"))
    nbytes, flops = kernels.launch_cost("lloyd_partial_sums", n=1_000_000,
                                        k=10, d=100)
    snap = {"ml.device": {"gauges": {
        'programBytes{fn="lloyd_partial_sums"}': float(nbytes),
        'programFlops{fn="lloyd_partial_sums"}': float(flops)}}}
    eff = profiling.efficiency_report(None, profile=report, snapshot=snap)
    lloyd = next(r for r in eff["fns"] if r["fn"] == "lloyd_partial_sums")
    assert lloyd["bound"] == "bandwidth"
    assert lloyd["utilization"] == pytest.approx(
        max(nbytes / 3.35e12, flops / 67e12) / 0.3e-3)


def test_cpu_capture_reads_host_fallback_and_claims_nothing(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "trace"))
    monkeypatch.setenv(profiling.CAPTURE_ENV, "1")
    LogisticRegression(device="cpu", max_iter=3, global_batch_size=50).fit(
        _lr_table(Table))
    LogisticRegression(device="cpu", max_iter=3, global_batch_size=50).fit(
        _lr_table(Table))  # one-shot: the second fit is not captured
    tracer.shutdown()
    trace_dir = tmp_path / "trace"
    captures = [p for p in os.listdir(trace_dir) if p.startswith("profile-")]
    assert captures == [f"profile-fit-LogisticRegression.fit-{os.getpid()}"]
    report = profiling.read_profile(str(trace_dir))
    assert report["source"] == "host-fallback"
    assert report["fns"] == [] and report["ops"]
    eff = profiling.efficiency_report(str(trace_dir))
    assert eff["source"] == "host-fallback"
    assert all(r["utilization"] is None for r in eff["fns"])


def test_torn_trace_is_a_parse_error(tmp_path):
    (tmp_path / "x.pt.trace.json").write_text("{not json")
    with pytest.raises(profiling.ProfileParseError):
        profiling.parse_profile_dir(str(tmp_path))
    with pytest.raises(profiling.ProfileParseError):
        profiling.parse_profile_dir(str(tmp_path / "missing"))
    with pytest.raises(profiling.ProfileParseError):
        profiling.read_profile(str(tmp_path))


def test_kill_switch_and_single_window_claim(tmp_path, monkeypatch):
    from flink_ml_tpu_torch.common import metrics as metrics_mod

    monkeypatch.setenv(profiling.CAPTURE_ENV, "0")
    with profiling.profile_window("x", out_dir=str(tmp_path / "a")) as h:
        assert h is None
    assert profiling.capture_now(5) is None
    monkeypatch.delenv(profiling.CAPTURE_ENV)
    assert metrics_mod.claim_profiler()
    try:
        with profiling.profile_window("y", out_dir=str(tmp_path / "b")) as h:
            assert h is None  # another window holds the claim
    finally:
        metrics_mod.release_profiler()
    with profiling.profile_window("z", out_dir=str(tmp_path / "c")) as h:
        assert h is not None
    assert h.report is not None and h.report["label"] == "z"


def test_capture_failure_releases_claim(tmp_path, monkeypatch):
    from flink_ml_tpu_torch.common import metrics as metrics_mod

    def broken(log_dir):
        raise RuntimeError("no profiler")

    monkeypatch.setattr(profiling, "_profiler_start", broken)
    with profiling.profile_window("x", out_dir=str(tmp_path)) as h:
        assert h is None
    assert metrics_mod.claim_profiler()
    metrics_mod.release_profiler()


def test_boot_phases_latch_to_ready(tmp_path):
    profiling.reset_boot()
    try:
        tracer.configure(str(tmp_path))
        with profiling.boot_phase("warmup-compile"):
            pass
        profiling.mark_ready()
        first = profiling.boot_to_ready_ms()
        profiling.mark_ready()  # first call wins
        with profiling.boot_phase("gate-open"):  # after ready: a no-op
            pass
        tracer.configure(None)
        assert first is not None and profiling.boot_to_ready_ms() == first
        names = [s["name"] for s in read_spans(str(tmp_path))]
        assert "boot.warmup-compile" in names
        assert "boot.gate-open" not in names
    finally:
        profiling.reset_boot()


# -- serving helpers --------------------------------------------------------------

def _serve(h):
    h.observe_serving("lr", 8, 3.0, predictions=[0.1, 0.9, 1.0])
    h.observe_serving("lr", 40, 12.5, predictions=np.arange(40) / 40.0)
    h.observe_serving_error("lr", "ValueError", 5.0)
    h.observe_serving_rejected("lr", "deadline")
    h.observe_serving_shards("lr", [3, 1], [0, 1])
    h.serving_inflight("lr", 1)
    h.serving_inflight("lr", -3)  # clamps at 0
    h.summarize_values("lr", "prob", [0.2, float("nan")])


def test_serving_helpers_match_jax(tmp_path, monkeypatch):
    from flink_ml_tpu.common.metrics import metrics as jax_registry

    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "jax"))
    jax_registry.clear()
    _serve(jax_health)
    jax_tracing.tracer.shutdown()
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "port"))
    metrics.clear()
    _serve(health)
    tracer.shutdown()
    port_snap, jax_snap = metrics.snapshot(), jax_registry.snapshot()
    for group in ("ml.serving", "ml.health"):
        assert json.dumps(port_snap[group], sort_keys=True) == json.dumps(
            jax_snap[group], sort_keys=True), group
    assert port_snap["ml.serving"]["gauges"][
        'inFlight{servable="lr"}'] == 0
    events = _events(tmp_path / "port", health.HEALTH_EVENT)
    assert [ev["attrs"]["kind"] for ev in events] == ["non-finite-prob"]


@pytest.mark.parametrize("raw,want", [(None, 1.0), ("", 1.0), ("0.25", 0.25),
                                      ("7", 1.0), ("-1", 0.0),
                                      ("junk", 1.0)])
def test_trace_sample_rate_parses_like_jax(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv(health.SAMPLE_ENV, raising=False)
    else:
        monkeypatch.setenv(health.SAMPLE_ENV, raw)
    assert health.trace_sample_rate() == jax_health.trace_sample_rate() \
        == want
    if want in (0.0, 1.0):  # the rate's ends draw no random number
        assert health.trace_sampled() is (want == 1.0)


# -- capture paths ------------------------------------------------------------------

def test_capture_now_clamps_to_the_route_bound(tmp_path, monkeypatch):
    monkeypatch.setenv(profiling.PROFILEZ_MAX_MS_ENV, "2")
    got = profiling.capture_now(10_000)
    assert got is not None and got["ms"] == 2
    assert got["report"]["source"] == "host-fallback"


def test_batch_tick_spans_n_ticks(tmp_path, monkeypatch):
    monkeypatch.setenv(TRACE_DIR_ENV, str(tmp_path / "trace"))
    monkeypatch.setenv(profiling.CAPTURE_ENV, "1")
    monkeypatch.setenv(profiling.TICKS_ENV, "2")
    profiling.batch_tick()  # starts the capture
    assert profiling._tick_handle is not None
    profiling.batch_tick()
    profiling.batch_tick()  # the second tick after the start ends it
    assert profiling._tick_handle is None
    assert profiling.read_profile(str(tmp_path / "trace"))["label"] == \
        "batcher-2ticks"
    profiling.batch_tick()  # once a process: nothing more
    assert profiling._tick_handle is None


def test_forked_children_never_profile(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling, "_owner_pid", -1)
    with profiling.profile_window("x", out_dir=str(tmp_path)) as handle:
        assert handle is None
