"""The port's serving runtime, held against the JAX package's.

Modelled on tests/test_serving_runtime.py and test_serving_telemetry.py.
Most cases run once per package (the ``pkg`` fixture: the same numpy-seeded
frames through ``flink_ml_tpu`` and ``flink_ml_tpu_torch``) and assert the
same outcome in both:

- the micro-batcher: per-request results split exactly from the padded
  batch, admission (queue-full, too-large, empty, shutdown), deadlines,
  schema rejections, a failing batch that leaves the loop alive, exact
  bucket fits and the pad-template cache, the env config, single-thread
  dispatch at ``pipeline_depth=0``, the pad span of tick N+1 overlapping
  the batch span of tick N, and a hot-swap between ticks;
- the registry: adoption in order, a bit-flipped checkpoint quarantined,
  non-finite candidates rejected once, probe gauges, health checks, a
  broken loader, the watcher thread; and across packages, a model either
  package publishes is adopted by the other's registry with its drift and
  quality baselines;
- the loadgen: ``percentiles`` equal to the JAX function's, outcome
  classes, the open loop;
- the server: the ``/healthz``, ``/serving``, ``/metrics``, ``/drift``,
  ``/slo``, ``/incidents`` and ``/fleet`` bodies carry the JAX server's
  keys.

Port-only cases: the LR device predict through the batcher equals the
per-request ``transform`` (``device="cpu"``), warmup holds the readiness
gate and runs each bucket on the batcher's dispatching thread with zero
kernel builds after it, ``run_on_stage`` and the device binding of the
dispatching thread, and a traced fit starting the endpoint.

Every wait is bounded: futures with timeouts, joins with timeouts, servers
on port 0 stopped in teardown.
"""

import json
import os
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the conftest pins it to the CPU)

PKGS = ("jax", "torch")
_NS = {}


def _namespace(name):
    """The serving modules of one package, as one namespace."""
    if name in _NS:
        return _NS[name]
    if name == "jax":
        from flink_ml_tpu import serving
        from flink_ml_tpu.common import metrics as metrics_mod
        from flink_ml_tpu.iteration import checkpoint
        from flink_ml_tpu.linalg import vectors
        from flink_ml_tpu.observability import (drift, evaluation,
                                                exporters, server, tracing)
        from flink_ml_tpu.servable import api, lr
    else:
        from flink_ml_tpu_torch import serving
        from flink_ml_tpu_torch.common import metrics as metrics_mod
        from flink_ml_tpu_torch.iteration import checkpoint
        from flink_ml_tpu_torch.linalg import vectors
        from flink_ml_tpu_torch.observability import (drift, evaluation,
                                                      exporters, server,
                                                      tracing)
        from flink_ml_tpu_torch.servable import api, lr

    class SumServable(api.TransformerServable):
        """Deterministic host servable: pred = sum(features) — exact
        per-row correctness is assertable through batching/padding."""

        features_col = "features"
        prediction_col = "pred"

        def transform(self, df):
            vals = [float(np.sum(r.get(0).to_array()))
                    for r in df.collect()]
            df.add_column("pred", api.DataTypes.DOUBLE, vals)
            return df

    ns = types.SimpleNamespace(
        name=name, serving=serving, api=api, lr=lr, server=server,
        tracing=tracing, exporters=exporters, drift=drift,
        evaluation=evaluation, checkpoint=checkpoint,
        metrics=metrics_mod.metrics, ML_GROUP=metrics_mod.ML_GROUP,
        DenseVector=vectors.DenseVector, SumServable=SumServable)
    _NS[name] = ns
    return ns


@pytest.fixture(params=PKGS)
def pkg(request):
    return _namespace(request.param)


@pytest.fixture
def port():
    return _namespace("torch")


@pytest.fixture(autouse=True)
def _clean_serving(monkeypatch):
    """Endpoint/gate/provider/drift state is process-wide: reset it."""
    monkeypatch.delenv("FLINK_ML_TPU_METRICS_PORT", raising=False)
    for name in PKGS:
        ns = _namespace(name)
        ns.server.stop()
        ns.drift.clear()
        ns.evaluation.clear()
    yield
    for name in PKGS:
        ns = _namespace(name)
        ns.server.stop()
        ns.drift.clear()
        ns.evaluation.clear()


def feature_frame(ns, rows, dim=4, seed=0):
    rng = np.random.default_rng(seed)
    return ns.api.DataFrame(
        ["features"], [ns.api.DataTypes.vector()],
        [ns.api.Row([ns.DenseVector(rng.normal(size=dim))])
         for _ in range(rows)])


def lr_servable(ns, dim, version=1, coef=None, device_predict=True):
    servable = ns.lr.LogisticRegressionModelServable()
    if device_predict:
        if ns.name == "torch":
            servable.set_device_predict(True, device="cpu")
        else:
            servable.set_device_predict(True)
    servable.model_data = ns.lr.LogisticRegressionModelData(
        np.arange(1.0, dim + 1) if coef is None else coef, version)
    return servable


def serving_group(ns):
    return ns.metrics.group(ns.ML_GROUP, "serving")


def sums(frame):
    return [float(np.sum(r.get(0).to_array())) for r in frame.collect()]


# -- the micro-batcher ----------------------------------------------------------

def test_batcher_config_validation(pkg):
    cfg_cls = pkg.serving.BatcherConfig
    for bad in ({"buckets": (8, 4)}, {"buckets": (0, 4)},
                {"window_ms": -1}, {"pipeline_depth": -1},
                {"max_queue_rows": 0}):
        with pytest.raises(ValueError):
            cfg_cls(**bad)
    cfg = cfg_cls(buckets=(4, 16))
    assert (cfg.bucket_for(1), cfg.bucket_for(5), cfg.max_bucket) == (
        4, 16, 16)
    assert cfg_cls(buckets=None).bucket_for(7) == 7


def test_batch_results_split_exactly_and_padding_discarded(pkg):
    sv = pkg.SumServable()
    sv.serving_name = f"sum@split-{pkg.name}"
    frames = [feature_frame(pkg, n, seed=n) for n in (1, 3, 2)]
    want = [sums(f) for f in frames]
    with pkg.serving.MicroBatcher(sv, pkg.serving.BatcherConfig(
            buckets=(8,), window_ms=100.0)) as b:
        futures = [b.submit(f) for f in frames]
        outs = [f.result(timeout=10) for f in futures]
    for out, frame, expected in zip(outs, frames, want):
        assert out.num_rows() == frame.num_rows()
        assert out.get("pred").values == expected
    grp = serving_group(pkg)
    labels = {"servable": sv.serving_name}
    assert grp.get_counter("batches", labels={**labels,
                                              "bucket": "8"}) == 1
    assert grp.get_counter("padRows", labels=labels) == 2


def test_queue_full_and_too_large_rejections(pkg):
    release = threading.Event()
    base = pkg.SumServable

    class SlowServable(base):
        def transform(self, df):
            release.wait(timeout=10)
            return base.transform.__wrapped__(self, df)

    sv = SlowServable()
    sv.serving_name = f"sum@full-{pkg.name}"
    cfg = pkg.serving.BatcherConfig(buckets=(2, 16), window_ms=0.0,
                                    max_queue_rows=4)
    rejected = pkg.api.RejectedRequest
    with pkg.serving.MicroBatcher(sv, cfg) as b:
        with pytest.raises(rejected) as exc:
            b.submit(feature_frame(pkg, 17)).result(timeout=5)
        assert exc.value.reason == "too-large"
        first = b.submit(feature_frame(pkg, 2))
        time.sleep(0.1)
        queued = [b.submit(feature_frame(pkg, 2)),
                  b.submit(feature_frame(pkg, 2))]
        with pytest.raises(rejected) as exc:
            b.submit(feature_frame(pkg, 2)).result(timeout=5)
        assert exc.value.reason == "queue-full"
        release.set()
        for fut in [first] + queued:
            assert fut.result(timeout=10).num_rows() == 2
    grp = serving_group(pkg)
    for reason in ("queue-full", "too-large"):
        assert grp.get_counter("rejected", labels={
            "servable": sv.serving_name, "reason": reason}) == 1


def test_deadline_expired_in_queue_rejected(pkg):
    gate = threading.Event()
    base = pkg.SumServable

    class BlockingServable(base):
        def transform(self, df):
            gate.wait(timeout=10)
            return base.transform.__wrapped__(self, df)

    sv = BlockingServable()
    sv.serving_name = f"sum@deadline-{pkg.name}"
    with pkg.serving.MicroBatcher(sv, pkg.serving.BatcherConfig(
            buckets=(2,), window_ms=0.0)) as b:
        blocker = b.submit(feature_frame(pkg, 2))
        time.sleep(0.05)
        doomed = b.submit(feature_frame(pkg, 1), deadline_ms=1.0)
        time.sleep(0.05)
        gate.set()
        with pytest.raises(pkg.api.RejectedRequest) as exc:
            doomed.result(timeout=10)
        assert exc.value.reason == "deadline"
        assert blocker.result(timeout=10).num_rows() == 2


def test_schema_mismatch_and_empty_rejected_others_served(pkg):
    sv = pkg.SumServable()
    with pkg.serving.MicroBatcher(sv, pkg.serving.BatcherConfig(
            buckets=(8,), window_ms=30.0)) as b:
        good = b.submit(feature_frame(pkg, 2))
        bad = b.submit(pkg.api.DataFrame(
            ["other"], [pkg.api.DataTypes.vector()],
            [pkg.api.Row([pkg.DenseVector([1.0, 2.0, 3.0, 4.0])])]))
        empty = b.submit(pkg.api.DataFrame(
            ["features"], [pkg.api.DataTypes.vector()], []))
        assert good.result(timeout=10).num_rows() == 2
        for fut, reason in ((bad, "schema"), (empty, "empty")):
            with pytest.raises(pkg.api.RejectedRequest) as exc:
                fut.result(timeout=10)
            assert exc.value.reason == reason


def test_stop_without_drain_rejects_queued_and_post_stop_submit(pkg):
    b = pkg.serving.MicroBatcher(pkg.SumServable(), pkg.serving.BatcherConfig(
        buckets=(64,), window_ms=10000.0)).start()
    fut = b.submit(feature_frame(pkg, 1))
    b.stop(drain=False)
    for f in (fut, b.submit(feature_frame(pkg, 1))):
        with pytest.raises(pkg.api.RejectedRequest) as exc:
            f.result(timeout=5)
        assert exc.value.reason == "shutdown"


def test_transform_failure_fails_batch_not_loop(pkg):
    class FailingServable(pkg.SumServable):
        def transform(self, df):
            raise RuntimeError("boom")

    with pkg.serving.MicroBatcher(FailingServable(), pkg.serving.BatcherConfig(
            buckets=(4,), window_ms=1.0)) as b:
        for rows in (2, 1):
            with pytest.raises(RuntimeError, match="boom"):
                b.submit(feature_frame(pkg, rows)).result(timeout=10)


@pytest.mark.parametrize("depth", [0, 1])
def test_exact_bucket_fit_and_pipeline_depth(pkg, depth):
    seen = []
    base = pkg.SumServable

    class Recording(base):
        def transform(self, df):
            seen.append(df.num_rows())
            return base.transform.__wrapped__(self, df)

    sv = Recording()
    sv.serving_name = f"sum@exact{depth}-{pkg.name}"
    cfg = pkg.serving.BatcherConfig(buckets=(8,), window_ms=1.0,
                                    pipeline_depth=depth)
    with pkg.serving.MicroBatcher(sv, cfg) as b:
        assert (b._device_thread is None) == (depth == 0)
        outs = [b.submit(feature_frame(pkg, n, seed=n)).result(timeout=10)
                for n in (8, 3, 1)]
        assert b.status()["pipeline_depth"] == depth
    assert [o.num_rows() for o in outs] == [8, 3, 1]
    assert seen == [8, 8, 8]
    assert serving_group(pkg).get_counter(
        "padRows", labels={"servable": sv.serving_name}) == 5 + 7


def test_pad_template_cache_counts_reuse_and_misses_on_dim(pkg):
    dims = []
    base = pkg.SumServable

    class DimRecorder(base):
        def transform(self, df):
            dims.append([r.get(0).size for r in df.collect()])
            return base.transform.__wrapped__(self, df)

    sv = DimRecorder()
    sv.serving_name = f"sum@padreuse-{pkg.name}"
    labels = {"servable": sv.serving_name}
    grp = serving_group(pkg)
    with pkg.serving.MicroBatcher(sv, pkg.serving.BatcherConfig(
            buckets=(8,), window_ms=20.0)) as b:
        b.submit(feature_frame(pkg, 3, seed=1)).result(timeout=10)
        first = grp.get_counter("paddingReuse", labels=labels)
        b.submit(feature_frame(pkg, 3, seed=2)).result(timeout=10)
        second = grp.get_counter("paddingReuse", labels=labels)
        b.submit(feature_frame(pkg, 3, dim=12)).result(timeout=10)
    assert (first, second) == (0, 5)
    assert dims == [[4] * 8, [4] * 8, [12] * 8]


def test_batcher_config_from_env(pkg, monkeypatch):
    s = pkg.serving
    monkeypatch.setenv(s.BUCKETS_ENV, "4,16,64")
    monkeypatch.setenv(s.WINDOW_ENV, "2.5")
    monkeypatch.setenv(s.DEADLINE_ENV, "none")
    monkeypatch.setenv(s.PIPELINE_ENV, "2")
    cfg = s.BatcherConfig.from_env()
    assert (cfg.buckets, cfg.window_ms, cfg.deadline_ms,
            cfg.pipeline_depth) == ((4, 16, 64), 2.5, None, 2)
    assert s.BatcherConfig.from_env(window_ms=9.0).window_ms == 9.0
    monkeypatch.setenv(s.BUCKETS_ENV, "eight")
    with pytest.raises(ValueError, match=s.BUCKETS_ENV):
        s.BatcherConfig.from_env()


def test_serving_provider_survives_overlapping_batchers(pkg):
    a, b = pkg.SumServable(), pkg.SumServable()
    a.serving_name, b.serving_name = "sum@a", "sum@b"
    cfg = pkg.serving.BatcherConfig(window_ms=1.0)
    batcher_a = pkg.serving.MicroBatcher(a, cfg).start()
    batcher_b = pkg.serving.MicroBatcher(b, cfg).start()
    assert pkg.server.get_serving_status()()["servable"] == "sum@b"
    batcher_b.stop()
    assert pkg.server.get_serving_status()()["servable"] == "sum@a"
    batcher_a.stop()
    assert pkg.server.get_serving_status() is None


def test_pipelined_dispatcher_pad_overlaps_device(pkg, tmp_path):
    """Under sustained load the ``serving.pad`` span of tick N+1 starts
    before the ``serving.batch`` span of tick N ends."""
    base = pkg.SumServable

    class Slowish(base):
        def transform(self, df):
            time.sleep(0.002)
            return base.transform.__wrapped__(self, df)

    sv = Slowish()
    sv.serving_name = f"sum@pipe-{pkg.name}"
    pkg.tracing.tracer.configure(str(tmp_path))
    try:
        with pkg.serving.MicroBatcher(sv, pkg.serving.BatcherConfig(
                buckets=(8,), window_ms=0.5)) as b:
            pkg.serving.run_loadgen(
                b.submit, lambda i: feature_frame(pkg, 1 + i % 4, seed=i),
                pkg.serving.LoadGenConfig(mode="closed", requests=80,
                                          concurrency=8))
    finally:
        pkg.tracing.tracer.configure(None)
    pads, batches = {}, {}
    for sp in pkg.exporters.read_spans(str(tmp_path)):
        tick = sp.get("attrs", {}).get("tick")
        if tick is None:
            continue
        if sp["name"] == "serving.pad":
            pads.setdefault(int(tick), sp)
        elif sp["name"] == "serving.batch":
            batches.setdefault(int(tick), sp)
    assert batches and all(sp["attrs"]["pipeline_depth"] == 1
                           for sp in batches.values())
    overlaps = sum(
        1 for tick, sp in batches.items()
        if tick + 1 in pads and sp.get("dur_us")
        and pads[tick + 1]["ts_us"] < sp["ts_us"] + sp["dur_us"])
    assert overlaps > 0


def test_traced_request_chain_links_submit_pad_batch_resolve(pkg,
                                                             tmp_path):
    sv = pkg.SumServable()
    sv.serving_name = f"sum@chain-{pkg.name}"
    pkg.tracing.tracer.configure(str(tmp_path))
    try:
        with pkg.serving.MicroBatcher(sv, pkg.serving.BatcherConfig(
                buckets=(4,), window_ms=1.0)) as b:
            b.submit(feature_frame(pkg, 2)).result(timeout=10)
    finally:
        pkg.tracing.tracer.configure(None)
    spans = {sp["name"]: sp for sp in pkg.exporters.read_spans(
        str(tmp_path))}
    for name in ("serving.submit", "serving.pad", "serving.batch",
                 "serving.resolve", "serving.request"):
        assert name in spans, name
    assert spans["serving.resolve"]["trace"] == spans["serving.submit"][
        "trace"]
    assert spans["serving.resolve"]["links"]
    assert spans["serving.batch"]["links"]


def test_inflight_request_completes_on_old_version_during_swap(pkg,
                                                               tmp_path):
    entered, release = threading.Event(), threading.Event()

    class Marker(pkg.api.TransformerServable):
        def __init__(self, version):
            self.version = version

        def transform(self, df):
            if self.version == 1:
                entered.set()
                release.wait(timeout=10)
            df.add_column("modelVersion", pkg.api.DataTypes.INT,
                          [self.version] * df.num_rows())
            return df

    reg = pkg.serving.ModelRegistry(str(tmp_path / "models"),
                                    lambda leaves, v: Marker(v), model="m")
    pkg.serving.publish_model(reg.watch_dir, [np.ones(2)], 1)
    assert reg.poll()
    with pkg.serving.MicroBatcher(reg, pkg.serving.BatcherConfig(
            buckets=(4,), window_ms=0.0)) as b:
        inflight = b.submit(feature_frame(pkg, 1))
        assert entered.wait(timeout=10)
        pkg.serving.publish_model(reg.watch_dir, [np.ones(2)], 2)
        assert reg.poll() and reg.version == 2
        release.set()
        assert inflight.result(timeout=10).get(
            "modelVersion").values == [1]
        assert b.submit(feature_frame(pkg, 1)).result(timeout=10).get(
            "modelVersion").values == [2]
        assert b.status()["model_version"] == 2


# -- the LR servable behind the batcher (port) -----------------------------------

def test_batched_lr_device_predict_equals_per_request_transform(port):
    dim = 7
    sv = lr_servable(port, dim, coef=np.linspace(-1.0, 1.0, dim))
    sv.serving_name = "lr@batched"
    frames = [feature_frame(port, n, dim=dim, seed=10 + i)
              for i, n in enumerate((1, 2, 4, 3, 8, 5))]
    want = []
    for f in frames:
        clone = port.api.DataFrame(
            f.column_names, f.data_types,
            [port.api.Row(list(r.values)) for r in f.collect()])
        out = sv.transform(clone)
        want.append((out.get("prediction").values,
                     [v.to_array() for v in out.get("rawPrediction").values]))
    with port.serving.MicroBatcher(sv, port.serving.BatcherConfig(
            buckets=(8, 32), window_ms=5.0)) as b:
        outs = [fut.result(timeout=10) for fut in [b.submit(f)
                                                   for f in frames]]
    # the float32 product of a padded batch may differ from the
    # request's own in the last ulp (another matrix shape): predictions
    # exact, probabilities within 1e-6 (the JAX mesh-parity bound)
    for out, (pred, raw) in zip(outs, want):
        assert out.get("prediction").values == pred
        np.testing.assert_allclose(
            np.asarray([v.to_array() for v in out.get("rawPrediction")
                        .values]), np.asarray(raw), rtol=0, atol=1e-6)


def test_warmup_holds_gate_runs_on_device_stage_zero_builds(port):
    from flink_ml_tpu_torch.observability import compilestats

    seen = []

    class Watched(port.lr.LogisticRegressionModelServable):
        def aot_warm(self, rows):
            seen.append((rows, threading.current_thread().name,
                         port.server.readiness()[0]))
            super().aot_warm(rows)

    sv = Watched().set_device_predict(True, device="cpu")
    sv.model_data = port.lr.LogisticRegressionModelData(np.ones(5), 1)
    with port.serving.MicroBatcher(sv, port.serving.BatcherConfig(
            buckets=(4, 16), window_ms=1.0)) as b:
        report = port.serving.warm(b)
        steady = port.serving.compile_count()
        for n in (1, 3, 4, 16, 9):
            assert b.submit(feature_frame(port, n, dim=5)).result(
                timeout=10).num_rows() == n
        assert port.serving.compile_count() - steady == 0
    assert [(r, t, ready) for r, t, ready in seen] == [
        (4, "flink-ml-tpu-batcher-dev", False),
        (16, "flink-ml-tpu-batcher-dev", False)]
    assert set(report["buckets"]) == {4, 16}
    assert report["compiles"] == 0 and report["thread"] == "device-stage"
    assert report["mesh_devices"] == 1 and report["sharded_buckets"] == []
    assert port.server.readiness() == (True, {})
    assert compilestats.compile_totals_split()["perfn"]["count"] == steady


def test_warmup_before_start_runs_on_caller_and_failure_keeps_gate(port):
    sv = lr_servable(port, 3)
    b = port.serving.MicroBatcher(sv, port.serving.BatcherConfig(
        buckets=(2,), window_ms=1.0))
    assert port.serving.warm(b)["thread"] == "caller"

    class BrokenWarm(port.SumServable):
        def aot_warm(self, rows):
            raise RuntimeError("no backend")

    with pytest.raises(RuntimeError, match="no backend"):
        port.serving.warm(BrokenWarm(), buckets=(4,))
    ready, blocked = port.server.readiness()
    assert not ready and "warmup failed" in blocked[
        port.serving.WARMUP_GATE]


@pytest.mark.parametrize("depth", [0, 1])
def test_run_on_stage_runs_on_the_dispatching_thread(port, depth):
    b = port.serving.MicroBatcher(port.SumServable(), port.serving
                                  .BatcherConfig(window_ms=1.0,
                                                 pipeline_depth=depth))
    with pytest.raises(RuntimeError):
        b.run_on_stage(lambda: None)
    with b:
        name = b.run_on_stage(lambda: threading.current_thread().name)
        with pytest.raises(ValueError, match="stage boom"):
            b.run_on_stage(lambda: (_ for _ in ()).throw(
                ValueError("stage boom")))
        # the loop survived the failing call
        assert b.submit(feature_frame(port, 2)).result(
            timeout=10).num_rows() == 2
    assert name == ("flink-ml-tpu-batcher" if depth == 0
                    else "flink-ml-tpu-batcher-dev")


def test_dispatching_thread_names_the_servables_card(port, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(
                            (d, threading.current_thread().name)))
    sv = port.SumServable()
    sv.device = torch.device("cuda", 0)
    with port.serving.MicroBatcher(sv, port.serving.BatcherConfig(
            buckets=(4,), window_ms=0.0)) as b:
        for n in (1, 2, 3):
            b.submit(feature_frame(port, n)).result(timeout=10)
    # once, on the device stage, not per tick and not on the caller
    assert calls == [(torch.device("cuda", 0), "flink-ml-tpu-batcher-dev")]


# -- the registry -----------------------------------------------------------------

def make_registry(ns, tmp_path, dim=6, **kwargs):
    def loader(leaves, version):
        return lr_servable(ns, dim, version, coef=np.asarray(leaves[0]))

    kwargs.setdefault("probe", lambda: feature_frame(ns, 4, dim=dim))
    return ns.serving.ModelRegistry(str(tmp_path / "models"), loader,
                                    model="lr", **kwargs)


def test_registry_adopts_published_versions_in_order(pkg, tmp_path):
    reg = make_registry(pkg, tmp_path)
    assert reg.active is None and not reg.poll()
    pkg.serving.publish_model(reg.watch_dir, [np.arange(1.0, 7.0)], 1)
    assert reg.poll() and reg.version == 1
    assert reg.active.serving_name == "lr@v1" and not reg.poll()
    pkg.serving.publish_model(reg.watch_dir, [np.arange(2.0, 8.0)], 2)
    pkg.serving.publish_model(reg.watch_dir, [np.arange(3.0, 9.0)], 3)
    assert reg.poll() and reg.version == 3
    assert serving_group(pkg).get_gauge(
        "modelVersion", labels={"model": "lr"}) == 3
    # no baseline was published: both planes record it as missing
    assert pkg.drift.evaluate("lr@v3")["source"] == "missing"
    assert pkg.evaluation.evaluate("lr@v3")["source"] == "missing"


def test_bit_flipped_checkpoint_quarantined_never_served(pkg, tmp_path):
    reg = make_registry(pkg, tmp_path)
    pkg.serving.publish_model(reg.watch_dir, [np.arange(1.0, 7.0)], 1)
    assert reg.poll()
    v1 = reg.active
    path = pkg.serving.publish_model(reg.watch_dir,
                                     [np.arange(9.0, 15.0)], 2)
    leaves = os.path.join(path, "leaves.npz")
    blob = bytearray(open(leaves, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(leaves, "wb").write(bytes(blob))
    assert not reg.poll()
    assert reg.version == 1 and reg.active is v1
    assert not os.path.exists(path) and os.path.exists(path + ".corrupt")
    assert serving_group(pkg).get_counter("swapRejected", labels={
        "model": "lr", "reason": "corrupt"}) >= 1


def test_non_finite_candidates_rejected_once(pkg, tmp_path):
    class NanServable(pkg.api.TransformerServable):
        prediction_col = "prediction"

        def transform(self, df):
            df.add_column("prediction", pkg.api.DataTypes.DOUBLE,
                          [float("nan")] * df.num_rows())
            return df

    def loader(leaves, version):
        return (NanServable() if version == 3 else
                lr_servable(pkg, 6, version, coef=np.asarray(leaves[0])))

    reg = pkg.serving.ModelRegistry(
        str(tmp_path / f"models-{pkg.name}"), loader, model="nan",
        probe=lambda: feature_frame(pkg, 4, dim=6))
    grp = serving_group(pkg)
    # the registry is process-wide: other files may have rejected a
    # "nan" model before this test
    before = {reason: grp.get_counter("swapRejected", labels={
        "model": "nan", "reason": reason})
        for reason in ("non-finite", "probe-non-finite")}
    pkg.serving.publish_model(reg.watch_dir, [np.arange(1.0, 7.0)], 1)
    assert reg.poll()
    pkg.serving.publish_model(reg.watch_dir, [np.full(6, np.nan)], 2)
    assert not reg.poll() and not reg.poll()
    pkg.serving.publish_model(reg.watch_dir, [np.arange(1.0, 7.0)], 3)
    assert not reg.poll()
    for reason in ("non-finite", "probe-non-finite"):
        assert grp.get_counter("swapRejected", labels={
            "model": "nan", "reason": reason}) == before[reason] + 1
    pkg.serving.publish_model(reg.watch_dir, [np.arange(2.0, 8.0)], 4)
    assert reg.poll() and reg.version == 4


def test_health_check_and_broken_loader(pkg, tmp_path):
    verdicts = iter([False, True])
    reg = make_registry(pkg, tmp_path, health_check=lambda sv: next(verdicts))
    pkg.serving.publish_model(reg.watch_dir, [np.arange(1.0, 7.0)], 1)
    assert not reg.poll()
    pkg.serving.publish_model(reg.watch_dir, [np.arange(2.0, 8.0)], 2)
    assert reg.poll() and reg.version == 2

    class Slotted:
        __slots__ = ("version",)

        def __init__(self, version):
            self.version = version

    broken = pkg.serving.ModelRegistry(
        str(tmp_path / "slotted"), lambda leaves, v: Slotted(v),
        model=f"slot-{pkg.name}")
    pkg.serving.publish_model(broken.watch_dir, [np.ones(2)], 1)
    assert not broken.poll() and not broken.poll()
    assert broken.version is None
    assert serving_group(pkg).get_counter("swapRejected", labels={
        "model": f"slot-{pkg.name}", "reason": "internal-error"}) == 1


def test_loader_failure_is_a_rejected_candidate(pkg, tmp_path):
    def loader(leaves, version):
        raise RuntimeError("no card")

    reg = pkg.serving.ModelRegistry(str(tmp_path / "m"), loader,
                                    model=f"noload-{pkg.name}")
    pkg.serving.publish_model(reg.watch_dir, [np.ones(3)], 1)
    assert not reg.poll() and reg.active is None
    assert serving_group(pkg).get_counter("swapRejected", labels={
        "model": f"noload-{pkg.name}", "reason": "load-error"}) == 1


def test_registry_watcher_thread_swaps_in_background(pkg, tmp_path):
    reg = make_registry(pkg, tmp_path, poll_interval_s=0.02)
    pkg.serving.publish_model(reg.watch_dir, [np.arange(1.0, 7.0)], 1)
    with reg:
        deadline = time.monotonic() + 10
        while reg.version != 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert reg.version == 1
        pkg.serving.publish_model(reg.watch_dir, [np.arange(2.0, 8.0)], 2)
        while reg.version != 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert reg.version == 2
    assert reg._watcher is None


def test_rollback_and_canary_routing(pkg, tmp_path):
    reg = make_registry(pkg, tmp_path)
    for v in (1, 2):
        pkg.serving.publish_model(reg.watch_dir,
                                  [np.arange(1.0, 7.0) * v], v)
        assert reg.poll()
    assert reg.rollback("test") == 1 and reg.version == 1
    assert not reg.poll()  # the demoted version is never re-adopted
    pkg.serving.publish_model(reg.watch_dir, [np.arange(3.0, 9.0)], 3)
    reg.hold_version(3)
    assert not reg.poll()
    reg.set_canary(reg.load_candidate(3), 3, fraction=1.0)
    assert reg.resolve().serving_name == "lr@v3"
    assert reg.promote_canary() == 3 and reg.version == 3


@pytest.mark.parametrize("publisher,adopter", [("jax", "torch"),
                                               ("torch", "jax")])
def test_publish_in_one_package_adopt_in_the_other(publisher, adopter,
                                                   tmp_path):
    """Checkpoints are byte-compatible: a model either package publishes,
    with its drift and quality baselines, is adopted by the other's
    registry, and both packages then predict the same."""
    pub, ado = _namespace(publisher), _namespace(adopter)
    rng = np.random.default_rng(5)
    coef = rng.normal(size=6)
    x = rng.normal(size=(300, 6))
    base = pub.drift.DriftBaseline("lr")
    base.group.observe({"f0": x[:, 0], "prediction": (x @ coef >= 0)
                        .astype(float)})
    qsk = pub.evaluation.QualitySketch()
    qsk.observe(1.0 / (1.0 + np.exp(-(x @ coef))),
                (x @ coef > 0).astype(float))
    qbase = pub.evaluation.QualityBaseline("lr", sketch=qsk)
    watch = str(tmp_path / "models")
    pub.serving.publish_model(watch, [coef], 7, baseline=base,
                              quality_baseline=qbase)
    reg = make_registry(ado, tmp_path)
    reg.watch_dir = watch
    assert reg.poll() and reg.version == 7
    np.testing.assert_array_equal(reg.active.model_data.coefficient, coef)
    installed = ado.drift.baseline_for("lr@v7")
    assert installed is not None and installed.version == 7
    assert installed.to_json()["sketches"] == base.to_json()["sketches"]
    qinstalled = ado.evaluation.baseline_for("lr@v7")
    assert qinstalled is not None
    assert qinstalled.sketch.auc() == qsk.auc()


# -- the loadgen ------------------------------------------------------------------

def test_percentiles_equal_the_jax_function():
    from flink_ml_tpu.serving.loadgen import percentiles as jax_pct
    from flink_ml_tpu_torch.serving.loadgen import percentiles

    rng = np.random.default_rng(3)
    for n in (0, 1, 2, 7, 100, 1001):
        samples = list(rng.exponential(5.0, size=n))
        assert percentiles(samples) == jax_pct(samples)
    p = percentiles([float(i) for i in range(1, 101)])
    assert (p["p50"], p["p99"], p["max"]) == (50.0, 99.0, 100.0)


def test_loadgen_classifies_ok_rejected_error(pkg):
    calls, lock = [0], threading.Lock()

    def submit(frame):
        with lock:
            calls[0] += 1
            i = calls[0]
        if i % 3 == 0:
            raise pkg.api.RejectedRequest("sv", "queue-full")
        if i % 3 == 1:
            raise ValueError("bad input")
        return frame

    res = pkg.serving.run_loadgen(
        submit, lambda i: feature_frame(pkg, 1),
        pkg.serving.LoadGenConfig(mode="closed", requests=9,
                                  concurrency=3))
    assert (res["ok"], res["rejected"], res["errors"]) == (3, 3, 3)
    assert res["rejectedByReason"] == {"queue-full": 3}
    assert res["errorsByClass"] == {"ValueError": 3}


def test_loadgen_open_loop_paces_feedback_and_config(pkg):
    ticks, fed = [], []
    res = pkg.serving.run_loadgen(
        lambda f: f, lambda i: feature_frame(pkg, 1),
        pkg.serving.LoadGenConfig(mode="open", requests=40, rps=400.0),
        tick=lambda n: ticks.append(n),
        feedback=lambda i, frame, fut: fed.append(i))
    assert res["ok"] == 40 and res["skipped"] == 0
    assert res["wall_s"] >= 40 / 400.0 * 0.8
    assert len(ticks) == 40 and sorted(fed) == list(range(40))
    for bad in ({"mode": "burst"}, {"mode": "open", "rps": 0},
                {"requests": 0}):
        with pytest.raises(ValueError):
            pkg.serving.LoadGenConfig(**bad)


def test_loadgen_tick_exception_propagates_to_caller(pkg):
    def tick(n):
        if n == 3:
            raise SystemExit(1)

    with pytest.raises(SystemExit):
        pkg.serving.run_loadgen(
            lambda f: f, lambda i: feature_frame(pkg, 1),
            pkg.serving.LoadGenConfig(mode="closed", requests=6,
                                      concurrency=2), tick=tick)


# -- the server -------------------------------------------------------------------

def _get(srv, route):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{route}",
                                    timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _served_session(ns):
    """One serving session on a fresh endpoint: v1 of an LR model with a
    drift baseline behind a batcher, 24 requests; the route bodies."""
    ns.metrics.clear()  # the exposition holds this session's families
    srv = ns.server.maybe_start(0)
    dim = 5
    rng = np.random.default_rng(11)
    base = ns.drift.DriftBaseline("lr", version=1)
    base.group.observe({f"f{i}": rng.normal(size=400) for i in range(dim)})
    ns.drift.install_baseline("lr@v1", base)
    sv = lr_servable(ns, dim)
    sv.serving_name = "lr@v1"
    bodies = {"healthz-before": _get(srv, "/healthz")}
    ns.server.set_gate(ns.serving.WARMUP_GATE, False, "warming")
    bodies["healthz-gated"] = _get(srv, "/healthz")
    ns.server.set_gate(ns.serving.WARMUP_GATE, True)
    with ns.serving.MicroBatcher(sv, ns.serving.BatcherConfig(
            buckets=(4, 8), window_ms=1.0)) as b:
        for i in range(24):
            b.submit(feature_frame(ns, 1 + i % 3, dim=dim, seed=i)).result(
                timeout=10)
        for route in ("/serving", "/metrics", "/drift", "/quality",
                      "/controller", "/spans/recent", "/nope"):
            bodies[route] = _get(srv, route)
    for route in ("/slo", "/incidents", "/fleet"):
        bodies[route] = _get(srv, route)
    return srv, bodies


def _keys(obj):
    """The nested key structure of a JSON document (values dropped)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    return None


def test_route_bodies_match_the_jax_server():
    jax_ns, port_ns = _namespace("jax"), _namespace("torch")
    _, jb = _served_session(jax_ns)
    jax_ns.server.stop()
    _, pb = _served_session(port_ns)
    for name in ("healthz-before", "healthz-gated", "/serving", "/drift",
                 "/quality", "/controller", "/spans/recent", "/nope",
                 "/slo", "/incidents", "/fleet"):
        (jcode, jbody), (pcode, pbody) = jb[name], pb[name]
        assert jcode == pcode, (name, jcode, pcode)
        jdoc, pdoc = json.loads(jbody), json.loads(pbody)
        if name == "/spans/recent":
            assert set(jdoc) == set(pdoc) == {"spans"}
            continue
        if name == "/drift":
            for doc in (jdoc, pdoc):
                for row in doc["servables"].values():
                    row.pop("evaluated_unix")
        assert _keys(jdoc) == _keys(pdoc), name
    assert pb["healthz-gated"][0] == 503
    assert json.loads(pb["/serving"][1])["serving"]["servable"] == "lr@v1"
    drift_doc = json.loads(pb["/drift"][1])
    assert drift_doc["servables"]["lr@v1"]["series"]["f0"]["live_n"] > 0
    # the same metric families, by Prometheus name, in both expositions
    families = [{line.split(" ")[2] for line in body.splitlines()
                 if line.startswith("# TYPE")}
                for body in (jb["/metrics"][1], pb["/metrics"][1])]
    serving = [{f for f in fams if "serving" in f} for fams in families]
    assert serving[0] and serving[0] == serving[1]
    for route in ("/slo", "/incidents", "/fleet"):
        assert pb[route][0] == 200, route
    slo_doc = json.loads(pb["/slo"][1])
    assert [v["slo"] for v in slo_doc["verdicts"]] == [
        v["slo"] for v in json.loads(jb["/slo"][1])["verdicts"]]
    assert json.loads(pb["/incidents"][1])["incidents"] == []
    assert json.loads(pb["/fleet"][1])["fleet"] is None
    assert set(port_ns.server.ROUTE_TABLE) == set(
        jax_ns.server.ROUTE_TABLE)


def test_profilez_route_refuses_when_killed(port, monkeypatch):
    monkeypatch.setenv("FLINK_ML_TPU_PROFILE_CAPTURE", "0")
    srv = port.server.maybe_start(0)
    assert _get(srv, "/profilez?ms=-1")[0] == 400
    assert _get(srv, "/profilez?ms=10")[0] == 409


def test_traced_fit_starts_the_endpoint(port, monkeypatch):
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.models.classification import LogisticRegression

    monkeypatch.setenv("FLINK_ML_TPU_METRICS_PORT", "0")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    table = Table.from_columns(features=x,
                               label=(x[:, 0] > 0).astype(np.float32))
    LogisticRegression(device="cpu", max_iter=2,
                       global_batch_size=32).fit(table)
    srv = port.server.maybe_start()
    assert srv is not None and srv.port > 0
    assert json.loads(_get(srv, "/healthz")[1])["status"] == "ok"
    assert port.tracing.tracer.keep_recent


# -- mesh-sharded dispatch ----------------------------------------------------------

def _mesh(ns, n):
    if ns.name == "jax":
        from flink_ml_tpu.parallel import create_mesh

        return create_mesh(devices=jax.devices()[:n])
    from flink_ml_tpu_torch.parallel import create_mesh

    return create_mesh((n,), devices=["cpu"] * n)


def _rows_by_shard(ns, servable):
    """The ``ml.shard rows`` gauges by shard, and the ``ml.serving
    shardRows`` gauges of ``servable`` by their device label."""
    from flink_ml_tpu_torch.observability.health import _parse_labels

    shard = {int(_parse_labels(k)["shard"]): v for k, v in ns.metrics.group(
        ns.ML_GROUP, "shard").snapshot()["gauges"].items()
        if k.startswith("rows{")}
    serving = {k: v for k, v in serving_group(ns).snapshot()[
        "gauges"].items() if k.startswith("shard")
        and f'servable="{servable}"' in k}
    return shard, serving


SHARD_SIZES = (8, 32, 3, 16, 8, 1, 5)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_dots_match_one_shard_and_jax(n):
    """Row-sharded dots on n virtual shards: within rtol 1e-6 of the
    one-shard product (float32 products of other row counts) and within
    1e-5 of the JAX package's sharded servable on n devices; the same
    per-shard rows for the same bucket and real rows."""
    dim = 12
    coef = np.linspace(-1.0, 1.0, dim)
    port_ns, jax_ns = _namespace("torch"), _namespace("jax")
    one = lr_servable(port_ns, dim, coef=coef)
    sv = lr_servable(port_ns, dim, coef=coef).set_mesh(_mesh(port_ns, n))
    jsv = lr_servable(jax_ns, dim, coef=coef).set_mesh(_mesh(jax_ns, n))
    for name, s in (("port", sv), ("jax", jsv)):
        s.serving_name = f"lr@shards{n}-{name}"
    rng = np.random.default_rng(3 + n)
    for bucket, real in ((8, 8), (8, 3), (16, 13), (32, 1)):
        x = np.zeros((bucket, dim), np.float32)
        x[:real] = rng.normal(size=(real, dim))
        assert sv._use_sharded(bucket) and jsv._use_sharded(bucket)
        got = sv._sharded_dots(x, real)
        np.testing.assert_allclose(got, one._device_dots(x), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(got, jsv._sharded_dots(x, real),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, x.astype(np.float64) @ coef,
                                   rtol=1e-5, atol=1e-6)
        port_rows, port_serving = _rows_by_shard(port_ns, sv.serving_name)
        jax_rows, jax_serving = _rows_by_shard(jax_ns, jsv.serving_name)
        assert port_rows == jax_rows
        assert port_rows == {
            s: min(max(real - s * (bucket // n), 0), bucket // n)
            for s in range(n)}
        assert {k.replace("-port", "") for k in port_serving} == {
            k.replace("-jax", "") for k in jax_serving}
        assert list(port_serving.values()) == list(jax_serving.values())


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_batcher_serves_what_one_shard_serves(pkg, n):
    """The same request stream through a one-shard and an n-shard batcher
    (warmed: every bucket × the mesh): identical predictions,
    probabilities within 1e-6, buckets n divides reported sharded."""
    dim = 12
    outs = {}
    for shards in (1, n):
        # transform adds its columns to the request frames: fresh ones
        frames = [feature_frame(pkg, r, dim=dim, seed=97 + i)
                  for i, r in enumerate(SHARD_SIZES)]
        mesh = _mesh(pkg, shards)
        sv = lr_servable(pkg, dim, coef=np.linspace(-1.0, 1.0, dim))
        sv.serving_name = f"lr@b{shards}"
        with pkg.serving.MicroBatcher(sv, pkg.serving.BatcherConfig(
                buckets=(8, 32), window_ms=1.0), mesh=mesh) as b:
            report = pkg.serving.warm(
                b, frame_factory=lambda r: feature_frame(pkg, r, dim=dim),
                gate=False)
            assert report["mesh_devices"] == shards
            assert report["sharded_buckets"] == (
                [] if shards == 1 else [8, 32])
            assert b.status()["sharded_dispatch"] == (shards > 1)
            outs[shards] = [b.submit(f).result(timeout=10) for f in frames]
    for a, b_ in zip(outs[1], outs[n]):
        assert a.get("prediction").values == b_.get("prediction").values
        np.testing.assert_allclose(
            np.asarray([v.to_array() for v in a.get("rawPrediction").values]),
            np.asarray([v.to_array()
                        for v in b_.get("rawPrediction").values]),
            rtol=0, atol=1e-6)


def test_sharded_serving_path_coverage(port, tmp_path, monkeypatch):
    """A traced batcher on 4 shards: every request's path reconstructs,
    each at least 0.9 attributed, and the trace dir reads as a 4-shard
    mesh with the bucket's rows per shard."""
    from flink_ml_tpu_torch.observability import meshstats, path, shards

    monkeypatch.setenv(port.tracing.TRACE_DIR_ENV, str(tmp_path))
    port.metrics.clear()  # the snapshot holds this run's series alone
    dim = 6
    sv = lr_servable(port, dim, coef=np.linspace(-1.0, 1.0, dim))
    sv.serving_name = "lr@traced"
    mesh = _mesh(port, 4)
    with port.serving.MicroBatcher(sv, port.serving.BatcherConfig(
            buckets=(8, 32), window_ms=1.0), mesh=mesh) as b:
        port.serving.warm(b, gate=False)
        futures = [b.submit(feature_frame(port, 1 + i % 4, dim=dim, seed=i))
                   for i in range(24)]
        for fut in futures:
            fut.result(timeout=10)
    port.tracing.tracer.shutdown()
    port.exporters.dump_metrics(str(tmp_path))
    spans = port.exporters.read_spans(str(tmp_path))
    report = path.analyze_paths(spans)
    assert report["requests"]["count"] == 24
    for row in report["slowest"]:
        assert row["coverage"] >= 0.9, row
    rows = path._request_rows(spans)
    assert len(rows) == 24 and min(r["coverage"] for r in rows) >= 0.9
    snap = port.exporters.read_metrics(str(tmp_path))
    assert meshstats.read_mesh(str(tmp_path))["device_count"] == 4
    summary = shards.shards_summary(spans, snap,
                                    meshstats.read_mesh(str(tmp_path)))
    assert [r["shard"] for r in summary["shards"]] == [0, 1, 2, 3]
    assert shards.main([str(tmp_path), "--check"]) == 0
