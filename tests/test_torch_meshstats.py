"""The port's mesh telemetry, held against the JAX package's.

Modelled on tests/test_meshstats.py. The JAX side runs on the conftest's 8
CPU devices (``mesh8``), the port side on 8 virtual CPU shards, with the
same numpy-seeded inputs:

- the topology snapshot and ``mesh.json`` (``device_count`` is the shard
  count in both; the port's virtual shards all name device 0);
- ``shard_row_counts`` / ``record_shard_rows`` and ``detect_skew`` on the
  same series: equal counts, spreads and ``ml.skew`` events;
- a traced KMeans fit on 8 shards in both packages with NaNs in the same
  rows of shard 5: the same ``mesh.json`` shape, per-shard ``rows`` and
  ``nonFinite`` gauges (both fits then fail on the NaN state);
- the port's traced fits on 8 shards, KMeans in host rounds and LR in
  segments: bit-identical to the same fits unarmed, with one
  ``readyMs`` series a shard (``phase`` epoch or segment) and the times on
  the epoch and segment spans; unarmed fits record nothing;
- two gloo ranks tracing into one dir: shards 0 and 1 stay apart, and each
  rank's snapshot holds both shards' gathered ``nonFinite`` counts.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.common.metrics import metrics as jax_metrics
from flink_ml_tpu.models.clustering import KMeans as JaxKMeans
from flink_ml_tpu.observability import exporters as jax_exporters
from flink_ml_tpu.observability import meshstats as jax_meshstats
from flink_ml_tpu.observability import tracing as jax_tracing
from flink_ml_tpu.parallel import create_mesh as jax_create_mesh
from flink_ml_tpu.parallel import set_default_mesh as jax_set_default_mesh
from flink_ml_tpu.parallel import shard_batch as jax_shard_batch

from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.common.metrics import MetricsRegistry, metrics
from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager
from flink_ml_tpu_torch.iteration.iteration import IterationConfig
from flink_ml_tpu_torch.models.classification import LogisticRegression
from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
from flink_ml_tpu_torch.observability import exporters, meshstats, tracing
from flink_ml_tpu_torch.parallel import collective as C
from flink_ml_tpu_torch.parallel import create_mesh
from flink_ml_tpu_torch.resilience.policy import NonFiniteState

REPO = Path(__file__).resolve().parent.parent
N, D = 240, 4


def port_mesh(n):
    return create_mesh((n,), devices=["cpu"] * n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for env in (tracing.TRACE_DIR_ENV, meshstats.SKEW_FACTOR_ENV,
                meshstats.SKEW_FLOOR_MS_ENV, "FLINK_ML_TPU_HEALTH"):
        monkeypatch.delenv(env, raising=False)
    metrics.clear()
    jax_metrics.clear()
    yield
    tracing.tracer.shutdown()
    jax_tracing.tracer.shutdown()
    tracing.tracer.configure(None)
    jax_tracing.tracer.configure(None)
    metrics.clear()
    jax_metrics.clear()
    meshstats._recorded.clear()
    jax_meshstats._recorded.clear()
    jax_set_default_mesh(None)


def _by_shard(snapshot, name, group="ml.shard", kind="gauges"):
    """``{shard: value}`` of one labeled ``ml.shard`` series (the device
    label differs between the packages: JAX devices 0-7, the port's
    virtual shards all on device 0)."""
    from flink_ml_tpu_torch.observability.health import _parse_labels

    out = {}
    for key, value in ((snapshot.get(group) or {}).get(kind) or {}).items():
        base, _, rest = key.partition("{")
        if base == name:
            out[int(_parse_labels(rest[:-1])["shard"])] = value
    return out


def _gauges(snapshot):
    return (snapshot.get("ml.shard") or {}).get("gauges") or {}


def _topology(snap):
    """A mesh snapshot without the device ids."""
    return {k: v for k, v in snap.items() if k != "devices"} | {
        "devices": [{k: v for k, v in d.items() if k != "id"}
                    for d in snap["devices"]]}


# -- topology -------------------------------------------------------------------

def test_mesh_snapshot_matches_jax(mesh8):
    got = meshstats.mesh_snapshot(port_mesh(8))
    want = jax_meshstats.mesh_snapshot(mesh8)
    assert _topology(got) == _topology(want)
    assert got["device_count"] == 8 and got["platform"] == "cpu"
    assert [d["id"] for d in got["devices"]] == [0] * 8
    json.dumps(got)


def test_mesh_recorded_once_with_root_attrs(tmp_path):
    tracing.tracer.configure(str(tmp_path))
    mesh = port_mesh(8)
    with tracing.tracer.span("Fit.fit"):
        with tracing.tracer.span("epoch"):
            meshstats.ensure_mesh_recorded(mesh)
            meshstats.ensure_mesh_recorded(mesh)
    tracing.tracer.shutdown()
    doc = json.load(open(tmp_path / meshstats.MESH_FILE))
    assert len(doc["meshes"]) == 1
    # either package reads the other's artifact
    assert jax_meshstats.read_mesh(str(tmp_path)) == \
        meshstats.read_mesh(str(tmp_path))
    root = [sp for sp in exporters.read_spans(str(tmp_path))
            if sp["name"] == "Fit.fit"][0]
    assert root["attrs"]["mesh_devices"] == 8
    assert root["attrs"]["mesh_axes"] == "data=8"
    assert root["attrs"]["mesh_platform"] == "cpu"
    assert metrics.group("ml", "mesh").get_gauge("deviceCount") == 8


def test_host_op_seam_records_the_mesh(tmp_path):
    tracing.tracer.configure(str(tmp_path))
    with tracing.tracer.span("fit"):
        C.ensure_on_mesh(port_mesh(4), np.ones((8, 2), np.float32))
    assert meshstats.read_mesh(str(tmp_path))["device_count"] == 4


# -- per-shard series and skew ----------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 7, 13, 16, 240, 241])
def test_record_shard_rows_match_jax(mesh8, n):
    got = meshstats.record_shard_rows(port_mesh(8), n)
    assert got == jax_meshstats.record_shard_rows(mesh8, n)
    assert _by_shard(metrics.snapshot(), "rows") == \
        _by_shard(jax_metrics.snapshot(), "rows")


@pytest.mark.parametrize("bucket,real", [(8, 3), (16, 13), (32, 32)])
def test_serving_shard_rows_match_jax(mesh8, bucket, real):
    got = meshstats.record_shard_rows(port_mesh(8), real,
                                      local_n=bucket // 8, skew=False)
    assert got == jax_meshstats.record_shard_rows(
        mesh8, real, local_n=bucket // 8, skew=False)


@pytest.mark.parametrize("series,floor", [
    ([10.0, 10.0, 100.0], 0.0),
    ([0.01, 0.01, 1.0], 50.0),
    ([1.0, 2.0, 3.0, 4.0], 0.0),
    ([0.0, 0.0, 5.0], 0.0),
    ([0.0, 0.0], 0.0),
    ([3.0], 0.0),
])
def test_detect_skew_matches_jax(tmp_path, monkeypatch, series, floor):
    monkeypatch.setenv(meshstats.SKEW_FACTOR_ENV, "2.0")
    events = {}
    for name, mod, trc, exp in (
            ("jax", jax_meshstats, jax_tracing, jax_exporters),
            ("port", meshstats, tracing, exporters)):
        trc.tracer.configure(str(tmp_path / name))
        with trc.tracer.span("fit"):
            spread = mod.detect_skew("readyMs", series, floor=floor,
                                     phase="epoch")
        trc.tracer.shutdown()
        events[name] = (spread, [
            ev["attrs"] for sp in exp.read_spans(str(tmp_path / name))
            for ev in sp.get("events", ()) if ev["name"] == "ml.skew"])
    assert events["port"] == events["jax"]
    assert _gauges(metrics.snapshot()) == _gauges(jax_metrics.snapshot())


def test_record_input_health_matches_jax(mesh8):
    x = np.ones((16, 2), np.float32)
    x[4, 1] = np.nan   # rows 4-5 are shard 2
    x[11, 0] = np.inf  # rows 10-11 are shard 5
    arr, _ = jax_shard_batch(mesh8, x)
    want = jax_meshstats.record_input_health("KMeans", mesh8, arr)
    mesh = port_mesh(8)
    got = meshstats.record_input_health("KMeans", mesh,
                                        C.ensure_on_mesh(mesh, x))
    assert got == want == [0, 0, 1, 0, 0, 1, 0, 0]
    assert _by_shard(metrics.snapshot(), "nonFinite") == \
        _by_shard(jax_metrics.snapshot(), "nonFinite")
    # one shard: nothing to attribute, as the JAX package's one device
    assert meshstats.record_input_health("KMeans", port_mesh(1),
                                         [torch.ones(3)]) is None


def test_registry_merge_keeps_shard_labels():
    child = MetricsRegistry()
    grp = child.group("ml", "shard")
    for i in range(4):
        labels = {"shard": str(i), "device": "0"}
        grp.gauge("rows", 10 + i, labels=labels)
        grp.histogram("readyMs", labels=labels).observe(float(i))
    driver = MetricsRegistry()
    driver.group("ml", "shard").histogram(
        "readyMs", labels={"shard": "0", "device": "0"}).observe(7.0)
    driver.merge(child.snapshot())
    got = driver.group("ml", "shard")
    for i in range(4):
        assert got.get_gauge("rows", labels={"shard": str(i),
                                             "device": "0"}) == 10 + i
    hist = got.snapshot()["histograms"]
    assert hist['readyMs{device="0",shard="0"}']["count"] == 2
    assert hist['readyMs{device="0",shard="3"}']["count"] == 1


# -- traced fits ---------------------------------------------------------------------

def _kmeans_rows(nan_rows=()):
    x = np.random.default_rng(0).normal(size=(N, D)).astype(np.float32)
    for r in nan_rows:
        x[r, 1] = np.nan
    return x


def test_traced_kmeans_fit_matches_jax_with_nans_in_shard5(mesh8, tmp_path,
                                                           monkeypatch):
    """Rows 150-179 are shard 5 of 240 rows on 8 shards in both packages."""
    x = _kmeans_rows(nan_rows=(152, 170))
    monkeypatch.setenv(tracing.TRACE_DIR_ENV, str(tmp_path / "jax"))
    jax_set_default_mesh(mesh8)
    with pytest.raises(Exception, match="non-finite"):
        JaxKMeans(k=3, seed=7, max_iter=4).fit(
            JaxTable.from_columns(features=x))
    jax_tracing.tracer.shutdown()
    monkeypatch.setenv(tracing.TRACE_DIR_ENV, str(tmp_path / "port"))
    with pytest.raises(NonFiniteState):
        KMeans(k=3, seed=7, max_iter=4, device="cpu",
               mesh=port_mesh(8)).fit(Table.from_columns(features=x))
    tracing.tracer.shutdown()

    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert _topology(meshstats.read_mesh(port_dir)) == \
        _topology(meshstats.read_mesh(jax_dir))
    port_snap = exporters.read_metrics(port_dir)
    jax_snap = exporters.read_metrics(jax_dir)
    for name in ("rows", "nonFinite"):
        assert _by_shard(port_snap, name) == _by_shard(jax_snap, name), name
    skew = {k: v for k, v in _gauges(port_snap).items()
            if k.startswith("skew")}
    assert skew == {k: v for k, v in _gauges(jax_snap).items()
                    if k.startswith("skew")} == {'skew{kind="rows"}': 1.0}
    assert _by_shard(port_snap, "rows") == {s: 30 for s in range(8)}
    assert _by_shard(port_snap, "nonFinite") == {
        s: 2 if s == 5 else 0 for s in range(8)}
    health = [ev["attrs"] for sp in exporters.read_spans(port_dir)
              for ev in sp["events"] if ev["name"] == "ml.health"
              and ev["attrs"].get("kind") == "non-finite-input"]
    assert health == [{"algo": "KMeans", "kind": "non-finite-input",
                       "shards": "5", "total": 2}]


def _kmeans_fit(mode):
    est = KMeans(k=3, seed=7, max_iter=5, device="cpu", mesh=port_mesh(8))
    est.set_iteration_config(IterationConfig(mode=mode))
    model = est.fit(Table.from_columns(features=_kmeans_rows()))
    return np.concatenate([model.centroids.ravel(), model.weights])


def _lr_fit(ckpt):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(200, 5)).astype(np.float32)
    y = (x @ rng.normal(size=5) > 0).astype(np.float64)
    est = LogisticRegression(device="cpu", mesh=port_mesh(8), max_iter=6,
                             global_batch_size=80)
    est.set_iteration_config(IterationConfig(
        checkpoint_interval=2, checkpoint_manager=CheckpointManager(ckpt)))
    return est.fit(Table.from_columns(features=x, label=y)).coefficients


@pytest.mark.parametrize("case", ["kmeans-host-rounds", "lr-segments"])
def test_armed_fits_bit_identical_with_ready_series(tmp_path, monkeypatch,
                                                    case):
    def fit(tag):
        if case == "kmeans-host-rounds":
            return _kmeans_fit("host")
        return _lr_fit(str(tmp_path / f"ckpt-{tag}"))

    want = fit("unarmed")
    assert "ml.shard" not in metrics.snapshot()
    assert not os.path.exists(tmp_path / "trace")
    trace = tmp_path / "trace"
    monkeypatch.setenv(tracing.TRACE_DIR_ENV, str(trace))
    got = fit("armed")
    tracing.tracer.shutdown()
    np.testing.assert_array_equal(got, want)

    phase, rounds, span_name = (("epoch", 5, "epoch")
                                if case == "kmeans-host-rounds"
                                else ("segment", 3, "segment"))
    snap = exporters.read_metrics(str(trace))
    ready = _by_shard(snap, "readyMs", kind="histograms")
    assert sorted(ready) == list(range(8))
    assert all(h["count"] == rounds for h in ready.values())
    assert all(f'phase="{phase}"' in k for k in
               snap["ml.shard"]["histograms"] if k.startswith("readyMs"))
    rows = _by_shard(snap, "rows")
    assert sum(rows.values()) == (N if case.startswith("kmeans") else 200)
    spans = [sp for sp in exporters.read_spans(str(trace))
             if sp["name"] == span_name]
    assert len(spans) == rounds
    assert all(len(sp["attrs"]["shard_ready_ms"]) == 8 for sp in spans)
    assert meshstats.read_mesh(str(trace))["device_count"] == 8
    # nothing marked stays behind once the loop ends
    assert getattr(meshstats._local, "marks", None) is None


def test_unarmed_marks_record_nothing():
    mesh = port_mesh(8)
    meshstats.mark_shard_ready(mesh, 0, torch.ones(2))
    assert meshstats.observe_shard_ready() is None
    with meshstats.collect_ready():
        meshstats.mark_shard_ready(port_mesh(1), 0, torch.ones(2))
        assert meshstats.observe_shard_ready() is None
        for s in range(8):
            meshstats.mark_shard_ready(mesh, s, torch.ones(2))
        times = meshstats.observe_shard_ready(phase="epoch")
        assert len(times) == 8 and all(t >= 0.0 for t in times)
        assert meshstats.observe_shard_ready() is None


# -- two gloo ranks -------------------------------------------------------------------

_RANK_PROGRAM = r"""
import os, sys
import numpy as np
import torch
from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.iteration.iteration import IterationConfig
from flink_ml_tpu_torch.models.clustering.kmeans import KMeans
from flink_ml_tpu_torch.observability import exporters, meshstats, tracing
from flink_ml_tpu_torch.parallel import collective as C, mesh as M

rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
store = torch.distributed.FileStore(os.path.join(root, "store"), world)
assert M.init_distributed(store=store, world_size=world, rank=rank,
                          device="cpu", timeout_s=60)
mesh = M.default_mesh()
x = np.load(os.path.join(root, "x.npy"))
KMeans(k=2, seed=3, max_iter=3, device="cpu").set_iteration_config(
    IterationConfig(mode="host")).fit(
        Table.from_columns(features=np.nan_to_num(x)))
# the fit recorded 0s; the rows with NaNs overwrite them
counts = meshstats.record_input_health("KMeans", mesh,
                                       C.ensure_on_mesh(mesh, x))
np.save(os.path.join(root, f"counts{rank}.npy"), np.asarray(counts))
exporters.dump_metrics(tracing.tracer.trace_dir)
tracing.tracer.shutdown()
M.shutdown_distributed()
"""


def test_two_gloo_ranks_keep_their_shards_apart(tmp_path):
    x = np.random.default_rng(5).normal(size=(20, 3)).astype(np.float32)
    x[[2, 3], 0] = np.nan   # shard 0 holds rows 0-9
    x[15, 2] = np.nan       # shard 1 holds rows 10-19
    np.save(tmp_path / "x.npy", x)
    trace = tmp_path / "trace"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    env[tracing.TRACE_DIR_ENV] = str(trace)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_PROGRAM, str(r), "2", str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=60)[0].decode())
    finally:
        for proc in procs:
            proc.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    for r in range(2):
        assert np.load(tmp_path / f"counts{r}.npy").tolist() == [2, 1]

    mesh = meshstats.read_mesh(str(trace))
    assert mesh["device_count"] == 2
    assert [d["process"] for d in mesh["devices"]] == [0, 1]
    snaps = sorted(trace.glob("metrics-*.json"))
    assert len(snaps) == 2
    readies = []
    for path in snaps:
        snap = json.load(open(path))
        # each rank holds every shard's gathered count
        assert _by_shard(snap, "nonFinite") == {0: 2, 1: 1}
        assert _by_shard(snap, "rows") == {0: 10, 1: 10}
        readies.append(sorted(_by_shard(snap, "readyMs",
                                        kind="histograms")))
    # each rank times its own shard only
    assert sorted(readies) == [[0], [1]]
    from flink_ml_tpu_torch.observability import shards

    summary = shards.shards_summary(exporters.read_spans(str(trace)),
                                    exporters.read_metrics(str(trace)), mesh)
    assert [(r["shard"], r["process"]) for r in summary["shards"]] == [
        (0, 0), (1, 1)]
    assert summary["process_count"] == 2
