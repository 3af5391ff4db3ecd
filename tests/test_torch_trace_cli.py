"""The port's trace CLI and artifact readers, held against the JAX package's.

One module-scoped set of trace dirs is written by each package with the
same numpy-seeded inputs (the JAX side on the conftest's CPU devices, the
port on virtual CPU shards):

- ``fit`` and ``fit-b``: a traced KMeans fit on 8 shards in host rounds
  with a checkpoint every 2 rounds (the two are the honest diff pair);
- ``one``: a traced LR fit on one shard in segments;
- ``nan``: the KMeans fit with NaNs in shard 5 (health events and an
  incident bundle);
- ``serve``: a traced micro-batcher on 4 shards with drift and quality
  capture armed and the lock watchdog armed;
- ``locks`` and ``cycle``: lock-watchdog dumps without and with an
  acquisition-order cycle;
- ``empty``; and ``profiled``, the port's CPU profile capture of a fit.

Then:

- **Each reader over the other package's artifacts**: ``cli.summarize``,
  ``shards.shards_summary``, ``path.analyze_paths``,
  ``diff.diff_profiles`` with ``violations``, and ``lockstats.report`` of
  both packages give equal outputs on every dir of either package.
- **Exit codes**: every subcommand of the port's
  ``flink-ml-tpu-torch-trace`` gives the JAX CLI's exit code on the same
  dirs, and the gates read as they should (0 clean, 2 broken or missing
  artifacts, 3 a health event, 4 a fired gate).
- The views new to the port: ``health``, ``drift`` and ``quality`` render
  the JSON the JAX views render on the same dirs, and ``efficiency`` reads
  the port's honest CPU capture in both packages.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import jax

REPO = Path(__file__).resolve().parent.parent
PKGS = ("jax", "torch")
DIM = 6


def _ns(name):
    if name == "jax":
        from flink_ml_tpu import Table, serving
        from flink_ml_tpu.common import locks
        from flink_ml_tpu.common import metrics as metrics_mod
        from flink_ml_tpu.iteration.checkpoint import CheckpointManager
        from flink_ml_tpu.iteration.iteration import IterationConfig
        from flink_ml_tpu.linalg.vectors import DenseVector
        from flink_ml_tpu.models.classification import LogisticRegression
        from flink_ml_tpu.models.clustering import KMeans
        from flink_ml_tpu.observability import (cli, diff, drift, evaluation,
                                                exporters, flightrecorder,
                                                health, lockstats,
                                                meshstats, path, profiling,
                                                shards, tracing)
        from flink_ml_tpu.parallel import create_mesh, set_default_mesh
        from flink_ml_tpu.servable import api, lr

        def mesh(n):
            return create_mesh(devices=jax.devices()[:n])

        def fit_kwargs(n):
            set_default_mesh(mesh(n))
            return {}
    else:
        from flink_ml_tpu_torch import Table, serving
        from flink_ml_tpu_torch.common import locks
        from flink_ml_tpu_torch.common import metrics as metrics_mod
        from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager
        from flink_ml_tpu_torch.iteration.iteration import IterationConfig
        from flink_ml_tpu_torch.linalg.vectors import DenseVector
        from flink_ml_tpu_torch.models.classification import (
            LogisticRegression,
        )
        from flink_ml_tpu_torch.models.clustering import KMeans
        from flink_ml_tpu_torch.observability import (cli, diff, drift,
                                                      evaluation, exporters,
                                                      flightrecorder,
                                                      health, lockstats,
                                                      meshstats, path,
                                                      profiling, shards,
                                                      tracing)
        from flink_ml_tpu_torch.parallel import create_mesh, set_default_mesh
        from flink_ml_tpu_torch.servable import api, lr

        def mesh(n):
            return create_mesh((n,), devices=["cpu"] * n)

        def fit_kwargs(n):
            return {"device": "cpu", "mesh": mesh(n)}

    return types.SimpleNamespace(
        name=name, Table=Table, serving=serving, locks=locks,
        metrics=metrics_mod.metrics, CheckpointManager=CheckpointManager,
        IterationConfig=IterationConfig, DenseVector=DenseVector,
        LogisticRegression=LogisticRegression, KMeans=KMeans, cli=cli,
        diff=diff, drift=drift, evaluation=evaluation, exporters=exporters,
        flightrecorder=flightrecorder, health=health, lockstats=lockstats,
        meshstats=meshstats, path=path,
        profiling=profiling, shards=shards, tracing=tracing, mesh=mesh,
        fit_kwargs=fit_kwargs, set_default_mesh=set_default_mesh, api=api,
        lr=lr)


NS = {name: _ns(name) for name in PKGS}
ENVS = ("FLINK_ML_TPU_TRACE_DIR", "FLINK_ML_TPU_HEALTH",
        "FLINK_ML_TPU_DRIFT", "FLINK_ML_TPU_QUALITY",
        "FLINK_ML_TPU_LOCKCHECK", "FLINK_ML_TPU_PROFILE_CAPTURE",
        "FLINK_ML_TPU_METRICS_PORT")


def _kmeans_x(nans=False):
    x = np.random.default_rng(0).normal(size=(240, 4)).astype(np.float32)
    if nans:
        x[[152, 170], 1] = np.nan  # shard 5 of 8
    return x


def _traced(ns, trace_dir, run, env=()):
    """Run ``run()`` with ``trace_dir`` armed, from an empty registry."""
    saved = {k: os.environ.get(k) for k in ENVS}
    os.environ["FLINK_ML_TPU_TRACE_DIR"] = str(trace_dir)
    os.environ.update(dict(env))
    for other in NS.values():
        other.metrics.clear()
        other.meshstats._recorded.clear()
    try:
        run()
    finally:
        ns.tracing.tracer.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        ns.set_default_mesh(None)


def _kmeans_fit(ns, ckpt, nans=False):
    est = ns.KMeans(k=3, seed=7, max_iter=4, **ns.fit_kwargs(8))
    est.set_iteration_config(ns.IterationConfig(
        mode="host", checkpoint_interval=2,
        checkpoint_manager=ns.CheckpointManager(str(ckpt))))
    table = ns.Table.from_columns(features=_kmeans_x(nans))
    if nans:
        with pytest.raises(Exception, match="non-finite"):
            est.fit(table)
    else:
        est.fit(table)


def _lr_fit(ns, ckpt):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(200, 5)).astype(np.float32)
    y = (x @ rng.normal(size=5) > 0).astype(np.float64)
    est = ns.LogisticRegression(max_iter=6, global_batch_size=50,
                                **ns.fit_kwargs(1))
    est.set_iteration_config(ns.IterationConfig(
        checkpoint_interval=2,
        checkpoint_manager=ns.CheckpointManager(str(ckpt))))
    est.fit(ns.Table.from_columns(features=x, label=y))


def _frame(ns, rows, seed):
    rng = np.random.default_rng(seed)
    return ns.api.DataFrame(
        ["features"], [ns.api.DataTypes.vector()],
        [ns.api.Row([ns.DenseVector(rng.normal(size=DIM))])
         for _ in range(rows)])


def _serve(ns, trace_dir):
    ns.locks.reseed_child()
    sv = ns.lr.LogisticRegressionModelServable()
    if ns.name == "torch":
        sv.set_device_predict(True, device="cpu")
    else:
        sv.set_device_predict(True)
    sv.model_data = ns.lr.LogisticRegressionModelData(
        np.linspace(-1.0, 1.0, DIM), 1)
    sv.serving_name = "lr@v1"
    mesh = ns.mesh(4)
    with ns.serving.MicroBatcher(sv, ns.serving.BatcherConfig(
            buckets=(8, 32), window_ms=1.0), mesh=mesh) as b:
        ns.serving.warm(b, frame_factory=lambda r: _frame(ns, r, 0),
                        gate=False)
        futures = [b.submit(_frame(ns, 1 + i % 4, seed=i))
                   for i in range(24)]
        for fut in futures:
            fut.result(timeout=30)
    ns.exporters.dump_metrics(str(trace_dir))


def _locks(ns, trace_dir, cycle):
    ns.locks.reseed_child()
    a, b = ns.locks.make_lock("cli.a"), ns.locks.make_lock("cli.b")
    with a:
        with b:
            pass
    if cycle:
        with b:
            with a:
                pass
    ns.exporters.dump_metrics(str(trace_dir))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("trace_cli")
    out = {}
    for name, ns in NS.items():
        d = {key: root / f"{name}-{key}" for key in (
            "fit", "fit-b", "one", "nan", "serve", "locks", "cycle")}
        _traced(ns, d["fit"], lambda: _kmeans_fit(ns, root / f"{name}-c1"))
        _traced(ns, d["fit-b"],
                lambda: _kmeans_fit(ns, root / f"{name}-c2"))
        _traced(ns, d["one"], lambda: _lr_fit(ns, root / f"{name}-c3"))
        with pytest.MonkeyPatch.context() as mp:
            # the nan run's incident bundle depends on that run alone,
            # whatever ran before in this worker: both flight recorders
            # start with no bundle behind them (no debounce window open,
            # none of the cap spent) and nothing is debounced. The runs
            # after it keep the default window, as they always had it.
            mp.setenv(ns.flightrecorder.DEBOUNCE_ENV, "0")
            for other in NS.values():
                other.flightrecorder.reset()
            _traced(ns, d["nan"],
                    lambda: _kmeans_fit(ns, root / f"{name}-c4", nans=True))
        _traced(ns, d["serve"], lambda: _serve(ns, d["serve"]),
                env={"FLINK_ML_TPU_DRIFT": "1", "FLINK_ML_TPU_QUALITY": "1",
                     "FLINK_ML_TPU_LOCKCHECK": "1"})
        _traced(ns, d["locks"], lambda: _locks(ns, d["locks"], False),
                env={"FLINK_ML_TPU_LOCKCHECK": "1"})
        _traced(ns, d["cycle"], lambda: _locks(ns, d["cycle"], True),
                env={"FLINK_ML_TPU_LOCKCHECK": "1"})
        ns.locks.reseed_child()
        out[name] = {k: str(v) for k, v in d.items()}
    port = NS["torch"]
    profiled = root / "torch-profiled"
    port.profiling.reset()
    _traced(port, profiled, lambda: _lr_fit(port, root / "torch-c5"),
            env={"FLINK_ML_TPU_PROFILE_CAPTURE": "1"})
    port.profiling.reset()
    out["torch"]["profiled"] = str(profiled)
    empty = root / "empty"
    empty.mkdir()
    for name in PKGS:
        out[name]["empty"] = str(empty)
    return out


def _same(a, b):
    return json.dumps(a, sort_keys=True, default=str) == \
        json.dumps(b, sort_keys=True, default=str)


READ_DIRS = ("fit", "one", "nan", "serve", "locks", "cycle")


@pytest.mark.parametrize("writer", PKGS)
@pytest.mark.parametrize("key", READ_DIRS)
def test_readers_agree_on_either_packages_artifacts(dirs, writer, key):
    d = dirs[writer][key]
    got = {}
    for name, ns in NS.items():
        spans = ns.exporters.read_spans(d)
        snap = ns.exporters.read_metrics(d)
        got[name] = {
            "summary": ns.cli.summarize(spans),
            "shards": ns.shards.shards_summary(spans, snap,
                                               ns.meshstats.read_mesh(d)),
            "paths": ns.path.analyze_paths(spans),
            "locks": ns.lockstats.report(d),
        }
    for part in got["torch"]:
        assert _same(got["torch"][part], got["jax"][part]), part


@pytest.mark.parametrize("writer", PKGS)
@pytest.mark.parametrize("pair", [("fit", "fit-b"), ("fit", "one"),
                                  ("one", "serve"), ("fit", "nan")])
def test_diffs_agree_on_either_packages_artifacts(dirs, writer, pair):
    a, b = (dirs[writer][k] for k in pair)
    got = {}
    for name, ns in NS.items():
        diff = ns.diff.diff_profiles(ns.diff.load_side(a),
                                     ns.diff.load_side(b))
        got[name] = (diff, ns.diff.violations(diff, 20.0, 5.0),
                     ns.diff.violations(diff, 1e6, 1e6))
    assert _same(got["torch"], got["jax"])
    assert got["torch"][2] == []


def test_artifacts_say_what_ran(dirs):
    """The port's dirs hold what phase 18 reads on the card."""
    port = NS["torch"]
    d = dirs["torch"]
    mesh = port.meshstats.read_mesh(d["fit"])
    assert mesh["device_count"] == 8 and mesh["platform"] == "cpu"
    summary = port.shards.shards_summary(
        port.exporters.read_spans(d["fit"]),
        port.exporters.read_metrics(d["fit"]), mesh)
    assert [r["rows"] for r in summary["shards"]] == [30] * 8
    assert all(r["readyCount"] == 4 for r in summary["shards"])
    nan = port.shards.shards_summary(
        port.exporters.read_spans(d["nan"]),
        port.exporters.read_metrics(d["nan"]),
        port.meshstats.read_mesh(d["nan"]))
    assert [r["nonFinite"] for r in nan["shards"]] == [0] * 5 + [2, 0, 0]
    report = port.path.analyze_paths(port.exporters.read_spans(d["serve"]))
    assert report["requests"]["count"] == 24
    assert report["requests"]["coverage"] >= 0.9
    assert port.meshstats.read_mesh(d["serve"])["device_count"] == 4
    rep = port.lockstats.report(d["serve"])
    assert rep is not None and rep["processes"] == 1
    assert port.lockstats.report(d["cycle"])["cycles"]


# -- exit codes ------------------------------------------------------------------------

#: (argv with {dir} / {a} / {b} placeholders, dir keys, the expected code on
#: each dir, or None where only the two packages' agreement is checked)
CASES = [
    (["{dir}", "--check"], {"fit": 0, "serve": 0, "empty": 2}),
    (["summary", "{dir}", "--json", "--check"], {"fit": 0, "empty": 2}),
    (["{dir}", "--prometheus"], {"fit": 0, "empty": 0}),
    (["diff", "{a}", "{b}", "--budget", "1000000", "--min-ms", "1000000"],
     {("fit", "fit-b"): 0, ("fit", "empty"): 2, ("one", "fit"): 0}),
    (["diff", "{a}", "{b}", "--budget", "0", "--min-ms", "0"],
     {("fit", "fit-b"): None, ("one", "serve"): None}),
    (["health", "{dir}", "--check"], {"fit": 0, "nan": 3, "empty": 2}),
    (["health", "{dir}", "--json"], {"nan": 0}),
    (["shards", "{dir}", "--check"],
     {"fit": 0, "serve": 0, "one": 2, "empty": 2}),
    (["shards", "{dir}", "--json"], {"fit": 0, "one": 0}),
    (["slo", "{dir}", "--check"], {"serve": None, "empty": 2}),
    (["drift", "{dir}", "--check"], {"serve": 0, "fit": 2, "empty": 2}),
    (["quality", "{dir}", "--check"], {"serve": None, "fit": 2}),
    (["controller", "{dir}", "--check"], {"serve": 2, "empty": 2}),
    (["path", "{dir}", "--check"], {"serve": 0, "fit": 2, "empty": 2}),
    (["path", "{dir}", "--check", "--budget", "100"], {"serve": 0}),
    (["path", "{dir}", "--json"], {"fit": 0}),
    (["incident", "{dir}", "--check"], {"nan": 4, "fit": None}),
    (["locks", "{dir}", "--check"],
     {"locks": 0, "cycle": 4, "fit": 2, "empty": 2}),
    (["locks", "{dir}"], {"cycle": 0}),
    (["fleet", "{dir}", "--check"], {"serve": None, "empty": 2}),
    (["efficiency", "{dir}"], {"fit": 2, "empty": 2}),
    (["{dir}", "--latest"], {"empty": None}),
]


def _runs():
    for argv, want in CASES:
        for keys, code in want.items():
            yield argv, keys, code


@pytest.mark.parametrize("writer", PKGS)
@pytest.mark.parametrize("argv,keys,code", list(_runs()),
                         ids=lambda v: str(v).replace(" ", ""))
def test_exit_codes_match_the_jax_cli(dirs, writer, argv, keys, code,
                                      capsys):
    if isinstance(keys, tuple):
        fill = {"a": dirs[writer][keys[0]], "b": dirs[writer][keys[1]]}
    else:
        fill = {"dir": dirs[writer][keys]}
    args = [a.format(**fill) for a in argv]
    rc = {name: ns.cli.main(list(args)) for name, ns in NS.items()}
    capsys.readouterr()
    assert rc["torch"] == rc["jax"], (args, rc)
    if code is not None:
        assert rc["torch"] == code, (args, rc)


def test_efficiency_reads_an_honest_cpu_capture(dirs, capsys):
    d = dirs["torch"]["profiled"]
    for ns in NS.values():
        assert ns.cli.main(["efficiency", d]) == 0
        assert ns.cli.main(["efficiency", d, "--check", "--min-util",
                            "0.99"]) == 0
        assert ns.cli.main(["efficiency", d, "--json"]) == 0
    out = capsys.readouterr().out
    assert "host-fallback" in out


@pytest.mark.parametrize("key", ["nan", "fit", "serve"])
@pytest.mark.parametrize("view", ["health", "drift", "quality"])
def test_new_views_render_what_jax_renders(dirs, capsys, view, key):
    d = dirs["torch"][key]
    outs = {}
    for name, ns in NS.items():
        rc = ns.cli.main([view, d, "--json"])
        outs[name] = (rc, capsys.readouterr().out)
    assert outs["torch"] == outs["jax"]


def test_console_script_and_module_entry(dirs):
    """``python -m flink_ml_tpu_torch.observability.cli`` runs the CLI
    without the JAX package, and pyproject names the console script."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys; sys.argv = ['cli', 'shards', sys.argv[1], "
         "'--check']; runpy.run_module("
         "'flink_ml_tpu_torch.observability.cli', run_name='__main__'); "
         "", dirs["torch"]["fit"]],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "8 device(s)" in proc.stdout
    text = (REPO / "pyproject.toml").read_text()
    assert ('flink-ml-tpu-torch-trace = '
            '"flink_ml_tpu_torch.observability.cli:main"') in text
