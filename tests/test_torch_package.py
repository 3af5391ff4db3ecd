"""Boundaries of the port: what it imports, where it runs, which path a
tensor takes.

- No module of ``flink_ml_tpu_torch`` and not ``chip_smoke.py`` imports
  ``jax`` or the JAX package (checked on the source, not by importing).
- Without a CUDA card the default device raises instead of running on the
  CPU.
- A CPU tensor reaches only the plain versions of the kernels, and a CUDA
  tensor only the kernels (checked by patching the launch and plain
  functions, so that the check runs without a card).
"""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flink_ml_tpu_torch
from flink_ml_tpu_torch import Table, device as port_device
from flink_ml_tpu_torch.iteration import IterationConfig, IterationListener
from flink_ml_tpu_torch.models.classification import (
    LogisticRegression,
    LogisticRegressionModel,
)
from flink_ml_tpu_torch.models.clustering import KMeans, KMeansModel
from flink_ml_tpu_torch.observability.health import NonFiniteState
from flink_ml_tpu_torch.ops import kernels
from flink_ml_tpu_torch.resilience import RetryPolicy
from flink_ml_tpu_torch.utils import io as rw

REPO = Path(__file__).resolve().parent.parent
PORT_DIR = Path(flink_ml_tpu_torch.__file__).parent
# _build/ holds what the kernels build to, not the package's source
PORT_FILES = sorted(p for p in PORT_DIR.rglob("*.py")
                    if "_build" not in p.relative_to(PORT_DIR).parts)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flink_ml_tpu")


@pytest.mark.parametrize(
    "path", PORT_FILES + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"


def test_port_files_were_found():
    names = {p.name for p in PORT_FILES}
    assert {"kernels.py", "kmeans.py", "runner.py", "io.py", "optimizer.py",
            "logisticregression.py", "knn.py", "online.py", "sparse.py",
            "streaming.py", "iteration.py", "checkpoint.py", "policy.py",
            "faults.py", "supervisor.py", "mesh.py", "collective.py",
            "mapreduce.py", "update_sharding.py", "pipeline.py", "graph.py",
            "columnar.py", "blas.py", "functions.py", "scalers.py",
            "quantile.py", "vectorops.py", "stats.py", "selectors.py",
            "tests.py", "binaryclassification.py", "naivebayes.py"} <= names


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_device.default_device()
    table = Table.from_columns(features=np.random.default_rng(0).random((20, 3)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KMeans(k=2).fit(table)
    with pytest.raises(RuntimeError, match="CUDA"):
        KMeansModel(centroids=np.eye(3), weights=np.ones(3)).transform(table)
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    def no_launch(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a kernel launch")

    for name in ("_launch_assign", "_launch_lloyd_partials", "_launch_reduce",
                 "_launch_sgd_terms"):
        monkeypatch.setattr(kernels, name, no_launch)
    kernels.reset_launch_counts()
    x = np.random.default_rng(1).random((60, 4))
    model = KMeans(k=3, seed=0, max_iter=3, device="cpu").fit(
        Table.from_columns(features=x))
    model.transform(Table.from_columns(features=x))
    kernels.reduce_partials(torch.ones((2, 3, 5)))
    labeled = Table.from_columns(features=x, label=(x[:, 0] > 0.5) * 1.0)
    LogisticRegression(max_iter=3, device="cpu").fit(labeled).transform(labeled)
    kernels.reduce_partials(torch.ones((2, 6)))
    assert set(kernels.launch_counts.values()) == {0}


def test_cuda_tensors_never_reach_the_plain_versions(monkeypatch):
    calls = []

    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    def launch_assign(x, c):
        calls.append("assign")
        return torch.zeros(x.shape[0], dtype=torch.int32)

    def launch_lloyd(x, v, c):
        calls.append("lloyd")
        return torch.zeros((3, c.shape[0], c.shape[1] + 1))

    def launch_reduce(p):
        calls.append("reduce")
        return p.sum(0)

    def launch_sgd_terms(xl, yl, wl, coeffs, start, clip, lb, loss_name):
        calls.append("sgd")  # both stages: one C call, no reduce_partials
        return torch.zeros((3, coeffs.shape[0] + 2))

    # every tensor counts as a CUDA tensor, so the check needs no card
    monkeypatch.setattr(kernels, "_is_cuda", lambda t: True)
    for name in ("assign_nearest_plain", "lloyd_partial_sums_plain",
                 "reduce_partials_plain", "sgd_batch_terms_plain"):
        monkeypatch.setattr(kernels, name, no_plain)
    monkeypatch.setattr(kernels, "_launch_assign", launch_assign)
    monkeypatch.setattr(kernels, "_launch_lloyd_partials", launch_lloyd)
    monkeypatch.setattr(kernels, "_launch_reduce", launch_reduce)
    monkeypatch.setattr(kernels, "_launch_sgd_terms", launch_sgd_terms)
    kernels.reset_launch_counts()
    x, c = torch.rand((10, 4)), torch.rand((2, 4))
    kernels.assign_nearest(x, c)
    kernels.lloyd_partial_sums(x, torch.ones(10), c)
    kernels.sgd_batch_terms(x, torch.ones(10), torch.ones(10), c[0], 2, 1, 5,
                            "hinge")
    assert calls == ["assign", "lloyd", "reduce", "sgd"]
    assert kernels.launch_counts == {"assign_nearest": 1,
                                     "lloyd_partial_sums": 1,
                                     "reduce_partials": 1,
                                     "sgd_batch_terms": 1,
                                     "segment_reduce_sum": 0,
                                     "knn_topk_indices": 0}
    kernels.reset_launch_counts()


def test_kmeans_fit_runs_every_round_through_the_partials_wrapper(monkeypatch):
    rounds = []
    real = kernels.lloyd_partial_sums

    def counting(x, v, c):
        rounds.append(tuple(x.shape))
        return real(x, v, c)

    monkeypatch.setattr(kernels, "lloyd_partial_sums", counting)
    x = np.random.default_rng(2).random((40, 3))
    KMeans(k=2, seed=0, max_iter=7, device="cpu").fit(
        Table.from_columns(features=x))
    assert rounds == [(40, 3)] * 7


def test_iteration_modes_of_later_slices_raise():
    """Host rounds, listeners, checkpoints and supervision raised until the
    iteration slice of the port, whence the name, kept so the test's history
    stays one line; now the estimator stores them and its fit runs them
    (tests/test_torch_iteration.py holds their results)."""
    est = KMeans(k=2, seed=0, max_iter=3, device="cpu")
    assert est.set_iteration_config(IterationConfig()) is est
    assert est.set_iteration_config(None) is est
    for config in (IterationConfig(mode="host"),
                   IterationConfig(checkpoint_interval=2)):
        assert est.set_iteration_config(config) is est
        assert est._iteration_config is config
    listener = IterationListener()
    assert est.set_iteration_config(None, listeners=[listener]) is est
    assert est._iteration_listeners == (listener,)
    policy = RetryPolicy(max_restarts=1)
    assert est.set_retry_policy(policy) is est and est._retry_policy is policy
    table = Table.from_columns(
        features=np.random.default_rng(5).random((30, 3)))
    est.set_iteration_config(IterationConfig(mode="host")).fit(table)
    assert est.last_execution_path == "torch-lloyd-rounds"


def test_load_class_maps_jax_paths_without_importing_them(monkeypatch):
    before = {m for m in sys.modules if m.startswith("flink_ml_tpu.")}
    cls = rw.load_class("flink_ml_tpu.models.clustering.kmeans.KMeansModel")
    assert cls is KMeansModel
    assert rw.load_class(
        "flink_ml_tpu_torch.models.clustering.kmeans.KMeans") is KMeans
    assert {m for m in sys.modules if m.startswith("flink_ml_tpu.")} == before
    with pytest.raises(ValueError, match="not part of the port"):
        rw.load_class("flink_ml_tpu.models.recommendation.swing.Swing")


def test_non_finite_final_state_raises():
    x = np.random.default_rng(3).random((30, 2))
    x[0, 0] = np.nan
    with pytest.raises(NonFiniteState):
        KMeans(k=2, seed=0, max_iter=2, device="cpu").fit(
            Table.from_columns(features=x))


def test_linear_models_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(4).random((20, 3))
    table = Table.from_columns(features=x, label=(x[:, 0] > 0.5) * 1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LogisticRegression().fit(table)
    with pytest.raises(RuntimeError, match="CUDA"):
        LogisticRegressionModel(coefficients=np.ones(3)).transform(table)
    # the iteration modes keep the card as the default device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LogisticRegression().set_iteration_config(
            IterationConfig(mode="host")).fit(table)
    est = LogisticRegression(device="cpu")
    policy = RetryPolicy(max_restarts=0)
    assert est.set_retry_policy(policy) is est and est._retry_policy is policy
    listener = IterationListener()
    assert est.set_iteration_config(None, listeners=[listener]) is est
    assert est._iteration_listeners == (listener,)
