"""Whole runs at tiny sizes on the CPU: the harness's look for a card is
skipped (``device="cpu"``), the rest of a run is driven as on the card, and
the timed path is broken underneath to see ``correct`` come out false.

The KMeans check's ``step_gap`` limit is set for 100,000 rows a cluster,
where a row that flips between two tied centroids moves one by 1e-5; at 50
rows a cluster one flip moves it by 1e-2, so the KMeans runs here take 2,000
rows, at which no round of these seeds meets a tie."""

import copy
import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from portbench.harness import bench

TINY = {"kmeans-fit": ("kmeans-1m-d100", {"numValues": 2000}),
        "lr-fit": ("lr-10m-d100", {"numValues": 3000})}
SEED = 3_000_000_123


def tiny_config(workload):
    name, sizes = TINY[workload]
    config = copy.deepcopy(bench.load_json(
        bench.ROOT / "portbench" / "configs" / f"{name}.json"))
    config["inputData"]["paramMap"].update(sizes)
    return config


def run(workload, trace=False, seed=SEED):
    return bench.run_cell(workload, seed, 0.2, trace, device="cpu",
                          config=tiny_config(workload))


@pytest.mark.parametrize("workload", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(workload, trace):
    result = run(workload, trace)
    assert result["correct"] is True, result["check"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "check"
    for c in result["check"].values():
        assert c["value"] <= c["limit"]
    names = {m["name"] for m in (bench.resolve(
        bench.load_json(bench.ROOT / "BENCHMARK.json"), workload)[
        3 if trace else 2])}
    # the CPU has no device operations and no peaks
    assert set(result["metrics"]) <= names
    if trace:
        assert result["device"]["window_s"] > 0
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == names
    assert result["readings"] and result["setup_phases_s"]["warmup"] > 0


def _kmeans_unchanged(monkeypatch):
    from flink_ml_tpu_torch.models.clustering import kmeans

    def unchanged(partials_fn, x, v, centroids, mesh=None, sharded=False):
        return centroids, torch.zeros(centroids.shape[0],
                                      device=centroids.device)
    monkeypatch.setattr(kmeans, "lloyd_round", unchanged)


def _kmeans_half(monkeypatch):
    from flink_ml_tpu_torch.ops import kernels

    full = kernels.lloyd_partial_sums

    def half(x, v, centroids):
        return full(x[:x.shape[0] // 2], v[:x.shape[0] // 2], centroids)
    monkeypatch.setattr(kernels, "lloyd_partial_sums", half)


def _kmeans_altered(monkeypatch):
    from flink_ml_tpu_torch.models.clustering import kmeans

    full = kmeans.lloyd_round

    def altered(*args, **kwargs):
        centroids, counts = full(*args, **kwargs)
        centroids = centroids.clone()
        centroids[0, 0] += 1e-3
        return centroids, counts
    monkeypatch.setattr(kmeans, "lloyd_round", altered)


def _lr_unchanged(monkeypatch):
    from flink_ml_tpu_torch.ops import optimizer

    def unchanged(prm, rule, mesh, sharded, coeffs, opt, parts, tp=None):
        return coeffs, opt, torch.full((), 0.7, device=coeffs.device)
    monkeypatch.setattr(optimizer, "_apply_round", unchanged)


def _lr_half(monkeypatch):
    from flink_ml_tpu_torch.ops import kernels

    full = kernels.sgd_batch_terms

    def half(xl, yl, wl, coeffs, start, clip, lb, loss_name):
        return full(xl, yl, wl, coeffs, start, clip, max(clip, lb // 2),
                    loss_name)
    monkeypatch.setattr(kernels, "sgd_batch_terms", half)


def _lr_dots_doubled(monkeypatch):
    """From round 2 on: round 1 starts from zero coefficients, where the
    dots are 0 either way."""
    from flink_ml_tpu_torch.ops import kernels

    full = kernels.sgd_batch_terms

    def doubled(xl, yl, wl, coeffs, start, clip, lb, loss_name):
        return full(xl, yl, wl, 2.0 * coeffs, start, clip, lb, loss_name)
    monkeypatch.setattr(kernels, "sgd_batch_terms", doubled)


def _lr_altered(monkeypatch):
    from flink_ml_tpu_torch.ops import optimizer

    full = optimizer._apply_round

    def altered(*args, **kwargs):
        coeffs, opt, loss = full(*args, **kwargs)
        coeffs = coeffs.clone()
        coeffs[0] += 1e-3
        return coeffs, opt, loss
    monkeypatch.setattr(optimizer, "_apply_round", altered)


FAULTS = {
    ("kmeans-fit", "state unchanged"): _kmeans_unchanged,
    ("kmeans-fit", "half the rows"): _kmeans_half,
    ("kmeans-fit", "answer altered"): _kmeans_altered,
    ("lr-fit", "state unchanged"): _lr_unchanged,
    ("lr-fit", "half the batch"): _lr_half,
    ("lr-fit", "dots doubled"): _lr_dots_doubled,
    ("lr-fit", "answer altered"): _lr_altered,
}


@pytest.mark.parametrize("fault", sorted(FAULTS), ids=lambda f: "-".join(f))
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    result = run(fault[0])
    assert result["correct"] is False, result["check"]
    # each judged window fit fails
    assert result["failed"] == min(result["attempted"], bench.SAMPLE) + 1


def test_forbidden_module_gives_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(bench.BenchError, match="jax"):
        run("lr-fit")


def test_program_modules_are_not_forbidden():
    assert "flink_ml_tpu_torch" in sys.modules
    assert not [m for m in bench.forbidden_modules()
                if m.startswith("flink_ml_tpu_torch")]


def _entry(cwd, *args):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "kmeans-fit",
         "--seed", "1", "--seconds", "1", *args], cwd=cwd,
        capture_output=True, text=True, timeout=300)


def test_entry_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _entry(bench.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_entry_without_the_program_prints_no_result(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    out = _entry(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.chip
def test_cell_on_the_card(card):
    """A short run of each cell at a tiny size on the card."""
    for workload in sorted(TINY):
        result = bench.run_cell(workload, SEED, 0.5, True, device=card,
                                config=tiny_config(workload))
        assert result["correct"] is True, result["check"]
        assert result["device"]["busy_s"] > 0
        json.dumps(result)
