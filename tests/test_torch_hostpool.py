"""The port's host pool (``flink_ml_tpu_torch/common/hostpool.py``), held
against the JAX package's ``common/hostpool.py``.

The pool is forced to fork with a small ``min_rows``. Results are compared
exactly (tolerance 0): shard bounds, shard order, arrays returned through
the pipe. Failures: a worker's exception comes back with its traceback, a
wedged worker ends in ``WorkerTimeout`` with every child reaped, and both
chaos sites (``hostpool-child``, ``hostpool-hang``) fire. A child's spans
land in the trace dir and its metrics fold back into the parent's registry.
The pool also forks cleanly after torch CPU ops have run on several
threads (the workers are numpy-only, as the fork rule says).
"""

import os
import threading

import numpy as np
import pytest
import torch

from flink_ml_tpu.common import hostpool as jax_hostpool
from flink_ml_tpu_torch.common import hostpool
from flink_ml_tpu_torch.common.metrics import metrics
from flink_ml_tpu_torch.observability import exporters, tracing
from flink_ml_tpu_torch.resilience import faults
from flink_ml_tpu_torch.resilience.policy import InjectedFault, WorkerTimeout


@pytest.fixture
def forks(monkeypatch):
    """The pids the pool forks, recorded by wrapping ``os.fork``."""
    pids = []
    real = os.fork

    def fork():
        pid = real()
        if pid:
            pids.append(pid)
        return pid

    monkeypatch.setattr(hostpool.os, "fork", fork)
    return pids


def _reaped(pids):
    """Every recorded child is gone: waitpid on it raises."""
    for pid in pids:
        with pytest.raises(ChildProcessError):
            os.waitpid(pid, os.WNOHANG)
    return True


@pytest.mark.parametrize("n,w", [(10, 3), (8, 8), (7, 8), (0, 4), (100, 1)])
def test_shard_bounds_match_jax(n, w):
    assert hostpool.shard_bounds(n, w) == jax_hostpool.shard_bounds(n, w)


@pytest.mark.parametrize("raw", [None, "3", "0", "junk"])
def test_env_knobs_match_jax(monkeypatch, raw):
    for var in ("FLINK_ML_TPU_HOST_PARALLELISM",
                "FLINK_ML_TPU_HOST_TIMEOUT_S"):
        if raw is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, raw)
    assert hostpool.host_parallelism() == jax_hostpool.host_parallelism()
    assert hostpool.child_deadline_s() == jax_hostpool.child_deadline_s()


def test_inline_below_min_rows(forks):
    calls = []

    def fn(lo, hi):
        calls.append((lo, hi))
        return hi - lo

    assert hostpool.map_row_shards(fn, 10, workers=4, min_rows=100) == [10]
    assert calls == [(0, 10)] and not forks


@pytest.mark.parametrize("workers,shard_cap", [(4, 1 << 20), (3, 7_000)])
def test_forked_shards_in_order_match_jax(forks, workers, shard_cap):
    x = np.random.default_rng(0).integers(0, 255, 50_000).astype(np.uint8)

    def fn(lo, hi):
        return lo, x[lo:hi]

    got = hostpool.map_row_shards(fn, len(x), workers=workers, min_rows=16,
                                  shard_cap=shard_cap)
    ours = list(forks)
    want = jax_hostpool.map_row_shards(fn, len(x), workers=workers,
                                       min_rows=16, shard_cap=shard_cap)
    assert [lo for lo, _ in got] == [lo for lo, _ in want]
    assert [lo for lo, _ in got] == sorted(lo for lo, _ in got)
    np.testing.assert_array_equal(np.concatenate([a for _, a in got]), x)
    assert len(ours) == len(got) > 1 and _reaped(forks)


def test_worker_error_carries_its_traceback(forks):
    def bad(lo, hi):
        if lo > 0:
            raise ValueError(f"boom at {lo}")
        return lo

    with pytest.raises(RuntimeError, match="boom at") as info:
        hostpool.map_row_shards(bad, 10_000, workers=2, min_rows=16)
    assert "Traceback" in str(info.value) and "in bad" in str(info.value)
    assert _reaped(forks)


def test_wedged_worker_times_out_and_is_reaped(forks):
    def wedge(lo, hi):
        if lo == 0:
            threading.Event().wait()
        return lo

    with pytest.raises(WorkerTimeout) as info:
        hostpool.map_row_shards(wedge, 4_000, workers=2, min_rows=16,
                                timeout_s=0.5)
    assert info.value.worker_index == 0 and info.value.rows[0] == 0
    assert _reaped(forks)


def test_chaos_hang_site(forks):
    with faults.chaos(at={"hostpool-hang": [1]}):
        with pytest.raises(WorkerTimeout):
            hostpool.map_row_shards(lambda lo, hi: lo, 4_000, workers=2,
                                    min_rows=16, timeout_s=0.5)
    assert _reaped(forks)


def test_chaos_child_site(forks):
    with faults.chaos(at={"hostpool-child": [2]}):
        with pytest.raises(RuntimeError, match="InjectedFault") as info:
            hostpool.map_row_shards(lambda lo, hi: lo, 8_000, workers=4,
                                    min_rows=16)
    assert "hostpool-child" in str(info.value)
    assert InjectedFault.__name__ in str(info.value)
    assert _reaped(forks)


def test_spans_and_metrics_fold_back(monkeypatch, tmp_path, forks):
    monkeypatch.setenv("FLINK_ML_TPU_TRACE_DIR", str(tmp_path))
    group = metrics.group("ml", "hostpool_test")
    before = group.snapshot().get("counters", {}).get("rows", 0)

    def fn(lo, hi):
        metrics.group("ml", "hostpool_test").counter("rows", hi - lo)
        return hi - lo

    with tracing.tracer.span("parent"):
        parts = hostpool.map_row_shards(fn, 6_000, workers=3, min_rows=16)
    assert sum(parts) == 6_000
    after = group.snapshot().get("counters", {}).get("rows", 0)
    assert after - before == 6_000
    names = [s["name"] for s in exporters.read_spans(str(tmp_path))]
    assert names.count("hostpool.child") == len(parts) == len(forks)
    assert "hostpool.map" in names
    assert _reaped(forks)


def test_fork_after_threaded_torch_cpu_ops(forks):
    """torch's intra-op pool has run on several threads in the parent; the
    numpy-only workers fork, run and exit cleanly all the same."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        a = torch.randn(256, 256)
        for _ in range(3):
            a = torch.tanh(a @ a.T / 256)
        x = np.arange(40_000, dtype=np.int64)
        parts = hostpool.map_row_shards(lambda lo, hi: x[lo:hi].sum(),
                                        len(x), workers=4, min_rows=16,
                                        timeout_s=60)
        assert sum(parts) == x.sum()
        assert (a @ a).isfinite().all()  # the parent's pool still works
    finally:
        torch.set_num_threads(threads)
    assert _reaped(forks)
