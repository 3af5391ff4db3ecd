"""The port's FTRL online logistic regression and its stream plumbing, held
against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in ``flink_ml_tpu_torch`` on the CPU: the Pallas
``segment_reduce_sum`` kernel in interpret mode (as
tests/test_pallas_kernels.py runs it) against the port's wrapper on CPU
tensors, which runs the kernel's plain PyTorch version; the JAX FTRL fits
against the port's on each engine. The JAX default mesh is pinned to one
device for each fit and restored afterwards, so that both packages see one
shard (on the tests' 8-device mesh the sparse engine would pack eight).

Tolerances:
- segment sums rtol 1e-5, atol 1e-5 (float32 sums of up to a thousand
  terms, added in another order; the plain version sums in float64);
- the dense engine (float32 on both sides) and the host CSR engine
  (float64 on both sides): coefficients and history rtol 1e-5, atol 1e-7;
- the sparse device engine (float32) against the JAX package's: rtol 1e-5,
  atol 1e-7; against the host CSR engine (float64): the JAX package's own
  rtol 1e-3, atol 1e-5 (tests/test_sparse_training.py);
- model versions, history versions and stream batches exactly.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.iteration import streaming as jax_streaming
from flink_ml_tpu.linalg import sparse as jax_sparse
from flink_ml_tpu.linalg.vectors import DenseVector as JaxDenseVector
from flink_ml_tpu.linalg.vectors import SparseVector as JaxSparseVector
from flink_ml_tpu.models import online as jax_online
from flink_ml_tpu.ops import pallas_kernels as pk
from flink_ml_tpu.parallel import create_mesh, set_default_mesh
from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.benchmark import datagen, runner
from flink_ml_tpu_torch.convert import online_lr_model_from_arrays
from flink_ml_tpu_torch.iteration import (
    CheckpointManager,
    IterationConfig,
    IterationListener,
    streaming,
)
from flink_ml_tpu_torch.linalg import sparse
from flink_ml_tpu_torch.linalg.vectors import DenseVector, SparseVector
from flink_ml_tpu_torch.models import online
from flink_ml_tpu_torch.models.online import (
    OnlineLogisticRegression,
    OnlineLogisticRegressionModel,
)
from flink_ml_tpu_torch.ops import kernels
from flink_ml_tpu_torch.resilience import RetryPolicy
from flink_ml_tpu_torch.utils import io as rw

SUM_RTOL, SUM_ATOL = 1e-5, 1e-5
RTOL, ATOL = 1e-5, 1e-7
CSR_RTOL, CSR_ATOL = 1e-3, 1e-5
CONFIG = "flink_ml_tpu/benchmark/configs/onlinelogisticregression-benchmark.json"
PARAMS = dict(features_col="f", label_col="l", weight_col="w",
              global_batch_size=100, reg=0.05, elastic_net=0.4, alpha=0.2,
              beta=0.5)


@pytest.fixture
def one_device_mesh():
    import jax

    set_default_mesh(create_mesh(devices=jax.devices()[:1]))
    try:
        yield
    finally:
        set_default_mesh(None)


def _np(values):
    return (values.numpy() if isinstance(values, torch.Tensor)
            else np.asarray(values))


# -- segment_reduce_sum ---------------------------------------------------------

def _segment_case(case, rng):
    n, u = 1000, 12
    ids = rng.integers(0, u, size=n).astype(np.int32)
    vals = rng.normal(size=n).astype(np.float32)
    if case == "2-d":
        vals = rng.normal(size=(n, 3)).astype(np.float32)
    elif case == "out-of-range":
        ids[:100] = u + 3
    elif case == "minus-one":
        ids[::7] = -1
    elif case == "empty":
        ids, vals = ids[:0], vals[:0]
    elif case == "empty-2-d":
        ids, vals = ids[:0], np.zeros((0, 2), np.float32)
    elif case == "one-segment":
        u = 1
        ids = (ids % 2).astype(np.int32)  # half the rows out of range
    return vals, ids, u


@pytest.mark.parametrize("case", ["1-d", "2-d", "out-of-range", "minus-one",
                                  "empty", "empty-2-d", "one-segment"])
def test_segment_reduce_plain_matches_pallas(case):
    vals, ids, u = _segment_case(case, np.random.default_rng(7))
    want = np.asarray(pk.segment_reduce_sum(vals, ids, u, interpret=True))
    got = kernels.segment_reduce_sum(torch.from_numpy(vals),
                                     torch.from_numpy(ids), u)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=SUM_RTOL,
                               atol=SUM_ATOL)


def test_segment_reduce_plain_is_exact_per_segment():
    # integers in float32: every order of adding gives the same sums
    rng = np.random.default_rng(3)
    vals = rng.integers(-50, 50, size=(5000, 2)).astype(np.float32)
    ids = rng.integers(-3, 40, size=5000).astype(np.int32)
    want = np.zeros((37, 2))
    for v, i in zip(vals, ids):
        if 0 <= i < 37:
            want[i] += v
    got = kernels.segment_reduce_sum(torch.from_numpy(vals),
                                     torch.from_numpy(ids), 37)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_layout():
    # (ut, tiles, cg, groups): FTRL's per-row dots at 131,072 rows and its
    # (d, 2) sums at d = 100
    assert kernels._seg_layout(131_072, 1) == (4096, 32, 1, 1)
    assert kernels._seg_layout(100, 2) == (100, 1, 2, 1)
    # a hashed domain: more tiles, each one more pass over the ids
    assert kernels._seg_layout(1 << 18, 2) == (2048, 128, 2, 1)
    # past 65,535 tiles the kernel loops over them
    assert kernels._seg_layout(65_536 * 4096 + 1, 1)[1] == 65_537
    # wide values: column groups of 4,096, one segment per tile
    assert kernels._seg_layout(64, 4096) == (1, 64, 4096, 1)
    assert kernels._seg_layout(3, 9000) == (1, 3, 4096, 3)
    for u, c in [(1, 1), (5, 3), (1 << 20, 7), (7, 5000)]:
        ut, tiles, cg, groups = kernels._seg_layout(u, c)
        assert ut * cg <= kernels.SEG_TILE_FLOATS
        assert (tiles - 1) * ut < u <= tiles * ut
        assert (groups - 1) * cg < c <= groups * cg


def test_segment_chunks_cover_every_row():
    # (n, tile-groups, resident) -> chunks, rows a chunk, item slots a tile
    assert kernels._segment_chunks(1_048_576, 32, 396) == (1024, 1024, 25)
    assert kernels._segment_chunks(1_048_576, 1, 2112) == (1024, 1024, 1024)
    assert kernels._segment_chunks(2_000_000, 64, 396) == (1024, 1954, 13)
    for n, tiles, resident in [(1_048_576, 1, 396), (1_048_576, 32, 396),
                               (5, 1, 396), (3000, 64, 10),
                               (100_000, 65_537, 396), (10 ** 8, 128, 396)]:
        chunks, rows, slots = kernels._segment_chunks(n, tiles, resident)
        assert chunks * rows >= n > (chunks - 1) * rows
        assert chunks == 1 or rows >= kernels.SEG_MIN_CHUNK_ROWS
        assert chunks <= kernels.SEG_MAX_CHUNKS
        assert 1 <= slots <= chunks
        # about two waves of blocks when every chunk meets every tile
        assert slots == chunks or tiles * slots >= 2 * resident


def test_segment_reduce_checks():
    v, ids = torch.ones(6), torch.zeros(6, dtype=torch.int32)
    for bad_ids in (ids.long(), ids[:5], torch.zeros((6, 1), dtype=torch.int32)):
        with pytest.raises(ValueError, match="segment_ids"):
            kernels.segment_reduce_sum(v, bad_ids, 3)
    with pytest.raises(ValueError, match="num_segments"):
        kernels.segment_reduce_sum(v, ids, 0)
    with pytest.raises(TypeError, match="float32"):
        kernels.segment_reduce_sum(v.double(), ids, 3)


def test_cuda_tensors_take_the_segment_kernel(monkeypatch):
    calls = []

    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    def launch(values, ids, u, c, shape):
        calls.append((tuple(values.shape), u, c))
        return torch.zeros(shape)

    monkeypatch.setattr(kernels, "_is_cuda", lambda t: True)
    for name in ("segment_reduce_sum_plain", "reduce_partials_plain"):
        monkeypatch.setattr(kernels, name, no_plain)
    monkeypatch.setattr(kernels, "_launch_segment", launch)
    kernels.reset_launch_counts()
    ids = torch.zeros(8, dtype=torch.int32)
    assert tuple(kernels.segment_reduce_sum(torch.ones(8), ids, 5).shape) == (5,)
    assert tuple(kernels.segment_reduce_sum(torch.ones((8, 2)), ids,
                                            5).shape) == (5, 2)
    assert tuple(kernels.segment_reduce_sum(torch.ones((0, 2)), ids[:0],
                                            5).shape) == (5, 2)
    # a wide domain and wide values take the kernel too
    assert tuple(kernels.segment_reduce_sum(torch.ones(8), ids,
                                            1 << 20).shape) == (1 << 20,)
    assert tuple(kernels.segment_reduce_sum(torch.ones((8, 5000)), ids,
                                            5).shape) == (5, 5000)
    assert calls == [((8,), 5, 1), ((8, 2), 5, 2), ((8,), 1 << 20, 1),
                     ((8, 5000), 5, 5000)]
    # one C entry a call: every stage is the segment kernel's own
    assert kernels.launch_counts["segment_reduce_sum"] == 4
    assert kernels.launch_counts["reduce_partials"] == 0
    kernels.reset_launch_counts()


# -- FTRL fits ----------------------------------------------------------------------

def _dense_data(seed, n, d):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = (x @ rng.normal(size=d) + 0.3 * rng.normal(size=n) > 0) * 1.0
    w = rng.random(n) + 0.5
    return x, y, w


def _sparse_matrix(seed, n, d, density):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[rng.random((n, d)) >= density] = 0.0
    y = (x @ rng.normal(size=d) > 0) * 1.0
    w = rng.random(n) + 0.5
    return sp.csr_matrix(x), y, w


def _init(d, version=0):
    coeffs = np.random.default_rng(d).normal(size=d) * 0.1
    return coeffs, version


def _fit_both(port_cols, jax_cols, d, **overrides):
    params = dict(PARAMS, **overrides)
    coeffs, version = _init(d, 3)
    jax_est = jax_online.OnlineLogisticRegression(**params)
    jax_est.set_initial_model_data(JaxTable.from_columns(
        coefficient=[JaxDenseVector(coeffs)],
        modelVersion=np.asarray([version], np.int64)))
    want = jax_est.fit(JaxTable.from_columns(**jax_cols))
    est = OnlineLogisticRegression(device="cpu", **params)
    est.set_initial_model_data(Table.from_columns(
        coefficient=[DenseVector(coeffs)],
        modelVersion=np.asarray([version], np.int64)))
    got = est.fit(Table.from_columns(**port_cols))
    return est, got, jax_est, want


def _check_fit(got, want, rtol, atol):
    assert got.coefficients.dtype == np.float64
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               rtol=rtol, atol=atol)
    assert got.model_version == want.model_version
    assert [v for v, _ in got.history] == [v for v, _ in want.history]
    for (_, a), (_, b) in zip(got.history, want.history):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("batch", [100, 64])
def test_dense_fit_matches_jax(one_device_mesh, batch):
    x, y, w = _dense_data(1, 500, 9)
    cols = dict(f=x, l=y, w=w)
    est, got, jax_est, want = _fit_both(cols, cols, 9, global_batch_size=batch)
    assert jax_est.last_execution_path == "device-batches"
    assert est.last_execution_path == "torch-dense-batches"
    assert got.model_version == 3 + 500 // batch
    _check_fit(got, want, RTOL, ATOL)
    assert got.params_to_json_str() == want.params_to_json_str()


def _csr_columns(x, y, w):
    return (dict(f=sparse.CsrVectorColumn(x), l=y, w=w),
            dict(f=jax_sparse.CsrVectorColumn(x), l=y, w=w))


def test_sparse_device_engine_matches_jax(one_device_mesh, monkeypatch):
    x, y, w = _sparse_matrix(2, 600, 40, 0.5)
    port_cols, jax_cols = _csr_columns(x, y, w)
    monkeypatch.setattr(jax_online, "_ftrl_sparse_broken", False)
    monkeypatch.setenv("FLINK_ML_TPU_FTRL_SPARSE_MIN_NNZ", "1")
    monkeypatch.setattr(online, "FTRL_SPARSE_MIN_NNZ", 1)
    est, got, jax_est, want = _fit_both(port_cols, jax_cols, 40)
    assert jax_est.last_execution_path == "device-csr-batches"
    assert est.last_execution_path == "torch-csr-batches"
    _check_fit(got, want, RTOL, ATOL)


def test_host_engine_matches_jax(one_device_mesh, monkeypatch):
    x, y, w = _sparse_matrix(3, 450, 30, 0.3)
    port_cols, jax_cols = _csr_columns(x, y, w)
    monkeypatch.setenv("FLINK_ML_TPU_FTRL_SPARSE_MIN_NNZ", str(1 << 60))
    monkeypatch.setattr(online, "FTRL_SPARSE_MIN_NNZ", 1 << 60)
    est, got, jax_est, want = _fit_both(port_cols, jax_cols, 30)
    assert jax_est.last_execution_path == "host-csr-batches"
    assert est.last_execution_path == "host-csr-batches"
    _check_fit(got, want, RTOL, ATOL)


def test_sparse_device_engine_matches_host_engine(monkeypatch):
    x, y, w = _sparse_matrix(4, 800, 25, 0.4)
    port_cols, _ = _csr_columns(x, y, w)
    fits = {}
    for name, threshold in [("device", 1), ("host", 1 << 60)]:
        monkeypatch.setattr(online, "FTRL_SPARSE_MIN_NNZ", threshold)
        est = OnlineLogisticRegression(device="cpu", **PARAMS)
        est.warm_start(np.zeros(25))
        fits[name] = (est.fit(Table.from_columns(**port_cols)),
                      est.last_execution_path)
    assert fits["device"][1] == "torch-csr-batches"
    assert fits["host"][1] == "host-csr-batches"
    _check_fit(fits["device"][0], fits["host"][0], CSR_RTOL, CSR_ATOL)


def test_object_column_of_sparse_vectors_takes_the_csr_engines(monkeypatch):
    x, y, w = _sparse_matrix(5, 300, 12, 0.4)
    obj = np.empty(300, dtype=object)
    for i in range(300):
        lo, hi = x.indptr[i], x.indptr[i + 1]
        obj[i] = SparseVector(12, x.indices[lo:hi], x.data[lo:hi])
    assert sparse.is_sparse_column(obj)
    est = OnlineLogisticRegression(device="cpu", **PARAMS).warm_start(
        np.zeros(12))
    a = est.fit(Table.from_columns(f=obj, l=y, w=w))
    b = est.fit(Table.from_columns(f=sparse.CsrVectorColumn(x), l=y, w=w))
    np.testing.assert_array_equal(a.coefficients, b.coefficients)


def test_mixed_stream_matches_jax(one_device_mesh, monkeypatch):
    """Dense and sparse chunks in one stream: the state moves between the
    device and the host, and executionPath counts each engine."""
    xd, yd, _ = _dense_data(6, 200, 8)
    xs, ys, _ = _sparse_matrix(7, 300, 8, 0.5)
    monkeypatch.setattr(jax_online, "_ftrl_sparse_broken", False)
    monkeypatch.setenv("FLINK_ML_TPU_FTRL_SPARSE_MIN_NNZ", "300")
    monkeypatch.setattr(online, "FTRL_SPARSE_MIN_NNZ", 300)
    # sparse batches of 100 rows hold ~400 values: device; 50-row ones host
    params = dict(PARAMS, weight_col=None)
    del params["weight_col"]

    def chunks(table_cls, csr_cls):
        yield table_cls.from_columns(f=xd[:100], l=yd[:100])
        yield table_cls.from_columns(f=csr_cls(xs[:100]), l=ys[:100])
        yield table_cls.from_columns(f=xd[100:200], l=yd[100:200])
        yield table_cls.from_columns(f=csr_cls(xs[100:200]), l=ys[100:200])

    jax_est = jax_online.OnlineLogisticRegression(**params)
    jax_est.set_initial_model_data(JaxTable.from_columns(
        coefficient=[JaxDenseVector(np.zeros(8))]))
    want = jax_est.fit(jax_streaming.StreamTable(
        chunks(JaxTable, jax_sparse.CsrVectorColumn)))
    est = OnlineLogisticRegression(device="cpu", **params).warm_start(
        np.zeros(8))
    got = est.fit(streaming.StreamTable(chunks(Table, sparse.CsrVectorColumn)))
    assert jax_est.last_execution_path == "mixed(device=2,device-csr=2)"
    assert est.last_execution_path == "mixed(torch-dense=2,torch-csr=2)"
    _check_fit(got, want, RTOL, ATOL)

    monkeypatch.setattr(online, "FTRL_SPARSE_MIN_NNZ", 1 << 60)
    est.fit(streaming.StreamTable(chunks(Table, sparse.CsrVectorColumn)))
    assert est.last_execution_path == "mixed(torch-dense=2,host-csr=2)"


def test_fit_edges_and_knobs(tmp_path):
    est = OnlineLogisticRegression(device="cpu", features_col="f")
    with pytest.raises(ValueError, match="initial model data"):
        est.fit(Table.from_columns(f=np.zeros((4, 2)), label=np.zeros(4)))
    # a stream of no full batch leaves the seed model and names no engine
    est.warm_start(np.ones(2), model_version=7)
    model = est.fit(Table.from_columns(f=np.zeros((4, 2)), label=np.zeros(4)))
    assert est.last_execution_path is None
    assert model.model_version == 7 and model.history == []
    np.testing.assert_array_equal(model.coefficients, np.ones(2))
    with pytest.raises(ValueError, match="1-D"):
        est.warm_start(np.ones((2, 2)))
    seed = OnlineLogisticRegressionModel(coefficients=np.ones(3),
                                         model_version=4)
    est.warm_start(seed)
    assert est._initial_model_data.scalars("modelVersion", np.int64)[0] == 4
    # the retry policy is stored (the JAX package's FTRL fit stores it and
    # does not supervise the stream); a checkpointing config is stored and
    # runs (test_stream_checkpoint_resumes_to_the_same_bytes)
    policy = RetryPolicy(max_restarts=1)
    assert est.set_retry_policy(policy) is est and est._retry_policy is policy
    config = IterationConfig(
        checkpoint_interval=2,
        checkpoint_manager=CheckpointManager(str(tmp_path / "ckpt")))
    assert est.set_iteration_config(config) is est
    assert est._iteration_config is config


class _Recorder:
    def __init__(self):
        self.calls = []

    def on_epoch_watermark_incremented(self, epoch, state):
        self.calls.append(("batch", epoch, int(state[3]), len(state[4])))

    def on_iteration_terminated(self, state):
        self.calls.append(("end", int(state[3]), len(state[4])))


def test_listeners_see_what_jax_listeners_see(one_device_mesh):
    x, y, w = _dense_data(8, 300, 5)
    jax_rec, port_rec = _Recorder(), _Recorder()
    jax_est = jax_online.OnlineLogisticRegression(**PARAMS)
    jax_est.set_initial_model_data(JaxTable.from_columns(
        coefficient=[JaxDenseVector(np.zeros(5))]))
    jax_est.set_iteration_config(None, listeners=[jax_rec])
    jax_est.fit(JaxTable.from_columns(f=x, l=y, w=w))
    est = OnlineLogisticRegression(device="cpu", **PARAMS).warm_start(
        np.zeros(5))
    assert est.set_iteration_config(None, listeners=[port_rec]) is est
    est.fit(Table.from_columns(f=x, l=y, w=w))
    assert port_rec.calls == jax_rec.calls
    assert port_rec.calls[-1] == ("end", 3, 3)


def test_stream_checkpointer_is_inert_without_config():
    ckpt = streaming.StreamCheckpointer()
    ckpt.after_batch(lambda: pytest.fail("an inert checkpointer built state"))
    ckpt.complete(lambda: pytest.fail("an inert checkpointer built state"))
    assert ckpt.batches == 1


# -- transform, model data, persistence ----------------------------------------

class _Crash(Exception):
    pass


class _CrashAt(IterationListener):
    """Dies when the given batch (0-based) completes, before its save."""

    def __init__(self, at):
        self.at = at

    def on_epoch_watermark_incremented(self, epoch, state):
        if epoch == self.at:
            raise _Crash()


def _engine_stream(engine, monkeypatch, table_cls=Table, csr_cls=None):
    """``rows(lo, hi)``: a table of rows [lo, hi) of a 600-row stream of
    width 8 for one FTRL engine (the engine's nnz gate patched)."""
    if engine == "dense":
        x, y, w = _dense_data(11, 600, 8)
        return lambda lo, hi: table_cls.from_columns(f=x[lo:hi], l=y[lo:hi],
                                                     w=w[lo:hi])
    x, y, w = _sparse_matrix(12, 600, 8, 0.5)
    monkeypatch.setattr(online, "FTRL_SPARSE_MIN_NNZ",
                        1 if engine == "csr-device" else 1 << 60)
    monkeypatch.setenv("FLINK_ML_TPU_FTRL_SPARSE_MIN_NNZ", str(1 << 60))
    csr_cls = csr_cls or sparse.CsrVectorColumn
    return lambda lo, hi: table_cls.from_columns(f=csr_cls(x[lo:hi]),
                                                 l=y[lo:hi], w=w[lo:hi])


def _snapshot_layout(mgr):
    name, = mgr.list_checkpoints()
    with open(f"{mgr.base_dir}/{name}/manifest.json") as f:
        manifest = json.load(f)
    return name, [(r["dtype"], tuple(r["shape"])) for r in manifest["leaves"]]


@pytest.mark.parametrize("engine", ["dense", "csr-device", "csr-host"])
def test_stream_checkpoint_resumes_to_the_same_bytes(tmp_path, monkeypatch,
                                                      engine):
    """A stream killed after its 4th batch resumes from the snapshot of its
    2nd on the rest of the stream and ends with the uninterrupted fit's
    bytes: coefficients, version and history. Every engine snapshots the
    same host view (trimmed (d,) float64 state, version, stacked
    history)."""
    rows = _engine_stream(engine, monkeypatch)

    def estimator():
        return OnlineLogisticRegression(device="cpu", **PARAMS).warm_start(
            np.zeros(8))

    clean = estimator().fit(rows(0, 600))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    config = IterationConfig(checkpoint_interval=2, checkpoint_manager=mgr)
    with pytest.raises(_Crash):
        estimator().set_iteration_config(
            config, listeners=[_CrashAt(3)]).fit(rows(0, 600))
    assert _snapshot_layout(mgr) == ("ckpt-00000002", [
        ("float64", (8,)), ("float64", (8,)), ("float64", (8,)),
        ("int64", ()), ("int64", (2,)), ("float64", (2, 8))])
    est = estimator().set_iteration_config(config)
    resumed = est.fit(rows(200, 600))
    assert est.last_execution_path == {
        "dense": "torch-dense-batches", "csr-device": "torch-csr-batches",
        "csr-host": "host-csr-batches"}[engine]
    np.testing.assert_array_equal(resumed.coefficients, clean.coefficients)
    assert resumed.model_version == clean.model_version == 6
    assert [v for v, _ in resumed.history] == [1, 2, 3, 4, 5, 6]
    for (_, a), (_, b) in zip(resumed.history, clean.history):
        np.testing.assert_array_equal(a, b)
    assert mgr.list_checkpoints() == []  # the completed stream cleared


@pytest.mark.parametrize("engine", ["dense", "csr-host"])
def test_stream_checkpoint_restores_across_packages(one_device_mesh, tmp_path,
                                                    monkeypatch, engine):
    """A snapshot that either package wrote mid-stream restores in the
    other, with the same leaves, and the resumed fit ends within the
    tolerance of the writer's uninterrupted fit."""
    from flink_ml_tpu.iteration import checkpoint as jax_ckpt
    from flink_ml_tpu.iteration import iteration as jax_iter

    rows = _engine_stream(engine, monkeypatch)
    jax_rows = _engine_stream(engine, monkeypatch, JaxTable,
                              jax_sparse.CsrVectorColumn)

    class JaxCrashAt(jax_iter.IterationListener):
        def on_epoch_watermark_incremented(self, epoch, state):
            if epoch == 3:
                raise _Crash()

    def jax_estimator():
        est = jax_online.OnlineLogisticRegression(**PARAMS)
        return est.set_initial_model_data(JaxTable.from_columns(
            coefficient=[JaxDenseVector(np.zeros(8))]))

    def port_estimator():
        return OnlineLogisticRegression(device="cpu", **PARAMS).warm_start(
            np.zeros(8))

    layouts = {}
    for writer in ("jax", "port"):
        base = str(tmp_path / writer)
        jax_mgr, port_mgr = (jax_ckpt.CheckpointManager(base),
                             CheckpointManager(base))
        jax_cfg = jax_iter.IterationConfig(checkpoint_interval=2,
                                           checkpoint_manager=jax_mgr)
        port_cfg = IterationConfig(checkpoint_interval=2,
                                   checkpoint_manager=port_mgr)
        with pytest.raises(_Crash):
            if writer == "jax":
                jax_estimator().set_iteration_config(
                    jax_cfg, listeners=[JaxCrashAt()]).fit(jax_rows(0, 600))
            else:
                port_estimator().set_iteration_config(
                    port_cfg, listeners=[_CrashAt(3)]).fit(rows(0, 600))
        layouts[writer] = _snapshot_layout(port_mgr)
        if writer == "jax":
            want = jax_estimator().fit(jax_rows(0, 600))
            got = port_estimator().set_iteration_config(port_cfg).fit(
                rows(200, 600))
        else:
            want = port_estimator().fit(rows(0, 600))
            got = jax_estimator().set_iteration_config(jax_cfg).fit(
                jax_rows(200, 600))
        _check_fit(got, want, RTOL, ATOL)
    assert layouts["jax"] == layouts["port"]


def test_transform_matches_jax(one_device_mesh):
    x, y, w = _dense_data(9, 120, 6)
    coeffs = np.random.default_rng(1).normal(size=6)
    want_model = jax_online.OnlineLogisticRegressionModel(
        coefficients=coeffs, model_version=5, prediction_col="p")
    got_model = OnlineLogisticRegressionModel(
        coefficients=coeffs, model_version=5, prediction_col="p",
        device="cpu")
    xs = sp.csr_matrix(np.where(np.abs(x) > 0.7, x, 0.0))
    for port_f, jax_f, dense in [
            (x, x, True),
            (sparse.CsrVectorColumn(xs), jax_sparse.CsrVectorColumn(xs), False)]:
        got = got_model.transform(Table.from_columns(features=port_f))[0]
        want = want_model.transform(JaxTable.from_columns(features=jax_f))[0]
        assert set(got.column_names) == set(want.column_names)
        if dense:
            assert isinstance(got["p"], torch.Tensor)
            assert got["p"].dtype == torch.float32
        else:
            assert got["p"].dtype == np.float64
        np.testing.assert_array_equal(_np(got["p"]), _np(want["p"]))
        np.testing.assert_allclose(_np(got["rawPrediction"]),
                                   _np(want["rawPrediction"]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got["version"], np.full(120, 5))


def test_save_load_model_data_and_jax_saved_model(tmp_path, one_device_mesh):
    x, y, w = _dense_data(10, 300, 4)
    jax_est = jax_online.OnlineLogisticRegression(
        **dict(PARAMS, prediction_col="pred"))
    jax_est.set_initial_model_data(JaxTable.from_columns(
        coefficient=[JaxDenseVector(np.zeros(4))]))
    jax_model = jax_est.fit(JaxTable.from_columns(f=x, l=y, w=w))
    jax_model.save(str(tmp_path / "jax"))
    loaded = rw.load_stage(str(tmp_path / "jax"), device="cpu")
    assert type(loaded) is OnlineLogisticRegressionModel
    assert loaded.prediction_col == "pred" and loaded.model_version == 3
    np.testing.assert_array_equal(loaded.coefficients, jax_model.coefficients)
    table = Table.from_columns(f=x)
    want = jax_model.transform(JaxTable.from_columns(f=x))[0]
    got = loaded.transform(table)[0]
    np.testing.assert_array_equal(_np(got["pred"]), _np(want["pred"]))

    loaded.save(str(tmp_path / "port"))
    again = OnlineLogisticRegressionModel.load(str(tmp_path / "port"),
                                               device="cpu")
    assert again.model_version == 3
    assert torch.equal(again.transform(table)[0]["pred"], got["pred"])
    data = loaded.get_model_data()[0]
    from_data = OnlineLogisticRegressionModel(device="cpu").set_model_data(data)
    np.testing.assert_array_equal(from_data.coefficients, loaded.coefficients)
    assert from_data.model_version == 3
    jax_data = jax_model.get_model_data()[0]
    np.testing.assert_array_equal(data.vectors("coefficient", np.float64),
                                  jax_data.vectors("coefficient", np.float64))
    converted = online_lr_model_from_arrays(
        jax_model.coefficients, 3, device="cpu", features_col="f",
        prediction_col="pred")
    assert torch.equal(converted.transform(table)[0]["pred"], got["pred"])
    with pytest.raises(ValueError, match="coefficients"):
        online_lr_model_from_arrays(np.ones((2, 2)))
    with pytest.raises(ValueError, match="no model data"):
        OnlineLogisticRegressionModel(device="cpu").transform(table)


def test_transform_stream_steps_through_history_as_jax(one_device_mesh):
    x, y, w = _dense_data(11, 400, 3)
    _, got, _, want = _fit_both(dict(f=x, l=y, w=w), dict(f=x, l=y, w=w), 3)
    outs = list(got.transform_stream(
        streaming.StreamTable.from_table(Table.from_columns(f=x), 150)))
    wants = list(want.transform_stream(
        jax_streaming.StreamTable.from_table(JaxTable.from_columns(f=x), 150)))
    assert [int(o["version"][0]) for o in outs] == \
        [int(o["version"][0]) for o in wants] == [4, 5, 6]
    for o, v in zip(outs, wants):
        np.testing.assert_array_equal(_np(o["prediction"]),
                                      _np(v["prediction"]))


@pytest.mark.parametrize("delay", [0, 2000, 5000])
def test_model_delay_join_matches_jax(delay):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(40, 2))
    ts = np.arange(40, dtype=np.int64) * 100  # chunk max ts: 900 ... 3900
    models = [(0, 1, np.array([1.0, 0.0])), (2900, 2, np.array([0.0, 1.0])),
              (3500, 3, np.array([1.0, 1.0]))]

    def run(model_cls, table_cls, stream_cls, **kw):
        model = model_cls(coefficients=np.array([1.0, 0.0]), model_version=1,
                          **kw)
        model.set_max_allowed_model_delay_ms(delay)
        stream = stream_cls.from_table(table_cls.from_columns(features=x, ts=ts),
                                       10)
        return list(model.transform_stream(stream, iter(models), "ts"))

    want = run(jax_online.OnlineLogisticRegressionModel, JaxTable,
               jax_streaming.StreamTable)
    got = run(OnlineLogisticRegressionModel, Table, streaming.StreamTable,
              device="cpu")
    assert [int(o["version"][0]) for o in got] == \
        [int(o["version"][0]) for o in want]
    for o, v in zip(got, want):
        np.testing.assert_array_equal(_np(o["prediction"]),
                                      _np(v["prediction"]))
    model = OnlineLogisticRegressionModel(coefficients=np.ones(2),
                                          device="cpu")
    with pytest.raises(ValueError, match="together"):
        model.transform_stream(streaming.StreamTable([]), model_stream=[])


# -- stream plumbing, table, vectors ------------------------------------------------

@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("sizes,batch", [([7, 3, 12, 1, 9], 5),
                                         ([4, 4, 4], 4), ([2, 3], 10),
                                         ([10, 0, 6], 3)])
def test_generate_batches_matches_jax(sizes, batch, drop_remainder):
    rng = np.random.default_rng(sum(sizes))
    n = sum(sizes)
    x, y = rng.normal(size=(n, 3)), rng.normal(size=n)
    bounds = np.cumsum([0] + sizes)

    def chunks(table_cls):
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            yield table_cls.from_columns(f=x[lo:hi], l=y[lo:hi])

    got = list(streaming.generate_batches(
        streaming.StreamTable(chunks(Table)), batch, drop_remainder))
    want = list(jax_streaming.generate_batches(
        jax_streaming.StreamTable(chunks(JaxTable)), batch, drop_remainder))
    assert [t.num_rows for t in got] == [t.num_rows for t in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.vectors("f", np.float64),
                                      w.vectors("f", np.float64))
        np.testing.assert_array_equal(g.scalars("l", np.float64),
                                      w.scalars("l", np.float64))


def test_generate_batches_keeps_tensor_columns_on_their_device():
    x = torch.arange(30, dtype=torch.float32).view(10, 3)
    stream = streaming.StreamTable.from_table(
        Table.from_columns(f=x, l=np.arange(10.0)), 4)
    batches = list(streaming.generate_batches(stream, 3))
    assert [b.num_rows for b in batches] == [3, 3, 3]
    assert all(isinstance(b.column("f"), torch.Tensor) for b in batches)
    assert torch.equal(torch.cat([b.column("f") for b in batches]), x[:9])


def test_table_take_and_concat_with_csr_and_tensor_columns():
    m = sp.csr_matrix(np.asarray([[0.0, 1.0], [2.0, 0.0], [0.0, 3.0]]))
    col = sparse.CsrVectorColumn(m)
    assert col[-1] == col[2] and col[-1].values.tolist() == [3.0]
    with pytest.raises(IndexError):
        col[3]
    obj = np.empty(2, dtype=object)
    obj[0] = SparseVector(2, [0], [9.0])
    obj[1] = DenseVector(np.asarray([7.0, 8.0]))
    t_csr, t_obj = Table.from_columns(v=col), Table.from_columns(v=obj)
    both, rev = t_csr.concat(t_obj), t_obj.concat(t_csr)
    assert sparse.is_csr_column(both.column("v"))
    assert sparse.is_csr_column(rev.column("v"))
    assert both.column("v")[3].to_array().tolist() == [9.0, 0.0]
    assert rev.column("v")[4].to_array().tolist() == [0.0, 3.0]
    np.testing.assert_array_equal(both.vectors("v", np.float64)[:3],
                                  m.toarray())
    assert both.take([4, 0]).column("v")[0] == SparseVector(2, [0, 1],
                                                            [7.0, 8.0])
    assert len(both.take(slice(1, 5, 2))) == 2
    # a tensor column joined to a host column lands on the tensor's device
    t = Table.from_columns(a=torch.ones(2)).concat(
        Table.from_columns(a=np.zeros(3)))
    assert isinstance(t.column("a"), torch.Tensor) and t.num_rows == 5
    assert torch.equal(Table.from_columns(a=torch.arange(6)).take(
        np.array([5, 1])).column("a"), torch.tensor([5, 1]))
    empty = Table.from_columns(a=np.zeros(0))
    assert empty.concat(t).num_rows == 5 and t.concat(empty) is t
    with pytest.raises(ValueError, match="schemas"):
        t.concat(Table.from_columns(b=np.zeros(1)))


def test_column_to_csr_matches_jax():
    rng = np.random.default_rng(13)
    x = rng.random((30, 6))
    x[x < 0.6] = 0.0
    port_col = np.empty(30, dtype=object)
    jax_col = np.empty(30, dtype=object)
    for i, row in enumerate(x):
        idx = np.flatnonzero(row)
        if i % 5 == 0:
            port_col[i] = DenseVector(row)
            jax_col[i] = JaxDenseVector(row)
        else:
            port_col[i] = SparseVector(6, idx, row[idx])
            jax_col[i] = JaxSparseVector(6, idx, row[idx])
    got = sparse.column_to_csr(port_col)
    want = jax_sparse.column_to_csr(jax_col)
    assert (got != want).nnz == 0 and got.shape == want.shape
    back = sparse.csr_to_column(got)
    assert all(isinstance(v, SparseVector) for v in back)
    np.testing.assert_array_equal(np.stack([v.to_array() for v in back]), x)
    with pytest.raises(ValueError, match="ragged"):
        sparse.column_to_csr(np.array([SparseVector(3, [0], [1.0]),
                                       SparseVector(4, [0], [1.0])]))
    assert not sparse.is_sparse_column(np.array([DenseVector([1.0])]))
    assert sparse.is_csr(sparse.features_matrix(
        Table.from_columns(f=port_col), "f"))


def test_sparse_vector_matches_jax():
    v = SparseVector(6, [4, 1, 3], [0.5, -1.0, 2.0])
    j = JaxSparseVector(6, [4, 1, 3], [0.5, -1.0, 2.0])
    np.testing.assert_array_equal(v.indices, j.indices)
    np.testing.assert_array_equal(v.to_array(), j.to_array())
    assert v.get(3) == j.get(3) == 2.0 and v.get(0) == 0.0
    assert repr(v) == repr(j) and v.size == 6 and v.to_sparse() is v
    assert v == SparseVector(6, [1, 3, 4], [-1.0, 2.0, 0.5])
    assert hash(v) == hash(SparseVector(6, [1, 3, 4], [-1.0, 2.0, 0.5]))
    for bad in (([0, 0], [1.0, 2.0]), ([6], [1.0]), ([0], [1.0, 2.0])):
        with pytest.raises(ValueError):
            SparseVector(6, *bad)


# -- benchmark ------------------------------------------------------------------------

def test_model_data_generator_matches_jax():
    from flink_ml_tpu.benchmark import datagen as jax_datagen

    want = jax_datagen.LogisticRegressionModelDataGenerator()
    want.params_from_json({"vectorDim": 5}, strict=True)
    got = datagen.LogisticRegressionModelDataGenerator(device="cpu")
    got.params_from_json({"vectorDim": 5}, strict=True)
    w, g = want.get_data(), got.get_data()
    np.testing.assert_array_equal(g.vectors("coefficient", np.float64),
                                  w.vectors("coefficient", np.float64))
    np.testing.assert_array_equal(g.scalars("modelVersion", np.int64), [0])


def test_runner_on_a_shrunken_ftrl_config(one_device_mesh):
    spec = runner.load_config(CONFIG)["OnlineLogisticRegression"]
    spec["inputData"]["paramMap"]["numValues"] = 2000
    spec["inputData"]["paramMap"]["vectorDim"] = 10
    spec["modelData"]["paramMap"]["vectorDim"] = 10
    spec["stage"]["paramMap"]["globalBatchSize"] = 400
    row = runner.run_benchmark("OnlineLogisticRegression", spec, device="cpu")
    assert row["executionPath"] == "torch-dense-batches"
    assert row["inputRecordNum"] == 2000 and row["outputRecordNum"] == 1
    # the generated table (2000 x 10 + label + weight, float64) and the
    # model data (one 10-wide coefficient vector, one version)
    assert row["inputBytes"] == 2000 * 12 * 8 + 10 * 8 + 8
    # the fit on the generated tables matches the JAX package's
    table = runner.build_generator(spec, "cpu").get_data()
    est = runner.build_stage(spec, "cpu").set_initial_model_data(
        runner.build_generator(spec, "cpu", "modelData").get_data())
    got = est.fit(table)
    jax_est = jax_online.OnlineLogisticRegression()
    jax_est.params_from_json(spec["stage"]["paramMap"], strict=True)
    jax_est.set_initial_model_data(JaxTable.from_columns(
        coefficient=[JaxDenseVector(np.zeros(10))]))
    want = jax_est.fit(JaxTable.from_columns(
        **{n: table.column(n) for n in table.column_names}))
    _check_fit(got, want, RTOL, ATOL)
    assert got.model_version == 5


# -- OnlineKMeans -----------------------------------------------------------------
#
# Tolerances: the port's batch partials are float32 sums (the Lloyd kernel's
# plain version here) where the JAX package sums float64, and its state is
# float64 as the JAX package's is: centroids and weights rtol 1e-5, atol
# 1e-6. The seeded clusters are well separated, so both assign every row
# alike. Resumed and rerun port fits equal the uninterrupted one exactly.

KM_RTOL, KM_ATOL = 1e-5, 1e-6


def _clusters(seed, n, d, k, spread=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * spread
    x = centers[rng.integers(0, k, n)] + rng.normal(size=(n, d))
    return x, centers + rng.normal(size=(k, d))


def _kmeans_both(x, init_c, init_w, stream_chunk=None, **params):
    from flink_ml_tpu.models.clustering import KMeansModel as JaxKMeansModel

    from flink_ml_tpu_torch.models.clustering import KMeansModel

    jax_est = jax_online.OnlineKMeans(**params).set_initial_model_data(
        JaxKMeansModel(centroids=init_c, weights=init_w).get_model_data()[0])
    est = online.OnlineKMeans(device="cpu", **params).set_initial_model_data(
        KMeansModel(centroids=init_c, weights=init_w).get_model_data()[0])
    if stream_chunk is None:
        want = jax_est.fit(JaxTable.from_columns(features=x))
        got = est.fit(Table.from_columns(features=x))
    else:
        want = jax_est.fit(jax_streaming.StreamTable.from_table(
            JaxTable.from_columns(features=x), stream_chunk))
        got = est.fit(streaming.StreamTable.from_table(
            Table.from_columns(features=x), stream_chunk))
    return est, got, want


@pytest.mark.parametrize("case", ["drift", "three-clusters", "ragged-stream",
                                  "decay-one"])
def test_online_kmeans_matches_jax(case):
    if case == "drift":
        # the stream sits at +10: one centroid follows it, the other keeps
        # its position with a decayed weight
        x = np.random.default_rng(0).normal(size=(1000, 2)) + 10.0
        init_c, init_w = np.array([[0.0, 0.0], [1.0, 1.0]]), np.ones(2)
        params = dict(global_batch_size=100, decay_factor=0.5, k=2)
    else:
        x, init_c = _clusters(1, 1200, 6, 3)
        init_w = np.array([1.0, 2.0, 3.0])
        params = dict(global_batch_size=150, decay_factor=0.3, k=3)
        if case == "decay-one":
            params["decay_factor"] = 1.0
    est, got, want = _kmeans_both(
        x, init_c, init_w, stream_chunk=70 if case == "ragged-stream"
        else None, **params)
    assert est.last_execution_path == "torch-lloyd-stream"
    assert isinstance(got, online.OnlineKMeansModel)
    assert got.centroids.dtype == np.float64 and got.weights.dtype == np.float64
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=KM_RTOL,
                               atol=KM_ATOL)
    np.testing.assert_allclose(got.weights, want.weights, rtol=KM_RTOL,
                               atol=KM_ATOL)
    assert got.params_to_json_str() == want.params_to_json_str()
    if case == "drift":
        assert np.linalg.norm(got.centroids - 10.0, axis=1).min() < 0.5
        assert got.weights.max() > 100 and got.weights.min() < 1


def test_online_kmeans_decay_zero_forgets_history():
    x = np.concatenate([np.full((50, 1), 5.0), np.full((50, 1), -5.0)])
    est, got, want = _kmeans_both(
        x, np.array([[100.0], [-100.0]]), np.array([1e9, 1e9]),
        global_batch_size=100, decay_factor=0.0, k=2)
    np.testing.assert_array_equal(sorted(got.centroids.ravel()), [-5.0, 5.0])
    np.testing.assert_array_equal(got.centroids, want.centroids)


@pytest.mark.parametrize("measure", ["manhattan", "cosine"])
def test_online_kmeans_other_measures_take_plain_partials(measure):
    x, init_c = _clusters(2, 600, 4, 3)
    x += 20.0  # cosine needs directions that differ; keep them apart
    init_c = x[:3].copy()
    est, got, want = _kmeans_both(x, init_c, np.zeros(3),
                                  global_batch_size=200, decay_factor=0.5,
                                  k=3, distance_measure=measure)
    assert est.last_execution_path == "torch-lloyd-stream"
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=KM_RTOL,
                               atol=KM_ATOL)


def test_online_kmeans_state_stays_on_the_device_until_the_end(monkeypatch):
    """One Lloyd partials call a batch, on the batch's float32 rows and the
    float32 view of the float64 state; the state is fetched once."""
    x, init_c = _clusters(3, 500, 5, 4)
    calls = []
    real = kernels.lloyd_partial_sums

    def spy(xb, v, c):
        calls.append((tuple(xb.shape), xb.dtype, c.dtype, float(v.sum())))
        return real(xb, v, c)

    monkeypatch.setattr(kernels, "lloyd_partial_sums", spy)
    from flink_ml_tpu_torch.models.clustering import KMeansModel

    est = online.OnlineKMeans(global_batch_size=100, decay_factor=0.2, k=4,
                              device="cpu").set_initial_model_data(
        KMeansModel(centroids=init_c, weights=np.ones(4)).get_model_data()[0])
    tensor_x = torch.from_numpy(x.astype(np.float32))
    got = est.fit(Table.from_columns(features=tensor_x))
    assert calls == [((100, 5), torch.float32, torch.float32, 100.0)] * 5
    again = est.fit(Table.from_columns(features=tensor_x))
    np.testing.assert_array_equal(again.centroids, got.centroids)
    np.testing.assert_array_equal(again.weights, got.weights)


def test_online_kmeans_requires_initial_model():
    with pytest.raises(ValueError, match="initial model"):
        online.OnlineKMeans(device="cpu").fit(
            Table.from_columns(features=np.zeros((4, 2))))


def test_online_kmeans_checkpoint_resume(tmp_path):
    """Crash after two batches, rerun the stream's tail: the resumed fit
    continues from the checkpointed float64 (centroids, weights) and equals
    the uninterrupted fit bit for bit; the JAX package's snapshot of the
    same state restores in the port."""
    x, _ = _clusters(4, 400, 3, 2)
    init = x[:2].copy()
    from flink_ml_tpu_torch.models.clustering import KMeansModel

    def est():
        return online.OnlineKMeans(
            global_batch_size=100, decay_factor=1.0, seed=0, device="cpu"
        ).set_initial_model_data(
            KMeansModel(centroids=init, weights=np.zeros(2)).get_model_data()[0])

    t = Table.from_columns(features=x)
    expected = est().fit(streaming.StreamTable.from_table(t, 100))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    cfg = IterationConfig(mode="host", checkpoint_interval=1,
                          checkpoint_manager=mgr)
    with pytest.raises(_Crash):
        est().set_iteration_config(cfg, listeners=[_CrashAt(1)]).fit(
            streaming.StreamTable.from_table(t, 100))
    resumed = est().set_iteration_config(cfg).fit(
        streaming.StreamTable.from_table(t.take(slice(100, 400)), 100))
    np.testing.assert_array_equal(resumed.centroids, expected.centroids)
    np.testing.assert_array_equal(resumed.weights, expected.weights)
    assert not mgr.list_checkpoints()

    # the JAX package's checkpoint of the first batch resumes in the port
    from flink_ml_tpu.iteration import CheckpointManager as JaxManager
    from flink_ml_tpu.iteration import IterationConfig as JaxConfig
    from flink_ml_tpu.models.clustering import KMeansModel as JaxKMeansModel

    jmgr = JaxManager(str(tmp_path / "jck"))
    jcfg = JaxConfig(mode="host", checkpoint_interval=1,
                     checkpoint_manager=jmgr)

    class _Die:
        def on_epoch_watermark_incremented(self, batch_idx, state):
            if batch_idx == 1:
                raise _Crash()

        def on_iteration_terminated(self, state):
            pass

    jax_est = jax_online.OnlineKMeans(
        global_batch_size=100, decay_factor=1.0, seed=0
    ).set_initial_model_data(
        JaxKMeansModel(centroids=init, weights=np.zeros(2)).get_model_data()[0])
    with pytest.raises(_Crash):
        jax_est.set_iteration_config(jcfg, listeners=[_Die()]).fit(
            jax_streaming.StreamTable.from_table(
                JaxTable.from_columns(features=x), 100))
    cross = est().set_iteration_config(IterationConfig(
        mode="host", checkpoint_interval=1,
        checkpoint_manager=CheckpointManager(str(tmp_path / "jck")))).fit(
        streaming.StreamTable.from_table(t.take(slice(100, 400)), 100))
    np.testing.assert_allclose(cross.centroids, expected.centroids,
                               rtol=KM_RTOL, atol=KM_ATOL)


def test_online_kmeans_model_transform_save_load(tmp_path):
    from flink_ml_tpu_torch.convert import online_kmeans_model_from_arrays

    x, init_c = _clusters(5, 300, 4, 3)
    _, got, want = _kmeans_both(x, init_c, np.ones(3),
                                global_batch_size=100, decay_factor=0.5, k=3)
    pred = got.transform(Table.from_columns(features=x))[0]["prediction"]
    want_pred = want.transform(JaxTable.from_columns(features=x))[0][
        "prediction"]
    np.testing.assert_array_equal(_np(pred), np.asarray(want_pred))
    # a JAX-saved OnlineKMeansModel loads in the port
    want.save(str(tmp_path / "jax"))
    loaded = rw.load_stage(str(tmp_path / "jax"), device="cpu")
    assert type(loaded) is online.OnlineKMeansModel
    np.testing.assert_array_equal(loaded.centroids, want.centroids)
    got.save(str(tmp_path / "port"))
    again = online.OnlineKMeansModel.load(str(tmp_path / "port"),
                                          device="cpu")
    np.testing.assert_array_equal(again.centroids, got.centroids)
    made = online_kmeans_model_from_arrays(want.centroids, want.weights,
                                           device="cpu", k=3)
    np.testing.assert_array_equal(_np(made.transform(Table.from_columns(
        features=x))[0]["prediction"]), np.asarray(want_pred))


# -- OnlineStandardScaler ---------------------------------------------------------
#
# Tolerances: a host column sums in float64 numpy as the JAX package does,
# so means, stds and history equal its bits; a tensor column sums in
# float64 where it lives, in another order: rtol 1e-12. The transform's
# float32 output against the JAX package's float64: rtol 1e-6, atol 1e-7.
# Versions, window assignment and timestamps exactly.

SCALER_RTOL = 1e-12


def _scaler_both(x, windows=None, chunk=None, fit_kwargs=None, cols=None,
                 tensor=False, **params):
    from flink_ml_tpu.common import window as jax_window

    from flink_ml_tpu_torch.common import window

    cols = dict(cols or {})
    jax_est = jax_online.OnlineStandardScaler(**params)
    est = online.OnlineStandardScaler(device="cpu", **params)
    if windows is not None:
        jax_est.set_windows(jax_window.Windows.from_json(windows.to_json()))
        est.set_windows(windows)
    jt = JaxTable.from_columns(input=x, **cols)
    pt = Table.from_columns(
        input=torch.from_numpy(x.astype(np.float32)) if tensor else x, **cols)
    if tensor:
        jt = JaxTable.from_columns(input=x.astype(np.float32).astype(
            np.float64), **cols)
    if chunk is not None:
        jt = jax_streaming.StreamTable.from_table(jt, chunk)
        pt = streaming.StreamTable.from_table(pt, chunk)
    want = jax_est.fit(jt, **(fit_kwargs or {}))
    got = est.fit(pt, **(fit_kwargs or {}))
    return got, want


def _check_scaler(got, want, rtol=0.0, timed=False):
    """Versions, statistics and history; with ``timed`` (time windows) the
    window-end timestamps too (other windows stamp the wall clock)."""
    assert got.model_version == want.model_version
    if timed:
        assert got.timestamp == want.timestamp
        assert got.history_timestamps == want.history_timestamps
    np.testing.assert_allclose(got.mean, want.mean, rtol=rtol, atol=0)
    np.testing.assert_allclose(got.std, want.std, rtol=rtol, atol=0)
    assert [v for v, _, _ in got.history] == [v for v, _, _ in want.history]
    for (_, gm, gs), (_, wm, ws) in zip(got.history, want.history):
        np.testing.assert_allclose(gm, wm, rtol=rtol, atol=0)
        np.testing.assert_allclose(gs, ws, rtol=rtol, atol=0)


@pytest.mark.parametrize("tensor", [False, True])
def test_online_scaler_count_windows_match_jax(tensor):
    from flink_ml_tpu_torch.common.window import CountTumblingWindows

    x = np.random.default_rng(0).normal(size=(1000, 3)) * [1, 5, 10] + \
        [0, 2, -4]
    got, want = _scaler_both(x, CountTumblingWindows.of(250), tensor=tensor,
                             with_mean=True)
    assert got.model_version == 3 and len(got.history) == 4
    _check_scaler(got, want, SCALER_RTOL if tensor else 0.0)
    out = got.transform(Table.from_columns(input=x))[0]
    jout = want.transform(JaxTable.from_columns(input=x))[0]
    assert out["output"].dtype == torch.float32
    np.testing.assert_allclose(_np(out["output"]), jout["output"], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(out["version"], jout["version"])


def test_online_scaler_sums_are_float64_where_the_column_lives():
    """The cancellation case: |mean| ≫ std in a float32 tensor column. The
    float64 sums of the exact squares keep the std to float64 accuracy of
    the float32 values themselves."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(20_000, 4)) + 1e3).astype(np.float32)
    from flink_ml_tpu_torch.common.window import CountTumblingWindows

    model = online.OnlineStandardScaler(
        windows=CountTumblingWindows.of(5000), device="cpu").fit(
        Table.from_columns(input=torch.from_numpy(x)))
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(model.mean, x64.mean(0), rtol=1e-12)
    np.testing.assert_allclose(model.std, x64.std(0, ddof=1), rtol=1e-6)
    assert len(model.history) == 4


def test_online_scaler_event_time_windows_match_jax():
    from flink_ml_tpu_torch.common.window import EventTimeTumblingWindows

    x = np.random.default_rng(2).normal(size=(60, 2)) * 3 + 2
    ts = np.arange(60, dtype=np.int64) * 100
    got, want = _scaler_both(x, EventTimeTumblingWindows.of(1000), chunk=25,
                             cols=dict(ts=ts),
                             fit_kwargs=dict(timestamp_col="ts"),
                             input_col="input", output_col="o")
    assert got.history_timestamps == want.history_timestamps == \
        [1000, 2000, 3000, 4000, 5000, 6000]
    assert got.timestamp == 6000
    _check_scaler(got, want, timed=True)
    with pytest.raises(ValueError, match="timestamp_col"):
        online.OnlineStandardScaler(device="cpu").set_windows(
            EventTimeTumblingWindows.of(1000)).fit(
            streaming.StreamTable.from_table(
                Table.from_columns(input=x, ts=ts), 25))


def test_online_scaler_session_windows_match_jax():
    from flink_ml_tpu_torch.common.window import EventTimeSessionWindows

    x = np.random.default_rng(3).normal(size=(60, 2)) * 3 + 2
    ts = np.concatenate([np.arange(20, dtype=np.int64) * 10,
                         5000 + np.arange(20, dtype=np.int64) * 10,
                         9000 + np.arange(20, dtype=np.int64) * 10])
    got, want = _scaler_both(x, EventTimeSessionWindows.with_gap(1000),
                             chunk=7, cols=dict(ts=ts),
                             fit_kwargs=dict(timestamp_col="ts"))
    assert got.history_timestamps == [1190, 6190, 10190]
    _check_scaler(got, want, timed=True)


def test_online_scaler_tensor_event_time_windows():
    """A tensor stream is split on its device; only the timestamps come to
    the host."""
    from flink_ml_tpu_torch.common.window import EventTimeTumblingWindows

    x = np.random.default_rng(4).normal(size=(90, 3))
    ts = np.arange(90, dtype=np.int64) * 37
    got, want = _scaler_both(x, EventTimeTumblingWindows.of(500), chunk=20,
                             cols=dict(ts=ts), tensor=True,
                             fit_kwargs=dict(timestamp_col="ts"))
    _check_scaler(got, want, SCALER_RTOL, timed=True)


def test_online_scaler_count_windows_rechunk_stream():
    from flink_ml_tpu_torch.common.window import CountTumblingWindows

    x = np.random.default_rng(5).normal(size=(230, 2))
    got, want = _scaler_both(x, CountTumblingWindows.of(100), chunk=25)
    assert len(got.history) == 3  # the last window holds 30 rows
    _check_scaler(got, want)


def test_online_scaler_global_windows_chunks_match_jax():
    x = np.random.default_rng(6).normal(size=(400, 3)) * 2 + 1
    got, want = _scaler_both(x, chunk=100)
    assert got.model_version == want.model_version == 3
    _check_scaler(got, want)
    got, want = _scaler_both(x, fit_kwargs=dict(batch_size=150))
    assert len(got.history) == 3
    _check_scaler(got, want)


def test_online_scaler_processing_time_windows(monkeypatch):
    import time as time_mod

    from flink_ml_tpu_torch.common.window import ProcessingTimeTumblingWindows

    x = np.random.default_rng(7).normal(size=(50, 2))
    arrivals = iter([0.0, 0.5, 1.2, 1.4, 3.1])  # seconds
    monkeypatch.setattr(time_mod, "time", lambda: next(arrivals, 10.0))
    model = online.OnlineStandardScaler(device="cpu").set_windows(
        ProcessingTimeTumblingWindows.of(1000)).fit(
        streaming.StreamTable.from_table(Table.from_columns(input=x), 10))
    # windows [0, 1 s) holds two chunks, [1, 2 s) two, [3, 4 s) one
    assert model.history_timestamps == [1000, 2000, 4000]
    np.testing.assert_allclose(model.mean, x.mean(0), rtol=1e-12)


def test_online_scaler_checkpoint_resume(tmp_path):
    x = np.random.default_rng(8).normal(size=(400, 3)) * 2 + 1
    t = Table.from_columns(input=x)

    def est():
        return online.OnlineStandardScaler(input_col="input", output_col="o",
                                           device="cpu")

    expected = est().fit(streaming.StreamTable.from_table(t, 100))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    cfg = IterationConfig(mode="host", checkpoint_interval=1,
                          checkpoint_manager=mgr)
    with pytest.raises(_Crash):
        est().set_iteration_config(cfg, listeners=[_CrashAt(1)]).fit(
            streaming.StreamTable.from_table(t, 100))
    resumed = est().set_iteration_config(cfg).fit(
        streaming.StreamTable.from_table(t.take(slice(100, 400)), 100))
    np.testing.assert_array_equal(resumed.mean, expected.mean)
    np.testing.assert_array_equal(resumed.std, expected.std)
    assert resumed.model_version == expected.model_version
    assert [v for v, _, _ in resumed.history] == [0, 1, 2, 3]


def test_online_scaler_save_load_and_jax_models(tmp_path):
    from flink_ml_tpu.common import window as jax_window

    from flink_ml_tpu_torch.common.metrics import metrics
    from flink_ml_tpu_torch.common.window import CountTumblingWindows
    from flink_ml_tpu_torch.convert import (
        online_standard_scaler_model_from_arrays,
    )

    x = np.random.default_rng(9).normal(size=(100, 2))
    got, want = _scaler_both(x, with_mean=True, model_version_col="v")
    got.save(str(tmp_path / "port"))
    again = online.OnlineStandardScalerModel.load(str(tmp_path / "port"),
                                                  device="cpu")
    np.testing.assert_array_equal(again.mean, got.mean)
    assert again.model_version == got.model_version and again._with_mean
    # a JAX-saved model, and a JAX-saved estimator with a windows param
    want.save(str(tmp_path / "jax"))
    loaded = rw.load_stage(str(tmp_path / "jax"), device="cpu")
    assert type(loaded) is online.OnlineStandardScalerModel
    np.testing.assert_array_equal(loaded.std, want.std)
    jest = jax_online.OnlineStandardScaler(
        windows=jax_window.CountTumblingWindows.of(7))
    jest.save(str(tmp_path / "jest"))
    pest = rw.load_stage(str(tmp_path / "jest"), device="cpu")
    assert pest.windows == CountTumblingWindows.of(7)
    assert pest.params_to_json_str() == jest.params_to_json_str()
    # model data in, gauges out (OnlineStandardScalerModel.java:202-210)
    data = want.get_model_data()[0]
    port_data = Table.from_columns(
        **{n: data.column(n) for n in data.column_names})
    model = online.OnlineStandardScalerModel(device="cpu").set_model_data(
        port_data)
    assert metrics.model_group().get_gauge("version") == want.model_version
    assert metrics.model_group().get_gauge("timestamp") == want.timestamp
    np.testing.assert_array_equal(model.mean, want.mean)
    made = online_standard_scaler_model_from_arrays(
        want.mean, want.std, want.model_version, with_mean=True,
        device="cpu", model_version_col="v")
    out = made.transform(Table.from_columns(input=x))[0]
    jout = want.transform(JaxTable.from_columns(input=x))[0]
    np.testing.assert_allclose(_np(out["output"]), jout["output"], rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(out["v"], jout["v"])


def test_online_scaler_empty_stream_raises():
    with pytest.raises(ValueError, match="empty"):
        online.OnlineStandardScaler(device="cpu").fit(
            streaming.StreamTable([]))


# -- window_stream, iterate_unbounded ----------------------------------------------

def _windows_both(name, *args):
    from flink_ml_tpu.common import window as jax_window

    from flink_ml_tpu_torch.common import window

    return getattr(window, name)(*args), getattr(jax_window, name)(*args)


def _window_rows(wins, with_end):
    if with_end:
        return [(end, _np(w.column("v")).tolist()) for end, w in wins]
    return [_np(w.column("v")).tolist() for w in wins]


@pytest.mark.parametrize("tensor", [False, True])
@pytest.mark.parametrize("chunk", [1, 2, 3, 7])
@pytest.mark.parametrize("spec", [("EventTimeTumblingWindows", 1000),
                                  ("EventTimeSessionWindows", 500)])
def test_window_stream_event_time_matches_jax(spec, chunk, tensor):
    """Tumbling and session windows over the same rows in chunks of any
    size: the same rows in the same windows, the same window ends."""
    port_w, jax_w = _windows_both(*spec)
    ts = np.array([0, 100, 400, 450, 1500, 1600, 3000, 3100], np.int64)
    v = np.arange(8.0)
    pt = Table.from_columns(v=torch.from_numpy(v) if tensor else v,
                            ts=torch.from_numpy(ts) if tensor else ts)
    got = list(streaming.window_stream(
        streaming.StreamTable.from_table(pt, chunk), port_w, "ts",
        with_end_ts=True))
    want = list(jax_streaming.window_stream(
        jax_streaming.StreamTable.from_table(
            JaxTable.from_columns(v=v, ts=ts), chunk), jax_w, "ts",
        with_end_ts=True))
    assert _window_rows(got, True) == _window_rows(want, True)
    if tensor:
        assert all(isinstance(w.column("v"), torch.Tensor) for _, w in got)
    with pytest.raises(ValueError, match="timestamp_col"):
        list(streaming.window_stream(streaming.StreamTable.from_table(pt, 3),
                                     port_w))


def test_window_stream_out_of_order_rows_match_jax():
    port_w, jax_w = _windows_both("EventTimeTumblingWindows", 1000)
    ts = np.array([0, 1200, 300, 1300, 2500, 100], np.int64)
    v = np.arange(6.0)
    got = list(streaming.window_stream(streaming.StreamTable.from_table(
        Table.from_columns(v=v, ts=ts), 3), port_w, "ts"))
    want = list(jax_streaming.window_stream(
        jax_streaming.StreamTable.from_table(JaxTable.from_columns(v=v, ts=ts),
                                             3), jax_w, "ts"))
    assert _window_rows(got, False) == _window_rows(want, False)


@pytest.mark.parametrize("session", [False, True])
def test_window_stream_processing_time_matches_jax(monkeypatch, session):
    import time as time_mod

    port_w, jax_w = _windows_both(
        "ProcessingTimeSessionWindows" if session
        else "ProcessingTimeTumblingWindows", 1000)
    v = np.arange(10.0)
    out = []
    for mod, table_cls, w in ((streaming, Table, port_w),
                              (jax_streaming, JaxTable, jax_w)):
        arrivals = iter([0.0, 0.1, 5.0, 5.2, 20.0])  # seconds
        monkeypatch.setattr(time_mod, "time", lambda: next(arrivals))
        out.append(_window_rows(list(mod.window_stream(
            mod.StreamTable.from_table(table_cls.from_columns(v=v), 2), w,
            with_end_ts=True)), True))
    assert out[0] == out[1]
    if session:
        assert [rows for _, rows in out[0]] == \
            [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


def test_window_stream_refuses_count_windows():
    from flink_ml_tpu_torch.common.window import CountTumblingWindows

    with pytest.raises(ValueError, match="tumbling and session"):
        list(streaming.window_stream(streaming.StreamTable([]),
                                     CountTumblingWindows.of(3)))


def test_windows_json_matches_jax():
    from flink_ml_tpu_torch.common import window

    specs = [("GlobalWindows",), ("CountTumblingWindows", 5),
             ("EventTimeTumblingWindows", 10),
             ("ProcessingTimeTumblingWindows", 20),
             ("EventTimeSessionWindows", 30),
             ("ProcessingTimeSessionWindows", 40)]
    for spec in specs:
        got, want = _windows_both(*spec)
        assert got.to_json() == want.to_json()
        assert window.Windows.from_json(want.to_json()) == got
    est = online.OnlineStandardScaler(device="cpu")
    assert est.windows == window.GlobalWindows.get_instance()
    jest = jax_online.OnlineStandardScaler()
    assert est.params_to_json_str() == jest.params_to_json_str()
    est.params_from_json({"windows": {"kind": "event_time_session",
                                      "gap_ms": 7}})
    assert est.windows == window.EventTimeSessionWindows.with_gap(7)


def test_iterate_unbounded_checkpointer(tmp_path):
    """The JAX package's case: resume restores (model, version) with native
    Python types; completion clears the checkpoints."""
    from flink_ml_tpu_torch.iteration import Iterations

    mgr = CheckpointManager(str(tmp_path / "ck"))
    cfg = IterationConfig(mode="host", checkpoint_interval=1,
                          checkpoint_manager=mgr)

    def step(model, batch):
        return model + batch

    out = list(streaming.iterate_unbounded(
        0.0, [1.0, 2.0], step, checkpointer=streaming.StreamCheckpointer(cfg)))
    assert out[-1] == (3.0, 2)
    assert not mgr.list_checkpoints()
    gen = streaming.iterate_unbounded(
        0.0, [1.0, 2.0, 4.0], step,
        checkpointer=streaming.StreamCheckpointer(cfg))
    assert next(gen) == (1.0, 1) and next(gen) == (3.0, 2)
    del gen  # abandoned mid-stream: the checkpoints survive
    assert mgr.list_checkpoints()
    (model, ver), = list(Iterations.iterate_unbounded_streams(
        0.0, [4.0], step, checkpointer=streaming.StreamCheckpointer(cfg)))
    assert (model, ver) == (7.0, 3) and type(ver) is int
    seen = []
    assert list(streaming.iterate_unbounded(
        1, [2, 3], step, on_model=lambda m, v: seen.append((m, v)),
        initial_version=5)) == [(3, 6), (6, 7)]
    assert seen == [(3, 6), (6, 7)]
