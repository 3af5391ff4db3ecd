"""The port's N-D meshes against the JAX package: the mesh axes, tensor
parallelism over a ``model`` axis, the hybrid ``(dcn, data)`` mesh with the
two-level reduce, the ``shard_map`` seam and the tensor-parallel example.

The JAX side runs on the 8-device CPU mesh of ``tests/conftest.py``; the
port's shards are virtual shards on the CPU. Tolerances: a tensor-parallel
fit differs from the JAX package's and from the port's own 1-D fit by the
float32 reduce order only (rtol 1e-5); a flat sum over a hybrid mesh is the
1-D sum over as many shards bit for bit; the two-level sum is the flat one
up to reassociation (rtol 1e-5, atol 1e-6, the JAX package's pin).
"""

import os

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from flink_ml_tpu.ops.losses import BinaryLogisticLoss as JaxLogistic
from flink_ml_tpu.ops.optimizer import SGD as JaxSGD, SGDParams as JaxParams
from flink_ml_tpu.parallel import mapreduce as jax_mr
from flink_ml_tpu.parallel import mesh as jax_mesh

from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.common.metrics import metrics
from flink_ml_tpu_torch.models.classification import LogisticRegression
from flink_ml_tpu_torch.models.clustering import KMeans
from flink_ml_tpu_torch.ops import kernels
from flink_ml_tpu_torch.ops.losses import BinaryLogisticLoss
from flink_ml_tpu_torch.ops.optimizer import SGD, SGDParams
from flink_ml_tpu_torch.parallel import collective as C
from flink_ml_tpu_torch.parallel import mapreduce as mr
from flink_ml_tpu_torch.parallel import mesh as M
from flink_ml_tpu_torch.parallel.shardmap import P as PortP
from flink_ml_tpu_torch.parallel.shardmap import axis_size, shard_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def cpu(n):
    return ["cpu"] * n


@pytest.fixture
def hier(monkeypatch):
    def set_mode(mode):
        monkeypatch.setenv(C.HIER_ENV, mode)
    return set_mode


@pytest.fixture(autouse=True)
def _no_default_mesh():
    M.set_default_mesh(None)
    yield
    M.set_default_mesh(None)


# -- the mesh axes ------------------------------------------------------------

@pytest.mark.parametrize("shape,axes", [
    ((8,), ("data",)), ((4, 2), ("data", "model")),
    ((2, 4), ("dcn", "data")), ((8,), ("seq",)),
    ((1, 8), ("data", "model"))])
def test_mesh_axes_match_jax(shape, axes):
    want = jax_mesh.create_mesh(shape, axes)
    got = M.create_mesh(shape, axes, devices=cpu(8))
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert M.model_axis_of(got) == jax_mesh.model_axis_of(want)
    if "data" in axes:
        assert M.data_axes(got) == jax_mesh.data_axes(want)
        assert M.data_shard_count(got) == jax_mesh.data_shard_count(want)
        assert M.data_pspec(got) == jax_mesh.data_pspec(want)
        assert got.size == jax_mesh.data_shard_count(want)
    else:
        with pytest.raises(ValueError, match="data-parallel"):
            M.data_axes(got)
        with pytest.raises(ValueError, match="data-parallel"):
            jax_mesh.data_axes(want)


def test_hybrid_mesh_matches_jax():
    want = jax_mesh.create_hybrid_mesh(ici_shape=(4,), dcn_shape=(2,))
    got = M.create_hybrid_mesh(ici_shape=(4,), dcn_shape=(2,),
                               devices=cpu(8))
    assert got.shape == dict(want.shape) == {"dcn": 2, "data": 4}
    assert M.data_axes(got) == jax_mesh.data_axes(want) == ("dcn", "data")
    assert M.data_pspec(got) == jax_mesh.data_pspec(want)
    # the defaults: ici from the device count over dcn
    assert M.create_hybrid_mesh(dcn_shape=(4,), devices=cpu(8)).shape == \
        dict(jax_mesh.create_hybrid_mesh(dcn_shape=(4,)).shape)
    with pytest.raises(ValueError, match="axis_names"):
        M.create_hybrid_mesh((2, 2), (2,), devices=cpu(8))


def test_shard_coordinates_are_row_major():
    mesh = M.create_mesh((4, 2), ("data", "model"), devices=cpu(8))
    assert mesh.shard_coords(3) == {"data": 3}
    assert len(mesh.model_devices(2)) == 2
    hybrid = M.create_hybrid_mesh((4,), (2,), devices=cpu(8))
    assert [hybrid.shard_coords(s) for s in (0, 3, 4, 7)] == [
        {"dcn": 0, "data": 0}, {"dcn": 0, "data": 3},
        {"dcn": 1, "data": 0}, {"dcn": 1, "data": 3}]
    with pytest.raises(ValueError, match="distinct names"):
        M.create_mesh((2, 2), ("data", "data"), devices=cpu(4))
    with pytest.raises(ValueError, match="own"):
        M.create_mesh((2, 2), ("data", "seq"), devices=cpu(4))
    # over processes: positions to ranks row-major, one a rank here; the
    # model-axis sum runs on the ranks of one data shard, the data-axis sum
    # on the ranks of one model shard
    ranks = [M.Mesh(cpu(4), ("data", "model"), shape=(2, 2), group=object(),
                    rank=r) for r in range(4)]
    assert [(m.positions, m.local_shards, m.local_models) for m in ranks] \
        == [((0,), (0,), (0,)), ((1,), (0,), (1,)), ((2,), (1,), (0,)),
            ((3,), (1,), (1,))]
    assert [m.axis_ranks(("model",)) for m in ranks] == [
        (0, 1), (0, 1), (2, 3), (2, 3)]
    assert [m.axis_ranks() for m in ranks] == [(0, 2), (1, 3), (0, 2),
                                               (1, 3)]
    assert ranks[0].axis_ranks(("data", "model")) == (0, 1, 2, 3)
    with pytest.raises(ValueError, match="neither whole model rows"):
        M.Mesh(cpu(6), ("data", "model"), shape=(2, 3), group=object(),
               processes=3)


def test_flat_mesh_is_unchanged():
    mesh = M.create_mesh((8,), devices=cpu(8))
    assert mesh.grid == mesh.devices and mesh.shard_axes == ("data",)
    assert mesh.size == 8 and mesh.model_size == 1 and mesh.processes == 1


# -- sums over a subset of the axes -------------------------------------------

def test_model_axis_sum_is_reduce_partials(monkeypatch):
    mesh = M.create_mesh((4, 2), ("data", "model"), devices=cpu(8))
    seen = []
    real = kernels.reduce_partials
    monkeypatch.setattr(kernels, "reduce_partials",
                        lambda p: seen.append(tuple(p.shape)) or real(p))
    parts = torch.arange(10, dtype=torch.float32).reshape(2, 5)
    got = C.all_reduce_sum(parts, mesh, axes=("model",))
    assert torch.equal(got, parts.sum(0)) and seen == [(2, 5)]
    with pytest.raises(ValueError, match="not axes"):
        C.all_reduce_sum(parts, mesh, axes=("dcn",))


def _sum_both(mode, hier, values):
    hier(mode)
    mesh = M.create_hybrid_mesh((4,), (2,), devices=cpu(8))
    return C.all_reduce_sum(torch.as_tensor(values), mesh)


def _jax_sum_both(mode, monkeypatch, value):
    from flink_ml_tpu.parallel import collective as jc

    monkeypatch.setenv(jc.HIER_ENV, mode)
    mesh = jax_mesh.create_hybrid_mesh(ici_shape=(4,), dcn_shape=(2,))
    return np.asarray(jax_mr.map_shards(
        lambda a: jax_mr.reduce_sum(a, ("dcn", "data")), mesh,
        in_specs=P(), out_specs=P())(value))


def test_hier_reduce_matches_flat_within_reassociation(hier, monkeypatch):
    g = np.arange(17, dtype=np.float32)  # odd length exercises the pad
    flat = _sum_both("0", hier, np.stack([g] * 8))
    two = _sum_both("1", hier, np.stack([g] * 8))
    np.testing.assert_allclose(two.numpy(), flat.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(two.numpy(), _jax_sum_both("1", monkeypatch,
                                                          g), rtol=1e-6)


def test_hier_reduce_random_values_tolerance(hier, rng):
    values = rng.normal(size=(8, 33, 3)).astype(np.float32)
    flat = _sum_both("0", hier, values)
    two = _sum_both("1", hier, values)
    np.testing.assert_allclose(two.numpy(), flat.numpy(), rtol=1e-5,
                               atol=1e-6)
    # flat over the hybrid mesh is the 1-D sum over 8 shards, bit for bit
    one_d = C.all_reduce_sum(torch.as_tensor(values),
                             M.create_mesh((8,), devices=cpu(8)))
    assert torch.equal(flat, one_d)


def test_hier_reduce_scalar_degenerates_to_flat(hier):
    got = _sum_both("1", hier, np.full(8, 1.5, np.float32))
    assert float(got) == 12.0


def test_hier_single_axis_never_decomposes(hier, monkeypatch):
    hier("1")
    assert C._hier_active(("data",)) is False
    calls = []
    real = kernels.reduce_partials
    monkeypatch.setattr(kernels, "reduce_partials",
                        lambda p: calls.append(p.shape) or real(p))
    mesh = M.create_mesh((8,), devices=cpu(8))
    out = C.all_reduce_sum(torch.stack([torch.arange(4.0)] * 8), mesh)
    assert torch.equal(out, 8.0 * torch.arange(4.0)) and len(calls) == 1


def _level_sum(level):
    snap = metrics.snapshot().get("ml.collective", {})
    return sum(float(h.get("sum", 0.0))
               for k, h in snap.get("histograms", {}).items()
               if k.startswith("levelPayloadBytes")
               and f'level="{level}"' in k)


def test_hier_level_accounting_inter_shrinks(hier, monkeypatch):
    from flink_ml_tpu.common.metrics import metrics as jax_metrics
    from flink_ml_tpu.parallel import collective as jc

    g = np.zeros((8, 64), np.float32)
    got = {}
    for mode in ("0", "1"):
        before = _level_sum("inter")
        _sum_both(mode, hier, g)
        got[mode] = _level_sum("inter") - before
    assert got["0"] == 64 * 4  # the whole payload crossed the outer axis
    assert got["1"] == 64 * 4 / 4  # the 1/local_N slice (local axis = 4)
    # the JAX package records the same bytes per level
    jax_got = {}
    for mode in ("0", "1"):
        snap = jax_metrics.snapshot().get("ml.collective", {})
        before = sum(float(h.get("sum", 0.0)) for k, h in snap.get(
            "histograms", {}).items() if k.startswith("levelPayloadBytes")
            and 'level="inter"' in k)
        _jax_sum_both(mode, monkeypatch, g[0])
        snap = jax_metrics.snapshot().get("ml.collective", {})
        jax_got[mode] = sum(float(h.get("sum", 0.0)) for k, h in snap.get(
            "histograms", {}).items() if k.startswith("levelPayloadBytes")
            and 'level="inter"' in k) - before
    assert jax_got == got
    monkeypatch.delenv(jc.HIER_ENV, raising=False)


def test_hier_auto_off_single_process(monkeypatch):
    monkeypatch.delenv(C.HIER_ENV, raising=False)
    assert C.hier_reduce_forced() is None
    assert C._hier_active(("dcn", "data")) is False
    monkeypatch.setenv(C.HIER_ENV, "1")
    assert C._hier_active(("dcn", "data")) is True
    assert C._hier_active(("data",)) is False


# -- map-reduce and shard_map over N-D meshes ---------------------------------

@pytest.mark.parametrize("shape,axes", [((4, 2), ("data", "model")),
                                        ((2, 4), ("dcn", "data"))])
def test_map_reduce_program_over_nd_meshes(shape, axes):
    mesh = M.create_mesh(shape, axes, devices=cpu(8))
    x = torch.arange(24, dtype=torch.float32).reshape(12, 2)
    prog = mr.MapReduceProgram(mesh)
    step = prog.build(lambda s, rows: rows.sum(0), lambda red: red)
    np.testing.assert_allclose(step([(p,) for p in prog.partition(x).parts]
                                    ).numpy(), x.sum(0).numpy())
    out = mr.map_rows(lambda rows: rows * 2.0, mesh)(x)
    assert torch.equal(out, x * 2.0)
    assert len(mr.map_shards(lambda s: s, mesh)([()] * mesh.size)) == \
        mesh.size


def test_shard_map_splits_and_joins():
    mesh = M.create_mesh((4,), devices=cpu(4))

    def body(a, b):
        assert axis_size("data") == 4
        return a * b, a.sum()[None]

    mapped = shard_map(body, mesh, in_specs=(PortP("data"), PortP()),
                       out_specs=(PortP("data"), None))
    prod, first = mapped(torch.arange(8.0), torch.tensor(3.0))
    assert torch.equal(prod, torch.arange(8.0) * 3.0)
    assert torch.equal(first, torch.tensor([1.0]))
    with pytest.raises(ValueError, match="does not split"):
        mapped(torch.arange(6.0), torch.tensor(1.0))
    with pytest.raises(RuntimeError, match="shard_map body"):
        axis_size("data")


def test_shard_map_records_the_mesh_once(tmp_path, monkeypatch):
    from flink_ml_tpu_torch.observability import meshstats, tracing

    monkeypatch.setenv(tracing.TRACE_DIR_ENV, str(tmp_path))
    mesh = M.create_mesh((2, 4), ("dcn", "data"), devices=cpu(8))
    with tracing.tracer.span("fit"):
        for _ in range(2):
            shard_map(lambda a: a, mesh, PortP(("dcn", "data")),
                      PortP(("dcn", "data")))(torch.arange(8.0))
    snap = meshstats.read_mesh(str(tmp_path))
    assert snap["shape"] == {"dcn": 2, "data": 4}
    assert snap["device_count"] == 8


# -- tensor parallelism -------------------------------------------------------

def _tp_data(seed=0, n=800, d=10):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = (rng.random(n) > 0.5).astype(np.float64)
    return x, y


@pytest.mark.parametrize("d", [10, 7])
@pytest.mark.parametrize("method", ["sgd", "adam"])
def test_tensor_parallel_fit_matches_jax(d, method):
    """JAX ``tests/test_sgd_programs.py:91-105``: the (4, 2) LR fit at
    800 x d, port against JAX and against the port's 1-D fit over the same
    4 data shards (an odd d pads the model axis)."""
    x, y = _tp_data(d=d)
    kw = dict(learning_rate=0.1, global_batch_size=200, max_iter=5, tol=0.0,
              reg=0.02, elastic_net=0.4, method=method)
    want, want_loss = JaxSGD(JaxParams(**kw)).optimize(
        JaxLogistic(), np.zeros(d), x, y,
        mesh=jax_mesh.create_mesh((4, 2), ("data", "model")))
    sgd = SGD(SGDParams(**kw))
    got, loss = sgd.optimize(BinaryLogisticLoss(), np.zeros(d), x, y,
                             mesh=M.create_mesh((4, 2), ("data", "model"),
                                                devices=cpu(8)))
    assert sgd.last_execution_path == "torch-tp"
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
    one_d, one_d_loss = SGD(SGDParams(**kw)).optimize(
        BinaryLogisticLoss(), np.zeros(d), x, y,
        mesh=M.create_mesh((4,), devices=cpu(4)))
    np.testing.assert_allclose(got, one_d, rtol=RTOL, atol=1e-7)


def test_tensor_parallel_launches_and_sharded_update(monkeypatch):
    """A TP round sums the margins over the model axis once per data shard
    and the packed terms over the data axes once; no batch-terms call. The
    sharded update stays off on a model axis, as in the JAX package."""
    from flink_ml_tpu_torch.parallel import update_sharding as upd

    monkeypatch.setenv(upd.ENV, "1")
    x, y = _tp_data()
    calls = []
    real = kernels.reduce_partials
    monkeypatch.setattr(kernels, "reduce_partials",
                        lambda p: calls.append(tuple(p.shape)) or real(p))
    monkeypatch.setattr(kernels, "sgd_batch_terms", None)
    sgd = SGD(SGDParams(global_batch_size=200, max_iter=3, tol=0.0))
    sgd.optimize(BinaryLogisticLoss(), np.zeros(10), x, y,
                 mesh=M.create_mesh((4, 2), ("data", "model"),
                                    devices=cpu(8)))
    assert calls.count((2, 50)) == 3 * 4 and calls.count((4, 12)) == 3
    assert upd.last_state_bytes("SGD[logistic]") == 5 * 4


def test_tensor_parallel_segments_resume_bit_for_bit(tmp_path):
    """The TP fit through the iteration runtime: K-round segments with a
    fault at the second boundary, resumed from the checkpoint, equal the
    all-device TP fit bit for bit."""
    from flink_ml_tpu_torch.iteration import IterationConfig
    from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager
    from flink_ml_tpu_torch.resilience import faults, run_supervised

    x, y = _tp_data(3)
    mesh = M.create_mesh((4, 2), ("data", "model"), devices=cpu(8))
    table = Table.from_columns(features=x, label=y)
    kw = dict(device="cpu", mesh=mesh, max_iter=8, global_batch_size=200)
    want = LogisticRegression(**kw).fit(table).coefficients
    mgr = CheckpointManager(str(tmp_path / "ck"))
    est = LogisticRegression(**kw).set_iteration_config(IterationConfig(
        checkpoint_interval=3, checkpoint_manager=mgr))
    with faults.chaos(at={"epoch-boundary": [2]}):
        got = run_supervised(lambda: est.fit(table), mgr=mgr).coefficients
    assert est.last_execution_path == "torch-tp-segments"
    np.testing.assert_array_equal(got, want)


# -- the hybrid mesh: fits ----------------------------------------------------

def _fit_lr(mesh, x, y):
    est = LogisticRegression(device="cpu", mesh=mesh, max_iter=6,
                             global_batch_size=160)
    return est.fit(Table.from_columns(features=x, label=y)).coefficients


def _fit_km(mesh, x):
    est = KMeans(k=3, seed=1, max_iter=5, device="cpu", mesh=mesh)
    model = est.fit(Table.from_columns(features=x))
    labels = model.transform(Table.from_columns(features=x))[0][
        "prediction"]
    return model.centroids, np.asarray(labels)


def test_hybrid_fits_flat_equal_1d_and_hier_within_tolerance(hier):
    """``(dcn 2, data 4)``: with the flat reduce the LR and KMeans fits are
    the 1-D 8-shard fits bit for bit (the JAX docstring at
    ``mesh.py:229-233``); with the two-level reduce within reassociation;
    and the JAX package's hybrid LR fit within rtol 1e-5."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(960, 6)).astype(np.float32)
    y = (x @ rng.normal(size=6) > 0).astype(np.float32)
    hybrid = M.create_hybrid_mesh((4,), (2,), devices=cpu(8))
    flat8 = M.create_mesh((8,), devices=cpu(8))
    hier("0")
    lr8, km8 = _fit_lr(flat8, x, y), _fit_km(flat8, x)
    lr_flat, km_flat = _fit_lr(hybrid, x, y), _fit_km(hybrid, x)
    np.testing.assert_array_equal(lr_flat, lr8)
    np.testing.assert_array_equal(km_flat[0], km8[0])
    np.testing.assert_array_equal(km_flat[1], km8[1])
    hier("1")
    lr_h, km_h = _fit_lr(hybrid, x, y), _fit_km(hybrid, x)
    np.testing.assert_allclose(lr_h, lr8, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(km_h[0], km8[0], rtol=RTOL, atol=1e-6)
    from flink_ml_tpu import Table as JaxTable
    from flink_ml_tpu.models.classification import (
        LogisticRegression as JaxLR)

    jax_mesh.set_default_mesh(jax_mesh.create_hybrid_mesh(
        ici_shape=(4,), dcn_shape=(2,)))
    try:
        want = JaxLR(max_iter=6, global_batch_size=160).fit(
            JaxTable.from_columns(features=x, label=y)).coefficients
    finally:
        jax_mesh.set_default_mesh(None)
    np.testing.assert_allclose(lr_flat, want, rtol=RTOL, atol=1e-6)


def test_hybrid_hier_fit_launches_two_legs(hier, monkeypatch):
    """On the hybrid mesh with the two-level reduce a round's sum is two
    reduce_partials calls: the inner sums of both outer rows at once, then
    the outer sum."""
    hier("1")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(800, 4)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    calls = []
    real = kernels.reduce_partials
    monkeypatch.setattr(kernels, "reduce_partials",
                        lambda p: calls.append(tuple(p.shape)) or real(p))
    est = LogisticRegression(device="cpu", max_iter=2, global_batch_size=80,
                             mesh=M.create_hybrid_mesh((4,), (2,),
                                                       devices=cpu(8)))
    est.fit(Table.from_columns(features=x, label=y))
    assert calls == [(4, 2 * 6), (2, 6)] * 2


# -- the tensor-parallel example ----------------------------------------------

def _tp_example_table():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4096, 512)).astype(np.float32)
    y = (x @ rng.normal(size=512) > 0).astype(np.float64)
    return x, y


def test_tensor_parallel_example_matches_jax():
    """``examples/tensor_parallel_example.py`` (it calls ``jax.devices()``,
    so its twin here): the same table and parameters on a (2, 2) mesh, the
    port's accuracy and coefficients against the JAX run's."""
    from flink_ml_tpu import Table as JaxTable
    from flink_ml_tpu.models.classification import (
        LogisticRegression as JaxLR)

    x, y = _tp_example_table()
    params = dict(max_iter=20, global_batch_size=1024, learning_rate=0.5)
    jax_mesh.set_default_mesh(jax_mesh.create_mesh(
        (2, 2), ("data", "model"), devices=jax.devices()[:4]))
    try:
        jm = JaxLR(**params).fit(JaxTable.from_columns(features=x, label=y))
        jpred = np.asarray(jm.transform(JaxTable.from_columns(
            features=x, label=y))[0]["prediction"])
    finally:
        jax_mesh.set_default_mesh(None)
    M.set_default_mesh(M.create_mesh((2, 2), ("data", "model"),
                                     devices=cpu(4)))
    model = LogisticRegression(device="cpu", **params).fit(
        Table.from_columns(features=x, label=y))
    pred = model.transform(Table.from_columns(features=x, label=y))[0][
        "prediction"]
    pred = np.asarray(pred.cpu() if isinstance(pred, torch.Tensor)
                      else pred)
    acc, jacc = float(np.mean(pred == y)), float(np.mean(jpred == y))
    assert acc > 0.9 and abs(acc - jacc) <= 2.0 / len(y)
    np.testing.assert_allclose(model.coefficients, jm.coefficients,
                               rtol=1e-4, atol=1e-5)
