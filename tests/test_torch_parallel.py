"""The port's data-parallel layer (``flink_ml_tpu_torch/parallel``), held
against the JAX package's (``flink_ml_tpu/parallel``) and against itself.

The JAX side runs on meshes of the 8 host devices ``tests/conftest.py``
provides (``create_mesh(devices=jax.devices()[:n])``); the port side on
in-process meshes of ``n`` virtual shards on the CPU
(``create_mesh((n,), devices=["cpu"] * n)``), where every cross-shard sum
is ``reduce_partials``' plain version. Inputs are numpy-seeded. Both
packages read the same switch, ``FLINK_ML_TPU_UPDATE_SHARDING``.

- The primitives (the counterparts of ``tests/test_mapreduce.py:57-131``),
  ``MapReduceProgram`` and ``sharded_apply``, at n in {1, 2, 8}.
- The fits at n in {1, 2, 8} x {replicated, sharded}: SGD with sgd,
  momentum and adam on 403 rows (a padded last shard) with a global batch
  of 81 (uneven local batches), rtol 1e-5, atol 1e-8; KMeans, centroids
  rtol 1e-4, atol 1e-6, weights exact; FTRL dense and device-CSR, rtol
  1e-5, atol 1e-7. The tolerances are those of the JAX package's own
  sharded-against-replicated tests: the packages add the shards' sums in
  other orders.
- Against itself: one shard is the fit with no mesh, bit for bit and
  window for window; the sharded update equals the replicated one bit
  for bit on virtual shards (they add in one order); the shard schedule
  weighs the JAX program's rows.
- The per-replica state bytes, the runner's mesh provenance, a sharded
  carry through the checkpoint manager, and two gloo ranks started as
  fresh processes (spawn) against the in-process backend, the virtual
  two-shard fit and the JAX two-device fit.
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
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.iteration.streaming import StreamTable as JaxStreamTable
from flink_ml_tpu.linalg.vectors import SparseVector as JaxSparseVector
from flink_ml_tpu.models import online as jax_online
from flink_ml_tpu.models.clustering import KMeans as JaxKMeans
from flink_ml_tpu.ops import losses as jax_losses
from flink_ml_tpu.ops import optimizer as jax_opt
from flink_ml_tpu.parallel import (
    DATA_AXIS,
    create_mesh as jax_create_mesh,
    mapreduce as jax_mr,
    set_default_mesh as jax_set_default_mesh,
    update_sharding as jax_upd,
)
from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.benchmark import runner
from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager
from flink_ml_tpu_torch.iteration.streaming import StreamTable
from flink_ml_tpu_torch.linalg import sparse
from flink_ml_tpu_torch.models import online
from flink_ml_tpu_torch.models.classification import LogisticRegression
from flink_ml_tpu_torch.models.clustering import KMeans
from flink_ml_tpu_torch.ops import kernels, losses, optimizer
from flink_ml_tpu_torch.parallel import (
    collective as C,
    create_mesh,
    mapreduce as mr,
    mesh as mesh_mod,
    update_sharding as upd,
)

REPO = Path(__file__).resolve().parent.parent
CONFIG = str(REPO / "flink_ml_tpu" / "benchmark" / "configs"
             / "onlinelogisticregression-benchmark.json")
MESH_SIZES = (1, 2, 8)
MODES = ("replicated", "sharded")
SGD_RTOL, SGD_ATOL = 1e-5, 1e-8
KM_RTOL, KM_ATOL = 1e-4, 1e-6
FTRL_RTOL, FTRL_ATOL = 1e-5, 1e-7


def jax_mesh(n):
    return jax_create_mesh(devices=jax.devices()[:n])


def port_mesh(n):
    return create_mesh((n,), devices=["cpu"] * n)


def _stack(values, n):
    """Every one of n shards holding ``values``: the port's (n, ...) stack."""
    return torch.as_tensor(np.stack([values] * n))


@pytest.fixture
def sharding(monkeypatch):
    """``sharding(mode)`` arms the sharded update of both packages (one
    switch) or disarms it."""

    def arm(mode):
        if mode == "sharded":
            monkeypatch.setenv(upd.ENV, "1")
        else:
            monkeypatch.delenv(upd.ENV, raising=False)

    monkeypatch.delenv(upd.ENV, raising=False)
    return arm


@pytest.fixture
def jax_default_mesh():
    """Set-and-restore of the JAX package's default mesh (its KMeans and
    FTRL fit on it)."""
    try:
        yield jax_set_default_mesh
    finally:
        jax_set_default_mesh(None)


@pytest.fixture
def port_default_mesh():
    try:
        yield mesh_mod.set_default_mesh
    finally:
        mesh_mod.set_default_mesh(None)


# -- primitives -------------------------------------------------------------------

@pytest.mark.parametrize("n", MESH_SIZES)
def test_reduce_scatter_sums_and_slices(n):
    """Every shard holds the same (16,) partial; each keeps its n-times
    slice, in shard order (the JAX program's P(data) output)."""
    g = np.arange(16, dtype=np.float32)
    want = np.asarray(jax_mr.map_shards(
        lambda a: jax_mr.reduce_scatter(a), jax_mesh(n), in_specs=P(),
        out_specs=P(DATA_AXIS))(g))
    got = C.reduce_scatter(_stack(g, n), port_mesh(n))
    assert got.shape == (n, 16 // n)
    np.testing.assert_array_equal(got.reshape(-1).numpy(), want)
    np.testing.assert_array_equal(want, n * g)


@pytest.mark.parametrize("n", MESH_SIZES)
def test_reduce_scatter_all_gather_roundtrip(n):
    g = np.arange(16, dtype=np.float32)
    want = np.asarray(jax_mr.map_shards(
        lambda a: jax_mr.all_gather(jax_mr.reduce_scatter(a)), jax_mesh(n),
        in_specs=P(), out_specs=P())(g))
    mesh = port_mesh(n)
    got = C.all_gather(C.reduce_scatter(_stack(g, n), mesh), mesh)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", MESH_SIZES)
def test_owned_slice_pairs_with_reduce_scatter(n):
    """reduce_scatter's shard-i slice is shard i's owned_slice: gather
    (scatter(g) - n * owned(g)) == 0."""
    g = torch.arange(16, dtype=torch.float32)
    mesh = port_mesh(n)
    diff = C.reduce_scatter(_stack(g.numpy(), n), mesh) - n * upd.owned_slice(
        g, mesh)
    np.testing.assert_array_equal(C.all_gather(diff, mesh).numpy(),
                                  np.zeros(16))


def test_broadcast_takes_src_shard():
    x = np.arange(8, dtype=np.float32).reshape(8, 1)
    want = np.asarray(jax_mr.map_shards(
        lambda a: jax_mr.broadcast(a, src=5), jax_mesh(8),
        in_specs=P(DATA_AXIS, None), out_specs=P(DATA_AXIS, None))(x))
    got = mr.broadcast(torch.as_tensor(x), port_mesh(8), src=5)
    np.testing.assert_array_equal(np.broadcast_to(got.numpy(), (8, 1)), want)


@pytest.mark.parametrize("n", MESH_SIZES)
def test_shard_count_and_index(n):
    count, idx = jax_mr.map_shards(
        lambda: (jnp.asarray(jax_mr.shard_count()),
                 jax_mr.shard_index()[None]),
        jax_mesh(n), in_specs=(), out_specs=(P(), P(DATA_AXIS)))()
    mesh = port_mesh(n)
    assert mr.shard_count(mesh) == int(count) == n
    assert list(mr.shard_index(mesh)) == np.asarray(idx).tolist()


def test_padding_helpers():
    assert upd.padded_len(10, 8) == 16
    assert upd.padded_len(16, 8) == 16
    assert upd.padded_len(5, 1) == 5
    x = torch.ones((3, 2))
    assert upd.pad_leading(x, 5).shape == (5, 2)
    assert float(upd.pad_leading(x, 5)[3:].sum()) == 0.0
    assert upd.pad_leading(x, 3) is x
    assert upd.pad_leading(x, 4, dim=1).shape == (3, 4)


@pytest.mark.parametrize("n", MESH_SIZES)
def test_reduce_mean_max_and_termination_vote(n):
    """Shard i holds row i of a seeded table: the mean and max over the
    shards, and the termination vote on per-shard counts."""
    x = np.random.default_rng(n).normal(size=(n, 3)).astype(np.float32)
    prog = jax_mr.map_shards(
        lambda a: (jax_mr.reduce_mean(a[0]), jax_mr.reduce_max(a[0])),
        jax_mesh(n), in_specs=P(DATA_AXIS, None), out_specs=(P(), P()))
    want_mean, want_max = (np.asarray(v) for v in prog(x))
    mesh = port_mesh(n)
    np.testing.assert_allclose(mr.reduce_mean(torch.as_tensor(x), mesh),
                               want_mean, rtol=1e-6)
    np.testing.assert_array_equal(mr.reduce_max(torch.as_tensor(x), mesh),
                                  want_max)
    zeros = torch.zeros(n, dtype=torch.int64)
    assert bool(C.termination_vote(zeros, mesh))
    assert not bool(C.termination_vote(zeros + (torch.arange(n) == n - 1),
                                       mesh))


@pytest.mark.parametrize("n", MESH_SIZES)
def test_renormalized_sum(n):
    """With every shard in, the plain sum bit for bit; without shard 0, the
    others' sum scaled by n / (n - 1), as the JAX primitive computes it."""
    x = np.random.default_rng(10 + n).normal(size=(n, 4)).astype(np.float32)
    mesh = port_mesh(n)
    every = mr.renormalized_sum(torch.as_tensor(x), torch.ones(n), mesh)
    assert torch.equal(every, mr.reduce_sum(torch.as_tensor(x), mesh))
    if n == 1:
        return
    include = (np.arange(n) != 0).astype(np.float32)
    want = np.asarray(jax_mr.map_shards(
        lambda a, inc: jax_mr.renormalized_sum(a[0], inc[0]), jax_mesh(n),
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS)), out_specs=P())(
        x, include))
    got = mr.renormalized_sum(torch.as_tensor(x), torch.as_tensor(include),
                              mesh)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_local_valid_mask():
    """1 for rows whose global index is below the valid count: the JAX
    helper's mask for shard s of a zero-padded batch."""
    n_valid, local_n = 13, 4
    masks = [mr.local_valid_mask(s, local_n, n_valid) for s in range(4)]
    np.testing.assert_array_equal(torch.cat(masks).numpy(),
                                  (np.arange(16) < n_valid).astype(np.float32))


def test_one_shard_primitives_launch_nothing(monkeypatch):
    """At one shard every primitive is the identity: no cross-shard sum
    runs, and the values are the shard's own."""
    calls = []
    monkeypatch.setattr(kernels, "reduce_partials",
                        lambda p: calls.append(p) or p.sum(0))
    mesh = port_mesh(1)
    x = torch.arange(8, dtype=torch.float32)[None]
    for got in (mr.reduce_sum(x, mesh), mr.reduce_mean(x, mesh),
                mr.reduce_max(x, mesh), mr.broadcast(x, mesh),
                C.all_gather(mr.reduce_scatter(x, mesh), mesh)):
        assert torch.equal(got, x[0])
    assert calls == []


def test_in_process_sum_is_reduce_partials():
    """The cross-shard sum of float32 values is reduce_partials (here its
    plain version) on the stack, in its fixed order, bit for bit."""
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(8, 5, 3)).astype(np.float32))
    mesh = port_mesh(8)
    want = kernels.reduce_partials_plain(x.reshape(8, -1)).reshape(5, 3)
    assert torch.equal(mr.reduce_sum(x, mesh), want)
    # other dtypes add the shards in shard order
    ints = torch.arange(24).reshape(8, 3)
    assert torch.equal(mr.reduce_sum(ints, mesh), ints.sum(0))


def test_row_placement_views_contiguous_shards():
    """ensure_on_mesh: shard s is rows [s*ls, min((s+1)*ls, n)) as a view
    of one placed tensor, the padded last shard short, shards past the end
    empty; ones_on_mesh splits the same way."""
    x = torch.arange(11 * 2, dtype=torch.float32).reshape(11, 2)
    rows = C.ensure_on_mesh(port_mesh(4), x)
    assert rows.ls == 3 and rows.real == [3, 3, 3, 2] and rows.n == 11
    for s, part in enumerate(rows.parts):
        assert torch.equal(part, x[3 * s:3 * s + rows.real[s]])
        assert part.data_ptr() == x[3 * s].data_ptr()  # a view, no copy
    rows = C.ensure_on_mesh(port_mesh(8), x[:5])
    assert rows.real == [1, 1, 1, 1, 1, 0, 0, 0]
    ones = C.ones_on_mesh(port_mesh(8), 5)
    assert [p.shape[0] for p in ones.parts] == rows.real


def test_map_rows_is_the_whole_apply():
    x = np.random.default_rng(4).normal(size=(13, 3)).astype(np.float32)
    w = torch.as_tensor([1.0, -2.0, 0.5])
    got = mr.map_rows(lambda rows, coef: rows @ coef, port_mesh(8))(x, w)
    # row blocks may take another matvec path than the whole
    np.testing.assert_allclose(got.numpy(), (torch.as_tensor(x) @ w).numpy(),
                               rtol=1e-6, atol=1e-7)


# -- MapReduceProgram and sharded_apply ----------------------------------------------

@pytest.mark.parametrize("n", MESH_SIZES)
def test_program_builder_identical_across_mesh_sizes(n):
    """partition → map → reduce → update gives the JAX program's weighted
    mean on every mesh size."""
    rng = np.random.default_rng(42)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    w = (rng.random(64) + 0.5).astype(np.float32)
    jprog = jax_mr.MapReduceProgram(jax_mesh(n))
    want = np.asarray(jprog.build(
        lambda xl, wl: {"sx": jnp.sum(xl * wl[:, None], axis=0),
                        "sw": jnp.sum(wl)},
        lambda red, xl, wl: red["sx"] / jnp.maximum(red["sw"], 1e-30),
        in_specs=(jprog.data_spec(2), jprog.data_spec(1)),
        out_specs=P())(x, w))
    prog = mr.MapReduceProgram(port_mesh(n))
    step = prog.build(
        lambda s, xl, wl: {"sx": torch.sum(xl * wl[:, None], dim=0),
                           "sw": torch.sum(wl)},
        lambda red: red["sx"] / torch.clamp_min(red["sw"], 1e-30))
    got = step(list(zip(prog.partition(x).parts, prog.partition(w).parts)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(want, (x * w[:, None]).sum(0) / w.sum(),
                               rtol=1e-5)


def test_program_builder_mixed_reducers():
    """Per-leaf reducers: the gradient leaf reduce-scatters while the
    scalar leaf all-reduces."""
    jprog = jax_mr.MapReduceProgram(jax_mesh(8))
    jstep = jprog.build(lambda g, s: {"grad": g, "scalar": s},
                        lambda red, g, s: (jax_mr.all_gather(red["grad"]),
                                           red["scalar"]),
                        in_specs=(P(), P()), out_specs=(P(), P()),
                        reduce={"grad": jax_mr.reduce_scatter,
                                "scalar": jax_mr.reduce_sum})
    g = np.arange(16, dtype=np.float32)
    want_full, want_scalar = jstep(g, np.float32(2.0))
    mesh = port_mesh(8)
    step = mr.MapReduceProgram(mesh).build(
        lambda s, g_s, s_s: {"grad": g_s, "scalar": s_s},
        lambda red: (mr.all_gather(red["grad"], mesh), red["scalar"]),
        reduce={"grad": mr.reduce_scatter, "scalar": mr.reduce_sum})
    full, scalar = step([(torch.as_tensor(g), torch.tensor(2.0))] * 8)
    np.testing.assert_array_equal(full.numpy(), np.asarray(want_full))
    assert float(scalar) == float(want_scalar) == 16.0


@pytest.mark.parametrize("n", MESH_SIZES)
def test_sharded_apply_matches_replicated_apply(n):
    """scatter → slice update → gather equals the replicated reduce → full
    update (and the JAX sharded_apply), the opt-state slices sharded."""
    d = 16
    g = np.linspace(-1, 1, d).astype(np.float32)
    p0 = np.ones(d, np.float32)
    s0 = np.full(d, 0.25, np.float32)

    def rule(gs, ps, ss):
        return ps - 0.5 * gs, ss + gs * gs

    jmesh = jax_mesh(n)
    sh = jax_mr.map_shards(
        lambda gl, pl, sl: (lambda out: (out[0], jax_mr.all_gather(out[1])))(
            jax_upd.sharded_apply(DATA_AXIS, gl, pl, sl, rule)),
        jmesh, in_specs=(P(), P(), P(DATA_AXIS)), out_specs=(P(), P()))
    want_p, want_s = (np.asarray(v) for v in sh(
        g, p0, jax.device_put(s0, NamedSharding(jmesh, P(DATA_AXIS)))))
    mesh = port_mesh(n)
    state = upd.place_opt_state(mesh, torch.as_tensor(s0))
    assert len(state.slices) == n and state.shape == (d,)
    got_p, got_s = upd.sharded_apply(mesh, _stack(g, n), torch.as_tensor(p0),
                                     state, rule)
    assert isinstance(got_s, upd.Sharded)
    full_g = mr.reduce_sum(_stack(g, n), mesh)
    rep_p, rep_s = rule(full_g, torch.as_tensor(p0), torch.as_tensor(s0))
    assert torch.equal(got_p, rep_p)
    assert torch.equal(got_s.global_view(), rep_s)
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=1e-5)
    np.testing.assert_allclose(got_s.global_view().numpy(), want_s, rtol=1e-5)


# -- SGD ---------------------------------------------------------------------------

SGD_N, SGD_D, SGD_GB = 403, 10, 81


def _sgd_data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(SGD_N, SGD_D)).astype(np.float32)
    y = (x @ rng.normal(size=SGD_D) > 0).astype(np.float32)
    return x, y


def _sgd_params(method, **kw):
    return dict(dict(learning_rate=0.1, global_batch_size=SGD_GB, max_iter=6,
                     tol=0.0, reg=0.02, elastic_net=0.4, method=method), **kw)


def _port_sgd(mesh, method, x, y, **kw):
    sgd = optimizer.SGD(optimizer.SGDParams(**_sgd_params(method)))
    coeffs, loss = sgd.optimize(losses.BinaryLogisticLoss(),
                                np.zeros(SGD_D), x, y, mesh=mesh, **kw)
    return coeffs, loss, sgd.last_execution_path


@pytest.mark.parametrize("method", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", MESH_SIZES)
def test_sgd_matches_jax(sharding, n, mode, method):
    """403 rows over n shards (a padded last shard at 2 and 8) with a
    global batch of 81 (local batches of 41/40 and 11/10): the per-shard
    windows, offsets and update of the JAX package's fit."""
    sharding(mode)
    x, y = _sgd_data()
    want, want_loss = jax_opt.SGD(jax_opt.SGDParams(**_sgd_params(
        method))).optimize(jax_losses.BinaryLogisticLoss(), np.zeros(SGD_D),
                           x, y, mesh=jax_mesh(n))
    got, loss, path = _port_sgd(port_mesh(n), method, x, y)
    assert got.shape == (SGD_D,) and path == "torch-sgd"
    np.testing.assert_allclose(got, want, rtol=SGD_RTOL, atol=SGD_ATOL)
    np.testing.assert_allclose(loss, want_loss, rtol=SGD_RTOL)


@pytest.mark.parametrize("n", MESH_SIZES)
def test_sgd_sharded_update_is_the_replicated_one_bit_for_bit(sharding, n):
    """On virtual shards the reduce-scatter adds in the all-reduce's order,
    so the sharded fit gives the replicated fit's bits."""
    x, y = _sgd_data(1)
    for method in ("sgd", "adam"):
        sharding("replicated")
        rep = _port_sgd(port_mesh(n), method, x, y)
        sharding("sharded")
        sh = _port_sgd(port_mesh(n), method, x, y)
        np.testing.assert_array_equal(sh[0], rep[0])
        assert sh[1] == rep[1]


def test_sgd_one_shard_is_the_fit_without_a_mesh(monkeypatch,
                                                 port_default_mesh):
    """A one-shard mesh runs the one-device schedule window for window and
    gives its bits; so does a one-shard default mesh."""
    calls = []
    real = kernels.sgd_batch_terms

    def counting(xl, yl, wl, coeffs, start, clip, lb, loss_name):
        calls.append((start, clip, lb))
        return real(xl, yl, wl, coeffs, start, clip, lb, loss_name)

    monkeypatch.setattr(kernels, "sgd_batch_terms", counting)
    x, y = _sgd_data(2)
    fits = []
    for mesh in (None, port_mesh(1)):
        calls.clear()
        sgd = optimizer.SGD(optimizer.SGDParams(**_sgd_params(
            "momentum", global_batch_size=150)))
        fits.append((sgd.optimize(losses.BinaryLogisticLoss(),
                                  np.zeros(SGD_D), x, y, device="cpu",
                                  mesh=mesh), list(calls)))
    port_default_mesh(port_mesh(1))
    sgd = optimizer.SGD(optimizer.SGDParams(**_sgd_params(
        "momentum", global_batch_size=150)))
    fits.append((sgd.optimize(losses.BinaryLogisticLoss(), np.zeros(SGD_D),
                              x, y), []))
    (plain, plain_calls), (one, one_calls), (default, _) = fits
    sched = jax_opt._static_batch_schedule(SGD_N, 150, 6)
    assert plain_calls == one_calls == [(s, c, 150) for s, c in sched]
    np.testing.assert_array_equal(one[0], plain[0])
    np.testing.assert_array_equal(default[0], plain[0])
    assert one[1] == plain[1]


@pytest.mark.parametrize("n,p,gb", [(403, 8, 81), (403, 2, 81), (50, 8, 3),
                                    (7, 8, 20), (100, 3, 300), (64, 4, 16)])
def test_shard_schedule_weighs_the_jax_rows(n, p, gb):
    """Each round, each shard's kernel window weighs exactly the rows the
    JAX while program weighs: window [start, start + lb_max), valid rows
    [offset, offset + lb_s), padded rows of weight 0; offsets wrap alike."""
    ls = C.shard_len(n, p)
    real = [max(0, min(ls, n - s * ls)) for s in range(p)]
    sched = optimizer.ShardSchedule(gb, p, ls, real)
    lb_base, lb_rem = gb // p, gb % p
    lb_max = min(lb_base + (1 if lb_rem else 0), ls)
    offsets = np.zeros(p, np.int32)
    for _ in range(12):
        for s in range(p):
            off = int(offsets[s])
            lb = min(lb_base + (s < lb_rem), ls)
            jstart = min(off, ls - lb_max)
            want = {r for r in range(jstart, jstart + lb_max)
                    if off <= r < off + lb and r < real[s]}
            start, clip, k_lb = sched.window(s, off)
            got = set(range(start + clip, start + k_lb)) if k_lb > clip \
                else set()
            assert got == want, (s, off)
            if k_lb > clip:
                assert 0 <= start and start + k_lb <= real[s]
        offsets = sched.advance(offsets)
        assert offsets.dtype == np.int32 and offsets.shape == (p,)


def test_sgd_launches_one_window_per_shard(monkeypatch):
    """Eight shards: a launch per shard whose window holds a real row, at
    the schedule's windows, on that shard's rows."""
    calls = []
    real = kernels.sgd_batch_terms

    def counting(xl, yl, wl, coeffs, start, clip, lb, loss_name):
        calls.append((xl.shape[0], start, clip, lb))
        return real(xl, yl, wl, coeffs, start, clip, lb, loss_name)

    monkeypatch.setattr(kernels, "sgd_batch_terms", counting)
    x, y = _sgd_data(3)
    _port_sgd(port_mesh(8), "sgd", x, y)
    ls = C.shard_len(SGD_N, 8)
    reals = [min(ls, SGD_N - s * ls) for s in range(8)]
    sched = optimizer.ShardSchedule(SGD_GB, 8, ls, reals)
    offsets, want = np.zeros(8, np.int32), []
    for _ in range(6):
        for s in range(8):
            start, clip, lb = sched.window(s, int(offsets[s]))
            if lb > clip:
                want.append((reals[s], start, clip, lb))
        offsets = sched.advance(offsets)
    # the last shard holds 50 of its 51 rows: a window that lies wholly in
    # its padding launches nothing
    assert calls == want and len(calls) < 6 * 8


# -- KMeans and FTRL -------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", MESH_SIZES)
def test_kmeans_matches_jax(sharding, jax_default_mesh, n, mode):
    sharding(mode)
    x = np.random.default_rng(42).normal(size=(243, 6)).astype(np.float32)
    jax_default_mesh(jax_mesh(n))
    want = JaxKMeans(k=4, seed=7, max_iter=6).fit(
        JaxTable.from_columns(features=x))
    est = KMeans(k=4, seed=7, max_iter=6, device="cpu", mesh=port_mesh(n))
    got = est.fit(Table.from_columns(features=x))
    assert est.last_execution_path == "torch-lloyd"
    np.testing.assert_allclose(got.centroids, want.centroids, rtol=KM_RTOL,
                               atol=KM_ATOL)
    np.testing.assert_array_equal(got.weights, want.weights)


def _ftrl_tables(d=6, batches=6, bs=61, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batches * bs, d)).astype(np.float32)
    y = (x @ rng.normal(size=d) > 0).astype(float)
    return (JaxTable.from_columns(features=x, label=y),
            Table.from_columns(features=x, label=y), bs)


def _jax_ftrl(table, bs, d, **params):
    est = jax_online.OnlineLogisticRegression(global_batch_size=bs, **params)
    est.set_initial_model_data(JaxTable.from_columns(
        coefficient=np.zeros((1, d)), modelVersion=np.asarray([0])))
    return est.fit(JaxStreamTable.from_table(table, bs)), est


def _port_ftrl(table, bs, d, mesh, **params):
    est = online.OnlineLogisticRegression(global_batch_size=bs, device="cpu",
                                          mesh=mesh, **params)
    est.warm_start(np.zeros(d))
    return est.fit(StreamTable.from_table(table, bs)), est


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", MESH_SIZES)
def test_ftrl_dense_matches_jax(sharding, jax_default_mesh, n, mode):
    """Batches of 61 rows (ragged shards) over n shards; the history keeps
    the trimmed (d,) snapshots in both modes."""
    sharding(mode)
    jax_default_mesh(jax_mesh(n))
    jt, pt, bs = _ftrl_tables()
    want, _ = _jax_ftrl(jt, bs, 6, reg=0.01, elastic_net=0.3)
    got, est = _port_ftrl(pt, bs, 6, port_mesh(n), reg=0.01, elastic_net=0.3)
    assert est.last_execution_path == "torch-dense-batches"
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               rtol=FTRL_RTOL, atol=FTRL_ATOL)
    assert got.model_version == want.model_version == 6
    assert all(c.shape == (6,) for _, c in got.history)
    for (va, a), (vb, b) in zip(got.history, want.history):
        assert va == vb
        np.testing.assert_allclose(a, b, rtol=FTRL_RTOL, atol=FTRL_ATOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", MESH_SIZES)
def test_ftrl_device_csr_matches_jax(sharding, jax_default_mesh, monkeypatch,
                                     n, mode):
    """The device CSR engine: each shard's row range packed, its segment
    sums, the (d, 2) gradient and weight columns summed (reduce-scattered
    when sharded) over the mesh."""
    sharding(mode)
    monkeypatch.setenv("FLINK_ML_TPU_FTRL_SPARSE_MIN_NNZ", "1")
    monkeypatch.setattr(jax_online, "_ftrl_sparse_broken", False)
    monkeypatch.setattr(online, "FTRL_SPARSE_MIN_NNZ", 1)
    jax_default_mesh(jax_mesh(n))
    rng = np.random.default_rng(5)
    rows, d = 300, 7
    x = rng.normal(size=(rows, d))
    y = (x @ rng.normal(size=d) > 0).astype(np.float64)
    mask = rng.random((rows, d)) < 0.6
    sv = np.empty(rows, object)
    for i in range(rows):
        idx = np.nonzero(mask[i])[0]
        sv[i] = JaxSparseVector(d, idx, x[i, idx])
    want, jest = _jax_ftrl(JaxTable.from_columns(features=sv, label=y), 100,
                           d)
    assert jest.last_execution_path == "device-csr-batches"
    import scipy.sparse as sp

    csr = sp.csr_matrix(np.where(mask, x, 0.0))
    got, est = _port_ftrl(Table.from_columns(
        features=sparse.CsrVectorColumn(csr), label=y), 100, d, port_mesh(n))
    assert est.last_execution_path == "torch-csr-batches"
    np.testing.assert_allclose(got.coefficients, want.coefficients,
                               rtol=FTRL_RTOL, atol=FTRL_ATOL)


@pytest.mark.parametrize("n,d,sharded_bytes", [(8, 10, 2 * 16 * 4 // 8),
                                               (2, 10, 2 * 10 * 4 // 2),
                                               (8, 6, 2 * 8 * 4 // 8)])
def test_state_bytes_accounting(sharding, n, d, sharded_bytes):
    """z + n per replica: 1/N of the padded length when sharded, the whole
    (d,) pair when replicated (the JAX test's 2*16*4/8 at d = 10, p = 8)."""
    _, pt, bs = _ftrl_tables(d=d, batches=2, seed=6)
    sharding("sharded")
    _port_ftrl(pt, bs, d, port_mesh(n))
    assert upd.last_state_bytes("OnlineLogisticRegression") == sharded_bytes
    sharding("replicated")
    _port_ftrl(pt, bs, d, port_mesh(n))
    assert upd.last_state_bytes("OnlineLogisticRegression") == 2 * d * 4


def test_sgd_moment_bytes_shrink(sharding):
    x, y = _sgd_data(4)
    sharding("sharded")
    _port_sgd(port_mesh(8), "adam", x, y)
    # m and v, 16 padded rows over 8 shards, and adam's step
    assert upd.last_state_bytes("SGD[logistic].moments") == 2 * 2 * 4 + 4
    sharding("replicated")
    _port_sgd(port_mesh(8), "adam", x, y)
    assert upd.last_state_bytes("SGD[logistic].moments") == 2 * 10 * 4 + 4


def test_benchmark_row_carries_mesh_provenance(sharding):
    """A runner row of a fit on a virtual 8-shard mesh names it: one
    physical device, ``data=8``, the sharded update and the per-replica
    state bytes its fit recorded."""
    sharding("sharded")
    spec = runner.load_config(CONFIG)["OnlineLogisticRegression"]
    spec["inputData"]["paramMap"]["numValues"] = 800
    spec["inputData"]["paramMap"]["vectorDim"] = 10
    spec["modelData"]["paramMap"]["vectorDim"] = 10
    spec["stage"]["paramMap"]["globalBatchSize"] = 200
    row = runner.run_benchmark("OnlineLogisticRegression", spec,
                               device="cpu", mesh=port_mesh(8))
    assert row["meshShape"] == "data=8" and row["deviceCount"] == 1
    assert row["updateSharding"] is True
    assert row["optStateBytesPerReplica"] == upd.last_state_bytes() == 16
    assert row["executionPath"] == "torch-dense-batches"
    sharding("replicated")
    row = runner.run_benchmark("OnlineLogisticRegression", spec, device="cpu")
    assert row["meshShape"] == "data=1" and row["deviceCount"] == 1
    assert row["updateSharding"] is False
    assert row["optStateBytesPerReplica"] == 2 * 10 * 4


# -- the mesh, the estimators, the checkpoint --------------------------------------------

def test_mesh_api(monkeypatch, port_default_mesh):
    # the model and dcn axes: a mesh's shards are its data-axis positions
    tp = create_mesh((4, 2), ("data", "model"), devices=["cpu"] * 8)
    assert tp.size == 4 and tp.model_size == 2 and len(tp.grid) == 8
    hybrid = create_mesh((2, 4), ("dcn", "data"), devices=["cpu"] * 8)
    assert hybrid.size == 8 and mesh_mod.data_axes(hybrid) == ("dcn", "data")
    with pytest.raises(ValueError, match="axes"):
        create_mesh((8,), ("rows",), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="needs 8 devices"):
        create_mesh((8,), devices=["cpu"] * 4)
    mesh = port_mesh(8)
    assert mesh.size == 8 and mesh.shape == {"data": 8}
    assert mesh.device_count == 1 and mesh.local_shards == tuple(range(8))
    assert mesh_mod.data_axes(mesh) == ("data",)
    assert mesh_mod.data_shard_count(mesh) == 8
    # no card: the default mesh raises instead of falling back to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.default_mesh()
    assert mesh_mod.resolve_mesh(None, "cpu").devices == (torch.device("cpu"),)
    port_default_mesh(mesh)
    assert mesh_mod.default_mesh() is mesh is mesh_mod.local_mesh()
    assert mesh_mod.resolve_mesh(None, "cpu") is mesh
    other = port_mesh(2)
    assert mesh_mod.resolve_mesh(other, "cpu") is other
    with pytest.raises(ValueError, match="world_size and rank"):
        mesh_mod.init_distributed("file:///nowhere")


def test_estimator_mesh_is_a_runtime_setting(port_default_mesh):
    """``mesh=`` on an estimator; unset, the default mesh."""
    x, y = _sgd_data(5)
    table = Table.from_columns(features=x, label=y)
    plain = LogisticRegression(device="cpu", max_iter=4).fit(table)
    est = LogisticRegression(device="cpu", max_iter=4, mesh=port_mesh(8))
    assert est.mesh.size == 8
    eight = est.fit(table)
    assert est.last_execution_path == "torch-sgd"
    port_default_mesh(port_mesh(8))
    default = LogisticRegression(device="cpu", max_iter=4).fit(table)
    np.testing.assert_array_equal(default.coefficients, eight.coefficients)
    assert not np.array_equal(eight.coefficients, plain.coefficients)


def test_checkpoint_manager_roundtrips_sharded_carry(tmp_path):
    """A carry holding Sharded leaves saves their global view and restores
    each onto its template's layout: one tensor per shard again."""
    mesh = port_mesh(8)
    w = torch.arange(16, dtype=torch.float32)
    z, n = upd.place_opt_state(mesh, (torch.linspace(0, 1, 16),
                                      torch.full((16,), 2.0)))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    path = mgr.save((w, z, n), epoch=3)
    with np.load(os.path.join(path, "leaves.npz")) as leaves:
        np.testing.assert_array_equal(leaves["leaf_1"],
                                      z.global_view().numpy())
    template = (torch.zeros(16), *upd.place_opt_state(
        mesh, (torch.zeros(16), torch.zeros(16))))
    (w2, z2, n2), epoch = mgr.restore(template)
    assert epoch == 3 and torch.equal(w2, w)
    assert isinstance(z2, upd.Sharded) and len(z2.slices) == 8
    assert all(s.shape == (2,) for s in z2.slices)
    assert torch.equal(z2.global_view(), z.global_view())
    assert torch.equal(n2.global_view(), n.global_view())


# -- torch.distributed: two gloo ranks ------------------------------------------------

_RANK_PROGRAM = r"""
import os, sys
import numpy as np
import torch
from flink_ml_tpu_torch.ops import losses, optimizer
from flink_ml_tpu_torch.parallel import collective as C, mesh as M
from flink_ml_tpu_torch.parallel import update_sharding as U

rank, world, root = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
store = torch.distributed.FileStore(os.path.join(root, "store"), world)
assert M.init_distributed(store=store, world_size=world, rank=rank,
                          device="cpu", timeout_s=60)
mesh = M.default_mesh()
assert mesh.distributed and mesh.local_shards == (rank,)
assert M.local_mesh().size == 1 and not M.local_mesh().distributed
data = np.load(os.path.join(root, "inputs.npz"))
mine = torch.as_tensor(data["values"][rank])[None]
out = {
    "sum": C.all_reduce_sum(mine, mesh),
    "max": C.all_reduce_max(mine, mesh),
    "scatter": C.reduce_scatter(mine, mesh),
    "gather": C.all_gather(C.reduce_scatter(mine, mesh), mesh),
    "bcast": C.broadcast_from(mine, mesh, src=1),
    "vote": C.termination_vote(torch.tensor([rank]), mesh),
    "rows": C.ensure_on_mesh(mesh, data["x"]).parts[0],
}
prm = optimizer.SGDParams(**{k: v.item() for k, v in
                             np.load(os.path.join(root, "params.npz")).items()})
for mode in ("replicated", "sharded"):
    os.environ[U.ENV] = "1" if mode == "sharded" else "0"
    coeffs, loss = optimizer.SGD(prm).optimize(
        losses.BinaryLogisticLoss(), np.zeros(data["x"].shape[1]),
        data["x"], data["y"])
    out["coeffs_" + mode] = coeffs
np.savez(os.path.join(root, f"rank{rank}.npz"),
         **{k: np.asarray(v) for k, v in out.items()})
M.shutdown_distributed()
"""


def test_two_gloo_ranks_match_the_virtual_backend_and_jax(tmp_path):
    """Two ranks, each a fresh process (spawn) joined through a FileStore:
    the collectives equal the in-process backend's; an LR fit, in which
    each rank places only its shard's rows, gives one model on both ranks,
    the virtual two-shard fit's within rtol 1e-6 and the JAX two-device
    fit's within rtol 1e-5, replicated and sharded."""
    rng = np.random.default_rng(8)
    values = rng.normal(size=(2, 6)).astype(np.float32)
    x, y = _sgd_data(6)
    params = _sgd_params("adam", max_iter=5)
    np.savez(tmp_path / "inputs.npz", values=values, x=x, y=y)
    np.savez(tmp_path / "params.npz", **{k: np.asarray(v)
                                         for k, v in params.items()})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
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
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]

    mesh = port_mesh(2)
    stack = torch.as_tensor(values)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["sum"], C.all_reduce_sum(stack, mesh),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got["max"],
                                      C.all_reduce_max(stack, mesh))
        np.testing.assert_allclose(got["scatter"][0],
                                   C.reduce_scatter(stack, mesh)[r],
                                   rtol=1e-6)
        np.testing.assert_allclose(got["gather"], C.all_gather(
            C.reduce_scatter(stack, mesh), mesh), rtol=1e-6)
        np.testing.assert_array_equal(got["bcast"], values[1])
        assert not bool(got["vote"])
        np.testing.assert_array_equal(
            got["rows"], C.ensure_on_mesh(mesh, x).parts[r].numpy())
    for mode in MODES:
        key = "coeffs_" + mode
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
        os.environ.pop(upd.ENV, None)
        if mode == "sharded":
            os.environ[upd.ENV] = "1"
        try:
            virtual = optimizer.SGD(optimizer.SGDParams(**params)).optimize(
                losses.BinaryLogisticLoss(), np.zeros(SGD_D), x, y,
                mesh=mesh)[0]
            want = jax_opt.SGD(jax_opt.SGDParams(**params)).optimize(
                jax_losses.BinaryLogisticLoss(), np.zeros(SGD_D), x, y,
                mesh=jax_mesh(2))[0]
        finally:
            os.environ.pop(upd.ENV, None)
        np.testing.assert_allclose(ranks[0][key], virtual, rtol=1e-6,
                                   atol=1e-9)
        np.testing.assert_allclose(ranks[0][key], want, rtol=1e-5,
                                   atol=SGD_ATOL)
    assert json.dumps(sorted(ranks[0])) == json.dumps(sorted(ranks[1]))
