"""The port's iteration runtime (``flink_ml_tpu_torch/iteration``), held
against the JAX package and against itself.

The same inputs, made from numpy seeds, go through
``flink_ml_tpu.iteration.iterate_bounded`` and the JAX fits on a one-device
mesh, and through the port on CPU tensors (the kernels' plain versions).

- Against the JAX package: ``iterate_bounded`` in device, segment and host
  modes on the same body (float32 on both sides, the same operations: rtol
  1e-6); the LR and KMeans fits in segment and host modes, and fits resumed
  from the other package's mid-fit checkpoint, rtol 1e-5, atol 1e-7 (the
  reduce-order deviation of ROADMAP Queue 3); a checkpoint of the same
  carry leaf for leaf: order, dtype, shape and sha256.
- The port against itself, bit for bit: every mode against the all-device
  fit, and crash-and-resume through a crashing listener and through
  ``_CrashingManager``.
- Cases mirrored from tests/test_iteration.py, test_fault_injection.py and
  test_fusion.py: an off-phase restore realigns to the K-grid, the final
  boundary is not snapshotted, and a boundary costs one fetch (counted by
  wrapping ``read_boundary``).
"""

import collections
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.iteration import checkpoint as jax_ckpt
from flink_ml_tpu.iteration import iteration as jax_iter
from flink_ml_tpu.models.classification import (
    LogisticRegression as JaxLogisticRegression,
)
from flink_ml_tpu.models.clustering import KMeans as JaxKMeans
from flink_ml_tpu.parallel import create_mesh, set_default_mesh
from flink_ml_tpu.resilience import faults as jax_faults
from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.iteration import checkpoint, iteration, termination
from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager
from flink_ml_tpu_torch.iteration.iteration import (
    IterationConfig,
    IterationListener,
    iterate_bounded,
)
from flink_ml_tpu_torch.models.classification import LogisticRegression
from flink_ml_tpu_torch.models.clustering import KMeans
from flink_ml_tpu_torch.resilience import faults

BODY_RTOL = 1e-6
FIT_RTOL, FIT_ATOL = 1e-5, 1e-7
CHAOS_VARS = ("FLINK_ML_TPU_CHAOS", "FLINK_ML_TPU_CHAOS_SEED",
              "FLINK_ML_TPU_CHAOS_RATE", "FLINK_ML_TPU_CHAOS_SITES",
              "FLINK_ML_TPU_CHAOS_AT")


@pytest.fixture(autouse=True)
def _no_ambient_chaos(monkeypatch):
    """Each test injects its own crashes; ambient (env-armed) chaos would
    race them."""
    for var in CHAOS_VARS:
        monkeypatch.delenv(var, raising=False)
    faults.reset_env_plan()
    jax_faults.reset_env_plan()


@pytest.fixture
def one_device_mesh():
    set_default_mesh(create_mesh(devices=jax.devices()[:1]))
    try:
        yield
    finally:
        set_default_mesh(None)


class _Crash(Exception):
    pass


class _CrashAt(IterationListener):
    """The FailingMap analog: dies when a given round completes."""

    def __init__(self, at):
        self.at = at

    def on_epoch_watermark_incremented(self, epoch, carry):
        if epoch == self.at:
            raise _Crash()


class _CrashingManager(CheckpointManager):
    """Process death at a segment boundary: the save for ``crash_epoch``
    never lands, earlier snapshots remain."""

    def __init__(self, base_dir, crash_epoch):
        super().__init__(base_dir)
        self.crash_epoch = crash_epoch

    def save(self, carry, epoch):
        if epoch == self.crash_epoch:
            raise _Crash()
        return super().save(carry, epoch)


class _JaxCrashingManager(jax_ckpt.CheckpointManager):
    def __init__(self, base_dir, crash_epoch):
        super().__init__(base_dir)
        self.crash_epoch = crash_epoch

    def save(self, carry, epoch):
        if epoch == self.crash_epoch:
            raise _Crash()
        return super().save(carry, epoch)


# -- iterate_bounded -------------------------------------------------------------

def _decay_body(carry, epoch):
    w = carry["w"] * 0.7 + 0.001 * epoch
    return {"w": w, "loss": (w * w).sum()}


def _decay_init(seed=0):
    w = np.random.default_rng(seed).normal(size=5).astype(np.float32)
    return w, np.float32(np.inf)


def _port_config(mode, tmp_path):
    if mode == "device":
        return None
    if mode == "segment":
        return IterationConfig(checkpoint_interval=3, checkpoint_manager=(
            CheckpointManager(str(tmp_path / "port"))))
    return IterationConfig(mode="host", checkpoint_interval=2,
                           checkpoint_manager=CheckpointManager(
                               str(tmp_path / "port")))


def _jax_config(mode, tmp_path):
    if mode == "device":
        return None
    if mode == "segment":
        return jax_iter.IterationConfig(
            checkpoint_interval=3, checkpoint_manager=(
                jax_ckpt.CheckpointManager(str(tmp_path / "jax"))))
    return jax_iter.IterationConfig(
        mode="host", checkpoint_interval=2,
        checkpoint_manager=jax_ckpt.CheckpointManager(str(tmp_path / "jax")))


@pytest.mark.parametrize("mode", ["device", "segment", "host"])
@pytest.mark.parametrize("tol", [None, 0.05])
def test_iterate_bounded_matches_jax(tmp_path, mode, tol):
    w, loss = _decay_init()
    want = jax_iter.iterate_bounded(
        {"w": jnp.asarray(w), "loss": jnp.asarray(loss)}, _decay_body,
        max_iter=20, config=_jax_config(mode, tmp_path),
        terminate=None if tol is None else (lambda c, e: c["loss"] < tol))
    got = iterate_bounded(
        {"w": torch.as_tensor(w), "loss": torch.as_tensor(loss)},
        _decay_body, max_iter=20, config=_port_config(mode, tmp_path),
        terminate=None if tol is None else (lambda c, e: c["loss"] < tol))
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=BODY_RTOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=BODY_RTOL)
    if tol is not None:  # stopped at the first round below tol (epoch 3)
        assert tol * 0.7 ** 2 < float(got["loss"]) < tol


@pytest.mark.parametrize("mode", ["segment", "host"])
@pytest.mark.parametrize("tol", [None, 0.05])
def test_iterate_bounded_modes_equal_the_device_loop(tmp_path, mode, tol):
    w, loss = _decay_init(1)
    terminate = None if tol is None else (lambda c, e: c["loss"] < tol)

    def run(config):
        return iterate_bounded(
            {"w": torch.as_tensor(w), "loss": torch.as_tensor(loss)},
            _decay_body, max_iter=20, config=config,
            terminate=terminate)

    want, got = run(None), run(_port_config(mode, tmp_path))
    assert torch.equal(got["w"], want["w"])
    assert torch.equal(got["loss"], want["loss"])


def test_device_loop_max_iter():
    out = iterate_bounded(torch.tensor(0.0), lambda c, e: c + 1.0,
                          max_iter=10)
    assert float(out) == 10.0


def test_device_loop_takes_host_leaves_as_tensors():
    out = iterate_bounded(np.float32(1.0), lambda c, e: c * 2.0 + 1.0,
                          max_iter=6, device="cpu")
    assert isinstance(out, torch.Tensor) and float(out) == 127.0
    assert out.device.type == "cpu"


@pytest.mark.parametrize("mode", ["device", "segment"])
def test_host_carry_defaults_to_the_card(tmp_path, monkeypatch, mode):
    """A carry with no tensor leaf goes to the default device, the card, as
    every entry point of the port does: without a card the device modes
    raise and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        iterate_bounded(np.float32(1.0), lambda c, e: c + 1.0, max_iter=3,
                        config=_port_config(mode, tmp_path))


def test_listeners_epoch_callbacks():
    events = []

    class Listener(IterationListener):
        def on_epoch_watermark_incremented(self, epoch, carry):
            events.append(("epoch", epoch, float(carry)))

        def on_iteration_terminated(self, carry):
            events.append(("done", None, float(carry)))

    iterate_bounded(torch.tensor(0.0), lambda c, e: c + 1, max_iter=3,
                    config=IterationConfig(mode="host"),
                    listeners=[Listener()])
    assert events == [("epoch", 0, 1.0), ("epoch", 1, 2.0), ("epoch", 2, 3.0),
                      ("done", None, 3.0)]


def test_per_round_lifecycle():
    # PER_ROUND parity: the scratch part of the carry is made anew each round
    def per_round_init(carry, epoch):
        return {**carry, "scratch": torch.tensor(0.0)}

    def body(carry, epoch):
        return {"acc": carry["acc"] + carry["scratch"] + 1.0,
                "scratch": carry["scratch"] + 100.0}

    out = iterate_bounded(
        {"acc": torch.tensor(0.0), "scratch": torch.tensor(0.0)}, body,
        max_iter=5,
        config=IterationConfig(mode="host", per_round_init=per_round_init))
    assert float(out["acc"]) == 5.0


def test_host_body_and_host_stop():
    """``jit_round=False``: a numpy body in the host loop, its stop read at
    once; the device modes never run it."""
    seen = []

    def body(carry, epoch):
        seen.append(type(carry))
        return carry * 0.5

    out = iterate_bounded(np.float64(1.0), body, max_iter=50,
                          terminate=lambda c, e: c < 0.1, jit_round=False)
    assert out == 0.0625 and seen == [np.float64] * 4


def test_checkpoint_resume_identical_result(tmp_path):
    """Kill the host loop mid-iteration, resume from the checkpoint: the
    result is the uninterrupted one, bit for bit."""
    def body(carry, epoch):
        return carry * 1.5 + float(epoch)

    expected = iterate_bounded(torch.tensor(1.0), body, max_iter=10,
                               config=IterationConfig(mode="host"))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    cfg = IterationConfig(mode="host", checkpoint_interval=2,
                          checkpoint_manager=mgr)
    with pytest.raises(_Crash):
        iterate_bounded(torch.tensor(1.0), body, max_iter=10, config=cfg,
                        listeners=[_CrashAt(5)])
    assert mgr.list_checkpoints() == ["ckpt-00000002", "ckpt-00000004"]
    resumed = iterate_bounded(torch.tensor(1.0), body, max_iter=10,
                              config=cfg)
    assert torch.equal(resumed, expected)
    assert mgr.list_checkpoints() == []


def test_invalid_iteration_mode_rejected():
    with pytest.raises(ValueError, match="mode"):
        IterationConfig(mode="bogus")


def test_dispatch_predicates_match_jax(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "a"))
    jmgr = jax_ckpt.CheckpointManager(str(tmp_path / "b"))
    cases = [dict(), dict(mode="host"), dict(checkpoint_interval=3),
             dict(checkpoint_interval=3, checkpoint_manager=True),
             dict(mode="host", checkpoint_interval=3,
                  checkpoint_manager=True),
             dict(checkpoint_interval=3, checkpoint_manager=True,
                  per_round_init=lambda c, e: c)]
    for case in cases:
        for listeners in ((), (IterationListener(),)):
            port = IterationConfig(**{
                k: (mgr if v is True else v) for k, v in case.items()})
            ref = jax_iter.IterationConfig(**{
                k: (jmgr if v is True else v) for k, v in case.items()})
            jl = tuple(jax_iter.IterationListener() for _ in listeners)
            assert iteration.needs_host_loop(port, listeners) == \
                jax_iter.needs_host_loop(ref, jl), case
            assert iteration.device_checkpoint_segment(port, listeners) == \
                jax_iter.device_checkpoint_segment(ref, jl), case


@pytest.mark.parametrize("make,value,want", [
    (lambda: termination.terminate_on_max_iter(5), 0.0, [False, True]),
    (lambda: termination.terminate_on_max_iter_or_tol(0.5), 0.25,
     [True, True]),
    (lambda: termination.terminate_on_max_iter_or_tol(
        0.5, loss_fn=lambda c: c * 4), 0.25, [False, False]),
    (lambda: termination.terminate_on_empty_round(lambda c: c), 0.0,
     [True, True]),
])
def test_termination_predicates_are_bool_tensors(make, value, want):
    predicate = make()
    got = [predicate(torch.tensor(value), epoch) for epoch in (3, 4)]
    assert all(isinstance(g, torch.Tensor) and g.dtype == torch.bool
               and g.dim() == 0 for g in got)
    assert [bool(g) for g in got] == want
    assert termination.forward_inputs_of_last_round(7, lambda c: c + 1) == 8


# -- the carry's pytree and the checkpoint format ------------------------------

_Pair = collections.namedtuple("_Pair", "a b")

TREES = {
    "sgd-carry": lambda: (np.float32([1, 2]), np.int32([3]), np.float32(4),
                          ()),
    "adam-carry": lambda: (np.float32([1, 2]), np.int32([0]), np.float32(4),
                           (np.float32([5, 6]), np.float32([7, 8]),
                            np.float32(9))),
    "dict-unsorted": lambda: {"z": np.float32(1), "a": [np.int64(2), None],
                              "m": {"y": 3.0, "b": (4, 5)}},
    "namedtuple-and-none": lambda: [_Pair(np.arange(3), None), None,
                                    (True, np.float64(2.5))],
    "ordered-dict": lambda: collections.OrderedDict(
        [("z", np.ones(2)), ("a", np.zeros(1))]),
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_tree_flatten_follows_jax_leaf_order(name):
    tree = TREES[name]()
    leaves, treedef = checkpoint.tree_flatten(tree)
    want, _ = jax.tree_util.tree_flatten(tree)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert a is b
    rebuilt = treedef.unflatten(leaves)
    assert jax.tree_util.tree_structure(rebuilt) == \
        jax.tree_util.tree_structure(tree)


def test_tree_unflatten_checks_the_leaf_count():
    _, treedef = checkpoint.tree_flatten((1, (2, 3)))
    with pytest.raises(ValueError, match="fewer"):
        treedef.unflatten([1, 2])
    with pytest.raises(ValueError, match="more"):
        treedef.unflatten([1, 2, 3, 4])


def _manifest_and_leaves(path):
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "leaves.npz")) as z:
        leaves = {k: z[k] for k in z.files}
    return manifest, leaves


@pytest.mark.parametrize("name", sorted(TREES))
def test_same_carry_gives_the_same_checkpoint_in_both_packages(tmp_path,
                                                               name):
    tree = TREES[name]()
    # the port saves tensors where the JAX package saves device arrays
    port_tree = jax.tree_util.tree_map(
        lambda x: torch.as_tensor(x) if isinstance(x, np.ndarray) else x,
        tree)
    jax_path = jax_ckpt.CheckpointManager(str(tmp_path / "jax")).save(tree, 3)
    port_path = CheckpointManager(str(tmp_path / "port")).save(port_tree, 3)
    jax_manifest, jax_leaves = _manifest_and_leaves(jax_path)
    port_manifest, port_leaves = _manifest_and_leaves(port_path)
    assert port_manifest == jax_manifest
    assert sorted(port_leaves) == sorted(jax_leaves)
    for key in jax_leaves:
        assert port_leaves[key].dtype == jax_leaves[key].dtype
        np.testing.assert_array_equal(port_leaves[key], jax_leaves[key])


def test_restore_places_leaves_on_the_template(tmp_path):
    """A tensor template leaf gets a tensor of its dtype and device; a numpy
    or Python leaf gets the host array as it is."""
    mgr = CheckpointManager(str(tmp_path))
    host = np.arange(3, dtype=np.float64)
    placed = mgr._place(host, torch.zeros(3, dtype=torch.float32))
    assert isinstance(placed, torch.Tensor) and placed.dtype == torch.float32
    assert mgr._place(host, np.zeros(3)) is host
    assert mgr._place(np.asarray(7), 0) == 7


def test_checkpoint_manager_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for e in range(5):
        mgr.save({"x": torch.arange(3.0)}, e)
    assert len(mgr.list_checkpoints()) == 2
    restored, epoch = mgr.restore({"x": torch.zeros(3)})
    assert epoch == 4
    assert torch.equal(restored["x"], torch.arange(3.0))


def test_restore_repads_dim0_when_asked(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), repad_dim0=True)
    mgr.save((torch.tensor([1.0, 2.0, 0.0, 0.0]), np.int32([4])), 2)
    (coeffs, offsets), epoch = mgr.restore((torch.zeros(2), np.int32([0])))
    assert epoch == 2 and torch.equal(coeffs, torch.tensor([1.0, 2.0]))
    assert offsets.dtype == np.int32


# -- the fits in every mode ------------------------------------------------------

def _lr_table(table_cls, seed=3):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=(300, 5)),
                        rng.normal(size=(300, 5)) + 2]).astype(np.float32)
    y = np.concatenate([np.zeros(300), np.ones(300)]).astype(np.float32)
    return table_cls.from_columns(features=x, label=y)


def _km_table(table_cls, seed=4):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=(100, 3)),
                        rng.normal(size=(100, 3)) + 6,
                        rng.normal(size=(60, 3)) - 6]).astype(np.float32)
    return table_cls.from_columns(features=x)


LR_PARAMS = dict(max_iter=12, global_batch_size=200, learning_rate=0.1)
KM_PARAMS = dict(k=3, seed=7, max_iter=8)


def _port(model, **overrides):
    if model == "lr":
        return LogisticRegression(device="cpu", **dict(LR_PARAMS, **overrides))
    return KMeans(device="cpu", **dict(KM_PARAMS, **overrides))


def _jax(model, **overrides):
    if model == "lr":
        return JaxLogisticRegression(**dict(LR_PARAMS, **overrides))
    return JaxKMeans(**dict(KM_PARAMS, **overrides))


def _table(model, table_cls):
    return (_lr_table if model == "lr" else _km_table)(table_cls)


def _result(model, fitted):
    return fitted.coefficients if model == "lr" else fitted.centroids


def _configs(cls_config, cls_mgr, base):
    return {"segment": lambda: cls_config(
                checkpoint_interval=3, checkpoint_manager=cls_mgr(base)),
            "host": lambda: cls_config(mode="host"),
            "host-checkpointed": lambda: cls_config(
                mode="host", checkpoint_interval=2,
                checkpoint_manager=cls_mgr(base))}


FIT_MODES = ["segment", "host", "host-checkpointed"]
PATHS = {("lr", "segment"): "torch-sgd-segments",
         ("lr", "host"): "torch-sgd-rounds",
         ("lr", "host-checkpointed"): "torch-sgd-rounds",
         ("km", "segment"): "torch-lloyd-segments",
         ("km", "host"): "torch-lloyd-rounds",
         ("km", "host-checkpointed"): "torch-lloyd-rounds"}


@pytest.mark.parametrize("model", ["lr", "km"])
@pytest.mark.parametrize("mode", FIT_MODES)
def test_fit_modes_match_jax_and_the_all_device_fit(one_device_mesh,
                                                    tmp_path, model, mode):
    port_cfg = _configs(IterationConfig, CheckpointManager,
                        str(tmp_path / "port"))[mode]()
    jax_cfg = _configs(jax_iter.IterationConfig, jax_ckpt.CheckpointManager,
                       str(tmp_path / "jax"))[mode]()
    plain = _port(model).fit(_table(model, Table))
    est = _port(model).set_iteration_config(port_cfg)
    got = est.fit(_table(model, Table))
    assert est.last_execution_path == PATHS[model, mode]
    np.testing.assert_array_equal(_result(model, got), _result(model, plain))
    if model == "km":
        np.testing.assert_array_equal(got.weights, plain.weights)
    want = _jax(model).set_iteration_config(jax_cfg).fit(
        _table(model, JaxTable))
    np.testing.assert_allclose(_result(model, got), _result(model, want),
                               rtol=FIT_RTOL, atol=FIT_ATOL)
    if port_cfg.checkpoint_manager is not None:
        assert port_cfg.checkpoint_manager.list_checkpoints() == []


@pytest.mark.parametrize("method", ["momentum", "adam"])
def test_stateful_rules_resume_bit_identical(tmp_path, method):
    """The opt moments ride at the end of the carry, and a resumed segment
    fit of each stateful rule ends with the all-device fit's bits."""
    plain = _port("lr", optimizer=method).fit(_lr_table(Table))
    bad = _CrashingManager(str(tmp_path / "ckpt"), crash_epoch=9)
    with pytest.raises(_Crash):
        _port("lr", optimizer=method).set_iteration_config(IterationConfig(
            checkpoint_interval=3, checkpoint_manager=bad)).fit(
            _lr_table(Table))
    with np.load(tmp_path / "ckpt" / "ckpt-00000006" / "leaves.npz") as z:
        assert len(z.files) == 3 + {"momentum": 1, "adam": 3}[method]
    resumed = _port("lr", optimizer=method).set_iteration_config(
        IterationConfig(checkpoint_interval=3, checkpoint_manager=(
            CheckpointManager(str(tmp_path / "ckpt"))))).fit(_lr_table(Table))
    np.testing.assert_array_equal(resumed.coefficients, plain.coefficients)


@pytest.mark.parametrize("model", ["lr", "km"])
def test_listener_crash_resume_is_bit_identical(tmp_path, model):
    expected = _result(model, _port(model).fit(_table(model, Table)))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    cfg = IterationConfig(mode="host", checkpoint_interval=2,
                          checkpoint_manager=mgr)
    with pytest.raises(_Crash):
        _port(model).set_iteration_config(
            cfg, listeners=[_CrashAt(5)]).fit(_table(model, Table))
    assert mgr.list_checkpoints()  # restart point survives
    resumed = _port(model).set_iteration_config(cfg).fit(
        _table(model, Table))
    np.testing.assert_array_equal(_result(model, resumed), expected)


@pytest.mark.parametrize("model,k,crash", [("lr", 2, 8), ("km", 3, 6)])
def test_segment_crash_resume_is_bit_identical(tmp_path, model, k, crash):
    expected = _result(model, _port(model).fit(_table(model, Table)))
    bad = _CrashingManager(str(tmp_path / "ckpt"), crash_epoch=crash)
    with pytest.raises(_Crash):
        _port(model).set_iteration_config(IterationConfig(
            checkpoint_interval=k, checkpoint_manager=bad)).fit(
            _table(model, Table))
    assert bad.list_checkpoints()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    resumed = _port(model).set_iteration_config(IterationConfig(
        checkpoint_interval=k, checkpoint_manager=mgr)).fit(
        _table(model, Table))
    np.testing.assert_array_equal(_result(model, resumed), expected)
    assert not mgr.list_checkpoints()  # the completed fit cleared


@pytest.mark.parametrize("model,writer", [("lr", "jax"), ("lr", "port"),
                                          ("km", "jax"), ("km", "port")])
def test_checkpoint_written_by_one_package_resumes_in_the_other(
        one_device_mesh, tmp_path, model, writer):
    """A fit killed mid-way leaves its snapshots; the other package resumes
    from the newest and ends within the tolerance of the writer's
    uninterrupted fit. The snapshots hold the same leaves in both
    packages."""
    crash, k = (8, 2) if model == "lr" else (6, 3)
    base = str(tmp_path / "ckpt")
    if writer == "jax":
        bad = _JaxCrashingManager(base, crash)
        writer_est, writer_table = _jax(model), _table(model, JaxTable)
        cfg_cls, reader = jax_iter.IterationConfig, _port(model)
        reader_table, reader_cfg = _table(model, Table), IterationConfig
        reader_mgr = CheckpointManager(base)
    else:
        bad = _CrashingManager(base, crash)
        writer_est, writer_table = _port(model), _table(model, Table)
        cfg_cls, reader = IterationConfig, _jax(model)
        reader_table, reader_cfg = (_table(model, JaxTable),
                                    jax_iter.IterationConfig)
        reader_mgr = jax_ckpt.CheckpointManager(base)
    with pytest.raises(_Crash):
        writer_est.set_iteration_config(cfg_cls(
            checkpoint_interval=k, checkpoint_manager=bad)).fit(writer_table)
    newest = os.path.join(base, bad.list_checkpoints()[-1])
    manifest, leaves = _manifest_and_leaves(newest)
    assert manifest["version"] == 2 and manifest["epoch"] == crash - k
    layout = [(r["dtype"], r["shape"]) for r in manifest["leaves"]]
    assert layout == ([("float32", [5]), ("int32", [1]), ("float32", [])]
                      if model == "lr" else
                      [("float32", [3, 3]), ("float32", [3])])
    want = _result(model, writer_est.set_iteration_config(None).fit(
        writer_table))
    got = _result(model, reader.set_iteration_config(reader_cfg(
        checkpoint_interval=k, checkpoint_manager=reader_mgr)).fit(
        reader_table))
    np.testing.assert_allclose(got, want, rtol=FIT_RTOL, atol=FIT_ATOL)


def test_tol_stop_inside_a_segment(tmp_path):
    """An early tol stop inside a segment equals the all-device fit, and
    saves no checkpoint after the stop."""
    expected = _port("lr", tol=0.5).fit(_lr_table(Table))
    saved = []

    class Spy(CheckpointManager):
        def save(self, carry, epoch):
            saved.append(epoch)
            return super().save(carry, epoch)

    est = _port("lr", tol=0.5).set_iteration_config(IterationConfig(
        checkpoint_interval=5, checkpoint_manager=Spy(str(tmp_path / "c"))))
    got = est.fit(_lr_table(Table))
    np.testing.assert_array_equal(got.coefficients, expected.coefficients)
    assert saved == []  # the stop came inside the first segment


def test_segment_resume_realigns_off_phase_checkpoint(tmp_path):
    """A restore off the K-grid (a snapshot of another interval) realigns:
    later boundaries checkpoint on-grid, and the final boundary saves
    nothing."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    with pytest.raises(_Crash):
        _port("lr").set_iteration_config(IterationConfig(
            mode="host", checkpoint_interval=5, checkpoint_manager=mgr),
            listeners=[_CrashAt(5)]).fit(_lr_table(Table))
    assert mgr.list_checkpoints() == ["ckpt-00000005"]
    saved = []

    class Recording(CheckpointManager):
        def save(self, carry, epoch):
            saved.append(epoch)
            return super().save(carry, epoch)

    resumed = _port("lr").set_iteration_config(IterationConfig(
        checkpoint_interval=2, checkpoint_manager=Recording(
            str(tmp_path / "ckpt")))).fit(_lr_table(Table))
    assert saved == [6, 8, 10]
    expected = _port("lr").fit(_lr_table(Table))
    np.testing.assert_array_equal(resumed.coefficients, expected.coefficients)


def test_final_boundary_snapshot_skipped(tmp_path):
    saved = []

    class Spy(CheckpointManager):
        def save(self, carry, epoch):
            saved.append(epoch)
            return super().save(carry, epoch)

    def run_segment(carry, epoch0, limit):
        for e in range(epoch0, limit):
            carry = carry * 1.5 + e
        return carry, limit, False

    mgr = Spy(str(tmp_path / "ckpt"))
    iteration.run_segmented(run_segment, np.float64(1.0), 12, 4, mgr)
    assert saved == [4, 8]  # boundaries 4, 8, 12: the final one saves nothing
    assert mgr.list_checkpoints() == []


@pytest.mark.parametrize("model,k,boundaries", [("lr", 3, 4), ("lr", 5, 3),
                                                ("km", 3, 3), ("km", 8, 1)])
def test_one_fetch_per_boundary(tmp_path, monkeypatch, model, k, boundaries):
    """Each segment boundary costs one device→host transfer: one
    ``read_boundary`` call on one stacked int32 [epoch, stop] tensor."""
    real = iteration.read_boundary
    fetched = []

    def counting(boundary):
        assert isinstance(boundary, torch.Tensor)
        assert boundary.dtype == torch.int32 and boundary.shape == (2,)
        fetched.append(tuple(int(v) for v in boundary))
        return real(boundary)

    monkeypatch.setattr(iteration, "read_boundary", counting)
    _port(model).set_iteration_config(IterationConfig(
        checkpoint_interval=k, checkpoint_manager=CheckpointManager(
            str(tmp_path / "ckpt")))).fit(_table(model, Table))
    max_iter = (LR_PARAMS if model == "lr" else KM_PARAMS)["max_iter"]
    assert len(fetched) == boundaries
    assert [e for e, _ in fetched] == [min(k * (i + 1), max_iter)
                                       for i in range(boundaries)]
    assert all(s == 0 for _, s in fetched)
