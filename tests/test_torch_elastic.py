"""The port's multi-process runtime (``parallel/distributed.py``) and elastic
recovery (``parallel/elastic.py``) against the JAX package.

Pure functions run in both packages on the same inputs: the env helpers,
``repad_or_rescale``, ``RoundParticipation``'s decisions on one ``ready_ms``
sequence, ``wait_with_deadline`` naming the stale process. The launcher and
``run_elastic`` start CPU ranks on gloo (each a fresh interpreter, 60 s
timeout each): a crash is reported within the child grace, a two-rank LR fit
that loses rank 1 at a boundary shrinks to one rank and resumes bit for bit
like a one-rank fit resumed from the same checkpoint, and two ranks of two
virtual shards each fit on a ``(dcn, data)`` mesh with the flat and the
two-level sum. The sharded-adam checkpoints re-place across N (4→2, 2→1)
as the JAX package's ``tests/test_elastic.py:349-404`` pins, resumed from
the JAX package's own snapshot.
"""

import glob
import json
import os
import shutil
import sys
import time

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu.iteration.checkpoint import CorruptCheckpoint as JaxCorrupt
from flink_ml_tpu.iteration.iteration import IterationConfig as JaxConfig
from flink_ml_tpu.parallel import distributed as jax_dist
from flink_ml_tpu.parallel import elastic as jax_elastic
from flink_ml_tpu.parallel import update_sharding as jax_upd
from flink_ml_tpu.resilience import InjectedFault as JaxInjected
from flink_ml_tpu.resilience import faults as jax_faults

from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.iteration import IterationConfig
from flink_ml_tpu_torch.iteration.checkpoint import CorruptCheckpoint
from flink_ml_tpu_torch.models.classification import LogisticRegression
from flink_ml_tpu_torch.observability import fleet, tracing
from flink_ml_tpu_torch.parallel import create_mesh
from flink_ml_tpu_torch.parallel import distributed as dist
from flink_ml_tpu_torch.parallel import elastic
from flink_ml_tpu_torch.parallel import update_sharding as upd
from flink_ml_tpu_torch.resilience import (RestartsExhausted, RetryPolicy,
                                           faults)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "port_elastic_worker.py")
# the ranks' tables are tiny: one intra-op thread a rank keeps the
# concurrent ranks from oversubscribing the host's cores
CHILD_ENV = {"PYTHONPATH": os.pathsep.join(
    [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
              if p]), "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True)
def _clean_stats():
    elastic.reset_stats()
    jax_elastic.reset_stats()
    yield
    elastic.reset_stats()
    jax_elastic.reset_stats()


@pytest.fixture
def pkg_env(monkeypatch):
    """Set one env var for both packages (they read the same names)."""
    def set_env(name, value):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    return set_env


# -- distributed.py: env mapping, process helpers, build_mesh ----------------

def test_env_names_are_the_jax_packages():
    for name in ("COORDINATOR_ENV", "NUM_PROCESSES_ENV", "PROCESS_ID_ENV",
                 "LOCAL_DEVICES_ENV"):
        assert getattr(dist, name) == getattr(jax_dist, name)
    for name in ("COLLECTIVE_TIMEOUT_ENV", "ROUND_DEADLINE_ENV",
                 "HEARTBEAT_DIR_ENV", "CHAOS_VICTIM_ENV", "CHAOS_HANG_ENV",
                 "ATTEMPT_ENV"):
        assert getattr(elastic, name) == getattr(jax_elastic, name)
    assert set(faults.SITES) == set(jax_faults.SITES)


@pytest.mark.parametrize("count,index", [(None, None), ("4", "2"),
                                         ("banana", ""), ("1", "0")])
def test_process_helpers_match_jax(pkg_env, count, index):
    pkg_env(dist.NUM_PROCESSES_ENV, count)
    pkg_env(dist.PROCESS_ID_ENV, index)
    assert dist.process_count() == jax_dist.process_count()
    assert dist.process_index() == jax_dist.process_index()
    assert dist.process_label() == jax_dist.process_label()


def test_init_distributed_unconfigured_is_noop(pkg_env):
    for var in (dist.COORDINATOR_ENV, dist.NUM_PROCESSES_ENV,
                dist.PROCESS_ID_ENV, dist.LOCAL_DEVICES_ENV):
        pkg_env(var, None)
    assert dist.init_distributed() is False
    assert dist.init_from_env() is False  # idempotent
    # a world of one, even with a coordinator: no group
    assert dist.init_distributed("127.0.0.1:1", num_processes=1,
                                 process_id=0) is False
    assert not torch.distributed.is_initialized()


def test_build_mesh_single_process(pkg_env):
    pkg_env(dist.DEVICE_ENV, "cpu")
    pkg_env(dist.LOCAL_DEVICES_ENV, "3")
    mesh = dist.build_mesh()
    assert mesh.axis_names == ("data",) and mesh.size == 3
    assert not mesh.distributed and mesh.devices[0].type == "cpu"
    assert dist.build_mesh(local_axis=2).size == 2


def test_launch_sets_the_env_mapping():
    records = dist.launch(
        [sys.executable, "-c",
         "import os; print(os.environ['FLINK_ML_TPU_PROCESS_ID'], "
         "os.environ['FLINK_ML_TPU_DIST_DEVICE'], "
         "os.environ['FLINK_ML_TPU_DIST_BACKEND'], "
         "os.environ['FLINK_ML_TPU_LOCAL_DEVICES'], "
         "os.environ['FLINK_ML_TPU_TRACE_PARENT'] != '', "
         "os.environ['FLINK_ML_TPU_COORDINATOR'][:7])"],
        num_processes=2, local_devices=3, timeout=60.0, device="cpu")
    assert [r["returncode"] for r in records] == [0, 0]
    for pid, rec in enumerate(records):
        # a rendezvous file: no TCP port picked ahead of its bind
        assert rec["stdout"].split() == [str(pid), "cpu", "gloo", "3",
                                         "True", "file://"]


CRASH_THEN_WEDGE = """
import os, sys, time
pid = int(os.environ["FLINK_ML_TPU_PROCESS_ID"])
if pid == 0:
    sys.exit(1)
time.sleep(60)
"""


def test_launch_child_grace_reports_crash_early():
    t0 = time.monotonic()
    records = dist.launch([sys.executable, "-c", CRASH_THEN_WEDGE], 2,
                          timeout=60.0, child_grace_s=1.5, device="cpu")
    assert time.monotonic() - t0 < 30.0  # not held to the full timeout
    assert records[0]["returncode"] == 1
    assert records[0]["exitOrder"] == 0  # the crash was seen first
    assert records[1]["returncode"] < 0  # the wedged sibling was killed


def test_launch_main_prefixes_output(capsys):
    rc = dist.main(["-n", "2", "--device", "cpu", "--timeout", "60", "--",
                    sys.executable, "-c", "print('hi')"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert sorted(out) == ["[p0:out] hi", "[p1:out] hi"]


# -- repad / rescale ----------------------------------------------------------

@pytest.mark.parametrize("host,target", [
    (np.arange(6, dtype=np.float32), (6,)),
    (np.r_[np.arange(1.0, 5.0), 0.0, 0.0].astype(np.float32), (4,)),
    (np.arange(1.0, 4.0, dtype=np.float32), (8,)),
    (np.full(4, 6, np.int32), (2,)),
    (np.full(2, 10, np.int32), (1,)),
    (np.full(1, 12, np.int32), (3,)),
    (np.ones((6, 2), np.float64), (4, 2))])
def test_repad_or_rescale_matches_jax(host, target):
    def run(fn):
        try:
            return fn(host, target)
        except (CorruptCheckpoint, JaxCorrupt) as e:
            return type(e).__name__

    got, want = run(elastic.repad_or_rescale), run(
        jax_elastic.repad_or_rescale)
    if isinstance(want, str):
        assert got == want
    else:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("host,target", [
    (np.array([3, 4], np.int32), (1,)),      # not uniform
    (np.full(3, 5, np.int32), (2,)),         # does not divide
    (np.ones((4, 3)), (4, 2))])              # not dim 0
def test_repad_or_rescale_refusals_match_jax(host, target):
    with pytest.raises(CorruptCheckpoint):
        elastic.repad_or_rescale(host, target)
    with pytest.raises(JaxCorrupt):
        jax_elastic.repad_or_rescale(host, target)


# -- RoundParticipation -------------------------------------------------------

TIMINGS = [[10, 11, 12, 13], [10, 11, 180, 13], [10, 11, 180, 13],
           [10, 11, 180, 13], [300, 300, 300, 300], [10, 400, 10, 10]]


@pytest.mark.parametrize("deadline,staleness", [(100.0, 2), (100.0, 3),
                                                (None, 3), (5.0, 1)])
def test_round_participation_matches_jax(deadline, staleness, pkg_env):
    pkg_env(elastic.ROUND_DEADLINE_ENV, None)
    port = elastic.RoundParticipation(4, deadline_ms=deadline,
                                      max_staleness=staleness)
    ref = jax_elastic.RoundParticipation(4, deadline_ms=deadline,
                                         max_staleness=staleness)
    for rnd, t in enumerate(TIMINGS):
        assert port.decide(rnd).tolist() == ref.decide(rnd).tolist()
        port.observe(t)
        ref.observe(t)
    assert port.decide(9).tolist() == ref.decide(9).tolist()
    assert port.dropped_rounds == ref.dropped_rounds
    assert port.participation_min == ref.participation_min
    assert elastic.provenance() == jax_elastic.provenance()
    with pytest.raises(ValueError, match="4 per-shard"):
        port.observe([1.0])


# -- detection: heartbeats and the watchdog -----------------------------------

def test_beat_and_stale_processes(pkg_env, tmp_path):
    pkg_env(elastic.HEARTBEAT_DIR_ENV, str(tmp_path))
    elastic.beat(epoch=3)
    beacons = glob.glob(str(tmp_path / "fleet-*.json"))
    assert len(beacons) == 1
    raw = json.loads(open(beacons[0]).read())
    assert raw["epoch"] == 3 and raw["role"] == "trainer"
    assert elastic.stale_processes(30.0, num_processes=3) == \
        jax_elastic.stale_processes(30.0, num_processes=3) == [1, 2]
    raw["time"] = time.time() - 120.0
    with open(beacons[0], "w") as f:
        json.dump(raw, f)
    assert elastic.stale_processes(30.0, num_processes=3) == [0, 1, 2]
    pkg_env(elastic.HEARTBEAT_DIR_ENV, None)
    assert elastic.stale_processes(1.0, num_processes=4) == []


def test_guard_fetch_noop_without_deadline(pkg_env):
    pkg_env(elastic.COLLECTIVE_TIMEOUT_ENV, None)
    tree = {"a": torch.ones(3)}
    assert elastic.guard_fetch(tree) is tree
    pkg_env(elastic.COLLECTIVE_TIMEOUT_ENV, "5")
    assert elastic.guard_fetch(tree) is tree  # a fast tree passes


def test_wait_with_deadline_names_the_stale_process(monkeypatch, pkg_env,
                                                    tmp_path):
    """A three-process world whose process 2 went stale: both packages
    name it (0 and 1 get future stamps so the short deadline cannot age
    them out mid-wait)."""
    pkg_env(dist.NUM_PROCESSES_ENV, "3")
    pkg_env(elastic.HEARTBEAT_DIR_ENV, str(tmp_path))
    now = time.time()
    for k, stamp in ((0, now + 30.0), (1, now + 30.0), (2, now - 120.0)):
        (tmp_path / f"fleet-p{k}-{1000 + k}.json").write_text(json.dumps(
            {"schema": 1, "time": stamp, "pid": 1000 + k, "process": k,
             "processIndex": k}))
    monkeypatch.setattr(elastic, "_block_until_ready",
                        lambda tree: time.sleep(2.0))
    monkeypatch.setattr(jax, "block_until_ready",
                        lambda tree: time.sleep(2.0))
    for mod in (elastic, jax_elastic):
        with pytest.raises(Exception, match="process 2") as ei:
            mod.wait_with_deadline({"x": 1}, 0.2, what="segment")
        assert ei.value.process_index == 2
    assert isinstance(ei.value, Exception)
    assert elastic.provenance() == jax_elastic.provenance() == {
        "elasticEvents": 1, "participationMin": 1.0}


def test_wait_with_deadline_reraises_worker_errors(monkeypatch):
    def boom(tree):
        raise ValueError("device melted")

    monkeypatch.setattr(elastic, "_block_until_ready", boom)
    with pytest.raises(ValueError, match="melted"):
        elastic.wait_with_deadline({"x": 1}, 5.0)


def test_iteration_drivers_call_the_hooks(monkeypatch, pkg_env, tmp_path):
    """Segments: one guarded boundary fetch and one on_boundary per
    segment; host rounds: one guarded stop bit and one on_boundary per
    round. The armed deadline lets a healthy fit through."""
    from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager

    pkg_env(elastic.COLLECTIVE_TIMEOUT_ENV, "30")
    seen = {"guard": [], "boundary": []}
    real_guard = elastic.guard_fetch
    monkeypatch.setattr(elastic, "guard_fetch", lambda t, what="": (
        seen["guard"].append(what) or real_guard(t, what)))
    monkeypatch.setattr(elastic, "on_boundary",
                        lambda epoch=None: seen["boundary"].append(epoch))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(200, 3))
    table = Table.from_columns(features=x, label=(x[:, 0] > 0) * 1.0)
    LogisticRegression(device="cpu", max_iter=6).set_iteration_config(
        IterationConfig(checkpoint_interval=3, checkpoint_manager=(
            CheckpointManager(str(tmp_path / "a"))))).fit(table)
    assert seen == {"guard": ["segment boundary"] * 2, "boundary": [3, 6]}
    seen["guard"].clear()
    seen["boundary"].clear()
    LogisticRegression(device="cpu", max_iter=3).set_iteration_config(
        IterationConfig(mode="host")).fit(table)
    assert seen == {"guard": ["round stop bit"] * 3, "boundary": [0, 1, 2]}


def test_chaos_sites_only_act_across_processes(pkg_env, monkeypatch):
    """worker-loss / worker-hang never fire in one process; across
    processes only the victim acts, and every process advances the same
    schedule."""
    acted = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: acted.append(sig))
    monkeypatch.setattr(time, "sleep", lambda s: acted.append(s))
    pkg_env(dist.NUM_PROCESSES_ENV, None)
    with faults.chaos(at={"worker-loss": [1], "worker-hang": [1]}) as plan:
        elastic.on_boundary(0)
    assert acted == [] and plan._counts == {}
    pkg_env(dist.NUM_PROCESSES_ENV, "2")
    pkg_env(elastic.CHAOS_HANG_ENV, "7")
    for me, want in (("0", []), ("1", [9, 7.0])):
        pkg_env(dist.PROCESS_ID_ENV, me)
        acted.clear()
        with faults.chaos(at={"worker-loss": [2], "worker-hang": [2]}):
            elastic.on_boundary(0)
            elastic.on_boundary(1)
        assert acted == want


# -- recovery: run_elastic over gloo CPU ranks --------------------------------

ELASTIC_CHILD = """
import os, sys, time, signal
att = int(os.environ.get("FLINK_ML_TPU_ELASTIC_ATTEMPT", "0"))
pid = int(os.environ.get("FLINK_ML_TPU_PROCESS_ID", "0"))
if att == 0 and pid == 1:
    os.kill(os.getpid(), signal.SIGKILL)
if att == 0:
    time.sleep(60)
"""


def test_run_elastic_exhausts_below_min_processes():
    always_dies = ELASTIC_CHILD.replace("att == 0 and pid == 1", "pid == 1")
    with pytest.raises(RestartsExhausted) as ei:
        elastic.run_elastic(
            [sys.executable, "-c", always_dies], num_processes=2,
            min_processes=2, policy=RetryPolicy(max_restarts=3,
                                                backoff_s=0.05),
            timeout=60.0, child_grace_s=1.5, device="cpu")
    assert ei.value.budget == "elastic"
    assert "min_processes" in str(ei.value)


def test_run_elastic_rejects_bad_floor():
    with pytest.raises(ValueError, match="min_processes"):
        elastic.run_elastic(["true"], num_processes=1, min_processes=2,
                            device="cpu")


def _one_rank_resume(frozen, tmp_path, tag, **kw):
    """A one-shard in-process LR fit resumed from a copy of ``frozen``, the
    worker's own table and parameters."""
    d = tmp_path / f"resume-{tag}"
    shutil.copytree(frozen, d)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(kw["rows"], 10)).astype(np.float32)
    y = (x @ rng.normal(size=10) > 0).astype(np.float32)
    mgr = elastic.ElasticCheckpointManager(str(d))
    est = LogisticRegression(device="cpu", mesh=create_mesh(
        (1,), devices=["cpu"]), max_iter=12, global_batch_size=400)
    est.set_iteration_config(IterationConfig(checkpoint_interval=3,
                                             checkpoint_manager=mgr))
    coef = est.fit(Table.from_columns(features=x, label=y)).coefficients
    assert not mgr.list_checkpoints()  # it restored, ran and cleared
    return np.asarray(coef, np.float32)


def test_run_elastic_shrinks_and_resumes_bit_for_bit(tmp_path):
    """Two gloo ranks fit LR in 3-round segments; worker-loss kills rank 1
    at the second boundary (epoch 6, which rank 0 snapshots before its next
    sum fails); the driver names it and relaunches one rank, which resumes
    from the newest checkpoint with its offsets rescaled (2 shards → 1);
    its coefficients equal a one-rank fit resumed from the same snapshot,
    bit for bit. The trace holds the loss and the relaunch; a beacon
    carries provenance."""
    trace = tmp_path / "trace"
    tracing.tracer.configure(str(trace))
    try:
        records = elastic.run_elastic(
            [sys.executable, WORKER, "--rows", "4000", "--ckpt",
             str(tmp_path / "ck"), "--out", str(tmp_path / "out")],
            num_processes=2, min_processes=1,
            env=dict(CHILD_ENV, FLINK_ML_TPU_CHAOS="1",
                     FLINK_ML_TPU_CHAOS_AT="worker-loss:2"),
            policy=RetryPolicy(max_restarts=2, backoff_s=0.05),
            timeout=60.0, child_grace_s=5.0, device="cpu",
            heartbeat_dir=str(tmp_path / "hb"))
        beacon = fleet.write_beacon(str(tmp_path / "fleet"), role="driver")
    finally:
        tracing.tracer.configure(None)
    assert len(records) == 1 and records[0]["returncode"] == 0
    assert elastic.provenance()["elasticEvents"] == 2  # loss + relaunch
    load = json.loads(open(beacon).read())["load"]
    assert load["elasticEvents"] == 2 and load["participation"] == 1.0
    events = [e["name"] for path in glob.glob(str(trace / "spans-*.jsonl"))
              for line in open(path) for e in json.loads(line).get(
                  "events", [])]
    assert "elastic.worker-lost" in events and "elastic.relaunch" in events
    result = json.loads((tmp_path / "out" / "result-attempt-1.json")
                        .read_text())
    assert result["processes"] == 1 and result["mesh"] == {"data": 1}
    assert result["path"] == "torch-sgd-segments"
    got = np.asarray(result["coef_bits"], np.int32).view(np.float32)
    want = _one_rank_resume(tmp_path / "out" / "frozen-attempt-1",
                            tmp_path, "a", rows=4000)
    np.testing.assert_array_equal(got, want)
    # the victim's beacon of the first attempt marks the fatal boundary
    hb = glob.glob(str(tmp_path / "hb" / "attempt-0" / "fleet-p1-*.json"))
    assert hb and json.loads(open(hb[0]).read())["epoch"] == 6


_SHUTDOWN_PROGRAM = r"""
import os, sys, time
import torch
from flink_ml_tpu_torch.parallel import mesh as M

rank, root, peer = int(sys.argv[1]), sys.argv[2], sys.argv[3]
store = torch.distributed.FileStore(os.path.join(root, "store"), 2)
assert M.init_distributed(store=store, world_size=2, rank=rank,
                          device="cpu", timeout_s=60)
if rank == 1:
    if peer == "exited":
        os._exit(0)  # gone without leaving the group
    time.sleep(60)  # alive, never at the barrier
t0 = time.monotonic()
try:
    M.shutdown_distributed(barrier_timeout_s=2.0)
    print("no error")
except RuntimeError as e:
    print(f"raised after {time.monotonic() - t0:.3f} s: {e}")
assert not torch.distributed.is_initialized() and M._default_mesh is None
"""


@pytest.mark.parametrize("peer", ["exited", "stalled"])
def test_shutdown_barrier_is_bounded_when_a_peer_is_gone(tmp_path, peer):
    """A rank whose peer exited or stalls does not wait out the group's
    60 s timeout at shutdown: the barrier raises within its bound, names
    the missing rank, and the rank has left the group all the same."""
    import subprocess

    env = dict(os.environ, **CHILD_ENV)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SHUTDOWN_PROGRAM, str(r), str(tmp_path),
         peer], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        out = procs[0].communicate(timeout=60)[0]
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()
    assert procs[0].returncode == 0, out[-2000:]
    line = next(ln for ln in out.splitlines()
                if ln.startswith(("raised", "no error")))
    assert line.startswith("raised") and "1" in line.split(":", 1)[1], line
    assert float(line.split()[2]) < 2.0 + 10.0, line


@pytest.mark.parametrize("made_by", ["init_distributed", "Mesh"])
def test_mesh_holds_no_reference_to_the_default_group(tmp_path, made_by):
    """A mesh over the default process group looks the group up where it
    is used and never holds it, so ``destroy_process_group`` leaves no
    group alive until interpreter exit (where a gloo group's late free can
    abort the process)."""
    import torch.distributed as tdist

    from flink_ml_tpu_torch.parallel import mesh as M

    store = tdist.FileStore(str(tmp_path / "store"), 1)
    try:
        if made_by == "init_distributed":
            M.init_distributed(store=store, world_size=1, rank=0,
                               device="cpu", timeout_s=60)
            mesh = M.default_mesh()
        else:
            tdist.init_process_group("gloo", store=store, world_size=1,
                                     rank=0)
            mesh = M.Mesh(["cpu"] * 2, ("seq",), group=tdist.group.WORLD,
                          processes=1)
        assert mesh.distributed and mesh.group is tdist.group.WORLD
        assert not any(isinstance(v, tdist.ProcessGroup)
                       for v in vars(mesh).values())
    finally:
        M.shutdown_distributed()
        M.set_default_mesh(None)
    assert mesh.group is None and mesh.distributed


def test_two_ranks_of_two_shards_flat_and_two_level(tmp_path):
    """``-d 2`` on two gloo ranks: a ``(dcn 2, data 2)`` mesh over
    processes. The flat and the two-level sums give the same fit up to
    reassociation, and both the in-process four-shard fit's. Across
    processes both routes put the rank's full payload on the group, and
    the inter-level record says so."""
    coefs, inter = {}, {}
    for mode in ("0", "1"):
        out = tmp_path / f"out{mode}"
        records = dist.launch(
            [sys.executable, WORKER, "--rows", "2000", "--ckpt",
             str(tmp_path / f"ck{mode}"), "--out", str(out)], 2,
            local_devices=2,
            env=dict(CHILD_ENV, FLINK_ML_TPU_HIER_REDUCE=mode),
            timeout=60.0, device="cpu")
        assert [r["returncode"] for r in records] == [0, 0], \
            records[0]["stderr"][-2000:]
        res = json.loads((out / "result-attempt-0.json").read_text())
        assert res["mesh"] == {"dcn": 2, "data": 2}
        inter[mode] = res["interBytes"]
        coefs[mode] = np.asarray(res["coef_bits"], np.int32).view(np.float32)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2000, 10)).astype(np.float32)
    y = (x @ rng.normal(size=10) > 0).astype(np.float32)
    want = LogisticRegression(device="cpu", max_iter=12,
                              global_batch_size=400,
                              mesh=create_mesh((4,), devices=["cpu"] * 4)
                              ).fit(Table.from_columns(features=x, label=y))
    for mode in ("0", "1"):
        np.testing.assert_allclose(coefs[mode], want.coefficients,
                                   rtol=1e-5, atol=1e-6)
    assert inter["0"] == inter["1"] > 0, inter


# -- cross-N re-placement of sharded adam -------------------------------------

def _data(seed=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(400, 10))
    y = (x @ rng.normal(size=10) > 0).astype(np.float64)
    return x, y


PRM = dict(learning_rate=0.1, global_batch_size=80, max_iter=8, tol=0.0,
           reg=0.02, elastic_net=0.4, method="adam")


def _port_fit(n, cfg):
    from flink_ml_tpu_torch.ops.losses import BinaryLogisticLoss
    from flink_ml_tpu_torch.ops.optimizer import SGD, SGDParams

    x, y = _data()
    return SGD(SGDParams(**PRM)).optimize(
        BinaryLogisticLoss(), np.zeros(10), x, y, device="cpu",
        mesh=create_mesh((n,), devices=["cpu"] * n), config=cfg)


def _jax_fit(n, cfg):
    from flink_ml_tpu.ops.losses import BinaryLogisticLoss
    from flink_ml_tpu.ops.optimizer import SGD, SGDParams
    from flink_ml_tpu.parallel import create_mesh as jax_create_mesh

    x, y = _data()
    return SGD(SGDParams(**PRM)).optimize(
        BinaryLogisticLoss(), np.zeros(10), x, y,
        mesh=jax_create_mesh(devices=jax.devices()[:n]), config=cfg)


@pytest.mark.parametrize("n_from,n_to", [(4, 2), (2, 1)])
def test_sharded_adam_replacement_across_n(monkeypatch, tmp_path, n_from,
                                           n_to):
    """The JAX package's sharded-adam fit killed at a segment boundary on
    ``n_from`` shards leaves a v2 snapshot; the port resumes it on ``n_to``
    shards (the padded 1/N moment slices trimmed or re-padded, the
    offsets rescaled), genuinely restoring, bit-identically across two
    resumes and within rtol 1e-5 of the JAX package's own resume."""
    monkeypatch.setenv(upd.ENV, "1")
    monkeypatch.setenv(jax_upd.ENV, "1")
    ck = tmp_path / "ck"
    mgr = jax_elastic.ElasticCheckpointManager(str(ck))
    cfg = JaxConfig(mode="device", checkpoint_interval=2,
                    checkpoint_manager=mgr)
    with jax_faults.chaos(at={"epoch-boundary": [2]}):
        with pytest.raises(JaxInjected):
            _jax_fit(n_from, cfg)
    assert mgr.list_checkpoints()
    frozen = tmp_path / "frozen"
    shutil.copytree(ck, frozen)

    def resume(tag, fit, manager, config):
        d = tmp_path / f"resume-{tag}"
        shutil.copytree(frozen, d)
        m = manager(str(d))
        coeffs, loss = fit(n_to, config(mode="device", checkpoint_interval=2,
                                         checkpoint_manager=m))
        assert not m.list_checkpoints()  # success cleared them
        assert not [p for p in os.listdir(d) if p.endswith(".corrupt")]
        assert np.isfinite(loss)
        return np.asarray(coeffs)

    a = resume("a", _port_fit, elastic.ElasticCheckpointManager,
               IterationConfig)
    b = resume("b", _port_fit, elastic.ElasticCheckpointManager,
               IterationConfig)
    np.testing.assert_array_equal(a, b)
    want = resume("jax", _jax_fit, jax_elastic.ElasticCheckpointManager,
                  JaxConfig)
    np.testing.assert_allclose(a, want, rtol=1e-5, atol=1e-7)


def test_replacement_nonzero_tail_quarantined(tmp_path):
    base = elastic.ElasticCheckpointManager(str(tmp_path))
    base.save((np.arange(12, dtype=np.float64) + 1.0,), epoch=2)
    assert base.restore((np.zeros(10),)) is None  # quarantined
    assert not base.list_checkpoints()


def test_elastic_ckpt_single_process_roundtrip(tmp_path):
    mgr = elastic.ElasticCheckpointManager(str(tmp_path))
    mesh = create_mesh((4,), devices=["cpu"] * 4)
    sharded = upd.Sharded.place(mesh, torch.arange(8, dtype=torch.float32))
    mgr.save({"w": sharded, "step": np.int64(3)}, epoch=4)
    restored, epoch = mgr.restore({"w": sharded, "step": np.int64(0)})
    assert epoch == 4 and isinstance(restored["w"], upd.Sharded)
    assert torch.equal(restored["w"].global_view(),
                       torch.arange(8, dtype=torch.float32))
    assert int(restored["step"]) == 3
