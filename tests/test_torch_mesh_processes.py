"""Meshes over processes with any axes: tensor-parallel fits whose ``model``
axis spans gloo ranks or lies inside one, and sequence attention with two
``seq`` shards a rank.

Two launches of ``scripts/port_mesh_worker.py`` on CPU gloo ranks, each run
once for the module: four ranks on a (data 2, model 2) mesh, one shard a
rank; two ranks of two shards each on (data 2, model 2) and on (data 1,
model 2), then ring and Ulysses attention on (seq 4). Every rank fits
LogisticRegression and LinearSVC at widths the model axis divides and does
not (d = 10, 7). Each fit holds against the port's in-process fit on the
same mesh shape within rtol 1e-6 (every sum here has two operands, so the
bits agree but for the partial dots' matmul over a column block that is a
view in-process and its own tensor on a rank), and against the JAX
package's fit on the same mesh shape over ``jax.devices()[:size]`` within
rtol 1e-5. Attention holds against the in-process port within 1e-6 and
against the JAX package's ``sharded_attention`` on 4 devices within 1e-5.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

import jax

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.models.classification import LinearSVC as JaxSVC
from flink_ml_tpu.models.classification import LogisticRegression as JaxLR
from flink_ml_tpu.parallel import mesh as jax_mesh
from flink_ml_tpu.parallel.sequence import sharded_attention as jax_sharded

from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.models.classification import (LinearSVC,
                                                      LogisticRegression)
from flink_ml_tpu_torch.parallel import distributed as dist_mod
from flink_ml_tpu_torch.parallel import mesh as M
from flink_ml_tpu_torch.parallel.sequence import sharded_attention
from flink_ml_tpu_torch.servable.lr import LogisticRegressionModelServable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "port_mesh_worker.py")
# one intra-op thread a rank keeps the concurrent ranks from
# oversubscribing the host's cores
CHILD_ENV = {"PYTHONPATH": os.pathsep.join(
    [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
              if p]), "OMP_NUM_THREADS": "1"}
PORT_RTOL, JAX_RTOL, ATOL = 1e-6, 1e-5, 1e-7
ATT_PORT_TOL, ATT_JAX_TOL = 1e-6, 1e-5


def _fits(shape, local, seed0):
    return [dict(kind="fit", name=f"{loss}-{shape[0]}x{shape[1]}-d{d}",
                 shape=list(shape), local=local, loss=loss, rows=400,
                 cols=d, seed=seed0 + i, batch=100, max_iter=6, reg=0.02,
                 elastic_net=0.4)
            for i, (loss, d) in enumerate(
                [(lo, dd) for lo in ("lr", "svc") for dd in (7, 10)])]


FOUR = _fits((2, 2), 1, 10)
TWO = _fits((2, 2), 2, 20) + _fits((1, 2), 1, 30)
ATTENTION = dict(kind="attention", name="seq4", shape=[4], local=2, L=64,
                 H=8, D=16, seed=5)


def _launch(tmp, jobs, n, local):
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "jobs.json").write_text(json.dumps(jobs))
    records = dist_mod.launch(
        [sys.executable, WORKER, "--jobs", str(tmp / "jobs.json"), "--out",
         str(tmp / "out")], n, local_devices=local, env=CHILD_ENV,
        timeout=60.0, device="cpu")
    assert [r["returncode"] for r in records] == [0] * n, \
        records[0]["stderr"][-3000:]
    return [json.loads((tmp / "out" / f"result-p{r}.json").read_text())
            for r in range(n)]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("four"), FOUR, 4, 1)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two")
    return _launch(tmp, TWO + [ATTENTION], 2, 2), tmp / "out"


@pytest.fixture(autouse=True)
def _no_default_mesh():
    M.set_default_mesh(None)
    yield
    M.set_default_mesh(None)


def _table(job):
    rng = np.random.default_rng(job["seed"])
    x = rng.normal(size=(job["rows"], job["cols"])).astype(np.float32)
    y = (x @ rng.normal(size=job["cols"]) > 0).astype(np.float32)
    return x, y


def _params(job):
    return dict(max_iter=job["max_iter"], global_batch_size=job["batch"],
                learning_rate=0.1, reg=job["reg"],
                elastic_net=job["elastic_net"], tol=0.0)


def _in_process(job):
    x, y = _table(job)
    cls = LinearSVC if job["loss"] == "svc" else LogisticRegression
    mesh = M.create_mesh(tuple(job["shape"]), ("data", "model"),
                         devices=["cpu"] * math.prod(job["shape"]))
    est = cls(device="cpu", mesh=mesh, **_params(job))
    return est.fit(Table.from_columns(features=x, label=y)).coefficients


def _jax(job):
    x, y = _table(job)
    cls = JaxSVC if job["loss"] == "svc" else JaxLR
    jax_mesh.set_default_mesh(jax_mesh.create_mesh(
        tuple(job["shape"]), ("data", "model"),
        devices=jax.devices()[:math.prod(job["shape"])]))
    try:
        return cls(**_params(job)).fit(
            JaxTable.from_columns(features=x, label=y)).coefficients
    finally:
        jax_mesh.set_default_mesh(None)


def _check_fit(results, job):
    want = np.asarray(_in_process(job), np.float32)
    jax_want = np.asarray(_jax(job), np.float64)
    for res in results:
        rec = res["jobs"][job["name"]]
        assert rec["path"] == "torch-tp", rec["path"]
        got = np.asarray(rec["coef_bits"], np.int32).view(np.float32)
        np.testing.assert_allclose(got, want, rtol=PORT_RTOL, atol=ATOL)
        np.testing.assert_allclose(got, jax_want, rtol=JAX_RTOL, atol=ATOL)


@pytest.mark.parametrize("job", FOUR, ids=[j["name"] for j in FOUR])
def test_four_ranks_one_shard_each(four_ranks, job):
    """(data 2, model 2) over four ranks: rank r holds position r, so the
    margins sum on the ranks of a data shard and the gradients on the
    ranks of a model shard, then over the model axis to make the whole
    gradient."""
    for res in four_ranks:
        rec = res["jobs"][job["name"]]
        r = res["process"]
        assert (rec["positions"], rec["local_shards"],
                rec["local_models"]) == ([r], [r // 2], [r % 2])
        assert rec["groups"]["model"]["ranks"] == [r - r % 2, r - r % 2 + 1]
        assert rec["groups"]["data"]["ranks"] == [r % 2, r % 2 + 2]
        assert rec["groups"]["model"]["group"] and \
            rec["groups"]["data"]["group"]
    _check_fit(four_ranks, job)


@pytest.mark.parametrize("job", TWO, ids=[j["name"] for j in TWO])
def test_two_ranks_two_shards_each(two_ranks, job):
    """Two ranks of two shards: on (data 2, model 2) a rank holds one data
    shard's two model shards (its model sum is in-process, no call), on
    (data 1, model 2) one model shard and the model axis spans the
    ranks."""
    results, _ = two_ranks
    for res in results:
        rec = res["jobs"][job["name"]]
        r = res["process"]
        if job["shape"] == [2, 2]:
            assert (rec["local_shards"], rec["local_models"]) == ([r],
                                                                 [0, 1])
            assert rec["groups"]["model"] == {"ranks": [r], "group": False}
        else:
            assert (rec["local_shards"], rec["local_models"]) == ([0], [r])
            assert rec["groups"]["data"] == {"ranks": [r], "group": False}
            assert rec["groups"]["model"]["ranks"] == [0, 1]
    _check_fit(results, job)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_attention_two_seq_shards_a_rank(two_ranks, kind, causal):
    """(seq 4) over two ranks: the ring hops once a step across ranks and
    re-indexes inside one; Ulysses' all-to-all carries both shards' chunks
    in the global order. Both ranks gather the same bits."""
    results, out = two_ranks
    key = f"{kind}-{int(causal)}"
    assert len({res["jobs"]["seq4"][key]["sha256"] for res in results}) == 1
    with np.load(out / "seq4.npz") as saved:
        got = saved[key]
    gen = torch.Generator().manual_seed(ATTENTION["seed"])
    q, k, v = (torch.randn((ATTENTION["L"], ATTENTION["H"], ATTENTION["D"]),
                           generator=gen) for _ in range(3))
    seq = M.create_mesh((4,), ("seq",), devices=["cpu"] * 4)
    want = sharded_attention(seq, q, k, v, kind=kind, causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATT_PORT_TOL)
    jax_got = np.asarray(jax_sharded(
        jax_mesh.create_mesh((4,), ("seq",), devices=jax.devices()[:4]),
        q.numpy(), k.numpy(), v.numpy(), kind=kind, causal=causal))
    np.testing.assert_allclose(got, jax_got, rtol=0, atol=ATT_JAX_TOL)


@pytest.mark.parametrize("ranks", ["four", "two"])
def test_subgroups_on_every_rank_then_torn_down(four_ranks, two_ranks,
                                                ranks):
    """Every rank makes every subgroup, its own or not (four ranks: the
    two model and the two data subgroups; two ranks: none, each axis is
    one rank or all of them), and ``shutdown_distributed()`` destroys
    them: no subgroup is left and no mesh holds a process group."""
    results = four_ranks if ranks == "four" else two_ranks[0]
    for res in results:
        assert res["subgroups_built"] == (4 if ranks == "four" else 0)
        assert res["subgroups_left"] == 0
        assert not res["mesh_holds_group"]
        assert all(res["groups_after"])


@pytest.mark.parametrize("shape,processes,held", [
    ((2, 2), 4, [((0,), (0,)), ((0,), (1,)), ((1,), (0,)), ((1,), (1,))]),
    ((2, 2), 2, [((0,), (0, 1)), ((1,), (0, 1))]),
    ((1, 2), 2, [((0,), (0,)), ((0,), (1,))]),
    ((4, 2), 2, [((0, 1), (0, 1)), ((2, 3), (0, 1))]),
    ((2, 4), 4, [((0,), (0, 1)), ((0,), (2, 3)), ((1,), (0, 1)),
                 ((1,), (2, 3))])])
def test_positions_split_row_major_over_ranks(shape, processes, held):
    """``len(grid) // processes`` consecutive positions a rank, row-major
    over (data, model): whole model rows or one data shard's model
    shards. No group is needed to lay the mesh out."""
    got = [M.Mesh(["cpu"] * math.prod(shape), ("data", "model"),
                  shape=shape, group=object(), rank=r, processes=processes)
           for r in range(processes)]
    assert [(m.local_shards, m.local_models) for m in got] == held
    for m in got:
        assert set(m.axis_ranks(("data", "model"))) == set(range(processes))
        assert m.rank in m.axis_ranks() and m.rank in m.axis_ranks(
            ("model",))


def test_uneven_split_and_bad_build_shape_raise(monkeypatch):
    monkeypatch.setenv(dist_mod.DEVICE_ENV, "cpu")
    with pytest.raises(ValueError, match="neither whole model rows"):
        M.Mesh(["cpu"] * 6, ("data", "model"), shape=(3, 2),
               group=object(), processes=2)
    with pytest.raises(ValueError, match="together"):
        dist_mod.build_mesh(1, shape=(2, 2))
    mesh = dist_mod.build_mesh(1, (2, 2), ("data", "model"))
    assert mesh.shape == {"data": 2, "model": 2} and not mesh.distributed


def test_sharded_serving_refuses_a_mesh_over_processes():
    """The JAX package's prediction tier places batches on ``local_mesh()``
    only; the port refuses a ``torch.distributed`` mesh and says why."""
    servable = LogisticRegressionModelServable()
    over = M.Mesh(["cpu"] * 2, group=object(), rank=0, processes=2)
    with pytest.raises(ValueError, match="local_mesh"):
        servable.set_mesh(over)
