"""The port's dataset primitives (``common/dataset.py``),
AgglomerativeClustering and Swing, held against the JAX package on the CPU.

The same seeded numpy inputs go through both packages. Tolerance 0
throughout: the dataset primitives and window assignment are exact, the
agglomerative labels and merge table come from the same scipy routine on the
same float64 rows, and Swing's scores are the same native kernel's (the
port's copy of the source, byte for byte) over the same groupings, so the
"item,score" strings match character for character.
"""

import numpy as np
import pytest
import torch

from flink_ml_tpu.common import dataset as jax_dataset
from flink_ml_tpu.common.table import Table as JaxTable
from flink_ml_tpu.common.window import CountTumblingWindows as JaxCount
from flink_ml_tpu.common.window import GlobalWindows as JaxGlobal
from flink_ml_tpu.iteration.streaming import StreamTable as JaxStream
from flink_ml_tpu.models.clustering import (
    AgglomerativeClustering as JaxAgglomerative,
)
from flink_ml_tpu.models.recommendation import Swing as JaxSwing
from flink_ml_tpu_torch import Table, native
from flink_ml_tpu_torch.benchmark import runner
from flink_ml_tpu_torch.common import dataset
from flink_ml_tpu_torch.common.window import (
    CountTumblingWindows,
    GlobalWindows,
)
from flink_ml_tpu_torch.iteration.streaming import StreamTable
from flink_ml_tpu_torch.models.clustering import AgglomerativeClustering
from flink_ml_tpu_torch.models.recommendation import Swing
from flink_ml_tpu_torch.ops import _build
from flink_ml_tpu_torch.resilience import faults
from flink_ml_tpu_torch.resilience.policy import InjectedFault, KernelBuildError

AGG_CONFIG = "flink_ml_tpu/benchmark/configs/agglomerativeclustering-benchmark.json"


def _np(col):
    return col.numpy() if isinstance(col, torch.Tensor) else np.asarray(col)


# -- dataset primitives -------------------------------------------------------------

def _tables(tensor=False):
    k = np.array([1, 2, 1, 3, 2, 1])
    v = np.arange(6.0)
    port = Table.from_columns(k=k, v=torch.from_numpy(v) if tensor else v)
    return port, JaxTable.from_columns(k=k, v=v)


@pytest.mark.parametrize("tensor", [False, True])
@pytest.mark.parametrize("parts", [1, 3, 4, 6])
def test_partition_and_map_partition_match_jax(parts, tensor):
    port, jax = _tables(tensor)
    got = dataset.partition(port, parts)
    want = jax_dataset.partition(jax, parts)
    assert [p.num_rows for p in got] == [p.num_rows for p in want]
    out = dataset.map_partition(port, lambda t: t.with_column(
        "v", t["v"] * 2), num_partitions=parts)
    jout = jax_dataset.map_partition(jax, lambda t: t.with_column(
        "v", t["v"] * 2), num_partitions=parts)
    np.testing.assert_array_equal(_np(out["v"]), jout["v"])
    if tensor:
        assert isinstance(out["v"], torch.Tensor)


def test_reduce_and_keyed_match_jax():
    port, jax = _tables()
    assert dataset.reduce([1, 2, 3], lambda a, b: a + b) == \
        jax_dataset.reduce([1, 2, 3], lambda a, b: a + b) == 6
    with pytest.raises(ValueError):
        dataset.reduce([], lambda a, b: a + b)
    rows = list(zip(port["k"], port["v"]))
    got = dataset.reduce_keyed(rows, key_fn=lambda t: t[0],
                               fn=lambda a, b: (a[0], a[1] + b[1]))
    want = jax_dataset.reduce_keyed(rows, key_fn=lambda t: t[0],
                                    fn=lambda a, b: (a[0], a[1] + b[1]))
    assert got == want and got[1] == (1, 7.0)


@pytest.mark.parametrize("parts", [1, 3])
def test_aggregate_matches_jax(parts):
    args = dict(create_accumulator=lambda: (0, 0),
                add=lambda acc, v: (acc[0] + v, acc[1] + 1),
                merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
                get_result=lambda acc: acc[0] / acc[1],
                num_partitions=parts)
    assert dataset.aggregate(range(10), **args) == \
        jax_dataset.aggregate(range(10), **args) == 4.5
    with pytest.raises(ValueError, match="merge"):
        dataset.aggregate(range(4), lambda: 0, lambda a, v: a + v,
                          num_partitions=2)


@pytest.mark.parametrize("tensor", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sample_picks_the_jax_packages_rows(seed, tensor):
    rng = np.random.default_rng(3)
    v = rng.normal(size=500)
    port = Table.from_columns(v=torch.from_numpy(v) if tensor else v)
    got = dataset.sample(port, 37, seed=seed)
    want = jax_dataset.sample(JaxTable.from_columns(v=v), 37, seed=seed)
    np.testing.assert_array_equal(_np(got["v"]), want["v"])
    assert dataset.sample(port, 600).num_rows == 500


@pytest.mark.parametrize("tensor", [False, True])
def test_co_group_matches_jax(tensor):
    ka, kb = np.array([1, 2, 2, 5]), np.array([2, 3, 5, 5])
    xa = np.array([10., 20., 21., 50.])

    def fn(k, ra, rb):
        return [(int(k), ra.num_rows, rb.num_rows)]

    got = dataset.co_group(
        Table.from_columns(k=torch.from_numpy(ka) if tensor else ka, x=xa),
        Table.from_columns(k=kb, y=kb * 1.0), "k", "k", fn, ["k", "na", "nb"])
    want = jax_dataset.co_group(
        JaxTable.from_columns(k=ka, x=xa), JaxTable.from_columns(k=kb,
                                                                 y=kb * 1.0),
        "k", "k", fn, ["k", "na", "nb"])
    assert got.rows() == want.rows() == [(1, 1, 0), (2, 2, 1), (3, 0, 1),
                                         (5, 1, 2)]


def test_window_all_and_process_matches_jax():
    port, jax = _tables()
    for windows, jax_windows, want in ((CountTumblingWindows.of(4),
                                        JaxCount.of(4), [4, 2]),
                                       (GlobalWindows(), JaxGlobal(), [6])):
        got = dataset.window_all_and_process(
            StreamTable.from_table(port, 2), windows, lambda t: t.num_rows)
        jgot = jax_dataset.window_all_and_process(
            JaxStream.from_table(jax, 2), jax_windows, lambda t: t.num_rows)
        assert got == jgot == want
    assert dataset.window_all_and_process(port, GlobalWindows(),
                                          lambda t: t.num_rows) == [6]


# -- AgglomerativeClustering ------------------------------------------------------

def _blobs(seed, n=40):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(scale=0.2, size=(n // 2, 2)),
                           rng.normal(scale=0.2, size=(n // 2, 2)) + 10])


def _merges_equal(got, want):
    for c in ("clusterId1", "clusterId2", "distance", "sizeOfMergedCluster"):
        np.testing.assert_array_equal(got[c], want[c])


@pytest.mark.parametrize("params", [
    dict(num_clusters=2),
    dict(num_clusters=5, linkage="complete"),
    dict(num_clusters=3, linkage="average", distance_measure="manhattan"),
    dict(num_clusters=4, linkage="single", distance_measure="cosine"),
    dict(num_clusters=None, distance_threshold=5.0, linkage="single"),
    dict(num_clusters=None, distance_threshold=1.0, linkage="ward",
         compute_full_tree=True),
])
@pytest.mark.parametrize("tensor", [False, True])
def test_agglomerative_matches_jax(params, tensor):
    x = _blobs(1) + 1.0
    if tensor:
        x = x.astype(np.float32).astype(np.float64)
    col = torch.from_numpy(x.astype(np.float32)) if tensor else x
    out, merges = AgglomerativeClustering(device="cpu", **params).transform(
        Table.from_columns(features=col))
    jout, jmerges = JaxAgglomerative(**params).transform(
        JaxTable.from_columns(features=x))
    assert out["prediction"].dtype == np.int64
    np.testing.assert_array_equal(out["prediction"], jout["prediction"])
    _merges_equal(merges, jmerges)
    assert merges.num_rows == x.shape[0] - 1


def test_agglomerative_edges_and_validation():
    one = Table.from_columns(features=np.zeros((1, 2)))
    out, merges = AgglomerativeClustering(device="cpu").transform(one)
    np.testing.assert_array_equal(out["prediction"], [0])
    assert merges.num_rows == 0 and merges.column_names == [
        "clusterId1", "clusterId2", "distance", "sizeOfMergedCluster"]
    t = Table.from_columns(features=_blobs(2))
    with pytest.raises(ValueError, match="exactly one"):
        AgglomerativeClustering(num_clusters=None, device="cpu").transform(t)
    with pytest.raises(ValueError, match="ward"):
        AgglomerativeClustering(linkage="ward", distance_measure="cosine",
                                device="cpu").transform(t)
    assert AgglomerativeClustering().params_to_json_str() == \
        JaxAgglomerative().params_to_json_str()


def test_agglomerative_config_through_the_runner():
    """The agglomerativeclustering config, uncut (1,000 x 100), through the
    port's runner on the CPU; the labels equal the JAX operator's on the
    same generated rows."""
    spec = runner.load_config(AGG_CONFIG)["agglomerativeclustering"]
    row = runner.run_benchmark("agglomerativeclustering", spec, device="cpu")
    assert row["inputRecordNum"] == 1000
    assert row["outputRecordNum"] == 1000 + 999
    assert row["deviceName"] == "cpu"
    table = runner.build_generator(spec, "cpu").get_data()
    out, merges = runner.build_stage(spec, "cpu").transform(table)
    x = table.vectors("features", np.float64)
    jout, jmerges = JaxAgglomerative().params_from_json(
        spec["stage"]["paramMap"]).transform(JaxTable.from_columns(features=x))
    np.testing.assert_array_equal(out["prediction"], jout["prediction"])
    _merges_equal(merges, jmerges)


# -- Swing --------------------------------------------------------------------------

def _purchases(seed, n_users=40, n_items=25, per_user=8):
    rng = np.random.default_rng(seed)
    users = np.repeat(np.arange(n_users), per_user).astype(np.int64)
    items = np.concatenate([rng.choice(n_items, per_user, replace=False)
                            for _ in range(n_users)]).astype(np.int64)
    return users, items


def _swing_both(users, items, tensor=False, **params):
    got = Swing(device="cpu", **params).transform(Table.from_columns(
        user=torch.from_numpy(users) if tensor else users, item=items))[0]
    want = JaxSwing(**params).transform(JaxTable.from_columns(
        user=users, item=items))[0]
    return got, want


@pytest.mark.parametrize("params", [
    dict(min_user_behavior=2, k=5, alpha1=5, beta=0.5),
    dict(min_user_behavior=1, k=3),
    dict(min_user_behavior=3, max_user_behavior=7, k=10, alpha2=1,
         max_user_num_per_item=6),
])
@pytest.mark.parametrize("tensor", [False, True])
def test_swing_matches_jax(params, tensor):
    users, items = _purchases(0)
    got, want = _swing_both(users, items, tensor, **params)
    np.testing.assert_array_equal(got["item"], want["item"])
    assert list(got["output"]) == list(want["output"])
    assert got.column_names == want.column_names


def test_swing_basic():
    users = np.repeat([1, 2], 3).astype(np.int64)
    items = np.tile([1, 2, 3], 2).astype(np.int64)
    got, want = _swing_both(users, items, min_user_behavior=1, alpha1=0,
                            alpha2=0, beta=0.0, k=2)
    assert set(got["item"].tolist()) == {1, 2, 3}
    recs = dict(zip(got["item"], got["output"]))
    item_id, score = recs[1].split(";")[0].split(",")
    assert float(score) == pytest.approx(1 / 3)
    assert list(got["output"]) == list(want["output"])


def test_swing_filters_and_validation():
    t = Table.from_columns(user=np.array([1, 1, 2], np.int64),
                           item=np.array([1, 2, 1], np.int64))
    assert Swing(min_user_behavior=2, k=5, device="cpu").transform(
        t)[0].num_rows == 0
    with pytest.raises(ValueError, match="maxUserBehavior"):
        Swing(min_user_behavior=10, max_user_behavior=5,
              device="cpu").transform(t)
    assert Swing().params_to_json_str() == JaxSwing().params_to_json_str()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_swing_native_equals_python_oracle(seed):
    users, items = _purchases(seed, n_users=60, n_items=30, per_user=9)
    op = Swing(min_user_behavior=2, k=6, alpha1=5, beta=0.5)
    groups = op._groupings(users, items)
    py = op._score_python(*groups, op.alpha2)
    cc = op._score_native(*groups, op.alpha2)
    assert py == cc  # the same items, order and float64 scores


def test_swing_native_matches_the_jax_binding():
    from flink_ml_tpu import native as jax_native

    users, items = _purchases(3)
    op = Swing(min_user_behavior=2, k=4)
    user_items, item_users, weights = op._groupings(users, items)
    ulist = list(user_items)
    index = {u: i for i, u in enumerate(ulist)}
    u_off = np.concatenate([[0], np.cumsum([len(user_items[u])
                                            for u in ulist])])
    u_flat = np.concatenate([user_items[u] for u in ulist])
    w = np.asarray([weights[u] for u in ulist])
    ilist = list(item_users)
    i_off = np.concatenate([[0], np.cumsum([len(item_users[i])
                                            for i in ilist])])
    i_flat = np.asarray([index[u] for i in ilist for u in item_users[i]])
    args = (u_flat, u_off, w, i_flat, i_off, np.asarray(ilist), 0.0, 4)
    for g, want in zip(native.swing_similarity(*args),
                       jax_native.swing_similarity(*args)):
        np.testing.assert_array_equal(g, want)
    bad = (u_flat, u_off, w, i_flat + len(ulist), i_off, np.asarray(ilist),
           0.0, 4)
    with pytest.raises(ValueError, match="user indices"):
        native.swing_similarity(*bad)


def test_swing_is_a_native_kernel_chaos_site():
    users, items = _purchases(4)
    with faults.chaos(at={"native-kernel": [1]}):
        with pytest.raises(InjectedFault):
            Swing(min_user_behavior=2, device="cpu").transform(
                Table.from_columns(user=users, item=items))


def test_swing_without_compiler_raises(monkeypatch, tmp_path):
    """Kernel or raise: no g++ (and no earlier build) fails the transform;
    the Python scorer is never a fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    native._lib.cache_clear()
    _build.load_host.cache_clear()
    users, items = _purchases(5)
    try:
        with pytest.raises(KernelBuildError, match="g\\+\\+"):
            Swing(min_user_behavior=2, device="cpu").transform(
                Table.from_columns(user=users, item=items))
    finally:
        native._lib.cache_clear()
        _build.load_host.cache_clear()
