"""The port's KNN, held against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its counterpart in ``flink_ml_tpu_torch`` on the CPU: the Pallas
``knn_topk_indices`` kernel in interpret mode (as
tests/test_pallas_kernels.py runs it) against the port's wrapper on CPU
tensors, which runs the kernel's plain PyTorch version; the JAX
``KnnModel.transform`` (its CPU path, ``xla-chunked``) against the port's
(``torch-knn``).

Tolerances: indices and predictions exactly equal. Test rows are checked in
float64, and kept only where their k + 1 nearest train rows are at least a
relative ``GAP`` apart, so float32 sums added in another order cannot
reorder them; planted duplicate train rows are exact ties, which both
sides resolve to the lowest index. A list of k + 1 rows has k gaps, so for
lists longer than 32 fewer rows keep (``LONG_MIN_KEEP`` of them at least,
against 90% for shorter lists). The CUDA kernel runs only on the card:
``chip_smoke.py`` holds it against the plain version there.
"""

import json

import numpy as np
import pytest
import torch

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.models.classification.knn import Knn as JaxKnn
from flink_ml_tpu.models.classification.knn import KnnModel as JaxKnnModel
from flink_ml_tpu.ops import pallas_kernels as pk
from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.benchmark import datagen, runner
from flink_ml_tpu_torch.convert import knn_model_from_arrays
from flink_ml_tpu_torch.models.classification import Knn, KnnModel
from flink_ml_tpu_torch.models.classification import knn as knn_mod
from flink_ml_tpu_torch.ops import kernels
from flink_ml_tpu_torch.utils import io as rw

#: smallest relative gap between consecutive float64 distances (among a
#: row's k + 1 nearest) that the inputs must keep
GAP = 1e-4
#: share of rows that must keep for lists longer than 32 (90% below)
LONG_MIN_KEEP = 0.3
CONFIG = "flink_ml_tpu/benchmark/configs/knn-benchmark.json"


def _without_near_ties(x, train, k):
    """The rows of x whose k + 1 nearest train rows keep consecutive
    float64 distances at least GAP apart (relative), unless the train rows
    are identical (an exact tie); most rows keep (a third at least for
    lists longer than 32)."""
    xd, td = x.astype(np.float64), train.astype(np.float64)
    d2 = ((xd[:, None, :] - td[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1, kind="stable")[:, :k + 1]
    near = np.take_along_axis(d2, order, axis=1)
    same = np.all(td[order[:, 1:]] == td[order[:, :-1]], axis=-1)
    gap = np.diff(near, axis=1) / np.maximum(near[:, 1:], 1e-30)
    keep = np.all(same | (gap >= GAP), axis=1)
    assert keep.mean() > (0.9 if k <= 32 else LONG_MIN_KEEP)
    return np.ascontiguousarray(x[keep])


def _knn_inputs(seed, n, nt, d, k, duplicates=(), exact=False):
    """Seeded inputs; with ``exact``, small integers, whose distances both
    sides compute exactly in float32, so every tie is an exact one and no
    row is left out (lists past 256 among a few thousand rows keep no row
    GAP apart throughout)."""
    rng = np.random.default_rng(seed)
    if exact:
        x = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
        train = rng.integers(-8, 9, size=(nt, d)).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        train = rng.normal(size=(nt, d)).astype(np.float32)
    for dst, src in duplicates:
        train[dst] = train[src]
    if exact:
        return x, train
    return _without_near_ties(x, train, min(k, nt)), train


@pytest.mark.parametrize("case,n,nt,d,k", [
    ("ragged-n", 300, 37, 8, 5),          # n not a multiple of 256
    ("train-tiles", 300, 2 * pk.KNN_TILE_T + 517, 8, 5),
    ("k-above-n-train", 10, 3, 4, 5),
    ("k=1", 257, 400, 6, 1),
    ("duplicates", 200, pk.KNN_TILE_T + 300, 8, 6),
    # lists longer than 32: the long-list kernel's capacities
    ("long k=33", 200, pk.KNN_TILE_T + 300, 4, 33),
    ("long k=64", 200, 700, 4, 64),
    ("long k=100", 200, 700, 4, 100),
    ("long duplicates", 200, pk.KNN_TILE_T + 300, 4, 40),
    # lists past 256: the radix route, on integer inputs (exact ties)
    ("wide k=257", 300, pk.KNN_TILE_T + 300, 4, 257),
    ("wide k=300", 200, pk.KNN_TILE_T + 300, 4, 300),
    ("wide duplicates", 200, pk.KNN_TILE_T + 300, 4, 300),
])
def test_knn_topk_plain_matches_pallas(case, n, nt, d, k):
    dups = (((50, nt - 7), (51, nt // 2), (52, 53))
            if case.endswith("duplicates") else ())
    x, train = _knn_inputs(n + nt + d, n, nt, d, k, dups,
                           exact=case.startswith("wide"))
    n = x.shape[0]
    want = np.asarray(pk.knn_topk_indices(x, train, k, interpret=True))
    got = kernels.knn_topk_indices(torch.from_numpy(x), torch.from_numpy(train),
                                   k)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, min(k, nt))
    np.testing.assert_array_equal(got.numpy(), want)
    if case.endswith("duplicates"):
        # a row holding the higher index of a planted pair holds the lower
        # one just before it
        rows, pos = np.nonzero(want == 53)
        assert len(rows) and np.all(want[rows, pos - 1] == 52)


def test_topk_ties_follow_lax_top_k():
    # equal distances inside the list and at the k-th place: lowest column
    # first, as lax.top_k orders them
    import jax

    d2 = np.array([[3.0, 1.0, 2.0, 1.0, 2.0, 0.5],
                   [1.0, 1.0, 1.0, 1.0, 0.0, 1.0]], np.float32)
    for k in (1, 2, 3, 4, 6):
        want = np.asarray(jax.lax.top_k(-d2, k)[1])
        got = kernels._topk_lowest_index(torch.from_numpy(d2), k)
        np.testing.assert_array_equal(got.numpy(), want)


def test_knn_topk_edges_and_checks():
    x, train = _knn_inputs(3, 20, 9, 5, 4)
    xt, tt = torch.from_numpy(x), torch.from_numpy(train)
    empty = kernels.knn_topk_indices(xt[:0], tt, 4)
    assert empty.dtype == torch.int32 and tuple(empty.shape) == (0, 4)
    assert tuple(kernels.knn_topk_indices(xt, tt, 50).shape) == (20, 9)
    with pytest.raises(ValueError, match="train row"):
        kernels.knn_topk_indices(xt, tt[:0], 3)
    with pytest.raises(ValueError, match="k >= 1"):
        kernels.knn_topk_indices(xt, tt, 0)
    with pytest.raises(ValueError, match="n_train, d"):
        kernels.knn_topk_indices(xt, tt[:, :4].contiguous(), 3)
    with pytest.raises(TypeError, match="float32"):
        kernels.knn_topk_indices(xt.double(), tt, 3)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.knn_topk_indices(xt, torch.zeros((5, 9)).T, 3)


def test_knn_layout():
    # every list up to 32 long takes the tiled kernel, whatever d: the
    # benchmark's k = 10, d = 32 the k <= 16 instance, d padded to the
    # 32-column chunks
    for (k, d), (kcap, dpad) in {(10, 32): (16, 32), (17, 33): (32, 64),
                                 (32, 128): (32, 128), (1, 1): (16, 32),
                                 (10, 129): (16, 160),
                                 (32, 768): (32, 768)}.items():
        plan = kernels._knn_plan(100, 1000, d, k, 132)
        assert (plan.route, plan.kcap, plan.dpad) == ("tiled", kcap, dpad)
        assert plan.ntp == 1024 and plan.tiles == 8
    # lists of 33 to 256 take the long-list kernel, padded as the tiled
    # one; longer lists the radix route, with its scratch of keys (its
    # 100 rows' pairs fit the select block's shared memory)
    plan = kernels._knn_plan(100, 1000, 32, 33, 132)
    assert (plan.route, plan.kcap, plan.dpad, plan.ntp) == ("long", 64, 32,
                                                            1024)
    for k, d, dpad in [(257, 32, 32), (500, 768, 768)]:
        plan = kernels._knn_plan(100, 1000, d, k, 132)
        assert (plan.route, plan.dpad, plan.ntp) == ("radix", dpad, 1024)
        # 1,000 train rows lie in 16 segments of 64: a warp's candidates
        # always fit its region
        assert (plan.chunk_rows, plan.cap_w, plan.pairs_smem) == (100, 64, 1)
        assert plan.scratch_bytes == 4 * 1024 * 100


def test_cuda_tensors_take_the_kernel(monkeypatch):
    calls = []

    def no_plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    def launch(x, train, k):
        calls.append((tuple(x.shape), k))
        return torch.zeros((x.shape[0], k), dtype=torch.int32)

    monkeypatch.setattr(kernels, "_is_cuda", lambda t: True)
    monkeypatch.setattr(kernels, "knn_topk_indices_plain", no_plain)
    monkeypatch.setattr(kernels, "_launch_knn", launch)
    kernels.reset_launch_counts()
    x, t = torch.rand((10, 4)), torch.rand((6, 4))
    kernels.knn_topk_indices(x, t, 8)  # k clamps to n_train
    # wide rows and long lists take the kernel too
    kernels.knn_topk_indices(torch.rand((3, 200)), torch.rand((5, 200)), 2)
    kernels.knn_topk_indices(torch.rand((3, 4)), torch.rand((90, 4)), 40)
    kernels.knn_topk_indices(torch.rand((3, 4)), torch.rand((900, 4)), 300)
    assert calls == [((10, 4), 6), ((3, 200), 2), ((3, 4), 40), ((3, 4), 300)]
    assert kernels.launch_counts["knn_topk_indices"] == 4
    kernels.reset_launch_counts()


def test_knn_launch_plan():
    # an H100 holds 132 blocks of the tiled kernel (one per SM); 264 is a
    # card that holds two per SM
    nt, d, k = 50_000, 32, 10
    for n, resident, splits in [(10_000_000, 132, 1), (10_000_000, 264, 1),
                                (16_384, 132, 1), (16_384, 264, 2),
                                (1_000, 132, 33), (1_000, 264, 33),
                                (1, 132, 132)]:
        plan = kernels._knn_plan(n, nt, d, k, resident)
        assert plan.splits == splits, (n, resident, plan)
        # the scratch holds each split's (n, k) distances and indices
        assert plan.scratch_bytes == (8 * splits * n * k if splits > 1 else 0)
        bounds = kernels.knn_split_bounds(nt, splits)
        # contiguous, whole train tiles, none empty, covering every row
        assert bounds[0][0] == 0 and bounds[-1][1] == nt
        assert all(hi > lo for lo, hi in bounds)
        assert all(a[1] == b[0] and b[0] % kernels.KNN_TILE_ROWS == 0
                   for a, b in zip(bounds, bounds[1:]))
        # the split costs no more than one: its waves of blocks over S
        waves = -(-(-(-n // 128)) * splits // resident)
        assert waves / splits <= -(-(-(-n // 128)) // resident)
    # never more splits than train tiles
    plan = kernels._knn_plan(10, 300, d, k, 132)
    assert plan.tiles == 3 and plan.splits == 3


@pytest.mark.parametrize("k,kcap,route", [
    (1, 16, "tiled"), (16, 16, "tiled"), (17, 32, "tiled"), (32, 32, "tiled"),
    (33, 64, "long"), (50, 64, "long"), (64, 64, "long"), (65, 128, "long"),
    (80, 128, "long"), (81, 0, "radix"), (128, 0, "radix"), (256, 0, "radix"),
    (257, 0, "radix"), (300, 0, "radix"), (4096, 0, "radix"),
    (50_000, 0, "radix")])
def test_knn_plan_routes_each_list_length(k, kcap, route):
    """Which instance each k takes, at the capacities and their edges:
    the tiled kernel up to 32, the long-list kernel up to the measured
    hand-over KNN_LONG_MAX_K = 80 (128 test rows a block, 64 for
    128-entry lists), the radix route past it, in chunks of test rows whose
    scratch stays under the cap."""
    assert kernels.KNN_LONG_MAX_K == 80 and kernels.KNN_LONG_KCAPS == (64,
                                                                       128)
    n, nt, d = 1_000, 50_000, 32
    plan = kernels._knn_plan(n, nt, d, k, 132)
    assert (plan.route, plan.kcap) == (route, kcap)
    if route == "radix":
        assert plan.ntp == 50_048 and plan.tiles == 391 and plan.dpad == 32
        assert plan.splits == -(-391 // kernels.KNN_KEY_TILES_PER_BLOCK)
        # the candidates' regions and the pairs in shared memory up to
        # k = 4,096 and more; at k = n_train the whole row, pairs in device
        # memory
        cap_w, pairs, smem = kernels.knn_select_layout(nt, k)
        assert (plan.cap_w, plan.pairs_smem) == (cap_w, pairs)
        assert (cap_w > 0) == (pairs == 1) == (k <= 4_096)
        assert smem <= kernels.SMEM_BLOCK_BYTES
        if cap_w:
            # twice a warp's share of about 2k + 32·nt/2,048 keys, and 64
            rank = kernels.knn_sample_rank(nt, k)
            assert rank == 2 * -(-k * 2_048 // nt) + 32
            share = -(-(-(-rank * nt // 2_048)) // 16)
            assert cap_w == -(-(2 * share + 64) // 32) * 32
        per_row = 4 * 50_048 + (0 if pairs else 16 * k)
        assert plan.chunk_rows == n and plan.scratch_bytes == n * per_row
        # the 10,000,000 rows of the benchmark go in chunks of whole test
        # tiles, each chunk's scratch under the cap
        big = kernels._knn_plan(10_000_000, nt, d, k, 132)
        assert big.chunk_rows % 128 == 0 and big.chunk_rows >= 128
        assert big.scratch_bytes == big.chunk_rows * per_row
        assert big.scratch_bytes <= kernels.KNN_KEY_CAP_BYTES
        assert (big.chunk_rows + 128) * per_row > kernels.KNN_KEY_CAP_BYTES
        # a cap below one row's scratch still runs one row a chunk
        assert kernels.knn_radix_plan(n, nt, d, k, cap=1).chunk_rows == 1
        return
    rows = 64 if kcap > 64 else 128
    assert kernels.knn_test_rows(kcap) == rows
    assert plan.ntp == 50_048 and plan.tiles == 391 and plan.dpad == 32
    # the splits fill the card over ceil(n / rows) test tiles
    assert plan.splits == kernels._knn_splits(-(-n // rows), 391, 132)
    assert plan.scratch_bytes == 8 * plan.splits * n * k
    # the benchmark's 10,000,000 rows fill the card without a split
    assert kernels._knn_plan(10_000_000, nt, d, k, 132).splits == 1


def _planted_distances(seed, n, nt):
    """(n, nt) float32 distances with planted exact ties: runs of equal
    values, +0.0 and -0.0 (which tie), negative values and a row of one
    value throughout."""
    rng = np.random.default_rng(seed)
    d2 = rng.integers(-50, 200, size=(n, nt)).astype(np.float32) / 4
    d2[:, ::7] = 0.0
    d2[:, 3::11] = -0.0
    d2[1] = 2.5
    d2[2, :] = np.where(np.arange(nt) % 2, -0.0, 0.0)
    return torch.from_numpy(d2)


@pytest.mark.parametrize("k", [257, 1000, "nt"])
def test_knn_radix_stages_compose_to_plain(k):
    """The radix route's stages, each by its plain twin (keys, radix
    select, compaction, stable radix sort), give the lists of
    knn_topk_indices_plain bit for bit: on distances with planted equal
    values and -0.0 against +0.0, and from x and train over several chunks
    of test rows (a cap of a few rows' scratch)."""
    nt = 2 * kernels.KNN_TILE_ROWS + 37
    k = nt if k == "nt" else k
    if k > nt:
        nt = k + 13
    d2 = _planted_distances(k, 9, nt)
    keys = kernels.knn_distance_keys_plain(d2)
    # -0.0 and +0.0 take one key; the keys order as the floats do
    assert int(keys[2].unique().numel()) == 1
    flat = d2.flatten().double()
    order = torch.sort(keys.flatten(), stable=True).indices
    assert bool((flat[order][1:] >= flat[order][:-1]).all())
    kth, need = kernels.knn_radix_select_plain(keys, k)
    assert bool((need >= 1).all())
    ckeys, cidx = kernels.knn_compact_plain(keys, kth, need, k)
    # in ascending train index, every key at or below the k-th
    assert bool((cidx[:, 1:] > cidx[:, :-1]).all())
    assert bool((ckeys <= kth[:, None]).all())
    got = kernels.knn_radix_sort_plain(ckeys, cidx)
    assert torch.equal(got, kernels._topk_lowest_index(d2, k))
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.integers(-4, 5, (300, 3)).astype(np.float32))
    train = torch.from_numpy(rng.integers(-4, 5, (nt, 3)).astype(np.float32))
    cap = 7 * 4 * (-(-nt // 128) * 128)  # seven rows' keys a chunk
    plan = kernels.knn_radix_plan(300, nt, 3, k, cap=cap)
    assert plan.route == "radix" and plan.chunk_rows == 7
    want = kernels.knn_topk_indices_plain(x, train, k)
    assert torch.equal(kernels.knn_topk_radix_plain(x, train, k, cap), want)
    assert torch.equal(kernels.knn_topk_radix_plain(x, train, k), want)


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_knn_merge_plain_matches_one_pass(splits):
    # 7 train tiles, the last of 5 rows: fewer than k; train rows that are
    # exact duplicates on both sides of every split boundary; test rows next
    # to those pairs, so the pairs are their nearest
    nt, d, k = 6 * kernels.KNN_TILE_ROWS + 5, 8, 8
    rng = np.random.default_rng(40 + splits)
    train = rng.normal(size=(nt, d)).astype(np.float32)
    bounds = kernels.knn_split_bounds(nt, splits)
    pairs = [(lo - 1, lo) for lo, _ in bounds[1:]] or [(100, 101)]
    for low, high in pairs:
        train[high] = train[low]
    x = rng.normal(size=(70, d)).astype(np.float32)
    x[:len(pairs)] = train[[low for low, _ in pairs]] + 1e-3
    xt, tt = torch.from_numpy(x), torch.from_numpy(train)
    dists, idx = kernels.knn_split_topk_plain(xt, tt, k, bounds)
    assert tuple(dists.shape) == tuple(idx.shape) == (splits, 70, k)
    if splits == 7:  # the last split holds 5 rows: padded with (+inf, 0)
        assert torch.isinf(dists[-1, :, 5:]).all() and not idx[-1, :, 5:].any()
    got = kernels.knn_merge_topk_plain(dists, idx, k)
    want = kernels.knn_topk_indices_plain(xt, tt, k)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
    # of two identical train rows, the lower index comes first
    for row, (low, high) in enumerate(pairs):
        assert got[row, :2].tolist() == [low, high]


def _labeled(seed, n, d, labels):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = np.asarray(labels, np.float64)[rng.integers(0, len(labels), n)]
    return x, y


@pytest.mark.parametrize("k", [1, 5, 12, 40])
def test_transform_matches_jax(k):
    # non-contiguous label values; test rows away from the train rows
    x, y = _labeled(21 + k, 240, 6, [-3.0, 2.0, 7.5, 10.0])
    test = _without_near_ties(np.random.default_rng(99).normal(size=(130, 6)),
                              x.astype(np.float32), k)
    jax_model = JaxKnn(k=k).fit(JaxTable.from_columns(features=x, label=y))
    want = jax_model.transform(JaxTable.from_columns(features=test))[0]
    est = Knn(k=k, device="cpu")
    model = est.fit(Table.from_columns(features=x, label=y))
    got = model.transform(Table.from_columns(features=test))[0]
    assert jax_model.last_execution_path == "xla-chunked"
    assert model.last_execution_path == "torch-knn"
    assert got["prediction"].dtype == torch.float64
    np.testing.assert_array_equal(got["prediction"].numpy(),
                                  np.asarray(want["prediction"]))
    assert model.params_to_json_str() == jax_model.params_to_json_str()


def test_chunked_transform_matches_one_block(monkeypatch):
    x, y = _labeled(5, 200, 6, [0.0, 1.0, 2.0])
    table = Table.from_columns(features=x, label=y)
    model = Knn(k=5, device="cpu").fit(table)
    whole = model.transform(table)[0]["prediction"]
    monkeypatch.setattr(knn_mod, "_MAX_DIST_ELEMS", 6 * 200)  # 6-row chunks
    assert torch.equal(model.transform(table)[0]["prediction"], whole)


def test_k_above_n_train_and_empty_input():
    x, y = _labeled(8, 4, 3, [1.0, 4.0])
    model = Knn(k=9, device="cpu").fit(Table.from_columns(features=x, label=y))
    test = np.random.default_rng(1).normal(size=(7, 3))
    want = JaxKnn(k=9).fit(JaxTable.from_columns(features=x, label=y)) \
        .transform(JaxTable.from_columns(features=test))[0]["prediction"]
    got = model.transform(Table.from_columns(features=test))[0]["prediction"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    empty = model.transform(Table.from_columns(features=np.zeros((0, 3))))[0]
    assert tuple(empty["prediction"].shape) == (0,)
    with pytest.raises(ValueError, match="no model data"):
        KnnModel(device="cpu").transform(Table.from_columns(features=test))


def test_save_load_model_data_and_jax_saved_model(tmp_path):
    x, y = _labeled(13, 150, 5, [3.0, 8.0, 9.0])
    test = np.random.default_rng(4).normal(size=(60, 5))
    jax_model = JaxKnn(k=4, prediction_col="p").fit(
        JaxTable.from_columns(features=x, label=y))
    want = np.asarray(jax_model.transform(
        JaxTable.from_columns(features=test))[0]["p"])

    jax_model.save(str(tmp_path / "jax"))
    loaded = rw.load_stage(str(tmp_path / "jax"), device="cpu")
    assert type(loaded) is KnnModel and loaded.k == 4
    got = loaded.transform(Table.from_columns(features=test))[0]["p"]
    np.testing.assert_array_equal(got.numpy(), want)

    loaded.save(str(tmp_path / "port"))
    again = KnnModel.load(str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(again.features, x)
    np.testing.assert_array_equal(again.labels, y)
    from_data = KnnModel(k=4, prediction_col="p", device="cpu").set_model_data(
        loaded.get_model_data()[0])
    got2 = from_data.transform(Table.from_columns(features=test))[0]["p"]
    np.testing.assert_array_equal(got2.numpy(), want)

    converted = knn_model_from_arrays(jax_model.features, jax_model.labels,
                                      device="cpu", k=4, prediction_col="p")
    np.testing.assert_array_equal(
        converted.transform(Table.from_columns(features=test))[0]["p"].numpy(),
        want)
    with pytest.raises(ValueError, match="labels"):
        knn_model_from_arrays(x, y[:-1])


def test_model_data_generator_matches_jax():
    from flink_ml_tpu.benchmark import datagen as jax_datagen

    params = {"seed": 2, "vectorDim": 7, "arraySize": 40, "labelArity": 5}
    want = jax_datagen.KnnModelDataGenerator()
    want.params_from_json(params, strict=True)
    got = datagen.KnnModelDataGenerator(device="cpu")
    got.params_from_json(params, strict=True)
    w, g = want.get_data(), got.get_data()
    np.testing.assert_array_equal(g.vectors("packedFeatures", np.float64),
                                  w.vectors("packedFeatures", np.float64))
    np.testing.assert_array_equal(g.scalars("labels", np.float64),
                                  w.scalars("labels", np.float64))


def test_runner_on_a_shrunken_knn_config():
    config = runner.load_config(CONFIG)
    spec = config["KnnModel-predict"]
    spec["inputData"]["paramMap"]["numValues"] = 3000
    spec["modelData"]["paramMap"]["arraySize"] = 500
    row = runner.run_benchmark("KnnModel-predict", spec, device="cpu")
    assert row["executionPath"] == "torch-knn"
    assert row["inputRecordNum"] == 3000 and row["outputRecordNum"] == 3000
    # input rows (3000 x 32 float64 on the host) and model data
    # (500 x 32 + 500 labels) both count
    assert row["inputBytes"] == 3000 * 32 * 8 + 500 * 33 * 8
    assert row["deviceName"] == "cpu"
    # the same predictions as the JAX model on the same tables
    model = runner.build_stage(spec, "cpu").set_model_data(
        runner.build_generator(spec, "cpu", "modelData").get_data())
    table = runner.build_generator(spec, "cpu").get_data()
    got = model.transform(table)[0]["prediction"].numpy()
    from flink_ml_tpu.benchmark import datagen as jax_datagen

    jgen = jax_datagen.KnnModelDataGenerator()
    jgen.params_from_json(spec["modelData"]["paramMap"], strict=True)
    jmodel = JaxKnnModel(k=10).set_model_data(jgen.get_data())
    want = jmodel.transform(JaxTable.from_columns(
        features=table.vectors("features", np.float64)))[0]["prediction"]
    # uniform rows in 32 dims: the two packages round their distances
    # differently, so a vote can flip at a near-tie
    assert np.mean(got == np.asarray(want)) >= 0.999


def test_stage_registry_knows_the_knn_stages():
    assert runner.resolve_stage(
        "org.apache.flink.ml.classification.knn.KnnModel") is KnnModel
    assert runner.resolve_stage("Knn") is Knn
    spec = json.loads(json.dumps(runner.load_config(CONFIG)["KnnModel-predict"]))
    stage = runner.build_stage(spec, "cpu")
    assert isinstance(stage, KnnModel) and stage.k == 10
