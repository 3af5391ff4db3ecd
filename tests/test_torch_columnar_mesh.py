"""Feature columns placed over the mesh's data shards, held against the JAX
package.

The JAX side runs on its default mesh of the conftest's 8 CPU devices, a
device column made by ``jax_columnar.to_device``. The port runs under
``set_default_mesh(create_mesh((8,), devices=["cpu"] * 8))`` (reset after
each test), a device column split over the 8 virtual shards
(``columnar.to_device``), and once more with no mesh on a CPU tensor of the
same numpy-seeded values.

- Every dense feature stage that reaches ``columnar.apply``/``apply_multi``
  returns a column split over the 8 shards that agrees with the JAX
  package within rtol 1e-5 / atol 1e-6, and with the port's no-mesh run
  bit for bit given the same model (all of them are row-wise), but for
  the DCT: a float32 product with the DCT matrix, whose one-row shards
  take another CPU product than the whole column, so it is held to the
  same tolerance there instead.
- The statistics of StandardScaler, MinMaxScaler, MaxAbsScaler,
  RobustScaler, VarianceThresholdSelector, ANOVA and F-value and
  NaiveBayes on a split column agree with the JAX package within rtol
  1e-5 (extremes and order statistics exactly).
- 1,001 rows (the last shard 119 rows) and 5 rows (three empty shards).
- ``Table`` reads of a split column give what a tensor column gives.
- KMeans and LogisticRegression fits on a column an 8-shard stage produced
  take its parts as they are (the same storage), and agree within rtol
  1e-4 with the fits of the no-mesh run (whose LR fit is given an 8-shard
  mesh of its own: SGD on one shard takes other rows each round).
- KNN and the linear models' transforms on a split column give split
  predictions equal to the one-tensor run's, and the binary evaluator
  reads them as it reads tensors.
- Two gloo ranks of two local shards each run a feature pipeline on their
  own rows; each rank's outputs equal the in-process 2-shard run of its
  rows (rtol 1e-6: a rank runs one CPU thread, this process several,
  and the CPU's reductions may block otherwise).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.models import feature as jf
from flink_ml_tpu.models.classification.naivebayes import \
    NaiveBayes as JaxNaiveBayes
from flink_ml_tpu.models.stats import ANOVATest as JaxANOVATest
from flink_ml_tpu.models.stats import FValueTest as JaxFValueTest
from flink_ml_tpu.ops import columnar as jax_columnar

from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.models import feature as pf
from flink_ml_tpu_torch.models.classification import LogisticRegression
from flink_ml_tpu_torch.models.classification.naivebayes import NaiveBayes
from flink_ml_tpu_torch.models.clustering import KMeans
from flink_ml_tpu_torch.models.stats import ANOVATest, FValueTest
from flink_ml_tpu_torch.ops import columnar, kernels
from flink_ml_tpu_torch.parallel import collective as C
from flink_ml_tpu_torch.parallel import distributed as dist_mod
from flink_ml_tpu_torch.parallel import mesh as M

RTOL, ATOL = 1e-5, 1e-6
SIZES = (1001, 5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "port_mesh_worker.py")
CHILD_ENV = {"PYTHONPATH": os.pathsep.join(
    [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
              if p]), "OMP_NUM_THREADS": "1"}


def _mesh(n):
    return M.create_mesh((n,), devices=["cpu"] * n)


@pytest.fixture(autouse=True)
def _reset_mesh():
    M.set_default_mesh(None)
    yield
    M.set_default_mesh(None)


def _np(col):
    if isinstance(col, np.ndarray) and col.dtype == object:
        return np.stack([np.asarray(v.to_array() if hasattr(v, "to_array")
                                    else v) for v in col])
    return np.asarray(col)


def _f32(v):
    v = np.asarray(v)
    return v.astype(np.float32) if v.dtype.kind == "f" else v


def _tables(**cols):
    """(JAX table on its 8-device mesh, port table of CPU tensors); the
    port's split table is :func:`_split` of the tensor one."""
    jt = JaxTable.from_columns(**{k: jax_columnar.to_device(_f32(v))
                                  for k, v in cols.items()})
    pt = Table.from_columns(**{k: torch.from_numpy(
        np.ascontiguousarray(_f32(v))) for k, v in cols.items()})
    return jt, pt


def _split(table, mesh):
    return Table({n: columnar.to_device(table.column(n), mesh)
                  for n in table.column_names})


def _assert_split(col, mesh, n):
    assert isinstance(col, C.ShardedColumn), type(col)
    assert col.mesh is mesh and len(col.parts) == 8 and len(col) == n
    ls = C.shard_len(n, 8)
    assert col.rows.real == [max(0, min(ls, n - s * ls)) for s in range(8)]
    assert [p.shape[0] for p in col.parts] == col.rows.real


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _data(n, d=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) * np.linspace(0.5, 5.0, d)
            + np.linspace(-2.0, 3.0, d))


# -- the dense stages --------------------------------------------------------

def _scaler(name, **params):
    def build(pkg, pt, jt, device):
        mod = pf if pkg == "port" else jf
        kw = dict(device=device) if pkg == "port" else {}
        est = getattr(mod, name)(**kw, **params)
        return est.fit(pt if pkg == "port" else jt)
    return build


def _transformer(name, **params):
    def build(pkg, pt, jt, device):
        mod = pf if pkg == "port" else jf
        kw = dict(device=device) if pkg == "port" else {}
        return getattr(mod, name)(**kw, **params)
    return build


def _selector(name, **params):
    return _scaler(name, **params)


#: (id, stage builder, input column names, output columns, bit-equal to
#: the no-mesh run)
STAGES = [
    ("StandardScaler", _scaler("StandardScaler", with_mean=True), ["input"],
     ["output"], True),
    ("MinMaxScaler", _scaler("MinMaxScaler", min=-1.0, max=2.0), ["input"],
     ["output"], True),
    ("MaxAbsScaler", _scaler("MaxAbsScaler"), ["input"], ["output"], True),
    ("RobustScaler", _scaler("RobustScaler", with_centering=True),
     ["input"], ["output"], True),
    ("Normalizer-2", _transformer("Normalizer", p=2.0), ["input"],
     ["output"], True),
    ("Normalizer-inf", _transformer("Normalizer", p=float("inf")),
     ["input"], ["output"], True),
    ("ElementwiseProduct", _transformer(
        "ElementwiseProduct", scaling_vec=[1.0, -2.0, 0.5, 3.0, 0.0, 7.0]),
     ["input"], ["output"], True),
    ("PolynomialExpansion", _transformer("PolynomialExpansion", degree=3),
     ["input"], ["output"], True),
    ("DCT", _transformer("DCT"), ["input"], ["output"], False),
    ("VectorSlicer", _transformer("VectorSlicer", indices=[4, 0, 2, 2]),
     ["input"], ["output"], True),
    ("Interaction", _transformer("Interaction",
                                 input_cols=["input", "s"]),
     ["input", "s"], ["output"], True),
    ("VectorAssembler", _transformer(
        "VectorAssembler", input_cols=["s", "input"], output_col="output",
        handle_invalid="keep"), ["s", "input"], ["output"], True),
    ("Binarizer", _transformer("Binarizer", input_cols=["s", "input"],
                               output_cols=["os", "ov"],
                               thresholds=[0.5, -0.2]),
     ["s", "input"], ["os", "ov"], True),
    ("Bucketizer", _transformer(
        "Bucketizer", input_cols=["s"], output_cols=["os"],
        splits_array=[[-1.0, 0.0, 0.5, 1.0, 2.0]], handle_invalid="keep"),
     ["s"], ["os"], True),
    ("VarianceThresholdSelector", _selector(
        "VarianceThresholdSelector", variance_threshold=2.0), ["input"],
     ["output"], True),
    ("UnivariateFeatureSelector", _selector(
        "UnivariateFeatureSelector", features_col="input", label_col="s",
        output_col="output", feature_type="continuous",
        label_type="continuous", selection_mode="numTopFeatures",
        selection_threshold=3), ["input", "s"], ["output"], True),
    ("IDF", _scaler("IDF", input_col="input", output_col="output"),
     ["input"], ["output"], True),
    ("KBinsDiscretizer", _scaler("KBinsDiscretizer", input_col="input",
                                 output_col="output", num_bins=3),
     ["input"], ["output"], True),
    ("VectorIndexer", _scaler("VectorIndexer", input_col="input",
                              output_col="output", max_categories=2000),
     ["input"], ["output"], True),
]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("sid,build,ins,outs,bit_equal", STAGES,
                         ids=[s[0] for s in STAGES])
def test_dense_stage_splits_over_eight_shards(sid, build, ins, outs,
                                              bit_equal, n):
    rng = np.random.default_rng(3)
    cols = {"input": _data(n, seed=1), "s": rng.uniform(-1.0, 2.0, n)}
    jt, pt = _tables(**{k: cols[k] for k in ins})
    plain_stage = build("port", pt, jt, "cpu")
    plain = plain_stage.transform(pt)[0]
    want = build("jax", pt, jt, None).transform(jt)[0]
    mesh = _mesh(8)
    M.set_default_mesh(mesh)
    st = _split(pt, mesh)
    stage = build("port", st, jt, "cpu")
    got = stage.transform(st)[0]
    # the same model under the mesh: the elementwise outputs' bits
    again = plain_stage.transform(st)[0]
    for name in outs:
        _assert_split(got.column(name), mesh, n)
        _close(got.column(name), want.column(name))
        if bit_equal:
            np.testing.assert_array_equal(_np(again.column(name)),
                                          _np(plain.column(name)))
        else:
            _close(again.column(name), plain.column(name))


@pytest.mark.parametrize("n", SIZES)
def test_fitted_stats_of_a_split_column_match_jax(n):
    x = _data(n, seed=4)
    x[min(3, n - 1), 2] *= 40.0  # an outlier for the quantiles
    jt, pt = _tables(input=x)
    mesh = _mesh(8)
    M.set_default_mesh(mesh)
    st = _split(pt, mesh)
    cases = [("StandardScaler", dict(with_mean=True), ("mean", "std")),
             ("MinMaxScaler", {}, ("data_min", "data_max")),
             ("MaxAbsScaler", {}, ("max_abs",)),
             ("RobustScaler", dict(lower=0.1, upper=0.9),
              ("medians", "ranges"))]
    for name, params, stats in cases:
        want = getattr(jf, name)(**params).fit(jt)
        got = getattr(pf, name)(device="cpu", **params).fit(st)
        for stat in stats:
            g, w = getattr(got, stat), np.asarray(getattr(want, stat))
            if name in ("MinMaxScaler", "MaxAbsScaler", "RobustScaler"):
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7)
    for thr in (0.0, 1.0, 4.0):
        want = jf.VarianceThresholdSelector(variance_threshold=thr).fit(jt)
        got = pf.VarianceThresholdSelector(
            device="cpu", variance_threshold=thr).fit(st)
        np.testing.assert_array_equal(got.indices, want.indices)


def _labeled(n, categorical_label=True, seed=5):
    rng = np.random.default_rng(seed)
    y = (rng.integers(0, 3, n).astype(np.float64) if categorical_label
         else rng.normal(size=n))
    x = rng.normal(size=(n, 5))
    x[:, 0] += 0.3 * y
    return x, y


@pytest.mark.parametrize("test,categorical", [("ANOVATest", True),
                                              ("FValueTest", False)])
def test_anova_and_f_value_of_a_split_column_match_jax(test, categorical):
    x, y = _labeled(1001, categorical)
    jt, pt = _tables(features=x, label=y)
    want = {"ANOVATest": JaxANOVATest,
            "FValueTest": JaxFValueTest}[test]().transform(jt)[0]
    mesh = _mesh(8)
    M.set_default_mesh(mesh)
    got = {"ANOVATest": ANOVATest, "FValueTest": FValueTest}[test]() \
        .transform(_split(pt, mesh))[0]
    for name in ("pValues", "statistics"):
        _close(got.column(name), want.column(name), rtol=RTOL, atol=1e-12)
    np.testing.assert_array_equal(_np(got.column("degreesOfFreedom")),
                                  _np(want.column("degreesOfFreedom")))


@pytest.mark.parametrize("integral", [True, False])
def test_naive_bayes_on_a_split_column_matches_jax(integral):
    rng = np.random.default_rng(6)
    x = rng.integers(0, 4, size=(1001, 3)).astype(np.float64)
    y = (x[:, 0] + rng.integers(0, 2, 1001) > 2).astype(np.float64)
    if not integral:
        x = x * 0.5 - 1.0
    jt, pt = _tables(features=x, label=y)
    want = JaxNaiveBayes(smoothing=1.0).fit(jt)
    mesh = _mesh(8)
    M.set_default_mesh(mesh)
    st = _split(pt, mesh)
    got = NaiveBayes(device="cpu", smoothing=1.0).fit(st)
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    np.testing.assert_allclose(got.pi, want.pi, rtol=RTOL)
    np.testing.assert_allclose(got.floors, want.floors, rtol=RTOL)
    for row_g, row_w in zip(got.theta, want.theta):
        for m_g, m_w in zip(row_g, row_w):
            assert sorted(m_g) == sorted(m_w)
            np.testing.assert_allclose([m_g[k] for k in sorted(m_g)],
                                       [m_w[k] for k in sorted(m_w)],
                                       rtol=RTOL)
    pred = got.transform(st)[0].column("prediction")
    _assert_split(pred, mesh, 1001)
    np.testing.assert_array_equal(
        _np(pred), _np(want.transform(jt)[0].column("prediction")))


# -- Table reads -------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
def test_table_reads_of_a_split_column_match_a_tensor_column(n):
    x = _data(n, d=3, seed=7).astype(np.float32)
    s = np.arange(n, dtype=np.float32)
    plain = Table.from_columns(v=torch.from_numpy(x), s=torch.from_numpy(s))
    mesh = _mesh(8)
    split = _split(plain, mesh)
    assert split.num_rows == len(split) == n
    for name in ("v", "s"):
        col = split.column(name)
        _assert_split(col, mesh, n)
        np.testing.assert_array_equal(np.asarray(col),
                                      plain.column(name).numpy())
        np.testing.assert_array_equal(columnar.to_host(col),
                                      plain.column(name).numpy())
        # placed from one tensor: the parts are views of it
        assert col.whole().data_ptr() == plain.column(name).data_ptr()
    assert split.vectors("v") is split.column("v")
    np.testing.assert_array_equal(np.asarray(split.vectors("s")),
                                  plain.vectors("s").numpy())
    np.testing.assert_array_equal(split.vectors("v", np.float64),
                                  plain.vectors("v", np.float64))
    np.testing.assert_array_equal(split.scalars("s"), plain.scalars("s"))
    picks = [slice(1, n - 1), slice(0, 0), slice(None, None, 2),
             np.asarray([n - 1, 0, n // 2]),
             torch.as_tensor([n - 1, 0, n // 2])]
    for idx in picks:
        got, want = split.take(idx), plain.take(idx)
        assert got.num_rows == want.num_rows
        for name in ("v", "s"):
            assert isinstance(got.column(name), C.ShardedColumn)
            assert got.column(name).mesh is mesh
            np.testing.assert_array_equal(np.asarray(got.column(name)),
                                          want.column(name).numpy())
    for k in (0, 3, n + 4):
        np.testing.assert_array_equal(np.asarray(split.head(k).column("v")),
                                      plain.head(k).column("v").numpy())
    both = split.concat(plain.head(2))
    assert isinstance(both.column("v"), C.ShardedColumn)
    np.testing.assert_array_equal(
        np.asarray(both.column("v")),
        np.concatenate([x, x[:2]]))
    np.testing.assert_array_equal(
        np.asarray(plain.head(2).concat(split).column("s")),
        np.concatenate([s[:2], s]))
    for got_row, want_row in zip(split.rows(), plain.rows()):
        for g, w in zip(got_row, want_row):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(split.to_dict()["s"],
                                  plain.to_dict()["s"])
    np.testing.assert_array_equal(
        columnar.head_rows(split.column("v"), 4).numpy(), x[:4])
    np.testing.assert_array_equal(
        columnar.dynamic_rows(split.column("v"), 2, 3).numpy(), x[2:5])
    dims = columnar.take_dims(split.column("v"), [2, 0])
    _assert_split(dims, mesh, n)
    np.testing.assert_array_equal(np.asarray(dims), x[:, [2, 0]])


# -- fits on a placed column -------------------------------------------------

def _spy(monkeypatch, name):
    """Record the storage pointer of the rows each launch of kernel
    ``name`` reads."""
    seen = []
    real = getattr(kernels, name)

    def spy(x, *args, **kwargs):
        seen.append(x.data_ptr())
        return real(x, *args, **kwargs)

    monkeypatch.setattr(kernels, name, spy)
    return seen


def test_fits_take_a_placed_column_with_no_copy(monkeypatch):
    rng = np.random.default_rng(8)
    x = rng.random((1001, 6)).astype(np.float32)
    y = (x[:, 0] > 0.5).astype(np.float32)
    table = Table.from_columns(f=torch.from_numpy(x), label=y)

    def pipeline(lr_mesh=None):
        t = pf.StandardScaler(device="cpu", with_mean=True, input_col="f",
                              output_col="s").fit(table).transform(table)[0]
        km = KMeans(device="cpu", features_col="s", k=4, max_iter=5,
                    seed=1).fit(t)
        lr = LogisticRegression(device="cpu", features_col="s",
                                max_iter=5, global_batch_size=200,
                                learning_rate=0.1, mesh=lr_mesh).fit(t)
        return t, km, lr

    # the no-mesh run's LR fit gets an 8-shard mesh of its own, so that
    # both fits take the same rows each round (a one-shard SGD fit takes
    # other rows); its input is the one tensor, split into views
    _, km0, lr0 = pipeline(_mesh(8))
    mesh = _mesh(8)
    M.set_default_mesh(mesh)
    lloyd = _spy(monkeypatch, "lloyd_partial_sums")
    t, km, lr = pipeline()
    col = t.column("s")
    _assert_split(col, mesh, 1001)
    ptrs = {p.data_ptr() for p in col.parts}
    assert C.ensure_on_mesh(mesh, col).parts is col.parts
    assert C.ensure_on_mesh(M.create_mesh(
        (8,), devices=["cpu"] * 8), col).parts is col.parts
    assert lloyd and set(lloyd) <= ptrs
    # re-split on the device for a mesh that splits otherwise
    four = C.ensure_on_mesh(_mesh(4), col)
    np.testing.assert_array_equal(torch.cat(four.parts).numpy(),
                                  np.asarray(col))
    np.testing.assert_allclose(km.centroids, km0.centroids, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(lr.coefficients, lr0.coefficients,
                               rtol=1e-4, atol=1e-6)
    pred = km.transform(t)[0].column("prediction")
    _assert_split(pred, mesh, 1001)
    M.set_default_mesh(None)
    want = km.transform(Table.from_columns(
        s=torch.from_numpy(np.asarray(col))))[0].column("prediction")
    M.set_default_mesh(mesh)
    np.testing.assert_array_equal(np.asarray(pred), want.numpy())
    margins = lr.transform(t)[0]
    _assert_split(margins.column("prediction"), mesh, 1001)


def test_datagen_splits_over_the_default_mesh_with_the_same_values():
    from flink_ml_tpu_torch.benchmark.datagen import DenseVectorGenerator

    def gen():
        g = DenseVectorGenerator(device="cpu", seed=3, num_values=40_000,
                                 vector_dim=60, col_names=[["f"]])
        return g.get_data().column("f")

    plain = gen()
    mesh = _mesh(8)
    M.set_default_mesh(mesh)
    split = gen()
    _assert_split(split, mesh, 40_000)
    assert split.whole().data_ptr() == split.parts[0].data_ptr()
    np.testing.assert_array_equal(np.asarray(split), plain.numpy())


# -- two gloo ranks of two shards each ---------------------------------------

def test_two_ranks_split_their_own_rows_over_their_own_shards(tmp_path):
    job = dict(kind="features", name="feat", rows=203, cols=5, seed=11)
    (tmp_path / "jobs.json").write_text(json.dumps([job]))
    records = dist_mod.launch(
        [sys.executable, WORKER, "--jobs", str(tmp_path / "jobs.json"),
         "--out", str(tmp_path / "out")], 2, local_devices=2, env=CHILD_ENV,
        timeout=60.0, device="cpu")
    assert [r["returncode"] for r in records] == [0, 0], \
        records[0]["stderr"][-3000:]
    for rank in range(2):
        rec = json.loads((tmp_path / "out" / f"result-p{rank}.json")
                         .read_text())["jobs"]["feat"]
        outs = np.load(tmp_path / "out" / f"feat-p{rank}.npz")
        rng = np.random.default_rng(job["seed"] + rank)
        x = rng.normal(size=(job["rows"], job["cols"])).astype(np.float32)
        M.set_default_mesh(_mesh(2))
        t = Table.from_columns(x=x)
        t = pf.StandardScaler(device="cpu", with_mean=True, input_col="x",
                              output_col="s").fit(t).transform(t)[0]
        t = pf.Normalizer(device="cpu", input_col="s",
                          output_col="n").transform(t)[0]
        t = pf.MinMaxScaler(device="cpu", input_col="n",
                            output_col="m").fit(t).transform(t)[0]
        M.set_default_mesh(None)
        for name in ("s", "n", "m"):
            assert rec[name]["type"] == "ShardedColumn"
            assert rec[name]["real"] == [102, 101]
            np.testing.assert_allclose(outs[name], np.asarray(t.column(name)),
                                       rtol=1e-6, atol=1e-7)


def test_knn_and_evaluator_read_split_columns():
    from flink_ml_tpu_torch.models.classification import Knn
    from flink_ml_tpu_torch.models.evaluation import \
        BinaryClassificationEvaluator

    rng = np.random.default_rng(9)
    x = rng.normal(size=(203, 4)).astype(np.float32)
    y = (x[:, 0] + 0.3 * rng.normal(size=203) > 0).astype(np.float32)
    train = Table.from_columns(features=x[:150], label=y[:150])
    test = Table.from_columns(features=torch.from_numpy(x),
                              label=torch.from_numpy(y))
    knn = Knn(device="cpu", k=5).fit(train)
    lr = LogisticRegression(device="cpu", max_iter=5, global_batch_size=50,
                            learning_rate=0.1, mesh=_mesh(8)).fit(test)
    ev = BinaryClassificationEvaluator(
        metrics_names=["areaUnderROC", "areaUnderPR"])
    want_knn = knn.transform(test)[0].column("prediction").numpy()
    want_auc = ev.transform(lr.transform(test)[0])[0].to_dict()
    mesh = _mesh(8)
    M.set_default_mesh(mesh)
    split = _split(test, mesh)
    pred = knn.transform(split)[0].column("prediction")
    _assert_split(pred, mesh, 203)
    np.testing.assert_array_equal(np.asarray(pred), want_knn)
    scored = lr.transform(split)[0]
    _assert_split(scored.column("rawPrediction"), mesh, 203)
    got_auc = ev.transform(scored)[0].to_dict()
    for name, want in want_auc.items():
        np.testing.assert_allclose(got_auc[name], want, rtol=1e-12)
