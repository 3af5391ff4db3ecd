"""The port's statistics, held against the JAX package on the CPU.

- ``ops/stats.py`` and the ChiSqTest / ANOVATest / FValueTest operators:
  host columns against the JAX package's float64 host path within rtol
  1e-9; tensor columns against its device path (a CPU ``jax.Array``)
  within rtol 1e-5 (float32 sums; χ² counts are exact, so rtol 1e-9).
- ``BinaryClassificationEvaluator``: float64 on both sides, rtol 1e-9,
  host and tensor columns.
- NaiveBayes: the host fit and the device fits (integral bincount and the
  per-dimension ``unique`` path) give the JAX package's model (rtol 1e-9)
  and its predictions exactly; JAX-saved models load in the port.
- ``approx_quantiles``, ``QuantileSummary`` and ``rank_select_device``:
  exact, with ±inf, NaN, ±0 and denormal rows.
- ``linalg/blas.py`` and ``common/functions.py``: the JAX package's
  results, rtol 1e-12.
"""

import numpy as np
import pytest
import torch

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.common import functions as jax_functions
from flink_ml_tpu.linalg import blas as jax_blas
from flink_ml_tpu.linalg import vectors as jax_vectors
from flink_ml_tpu.models import evaluation as jax_evaluation
from flink_ml_tpu.models import stats as jax_stats_ops
from flink_ml_tpu.models.classification import NaiveBayes as JaxNaiveBayes
from flink_ml_tpu.ops import columnar as jax_columnar
from flink_ml_tpu.ops import quantile as jax_quantile
from flink_ml_tpu.ops import stats as jax_stats
from flink_ml_tpu_torch import Table, convert
from flink_ml_tpu_torch.common import functions as port_functions
from flink_ml_tpu_torch.linalg import blas as port_blas
from flink_ml_tpu_torch.linalg import vectors as port_vectors
from flink_ml_tpu_torch.models import evaluation as port_evaluation
from flink_ml_tpu_torch.models import stats as port_stats_ops
from flink_ml_tpu_torch.models.classification import (
    NaiveBayes,
    NaiveBayesModel,
)
from flink_ml_tpu_torch.ops import quantile as port_quantile
from flink_ml_tpu_torch.ops import stats as port_stats
from flink_ml_tpu_torch.utils import io as rw

KINDS = ("host", "tensor")


def _tables(kind, **cols):
    """(JAX table, port table) of the same numpy columns, as host columns
    or as float32 device columns (jax.Array / CPU tensor)."""
    if kind == "host":
        return JaxTable.from_columns(**cols), Table.from_columns(**cols)
    jcols, pcols = {}, {}
    for name, v in cols.items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            v = v.astype(np.float32)
        jcols[name] = jax_columnar.to_device(v)
        pcols[name] = torch.from_numpy(np.ascontiguousarray(v))
    return JaxTable.from_columns(**jcols), Table.from_columns(**pcols)


def _np(col):
    if isinstance(col, torch.Tensor):
        return col.numpy()
    if isinstance(col, np.ndarray) and col.dtype == object:
        return np.stack([np.asarray(v.to_array() if hasattr(v, "to_array")
                                    else v) for v in col])
    return np.asarray(col)


def _labeled(seed, label_kind, n=240, d=5, categorical=False):
    rng = np.random.default_rng(seed)
    y = (rng.integers(0, 3, n).astype(np.float64)
         if label_kind == "categorical" else rng.normal(size=n))
    x = rng.normal(size=(n, d))
    x[:, 0] += 0.3 * y
    x[:, 2] -= 0.1 * y
    if categorical:
        x = np.floor(np.clip(x, -1.99, 2.99))
    return x, y


# -- ops/stats.py ------------------------------------------------------------

TESTS = [("chi_square_test", "categorical", True),
         ("anova_f_test", "categorical", False),
         ("f_value_test", "continuous", False)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fn,label_kind,categorical", TESTS,
                         ids=[t[0] for t in TESTS])
def test_stats_cores_match_jax(fn, label_kind, categorical, kind):
    x, y = _labeled(1, label_kind, categorical=categorical)
    if kind == "host":
        want = getattr(jax_stats, fn)(x, y)
        got = getattr(port_stats, fn)(x, y)
        rtol = 1e-9
    else:
        x32 = x.astype(np.float32)
        # the JAX package counts χ² on the host (exact counts either way)
        jx = x32 if fn == "chi_square_test" else jax_columnar.to_device(x32)
        want = getattr(jax_stats, fn)(jx, y)
        got = getattr(port_stats, fn)(torch.from_numpy(x32),
                                      torch.from_numpy(y.astype(np.float32)))
        rtol = 1e-9 if fn == "chi_square_test" else 1e-5
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=1e-12)
    np.testing.assert_array_equal(got[2], want[2])


def test_anova_constant_and_perfect_features_match_jax():
    y = np.repeat([0.0, 1.0, 2.0], 16)
    x = np.stack([np.full(48, 3.0), y * 2.0, np.arange(48.0)], axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        want = jax_stats.anova_f_test(
            jax_columnar.to_device(x.astype(np.float32)), y)
        got = port_stats.anova_f_test(torch.from_numpy(x.astype(np.float32)),
                                      torch.from_numpy(y))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-5)
    assert np.isnan(got[0][0]) and np.isinf(got[0][1])


OPS = [("ChiSqTest", "categorical", True), ("ANOVATest", "categorical", False),
       ("FValueTest", "continuous", False)]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("flatten", [False, True])
@pytest.mark.parametrize("name,label_kind,categorical", OPS,
                         ids=[o[0] for o in OPS])
def test_test_operators_match_jax(name, label_kind, categorical, flatten,
                                  kind):
    x, y = _labeled(2, label_kind, categorical=categorical)
    jt = JaxTable.from_columns(features=x, label=y)
    _, pt = _tables(kind, features=x, label=y)
    want = getattr(jax_stats_ops, name)(flatten=flatten).transform(jt)[0]
    got = getattr(port_stats_ops, name)(device="cpu", flatten=flatten) \
        .transform(pt)[0]
    assert got.column_names == want.column_names
    rtol = 1e-9 if kind == "host" or name == "ChiSqTest" else 1e-4
    for col in got.column_names:
        g, w = _np(got[col]), _np(want[col])
        if g.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-10)


# -- BinaryClassificationEvaluator -----------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("raw", ["scalar", "vector"])
def test_binary_evaluator_matches_jax(kind, weighted, raw):
    rng = np.random.default_rng(3)
    n = 400
    y = (rng.random(n) < 0.4).astype(np.float64)
    score = np.round(1 / (1 + np.exp(-(rng.normal(size=n) + 1.2 * y))), 2)
    cols = dict(label=y, rawPrediction=(
        score if raw == "scalar" else np.stack([1 - score, score], axis=1)))
    if weighted:
        cols["w"] = rng.random(n) + 0.1
    if kind == "tensor":  # the same float32 values on both sides
        cols = {k: v.astype(np.float32) for k, v in cols.items()}
    jt = JaxTable.from_columns(**cols)
    _, pt = _tables(kind, **cols)
    names = ["areaUnderROC", "areaUnderPR", "ks", "areaUnderLorenz"]
    params = dict(metrics_names=names,
                  weight_col="w" if weighted else None)
    want = jax_evaluation.BinaryClassificationEvaluator(**params) \
        .transform(jt)[0]
    got = port_evaluation.BinaryClassificationEvaluator(
        device="cpu", **params).transform(pt)[0]
    for name in names:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-9)


# -- NaiveBayes --------------------------------------------------------------

def _nb_data(seed, integral=True, n=300, d=4):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, n).astype(np.float64)
    x = np.floor(rng.random((n, d)) * 5) + (y[:, None] == 1) * \
        (rng.random((n, d)) < 0.5)
    if not integral:
        x = x * 0.5 - 1.0
    return x, y


def _assert_nb_models_equal(got, want):
    np.testing.assert_array_equal(got.labels, np.asarray(want.labels))
    np.testing.assert_allclose(got.pi, want.pi, rtol=1e-9)
    np.testing.assert_allclose(got.floors, want.floors, rtol=1e-9)
    for row_g, row_w in zip(got.theta, want.theta):
        for m_g, m_w in zip(row_g, row_w):
            assert sorted(m_g) == sorted(m_w)
            np.testing.assert_allclose([m_g[k] for k in sorted(m_g)],
                                       [m_w[k] for k in sorted(m_w)],
                                       rtol=1e-9)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("integral", [True, False])
@pytest.mark.parametrize("smoothing", [1.0, 0.5])
def test_naive_bayes_fit_and_predict_match_jax(kind, integral, smoothing):
    x, y = _nb_data(4, integral)
    jt, pt = _tables(kind, features=x, label=y)
    want = JaxNaiveBayes(smoothing=smoothing).fit(jt)
    got = NaiveBayes(device="cpu", smoothing=smoothing).fit(pt)
    _assert_nb_models_equal(got, want)
    # unseen values take the floor
    x_new = np.concatenate([x[:50], np.full((4, x.shape[1]), 99.0)])
    jn, pn = _tables(kind, features=x_new)
    pred = got.transform(pn)[0]["prediction"]
    assert isinstance(pred, torch.Tensor) == (kind == "tensor")
    np.testing.assert_array_equal(
        _np(pred), _np(want.transform(jn)[0]["prediction"]))


def test_naive_bayes_models_cross_packages(tmp_path):
    x, y = _nb_data(5)
    jt = JaxTable.from_columns(features=x, label=y)
    want = JaxNaiveBayes().fit(jt)
    expected = np.asarray(want.transform(jt)[0]["prediction"])
    want.save(str(tmp_path / "jax"))
    loaded = rw.load_stage(str(tmp_path / "jax"), device="cpu")
    assert isinstance(loaded, NaiveBayesModel)
    _assert_nb_models_equal(loaded, want)
    tensor_table = Table.from_columns(features=torch.from_numpy(x))
    for model in (loaded, convert.naive_bayes_model_from_arrays(
            want.theta, want.pi, want.labels, want.floors, device="cpu")):
        np.testing.assert_array_equal(
            model.transform(Table.from_columns(features=x))[0]["prediction"],
            expected)
        np.testing.assert_array_equal(
            model.transform(tensor_table)[0]["prediction"].numpy(), expected)
    loaded.save(str(tmp_path / "port"))
    again = NaiveBayesModel.load(str(tmp_path / "port"), device="cpu")
    _assert_nb_models_equal(again, want)
    (md,) = again.get_model_data()
    fresh = NaiveBayesModel(device="cpu").set_model_data(md)
    _assert_nb_models_equal(fresh, want)
    with pytest.raises(ValueError, match="floors"):
        convert.naive_bayes_model_from_arrays(want.theta, want.pi,
                                              want.labels, want.floors[0])


# -- quantiles ---------------------------------------------------------------

def _adversarial_columns(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(301, 6)).astype(np.float32)
    x[:, 1] = np.float32(3.5)                     # constant column
    x[::7, 2] = np.float32(-0.0)
    x[1::7, 2] = np.float32(0.0)
    x[::11, 3] = np.inf
    x[5::13, 3] = -np.inf
    x[::17, 4] = np.nan
    x[:, 5] = rng.normal(size=301).astype(np.float32) * 1e-40  # denormals
    return x


@pytest.mark.parametrize("probs", [[0.25, 0.5, 0.75], [0.0, 1.0],
                                   [0.1, 0.37, 0.9]])
def test_rank_select_device_bit_for_bit_with_jax(probs):
    x = _adversarial_columns(len(probs))
    got = port_quantile.rank_select_device(torch.from_numpy(x), probs)
    want = np.asarray(jax_quantile.rank_select_device(
        jax_columnar.to_device(x[:296]), probs))
    got_296 = port_quantile.rank_select_device(torch.from_numpy(x[:296]),
                                               probs)
    assert got.dtype == torch.float32 and got.shape == (len(probs), 6)
    np.testing.assert_array_equal(got_296.numpy().view(np.int32),
                                  want.view(np.int32))
    # the finite columns against numpy's 'lower' quantile
    lower = np.quantile(x[:, [0, 1, 5]], probs, axis=0, method="lower")
    np.testing.assert_array_equal(got.numpy()[:, [0, 1, 5]], lower)


@pytest.mark.parametrize("columns", [1, 4])
def test_rank_select_device_sorts_column_groups_bit_for_bit(columns,
                                                            monkeypatch):
    """Columns sorted a group at a time (as at full size) give the JAX
    package's keys bit for bit, the last group short."""
    x = _adversarial_columns(4)[:296]
    probs = [0.0, 0.25, 0.5, 0.75, 1.0]
    monkeypatch.setattr(port_quantile, "_SORT_ELEMS", columns * x.shape[0])
    got = port_quantile.rank_select_device(torch.from_numpy(x), probs)
    want = np.asarray(jax_quantile.rank_select_device(
        jax_columnar.to_device(x), probs))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_approx_quantiles_and_summary_match_jax():
    x = np.random.default_rng(8).normal(size=(257, 5))
    probs = [0.05, 0.5, 0.95]
    np.testing.assert_array_equal(
        port_quantile.approx_quantiles(x, probs),
        jax_quantile.approx_quantiles(x, probs))
    a, b = port_quantile.QuantileSummary(0.01), \
        jax_quantile.QuantileSummary(0.01)
    values = np.random.default_rng(9).normal(size=3000)
    a.insert_all(values)
    b.insert_all(values)
    np.testing.assert_array_equal(a.query_all(probs), b.query_all(probs))


# -- linalg/blas.py and common/functions.py ---------------------------------

def _pair(make):
    """The same vector or matrix in both packages."""
    return make(jax_vectors), make(port_vectors)


def test_blas_matches_jax():
    rng = np.random.default_rng(10)
    a, b = rng.normal(size=7), rng.normal(size=7)
    jd, pd = _pair(lambda m: m.DenseVector(a))
    js, ps = _pair(lambda m: m.SparseVector(7, [1, 4, 6], [2.0, -1.0, 0.5]))
    js2, ps2 = _pair(lambda m: m.SparseVector(7, [0, 4], [3.0, 2.0]))
    for jx, px in ((jd, pd), (js, ps), (b, b)):
        for jy, py in ((jd, pd), (js2, ps2)):
            assert port_blas.dot(px, py) == pytest.approx(
                jax_blas.dot(jx, jy), rel=1e-12)
        assert port_blas.asum(px) == pytest.approx(jax_blas.asum(jx),
                                                   rel=1e-12)
    for p in (1.0, 2.0, 3.0, np.inf):
        assert port_blas.norm(ps, p) == pytest.approx(jax_blas.norm(js, p),
                                                      rel=1e-12)
    assert port_blas.norm2(pd) == pytest.approx(jax_blas.norm2(jd),
                                                rel=1e-12)
    # in place: axpy (dense, sparse, sliced), h_dot, scal, gemv
    jy, py = _pair(lambda m: m.DenseVector(b.copy()))
    jax_blas.axpy(0.5, js, jy)
    port_blas.axpy(0.5, ps, py)
    jax_blas.axpy(2.0, jd, jy, k=3)
    port_blas.axpy(2.0, pd, py, k=3)
    jax_blas.h_dot(js2, jy)
    port_blas.h_dot(ps2, py)
    jax_blas.scal(-1.5, jy)
    port_blas.scal(-1.5, py)
    np.testing.assert_allclose(py.values, jy.values, rtol=1e-12)
    mat = rng.normal(size=(7, 4))
    jm, pm = _pair(lambda m: m.DenseMatrix(7, 4, mat))
    for trans, xv in ((False, rng.normal(size=4)), (True, a)):
        jy, py = _pair(lambda m: m.DenseVector(
            np.ones(4 if trans else 7)))
        jax_blas.gemv(2.0, jm, trans, xv, jy, beta=0.5)
        port_blas.gemv(2.0, pm, trans, xv, py, beta=0.5)
        np.testing.assert_allclose(py.values, jy.values, rtol=1e-12)
    assert port_vectors.DenseMatrix.from_bytes(pm.to_bytes()) == pm
    assert pm.to_bytes() == jm.to_bytes()
    assert ps.to_dense().to_sparse() == ps
    assert port_vectors.Vectors.dense(1.0, 2.0) == \
        port_vectors.DenseVector([1.0, 2.0])
    assert port_vectors.VectorWithNorm(pd).l2_norm == pytest.approx(
        np.linalg.norm(a))


def test_functions_match_jax():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(6, 3))
    jt = JaxTable.from_columns(v=x, a=[list(r) for r in x])
    pt = Table.from_columns(v=x, a=[list(r) for r in x])
    assert list(port_functions.vector_to_array(pt, "v", "o")["o"]) == \
        list(jax_functions.vector_to_array(jt, "v", "o")["o"])
    np.testing.assert_array_equal(
        port_functions.array_to_vector(pt, "a", "o")["o"],
        jax_functions.array_to_vector(jt, "a", "o")["o"])
    ragged = [[1.0], [1.0, 2.0]]
    got = port_functions.array_to_vector(
        Table.from_columns(a=ragged), "a", "o")["o"]
    want = jax_functions.array_to_vector(
        JaxTable.from_columns(a=ragged), "a", "o")["o"]
    assert [list(v.values) for v in got] == [list(v.values) for v in want]
    for n in (1, 256, 257, 1 << 16, (1 << 16) + 1, 1 << 31, (1 << 31) + 1):
        assert port_functions.narrow_uint(n) == jax_functions.narrow_uint(n)
