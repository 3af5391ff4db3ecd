"""The port's dense feature transformers and selectors, held against the JAX
package.

Every case runs the same numpy-seeded table through a JAX stage and its
port counterpart (``device="cpu"``), in two column kinds:

- ``host``: numpy columns. The fit statistics are float64 on both sides
  and agree within rtol 1e-9; the transforms compute in float32 on both
  sides and agree within rtol 1e-5 / atol 1e-6 (the DCT is a product with
  the DCT matrix in the port, an FFT in the JAX package).
- ``tensor``: a CPU ``torch.Tensor`` column in the port, a CPU
  ``jax.Array`` column (the JAX package's device path, on its 8-device CPU
  mesh) in the JAX package. Float32 statistics and outputs agree within
  rtol 1e-5 / atol 1e-6.

Discrete outputs (selected indices, bucket ids, binarized values) are
exact in both; RobustScaler's tensor-column quantiles are the same
elements. CSR branches, save/load across the packages
and the ``convert.py`` functions are covered too.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.linalg import sparse as jax_sparse
from flink_ml_tpu.models import feature as jf
from flink_ml_tpu.ops import columnar as jax_columnar
from flink_ml_tpu_torch import Table, convert
from flink_ml_tpu_torch.linalg import sparse as port_sparse
from flink_ml_tpu_torch.models import feature as pf
from flink_ml_tpu_torch.ops import columnar
from flink_ml_tpu_torch.utils import io as rw

KINDS = ("host", "tensor")
STAT_RTOL = {"host": 1e-9, "tensor": 1e-5}
OUT_RTOL, OUT_ATOL = 1e-5, 1e-6


def _np(col):
    if isinstance(col, torch.Tensor):
        return col.numpy()
    if getattr(col, "is_csr_vector_column", False):
        return col.to_csr().toarray()
    if isinstance(col, np.ndarray) and col.dtype == object:
        return np.stack([np.asarray(v.to_array() if hasattr(v, "to_array")
                                    else v) for v in col])
    return np.asarray(col)


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


def _assert_out(got, want, exact=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=OUT_RTOL, atol=OUT_ATOL)


def _data(seed=0, n=256, d=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)) * np.linspace(0.5, 5.0, d)
            + np.linspace(-2.0, 3.0, d))


# -- scalers -----------------------------------------------------------------

SCALERS = [
    ("StandardScaler", dict(with_mean=True, with_std=True), ("mean", "std")),
    ("StandardScaler", dict(), ("mean", "std")),
    ("StandardScaler", dict(with_mean=True, with_std=False), ("mean", "std")),
    ("MinMaxScaler", dict(min=-1.0, max=2.0), ("data_min", "data_max")),
    ("MaxAbsScaler", dict(), ("max_abs",)),
    ("RobustScaler", dict(with_centering=True), ("medians", "ranges")),
    ("RobustScaler", dict(lower=0.1, upper=0.9), ("medians", "ranges")),
]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,params,stats", SCALERS,
                         ids=[f"{s[0]}-{i}" for i, s in enumerate(SCALERS)])
def test_scaler_fit_and_transform_match_jax(name, params, stats, kind):
    x = _data(1)
    x[3, 2] = x[3, 2] * 40.0  # an outlier for the quantiles
    jt, pt = _tables(kind, input=x)
    want = getattr(jf, name)(**params).fit(jt)
    got = getattr(pf, name)(device="cpu", **params).fit(pt)
    for stat in stats:
        if name == "RobustScaler" and kind == "tensor":
            # rank selection is exact on both devices
            np.testing.assert_array_equal(getattr(got, stat),
                                          np.asarray(getattr(want, stat)))
        else:
            np.testing.assert_allclose(getattr(got, stat),
                                       np.asarray(getattr(want, stat)),
                                       rtol=STAT_RTOL[kind], atol=1e-12)
    out = got.transform(pt)[0]["output"]
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    _assert_out(out, want.transform(jt)[0]["output"])


def test_minmax_constant_dimension_maps_to_midpoint():
    x = np.ones((16, 2))
    x[:, 1] = np.arange(16)
    got = pf.MinMaxScaler(device="cpu").fit(Table.from_columns(input=x))
    want = jf.MinMaxScaler().fit(JaxTable.from_columns(input=x))
    _assert_out(got.transform(Table.from_columns(input=x))[0]["output"],
                want.transform(JaxTable.from_columns(input=x))[0]["output"])


@pytest.mark.parametrize("name,params,stats", [
    ("StandardScaler", dict(), ("mean", "std")),
    ("StandardScaler", dict(with_std=False), ("mean", "std")),
    ("MaxAbsScaler", dict(), ("max_abs",)),
    ("MinMaxScaler", dict(), ("data_min", "data_max")),
])
def test_scaler_sparse_branch_matches_jax(name, params, stats):
    m = sp.random(64, 10, density=0.3, random_state=3, format="csr") * 4 - \
        sp.random(64, 10, density=0.1, random_state=4, format="csr")
    jt = JaxTable.from_columns(input=jax_sparse.CsrVectorColumn(m))
    pt = Table.from_columns(input=port_sparse.CsrVectorColumn(m))
    want = getattr(jf, name)(**params).fit(jt)
    got = getattr(pf, name)(device="cpu", **params).fit(pt)
    for stat in stats:
        np.testing.assert_allclose(getattr(got, stat), getattr(want, stat),
                                   rtol=1e-12, atol=1e-15)
    out = got.transform(pt)[0]["output"]
    jout = want.transform(jt)[0]["output"]
    if name == "MinMaxScaler":  # the offset densifies: a float32 tensor
        _assert_out(out, jout)
    else:
        assert getattr(out, "is_csr_vector_column", False)
        np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-12)


@pytest.mark.parametrize("name,params", [
    ("StandardScaler", dict(with_mean=True)),
    ("MinMaxScaler", dict(min=0.5)),
    ("MaxAbsScaler", dict()),
    ("RobustScaler", dict(with_centering=True)),
])
def test_scaler_models_cross_packages_by_save_and_arrays(name, params,
                                                         tmp_path):
    x = _data(5)
    jt, pt = JaxTable.from_columns(input=x), Table.from_columns(input=x)
    want = getattr(jf, name)(**params).fit(jt)
    want.save(str(tmp_path / "jax"))
    loaded = rw.load_stage(str(tmp_path / "jax"), device="cpu")
    assert type(loaded) is getattr(pf, name + "Model")
    expected = want.transform(jt)[0]["output"]
    _assert_out(loaded.transform(pt)[0]["output"], expected)
    # port save → port load keeps params and statistics
    loaded.save(str(tmp_path / "port"))
    again = getattr(pf, name + "Model").load(str(tmp_path / "port"),
                                            device="cpu")
    for stat in loaded.STAT_NAMES:
        np.testing.assert_array_equal(getattr(again, stat),
                                      getattr(loaded, stat))
    _assert_out(again.transform(pt)[0]["output"], expected)
    # the JAX model's arrays through convert.py
    fn = {"StandardScaler": convert.standard_scaler_model_from_arrays,
          "MinMaxScaler": convert.min_max_scaler_model_from_arrays,
          "MaxAbsScaler": convert.max_abs_scaler_model_from_arrays,
          "RobustScaler": convert.robust_scaler_model_from_arrays}[name]
    arrays = [getattr(want, s) for s in want.STAT_NAMES]
    built = fn(*arrays, device="cpu", **params)
    _assert_out(built.transform(pt)[0]["output"], expected)
    # and the model data table round trip
    (md,) = built.get_model_data()
    fresh = getattr(pf, name + "Model")(device="cpu", **params) \
        .set_model_data(md)
    _assert_out(fresh.transform(pt)[0]["output"], expected)


def test_convert_rejects_mismatched_statistics():
    with pytest.raises(ValueError, match="statistics"):
        convert.standard_scaler_model_from_arrays(np.zeros(3), np.zeros(4))
    with pytest.raises(ValueError, match="indices"):
        convert.variance_threshold_selector_model_from_arrays(np.zeros((2, 2)))


# -- vector transformers -----------------------------------------------------

VECTOR_OPS = [
    ("Normalizer", dict(p=2.0)),
    ("Normalizer", dict(p=1.0)),
    ("Normalizer", dict(p=3.0)),
    ("Normalizer", dict(p=float("inf"))),
    ("ElementwiseProduct", dict(scaling_vec=[1.0, -2.0, 0.5, 3.0, 0.0, 7.0])),
    ("PolynomialExpansion", dict(degree=1)),
    ("PolynomialExpansion", dict(degree=2)),
    ("PolynomialExpansion", dict(degree=3)),
    ("DCT", dict()),
    ("DCT", dict(inverse=True)),
    ("VectorSlicer", dict(indices=[4, 0, 2, 2])),
]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,params", VECTOR_OPS,
                         ids=[f"{v[0]}-{i}" for i, v in enumerate(VECTOR_OPS)])
def test_vector_op_matches_jax(name, params, kind):
    x = _data(2, n=128)
    x[7] = 0.0  # a zero row: the norm divides by 1
    jt, pt = _tables(kind, input=x)
    want = getattr(jf, name)(**params).transform(jt)[0]["output"]
    got = getattr(pf, name)(device="cpu", **params).transform(pt)[0]["output"]
    assert isinstance(got, torch.Tensor)
    _assert_out(got, want, exact=(name == "VectorSlicer"))


def test_dct_round_trip_and_slicer_bounds():
    x = torch.from_numpy(_data(3, n=32).astype(np.float32))
    t = Table.from_columns(input=x)
    y = pf.DCT(device="cpu", output_col="y").transform(t)[0]
    back = pf.DCT(device="cpu", inverse=True, input_col="y") \
        .transform(y)[0]["output"]
    np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(IndexError):
        pf.VectorSlicer(device="cpu", indices=[6]).transform(t)
    with pytest.raises(ValueError):
        pf.VectorSlicer(device="cpu", indices=[-1]).transform(t)


@pytest.mark.parametrize("kind", KINDS)
def test_interaction_matches_jax(kind):
    rng = np.random.default_rng(4)
    cols = dict(a=rng.normal(size=64), b=rng.normal(size=(64, 3)),
                c=rng.normal(size=(64, 2)))
    jt, pt = _tables(kind, **cols)
    want = jf.Interaction(input_cols=["a", "b", "c"]).transform(jt)[0]
    got = pf.Interaction(device="cpu", input_cols=["a", "b", "c"]) \
        .transform(pt)[0]
    _assert_out(got["output"], want["output"])
    assert got["output"].shape == (64, 6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("handle", ["keep", "skip", "error"])
def test_vector_assembler_matches_jax(kind, handle):
    rng = np.random.default_rng(5)
    cols = dict(a=rng.normal(size=64), b=rng.normal(size=(64, 3)),
                label=np.arange(64.0))
    cols["a"][[3, 40]] = np.nan
    jt, pt = _tables(kind, **cols)
    params = dict(input_cols=["a", "b"], output_col="v",
                  handle_invalid=handle)
    if handle == "error":
        with pytest.raises(ValueError, match="NaN"):
            jf.VectorAssembler(**params).transform(jt)
        with pytest.raises(ValueError, match="NaN"):
            pf.VectorAssembler(device="cpu", **params).transform(pt)
        return
    want = jf.VectorAssembler(**params).transform(jt)[0]
    got = pf.VectorAssembler(device="cpu", **params).transform(pt)[0]
    assert got.num_rows == want.num_rows == (64 if handle == "keep" else 62)
    for name in ("v", "label"):
        _assert_out(got[name], want[name])
    if kind == "tensor":  # assembled on the device, nothing off-ramped
        assert isinstance(got["v"], torch.Tensor)
        assert isinstance(got["label"], torch.Tensor)


@pytest.mark.parametrize("kind", KINDS)
def test_vector_assembler_input_sizes_match_jax(kind):
    rng = np.random.default_rng(6)
    jt, pt = _tables(kind, a=rng.normal(size=32), b=rng.normal(size=(32, 2)))
    ok = dict(input_cols=["a", "b"], output_col="v", input_sizes=[1, 2])
    _assert_out(pf.VectorAssembler(device="cpu", **ok).transform(pt)[0]["v"],
                jf.VectorAssembler(**ok).transform(jt)[0]["v"])
    bad = dict(ok, input_sizes=[1, 3])
    with pytest.raises(ValueError, match="size"):
        jf.VectorAssembler(**bad).transform(jt)
    with pytest.raises(ValueError, match="size"):
        pf.VectorAssembler(device="cpu", **bad).transform(pt)
    skip = dict(bad, handle_invalid="skip")
    assert pf.VectorAssembler(device="cpu", **skip).transform(pt)[0] \
        .num_rows == jf.VectorAssembler(**skip).transform(jt)[0].num_rows == 0


@pytest.mark.parametrize("kind", KINDS)
def test_binarizer_matches_jax_exactly(kind):
    rng = np.random.default_rng(7)
    jt, pt = _tables(kind, s=rng.random(64), v=rng.normal(size=(64, 3)))
    params = dict(input_cols=["s", "v"], output_cols=["os", "ov"],
                  thresholds=[0.5, -0.2])
    want = jf.Binarizer(**params).transform(jt)[0]
    got = pf.Binarizer(device="cpu", **params).transform(pt)[0]
    for name in ("os", "ov"):
        _assert_out(got[name], want[name], exact=True)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("handle", ["keep", "skip", "error"])
def test_bucketizer_matches_jax_exactly(kind, handle):
    rng = np.random.default_rng(8)
    a = rng.uniform(-1.5, 2.5, size=96)
    a[[0, 1, 2]] = [0.5, 2.0, -1.0]   # on splits, the top boundary
    a[5] = np.nan
    b = rng.uniform(0.0, 1.0, size=96)
    jt, pt = _tables(kind, a=a, b=b)
    params = dict(input_cols=["a", "b"], output_cols=["oa", "ob"],
                  splits_array=[[-1.0, 0.0, 0.5, 1.0, 2.0],
                                [0.0, 0.25, 1.0]],
                  handle_invalid=handle)
    if handle == "error":
        with pytest.raises(ValueError, match="invalid"):
            pf.Bucketizer(device="cpu", **params).transform(pt)
        return
    want = jf.Bucketizer(**params).transform(jt)[0]
    got = pf.Bucketizer(device="cpu", **params).transform(pt)[0]
    assert got.num_rows == want.num_rows
    for name in ("oa", "ob", "a"):
        _assert_out(got[name], want[name], exact=True)


# -- CSR branches of the vector ops -----------------------------------------

def _csr_tables():
    m = sp.random(48, 8, density=0.25, random_state=11, format="csr")
    m.data = m.data * 4 - 2
    s = np.random.default_rng(12).normal(size=48)
    return (JaxTable.from_columns(x=jax_sparse.CsrVectorColumn(m), s=s),
            Table.from_columns(x=port_sparse.CsrVectorColumn(m), s=s))


@pytest.mark.parametrize("name,params", [
    ("Normalizer", dict(input_col="x", p=2.0)),
    ("Normalizer", dict(input_col="x", p=float("inf"))),
    ("ElementwiseProduct", dict(input_col="x", scaling_vec=np.arange(8.0))),
    ("VectorSlicer", dict(input_col="x", indices=[1, 5, 7])),
    ("Binarizer", dict(input_cols=["x"], output_cols=["output"],
                       thresholds=[0.5])),
    ("Interaction", dict(input_cols=["s", "x"])),
    ("VectorAssembler", dict(input_cols=["x", "s"], output_col="output")),
])
def test_csr_branches_match_jax(name, params):
    jt, pt = _csr_tables()
    want = getattr(jf, name)(**params).transform(jt)[0]["output"]
    got = getattr(pf, name)(device="cpu", **params).transform(pt)[0]["output"]
    assert getattr(got, "is_csr_vector_column", False)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-12)
    assert got.to_csr().nnz == want.to_csr().nnz


# -- selectors ---------------------------------------------------------------

def _selector_data(kind, label_kind, seed=13):
    rng = np.random.default_rng(seed)
    n = 240
    if label_kind == "categorical":
        y = rng.integers(0, 3, n).astype(np.float64)
    else:
        y = rng.normal(size=n)
    x = rng.normal(size=(n, 8))
    x[:, 1] += y * 1.5
    x[:, 4] -= y * 0.4
    x[:, 6] += y * 0.05
    return x, y


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ftype,ltype", [("continuous", "categorical"),
                                         ("continuous", "continuous"),
                                         ("categorical", "categorical")])
@pytest.mark.parametrize("mode,thr", [("numTopFeatures", 3),
                                      ("percentile", 0.5), ("fpr", 0.05),
                                      ("fdr", 0.05), ("fwe", 0.05)])
def test_univariate_selector_matches_jax(kind, ftype, ltype, mode, thr):
    x, y = _selector_data(kind, ltype)
    if ftype == "categorical":
        x = np.floor(np.clip(x, -2.99, 2.99))
    jt, pt = _tables(kind, features=x, label=y)
    params = dict(feature_type=ftype, label_type=ltype, selection_mode=mode,
                  selection_threshold=thr, output_col="o")
    want = jf.UnivariateFeatureSelector(**params).fit(jt)
    got = pf.UnivariateFeatureSelector(device="cpu", **params).fit(pt)
    np.testing.assert_array_equal(got.indices, want.indices)
    _assert_out(got.transform(pt)[0]["o"], want.transform(jt)[0]["o"],
                exact=True)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("threshold", [0.0, 1.0, 4.0])
def test_variance_threshold_selector_matches_jax(kind, threshold):
    x = _data(14)
    x[:, 3] = 2.0  # constant: variance 0
    jt, pt = _tables(kind, input=x)
    want = jf.VarianceThresholdSelector(variance_threshold=threshold).fit(jt)
    got = pf.VarianceThresholdSelector(
        device="cpu", variance_threshold=threshold).fit(pt)
    np.testing.assert_array_equal(got.indices, want.indices)
    _assert_out(got.transform(pt)[0]["output"],
                want.transform(jt)[0]["output"], exact=True)


@pytest.mark.parametrize("name,params", [
    ("VarianceThresholdSelector", dict(variance_threshold=0.01)),
    ("UnivariateFeatureSelector", dict(
        features_col="input", feature_type="continuous",
        label_type="continuous", selection_threshold=2)),
])
def test_selector_sparse_save_load_and_convert(name, params, tmp_path):
    m = sp.random(60, 7, density=0.4, random_state=15, format="csr")
    y = np.asarray(m.sum(axis=1)).ravel()
    jt = JaxTable.from_columns(input=jax_sparse.CsrVectorColumn(m), label=y)
    pt = Table.from_columns(input=port_sparse.CsrVectorColumn(m), label=y)
    if name == "UnivariateFeatureSelector":  # the tests densify CSR
        jt = JaxTable.from_columns(input=m.toarray(), label=y)
    want = getattr(jf, name)(**params).fit(jt)
    got = getattr(pf, name)(device="cpu", **params).fit(pt)
    np.testing.assert_array_equal(got.indices, want.indices)
    out = got.transform(pt)[0]["output"]
    np.testing.assert_allclose(_np(out), m.toarray()[:, want.indices])
    want.save(str(tmp_path / "jax"))
    loaded = rw.load_stage(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_array_equal(loaded.indices, want.indices)
    fn = {"VarianceThresholdSelector":
          convert.variance_threshold_selector_model_from_arrays,
          "UnivariateFeatureSelector":
          convert.univariate_feature_selector_model_from_arrays}[name]
    model_params = {k: v for k, v in params.items() if k == "features_col"}
    built = fn(want.indices, device="cpu", **model_params)
    (md,) = built.get_model_data()
    fresh = getattr(pf, name + "Model")(device="cpu", **model_params) \
        .set_model_data(md)
    for model in (loaded, built, fresh):
        np.testing.assert_allclose(_np(model.transform(pt)[0]["output"]),
                                   _np(out))


# -- the on-ramp -------------------------------------------------------------

def test_columnar_on_ramp_keeps_tensors_and_casts_host_floats():
    t = torch.arange(6.0).reshape(3, 2)
    assert columnar.to_device(t, "cpu") is t
    host = columnar.to_device(np.arange(4.0), "cpu")
    assert host.dtype == torch.float32
    ints = columnar.to_device(np.arange(4), "cpu")
    assert ints.dtype == torch.int64
    table = Table.from_columns(v=t, h=np.arange(3.0))
    x, xp = columnar.fit_vectors(table, "v")
    assert xp is torch and x is t
    x, xp = columnar.fit_vectors(table, "h")
    assert xp is np and x.dtype == np.float64 and x.shape == (3, 1)
    assert columnar.input_scalars(table, "h", "cpu").dtype == torch.float32
    np.testing.assert_array_equal(columnar.take_dims(t, [1]).numpy(),
                                  t.numpy()[:, [1]])
    np.testing.assert_array_equal(columnar.head_rows(t, 2).numpy(),
                                  t.numpy()[:2])
    np.testing.assert_array_equal(columnar.dynamic_rows(t, 1, 2).numpy(),
                                  t.numpy()[1:3])
    np.testing.assert_array_equal(columnar.to_host(t), t.numpy())
