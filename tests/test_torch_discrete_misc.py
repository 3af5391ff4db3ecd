"""The port's discrete encoders and misc ops
(``flink_ml_tpu_torch/models/feature/{discrete,misc}.py``), held against
the JAX package, and the runner on ``benchmark-demo.json``.

Every case runs the same numpy-seeded columns through the JAX stage and its
port counterpart (``device="cpu"``), as host columns and, where the stage
computes on the card, as CPU tensor columns (a ``jax.Array`` on the JAX
side). Indices, vocabularies, category maps, bin ids, row selections and
hashes must be equal (tolerance 0). Statistics: Imputer's mean within rtol
1e-12 (float64 sums in another order), its median and most frequent value
exactly, KBinsDiscretizer's edges within rtol 1e-12. SQL outputs within
rtol 1e-6 on tensor columns (float32 on the port's side, float64 numpy on
the JAX package's host copy) and exactly on host columns.
"""

import json

import numpy as np
import pytest
import torch

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.benchmark import runner as jax_runner
from flink_ml_tpu.models import feature as jf
from flink_ml_tpu.ops import columnar as jax_columnar
from flink_ml_tpu_torch import Table, convert
from flink_ml_tpu_torch.benchmark import runner
from flink_ml_tpu_torch.common import hostpool
from flink_ml_tpu_torch.models import feature as pf
from flink_ml_tpu_torch.utils import io as rw

STAT_RTOL = 1e-12
F32_RTOL = 1e-6
ORDERS = ("arbitrary", "frequencyDesc", "frequencyAsc", "alphabetDesc",
          "alphabetAsc")
INVALID = ("error", "skip", "keep")
DEMO = "flink_ml_tpu/benchmark/configs/benchmark-demo.json"


@pytest.fixture(params=("inline", "forked"))
def pool(request, monkeypatch):
    if request.param == "forked":
        real = hostpool.map_row_shards
        monkeypatch.setenv("FLINK_ML_TPU_HOST_PARALLELISM", "4")
        monkeypatch.setattr(hostpool, "map_row_shards",
                            lambda fn, n, **kw: real(fn, n, min_rows=64))
    return request.param


def _np(col):
    if isinstance(col, torch.Tensor):
        return col.numpy()
    if getattr(col, "is_csr_vector_column", False):
        return col.to_csr().toarray()
    return np.asarray(col)


def _tables(kind, **cols):
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


def _both(jstage, pstage, jt, pt):
    """(port output, JAX output) tables, or the two exceptions' types."""
    try:
        want = jstage.transform(jt)[0]
    except ValueError as e:
        with pytest.raises(type(e)):
            pstage.transform(pt)
        return None, None
    return pstage.transform(pt)[0], want


# -- StringIndexer / IndexToString --------------------------------------------

def _string_cols(seed, n=900):
    rng = np.random.default_rng(seed)
    words = np.array(["b", "a", "c", "dd", "a1", "Z"])
    p = np.array([0.3, 0.3, 0.2, 0.1, 0.05, 0.05])
    return {"s": words[rng.choice(6, n, p=p)],
            "o": np.array([("x" if v else 1.5) for v in rng.integers(0, 2, n)],
                          dtype=object)}


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("handle", INVALID)
def test_string_indexer_matches_jax(pool, order, handle):
    cols = _string_cols(1)
    kw = dict(input_cols=["s", "o"], output_cols=["si", "oi"],
              string_order_type=order, handle_invalid=handle)
    jm = jf.StringIndexer(**kw).fit(JaxTable.from_columns(**cols))
    pm = pf.StringIndexer(device="cpu", **kw).fit(Table.from_columns(**cols))
    assert pm.string_arrays == jm.string_arrays
    test = _string_cols(2, n=300)
    test["s"][::17] = "unseen"
    got, want = _both(jm, pm, JaxTable.from_columns(**test),
                      Table.from_columns(**test))
    if want is None:
        return
    for c in ("si", "oi", "s"):
        np.testing.assert_array_equal(_np(got.column(c)),
                                      _np(want.column(c)))


def test_string_indexer_tensor_column_and_index_to_string():
    vals = np.random.default_rng(3).integers(0, 7, 400).astype(np.float32)
    jt, pt = _tables("tensor", x=vals)
    kw = dict(input_cols=["x"], output_cols=["i"],
              string_order_type="frequencyDesc")
    jm, pm = jf.StringIndexer(**kw).fit(jt), pf.StringIndexer(
        device="cpu", **kw).fit(pt)
    assert pm.string_arrays == jm.string_arrays
    got = pm.transform(pt)[0].column("i")
    np.testing.assert_array_equal(got, jm.transform(jt)[0].column("i"))
    inv_kw = dict(input_cols=["i"], output_cols=["back"])
    jinv = jf.IndexToString(string_arrays=jm.string_arrays, **inv_kw)
    pinv = convert.string_indexer_model_from_arrays(
        pm.string_arrays, device="cpu", inverse=True, **inv_kw)
    back = pinv.transform(Table.from_columns(i=got))[0].column("back")
    np.testing.assert_array_equal(back, jinv.transform(
        JaxTable.from_columns(i=got))[0].column("back"))
    with pytest.raises(ValueError, match="out of range"):
        pinv.transform(Table.from_columns(i=np.array([99.0])))


# -- OneHotEncoder ------------------------------------------------------------

@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("handle", INVALID)
@pytest.mark.parametrize("kind", ["host", "tensor"])
def test_one_hot_encoder_matches_jax(drop_last, handle, kind):
    rng = np.random.default_rng(4)
    train = {"a": rng.integers(0, 5, 300).astype(np.float64),
             "b": rng.integers(0, 3, 300).astype(np.float64)}
    kw = dict(input_cols=["a", "b"], output_cols=["ea", "eb"],
              drop_last=drop_last, handle_invalid=handle)
    jt, pt = _tables(kind, **train)
    jm = jf.OneHotEncoder(**kw).fit(jt)
    pm = pf.OneHotEncoder(device="cpu", **kw).fit(pt)
    assert pm.category_sizes == jm.category_sizes
    test = {k: v.copy() for k, v in train.items()}
    test["a"][::13] = 7.0
    test["b"][5::29] = 1.5
    got, want = _both(jm, pm, *_tables(kind, **test))
    if want is None:
        return
    for c in ("ea", "eb"):
        g, w = got.column(c).to_csr(), want.column(c).to_csr()
        assert g.shape == w.shape and (g != w).nnz == 0


def test_one_hot_encoder_rejects_non_integers():
    with pytest.raises(ValueError, match="non-negative integers"):
        pf.OneHotEncoder(input_cols=["a"], output_cols=["e"], device="cpu") \
            .fit(Table.from_columns(a=np.array([0.0, 1.5])))


# -- KBinsDiscretizer ---------------------------------------------------------

@pytest.mark.parametrize("strategy", ["uniform", "quantile", "kmeans"])
@pytest.mark.parametrize("kind", ["host", "tensor"])
def test_kbins_discretizer_matches_jax(strategy, kind):
    rng = np.random.default_rng(5)
    x = np.column_stack([rng.normal(size=600), rng.integers(0, 4, 600),
                         np.full(600, 2.5)])
    jt, pt = _tables(kind, x=x)
    kw = dict(input_col="x", output_col="b", strategy=strategy, num_bins=4,
              sub_samples=500)
    jm = jf.KBinsDiscretizer(**kw).fit(jt)
    pm = pf.KBinsDiscretizer(device="cpu", **kw).fit(pt)
    for g, w in zip(pm.bin_edges, jm.bin_edges):
        np.testing.assert_allclose(g, w, rtol=STAT_RTOL)
    got = pm.transform(pt)[0].column("b")
    if kind == "tensor":
        assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(_np(got), _np(jm.transform(jt)[0]
                                                .column("b")))


# -- VectorIndexer ------------------------------------------------------------

def _indexer_matrix(seed, n=5000):
    rng = np.random.default_rng(seed)
    x = np.column_stack([
        rng.integers(0, 4, n),                 # categorical
        rng.normal(size=n),                    # continuous
        rng.integers(0, 3, n) + 0.5,           # fractional categorical
        rng.integers(0, 3, n).astype(float),   # with NaN
        rng.integers(0, 2, n).astype(float),   # with inf
        np.where(np.arange(n) < 4096, 1.0, rng.integers(0, 40, n)),
    ]).astype(np.float64)
    x[7, 3] = np.nan
    x[11, 4] = np.inf
    return x


@pytest.mark.parametrize("kind", ["host", "tensor"])
@pytest.mark.parametrize("handle", INVALID)
def test_vector_indexer_matches_jax(kind, handle):
    x = _indexer_matrix(6)
    jt, pt = _tables(kind, x=x)
    kw = dict(input_col="x", output_col="y", max_categories=5,
              handle_invalid=handle)
    jm = jf.VectorIndexer(**kw).fit(jt)
    pm = pf.VectorIndexer(device="cpu", **kw).fit(pt)
    assert pm.category_maps.keys() == jm.category_maps.keys()
    for dim in jm.category_maps:
        a, b = pm.category_maps[dim], jm.category_maps[dim]
        assert [(k, v) for k, v in a.items() if not np.isnan(k)] == \
            [(k, v) for k, v in b.items() if not np.isnan(k)]
        assert sum(np.isnan(k) for k in a) == sum(np.isnan(k) for k in b)
    test = _indexer_matrix(7, n=300)
    test[3, 0] = 9.0
    got, want = _both(jm, pm, *_tables(kind, x=test))
    if want is None:
        return
    g = got.column("y")
    assert isinstance(g, torch.Tensor) == (kind == "tensor")
    np.testing.assert_array_equal(_np(g), _np(want.column("y")))


def test_vector_indexer_screen_skips_continuous_dims(monkeypatch):
    """Dims with more than maxCategories values in their first 4,096 rows
    never reach the full-column pass."""
    from flink_ml_tpu_torch.models.feature import discrete

    seen = []
    real = discrete._distinct_per_dim
    monkeypatch.setattr(discrete, "_distinct_per_dim",
                        lambda x, k: seen.append(tuple(x.shape)) or real(x, k))
    x = torch.from_numpy(_indexer_matrix(8).astype(np.float32))
    pf.VectorIndexer(input_col="x", output_col="y", max_categories=5,
                     device="cpu").fit(Table.from_columns(x=x))
    assert seen == [(4096, 6), (5000, 5)]


# -- Imputer ------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["mean", "median", "most_frequent"])
@pytest.mark.parametrize("kind", ["host", "tensor"])
@pytest.mark.parametrize("missing", [float("nan"), -1.0, 0.1])
def test_imputer_matches_jax(strategy, kind, missing):
    rng = np.random.default_rng(9)
    cols = {f"c{i}": rng.integers(-1, 6, 1001).astype(np.float64) / 2
            for i in range(3)}
    cols["c0"][::5] = np.nan
    cols["c1"][::7] = 0.1
    jt, pt = _tables(kind, **cols)
    kw = dict(input_cols=list(cols), output_cols=[f"o{i}" for i in range(3)],
              strategy=strategy, missing_value=missing)
    jm = jf.Imputer(**kw).fit(jt)
    pm = pf.Imputer(device="cpu", **kw).fit(pt)
    rtol = STAT_RTOL if strategy == "mean" else 0.0
    np.testing.assert_allclose(pm.surrogates, jm.surrogates, rtol=rtol)
    got, want = pm.transform(pt)[0], jm.transform(jt)[0]
    for i in range(3):
        g = got.column(f"o{i}")
        assert isinstance(g, torch.Tensor) == (kind == "tensor")
        np.testing.assert_allclose(
            _np(g), _np(want.column(f"o{i}")),
            rtol=F32_RTOL if kind == "tensor" else 0.0)


def test_imputer_all_missing_raises():
    t = Table.from_columns(a=torch.tensor([float("nan")] * 3))
    with pytest.raises(ValueError, match="no non-missing"):
        pf.Imputer(input_cols=["a"], output_cols=["b"],
                   device="cpu").fit(t)


# -- RandomSplitter -----------------------------------------------------------

@pytest.mark.parametrize("weights", [(1.0, 1.0), (0.2, 0.5, 0.3)])
def test_random_splitter_matches_jax(weights):
    x = np.arange(500, dtype=np.float64)
    jparts = jf.RandomSplitter(weights=weights, seed=3).transform(
        JaxTable.from_columns(x=x))
    pparts = pf.RandomSplitter(weights=weights, seed=3, device="cpu") \
        .transform(Table.from_columns(x=torch.from_numpy(x)))
    assert len(pparts) == len(jparts)
    for p, j in zip(pparts, jparts):
        np.testing.assert_array_equal(_np(p.column("x")), _np(j.column("x")))


# -- SQLTransformer -----------------------------------------------------------

STATEMENTS = (
    "SELECT *, ABS(v1) AS v2 FROM __THIS__",
    "SELECT v1 * 2 + k AS y, -k, SQRT(ABS(v1)) FROM __THIS__ WHERE k > 1",
    "SELECT k / 2 AS q, k % 3 AS r, POWER(v1, 2) AS p FROM __THIS__ "
    "WHERE NOT (v1 < 0 OR k = 2) AND v1 <> 0.5",
    "SELECT EXP(v1), LN(ABS(v1) + 1) AS l, 3 AS c FROM __THIS__",
    "SELECT k, COUNT(*) AS n FROM __THIS__ GROUP BY k ORDER BY k",
    "SELECT LOWER(s) AS ls, k FROM __THIS__ WHERE s = 'B'",
)


@pytest.mark.parametrize("statement", STATEMENTS)
@pytest.mark.parametrize("kind", ["host", "tensor"])
def test_sql_transformer_matches_jax(statement, kind):
    rng = np.random.default_rng(10)
    v1 = rng.normal(size=200)
    v1[::9] = np.nan
    k = rng.integers(-3, 4, 200).astype(np.int64)
    s = np.array(["A", "B", "c"])[rng.integers(0, 3, 200)]
    if kind == "host":
        jt = JaxTable.from_columns(v1=v1, k=k, s=s)
        pt = Table.from_columns(v1=v1, k=k, s=s)
    else:
        f32 = v1.astype(np.float32)
        jt = JaxTable.from_columns(v1=jax_columnar.to_device(f32), k=k, s=s)
        pt = Table.from_columns(v1=torch.from_numpy(f32),
                                k=torch.from_numpy(k), s=s)
    want = jf.SQLTransformer(statement=statement).transform(jt)[0]
    got = pf.SQLTransformer(statement=statement, device="cpu") \
        .transform(pt)[0]
    assert got.column_names == want.column_names
    for name in want.column_names:
        g, w = _np(got.column(name)), _np(want.column(name))
        assert g.shape == w.shape, name
        if w.dtype.kind in "fiu" and g.dtype.kind in "fiu":
            np.testing.assert_allclose(
                g.astype(np.float64), w.astype(np.float64),
                rtol=F32_RTOL if kind == "tensor" else 0.0, equal_nan=True)
        else:
            np.testing.assert_array_equal(g, w)


def test_sql_transformer_tensor_columns_stay_tensors():
    x = torch.arange(10, dtype=torch.float32) - 5
    out = pf.SQLTransformer(statement="SELECT *, ABS(v1) AS v2 FROM __THIS__",
                            device="cpu").transform(
        Table.from_columns(v1=x))[0]
    assert out.column("v1") is x
    assert isinstance(out.column("v2"), torch.Tensor)
    assert torch.equal(out.column("v2"), x.abs())


# -- MinHashLSH ---------------------------------------------------------------

def test_minhash_lsh_matches_jax(tmp_path):
    from flink_ml_tpu.linalg.vectors import SparseVector as JSparse
    from flink_ml_tpu_torch.linalg.vectors import SparseVector as PSparse

    rng = np.random.default_rng(12)
    rows = [np.unique(rng.integers(0, 50, rng.integers(1, 8)))
            for _ in range(60)]
    jcol = np.empty(60, dtype=object)
    pcol = np.empty(60, dtype=object)
    jcol[:] = [JSparse(50, r, np.ones(len(r))) for r in rows]
    pcol[:] = [PSparse(50, r, np.ones(len(r))) for r in rows]
    ids = np.arange(60)
    kw = dict(input_col="v", output_col="h", num_hash_tables=3,
              num_hash_functions_per_table=2, seed=7)
    jt = JaxTable.from_columns(v=jcol, id=ids)
    pt = Table.from_columns(v=pcol, id=ids)
    jm = jf.MinHashLSH(**kw).fit(jt)
    pm = pf.MinHashLSH(device="cpu", **kw).fit(pt)
    np.testing.assert_array_equal(pm.coeff_a, jm.coeff_a)
    np.testing.assert_array_equal(pm.coeff_b, jm.coeff_b)
    gh = pm.transform(pt)[0].column("h")
    wh = jm.transform(jt)[0].column("h")
    for g, w in zip(gh, wh):
        np.testing.assert_array_equal([v.to_array() for v in g],
                                      [v.to_array() for v in w])
    gn = pm.approx_nearest_neighbors(pt, pcol[0], 5)
    wn = jm.approx_nearest_neighbors(jt, jcol[0], 5)
    np.testing.assert_array_equal(gn.column("id"), wn.column("id"))
    np.testing.assert_array_equal(gn.column("distCol"), wn.column("distCol"))
    gj = pm.approx_similarity_join(pt, pt, 0.6, "id")
    wj = jm.approx_similarity_join(jt, jt, 0.6, "id")
    for c in ("idA", "idB", "distCol"):
        np.testing.assert_array_equal(gj.column(c), wj.column(c))
    jm.save(str(tmp_path / "m"))
    loaded = rw.load_stage(str(tmp_path / "m"), device="cpu")
    np.testing.assert_array_equal(loaded.coeff_a, jm.coeff_a)
    conv = convert.minhash_lsh_model_from_arrays(jm.coeff_a, jm.coeff_b,
                                                 device="cpu", **kw)
    np.testing.assert_array_equal(
        np.stack([np.stack([v.to_array() for v in r]) for r in
                  conv.transform(pt)[0].column("h")]),
        np.stack([np.stack([v.to_array() for v in r]) for r in gh]))


# -- save/load across the packages, convert.py --------------------------------

def _fitted(name):
    rng = np.random.default_rng(13)
    x = rng.integers(0, 3, (300, 2)).astype(np.float64)
    s = np.array(["a", "b", "c"])[rng.integers(0, 3, 300)]
    t = dict(x=x, a=x[:, 0], s=s)
    if name == "stringindexer":
        est = ("StringIndexer", dict(input_cols=["s"], output_cols=["o"]))
    elif name == "onehotencoder":
        est = ("OneHotEncoder", dict(input_cols=["a"], output_cols=["o"]))
    elif name == "kbins":
        est = ("KBinsDiscretizer", dict(input_col="x", output_col="o"))
    elif name == "vectorindexer":
        est = ("VectorIndexer", dict(input_col="x", output_col="o"))
    else:
        est = ("Imputer", dict(input_cols=["a"], output_cols=["o"],
                               strategy="median"))
    cls, kw = est
    return getattr(jf, cls)(**kw).fit(JaxTable.from_columns(**t)), t


CONVERT = {
    "stringindexer": lambda m: convert.string_indexer_model_from_arrays(
        m.string_arrays, device="cpu"),
    "onehotencoder": lambda m: convert.one_hot_encoder_model_from_arrays(
        m.category_sizes, device="cpu"),
    "kbins": lambda m: convert.kbins_discretizer_model_from_arrays(
        m.bin_edges, device="cpu"),
    "vectorindexer": lambda m: convert.vector_indexer_model_from_arrays(
        m.category_maps, device="cpu"),
    "imputer": lambda m: convert.imputer_model_from_arrays(
        m.surrogates, device="cpu"),
}


@pytest.mark.parametrize("name", sorted(CONVERT))
def test_jax_saved_models_load_and_convert(tmp_path, name):
    jm, cols = _fitted(name)
    jm.save(str(tmp_path / "jax"))
    loaded = rw.load_stage(str(tmp_path / "jax"), device="cpu")
    loaded.save(str(tmp_path / "port"))
    again = rw.load_stage(str(tmp_path / "port"), device="cpu")
    converted = loaded.copy_params_to(CONVERT[name](jm))
    want = jm.transform(JaxTable.from_columns(**cols))[0].column("o")
    for m in (loaded, again, converted):
        got = m.transform(Table.from_columns(**cols))[0].column("o")
        np.testing.assert_array_equal(_np(got), _np(want))


def test_count_vectorizer_and_idf_convert():
    cv = convert.count_vectorizer_model_from_arrays(
        ["a", "b"], device="cpu", input_col="t", output_col="o")
    out = cv.transform(Table.from_columns(
        t=np.array([["a", "a", "c"], ["b", "a", "b"]])))[0].column("o")
    assert torch.equal(out, torch.tensor([[2.0, 0.0], [1.0, 2.0]]))
    idf = convert.idf_model_from_arrays([0.5, 2.0], [3, 1], 4, device="cpu",
                                        input_col="x", output_col="o")
    out = idf.transform(Table.from_columns(x=np.ones((2, 2))))[0].column("o")
    assert torch.equal(out, torch.tensor([[0.5, 2.0], [0.5, 2.0]]))
    with pytest.raises(ValueError, match="one size"):
        convert.idf_model_from_arrays([0.5], [1, 2], 3)


# -- the runner ---------------------------------------------------------------

def test_runner_reports_benchmark_demo_as_jax():
    """``benchmark-demo.json`` through both runners: the same rows, and
    its two broken rows reported as the same exceptions."""
    got = runner.run_benchmarks(runner.load_config(DEMO), device="cpu")
    want = jax_runner.run_benchmarks(jax_runner.load_config(DEMO))
    assert list(got) == list(want)
    for name, entry in want.items():
        if "exception" in entry:
            assert got[name]["exception"] == entry["exception"], name
            continue
        row = got[name]["results"]
        assert "exception" not in got[name], got[name]
        for key in ("inputRecordNum", "outputRecordNum"):
            assert row[key] == entry["results"][key], (name, key)
        assert row["nativeThreads"] == entry["results"]["nativeThreads"]
    assert {n for n, e in got.items() if "exception" in e} == {
        "Undefined-Parameter", "Unmatch-Input"}
    json.dumps(got)


@pytest.mark.parametrize("name", ["tokenizer", "stringindexer", "imputer",
                                  "sqltransformer"])
def test_runner_on_shrunken_configs(monkeypatch, name):
    """The configs of this slice run through the port's runner on the CPU
    at a small numValues, with the native provenance on the row."""
    monkeypatch.setenv("FLINK_ML_TPU_NATIVE_THREADS", "2")
    ((key, spec),) = runner.load_config(
        f"flink_ml_tpu/benchmark/configs/{name}-benchmark.json").items()
    spec["inputData"]["paramMap"]["numValues"] = 3000
    row = runner.run_benchmark(key, spec, device="cpu")
    assert row["nativeThreads"] == 2 and row["inputRecordNum"] == 3000
    assert row["outputRecordNum"] >= 1
