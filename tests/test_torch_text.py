"""The port's text ops (``flink_ml_tpu_torch/models/feature/text.py``) and
string generators, held against the JAX package.

Every case runs the same numpy-seeded column through the JAX stage and its
port counterpart (``device="cpu"``), on token matrices (fixed-width ``<U``
arrays, the generators' form) and on ragged object columns (the per-token
loops), with the host pool inline and forced to fork (``min_rows`` 64,
four workers). Tokens, vocabularies, hashed buckets, counts and document
frequencies must be equal (tolerance 0); IDF weights and scaled values
within rtol 1e-12 on the host (both float64) and rtol 1e-6 on tensor
columns (float32 products); the dense counts exactly. The sparse text
chain (Tokenizer → HashingTF → FTRL) at 300 documents must give the JAX
package's coefficients within the FTRL tests' CSR_RTOL/CSR_ATOL.
"""

import numpy as np
import pytest
import torch

from flink_ml_tpu import Table as JaxTable
from flink_ml_tpu.benchmark import datagen as jax_datagen
from flink_ml_tpu.common import hostpool as jax_hostpool
from flink_ml_tpu.models import feature as jf
from flink_ml_tpu.models.feature import text as jtext
from flink_ml_tpu.ops import columnar as jax_columnar
from flink_ml_tpu_torch import Table
from flink_ml_tpu_torch.benchmark import datagen
from flink_ml_tpu_torch.common import hostpool
from flink_ml_tpu_torch.models import feature as pf
from flink_ml_tpu_torch.models.feature import text as ptext
from flink_ml_tpu_torch.utils import io as rw

HOST_RTOL = 1e-12
TENSOR_RTOL = 1e-6
CSR_RTOL, CSR_ATOL = 1e-3, 1e-5
POOLS = ("inline", "forked")


@pytest.fixture(params=POOLS)
def pool(request, monkeypatch):
    """The port's pool inline, or forced to fork on small inputs."""
    if request.param == "forked":
        real = hostpool.map_row_shards
        monkeypatch.setenv("FLINK_ML_TPU_HOST_PARALLELISM", "4")
        monkeypatch.setattr(hostpool, "map_row_shards",
                            lambda fn, n, **kw: real(fn, n, min_rows=64))
    return request.param


def _token_matrix(seed, n=400, w=12, k=30, prefix="w"):
    toks = np.array([f"{prefix}{v}" for v in range(k)])
    return toks[np.random.default_rng(seed).integers(0, k, (n, w))]


def _ragged(seed, n=300, k=25):
    rng = np.random.default_rng(seed)
    toks = [f"t{v}" for v in range(k)] + ["The", "a", "İs", "I"]
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = [toks[j] for j in rng.integers(0, len(toks),
                                                rng.integers(0, 9))]
    return out


def _texts(seed, n=500):
    words = np.array(["Alpha", "beta", "GAMMA", "delta", "eps", "the", "a",
                      "zeta111", "x1y"])
    rng = np.random.default_rng(seed)
    return np.array([" ".join(words[rng.integers(0, len(words),
                                                 rng.integers(1, 6))])
                     + ("\t" if i % 7 == 0 else "") for i in range(n)])


def _cells(col):
    """A token column as a list of token lists."""
    return [list(map(str, row)) for row in col]


def _csr(col):
    return col.to_csr()


def _assert_csr_equal(got, want, rtol=0.0):
    g, w = _csr(got), _csr(want)
    assert g.shape == w.shape
    np.testing.assert_array_equal(g.indptr, w.indptr)
    np.testing.assert_array_equal(g.indices, w.indices)
    np.testing.assert_allclose(g.data, w.data, rtol=rtol, atol=0)


def _run(jstage, pstage, col, name="t"):
    want = jstage.transform(JaxTable.from_columns(**{name: col}))[0]
    got = pstage.transform(Table.from_columns(**{name: col}))[0]
    return got, want


# -- helpers and generators ---------------------------------------------------

@pytest.mark.parametrize("cls,params", [
    ("RandomStringGenerator", dict(numValues=1000, numDistinctValues=100)),
    ("RandomStringGenerator", dict(numValues=50, numDistinctValues=10_000)),
    ("RandomStringArrayGenerator", dict(numValues=300, arraySize=7,
                                        numDistinctValues=40)),
])
def test_string_generators_match_jax(cls, params):
    spec = dict(params, colNames=[["a", "b"]], seed=5)
    jg = getattr(jax_datagen, cls)()
    jg.params_from_json(spec, strict=True)
    pg = datagen.resolve_generator(f"flink_ml_tpu.benchmark.datagen.{cls}")(
        device="cpu")
    pg.params_from_json(spec, strict=True)
    want, got = jg.get_data(), pg.get_data()
    for name in ("a", "b"):
        assert got.column(name).dtype == want.column(name).dtype
        np.testing.assert_array_equal(got.column(name), want.column(name))


@pytest.mark.parametrize("m", [1000, 262144, (1 << 31) - 1])
def test_numeric_bits_hash_on_tensors_matches_jax(m):
    vals = np.concatenate([
        [0.0, -0.0, 1.0, -1.5, np.inf, -np.inf, 1e300, 5e-324],
        np.random.default_rng(m).normal(size=500) * 1e3])
    want = jtext._hash_numeric_bits(vals, 0xDEADBEEF, m)
    np.testing.assert_array_equal(
        ptext._hash_numeric_bits(vals, 0xDEADBEEF, m), want)
    np.testing.assert_array_equal(ptext._hash_numeric_bits_torch(
        torch.from_numpy(vals), 0xDEADBEEF, m).numpy(), want)
    f32 = vals.astype(np.float32)
    np.testing.assert_array_equal(ptext._hash_numeric_bits_torch(
        torch.from_numpy(f32), 7, m).numpy(),
        jtext._hash_numeric_bits(f32, 7, m))
    assert ptext._hash_index("token=1", m) == jtext._hash_index("token=1", m)


@pytest.mark.parametrize("kind", ["U1", "U2", "U5", "object", "int"])
@pytest.mark.parametrize("sort", [True, False])
def test_token_codes_match_jax(kind, sort):
    rng = np.random.default_rng(11)
    if kind == "object":
        col = np.array([f"o{v}" for v in rng.integers(0, 9, 300)],
                       dtype=object)
    elif kind == "int":
        col = rng.integers(-5, 5, (40, 7))
    else:
        width = int(kind[1:])
        col = np.array(["abcdefgh"[:width][::-1][: 1 + v % width] + str(v)
                        for v in range(60)]).astype(f"<{kind}")
        col = col[rng.integers(0, 60, (50, 9))]
    guniq, gcodes = ptext._token_codes(col, sort=sort)
    wuniq, wcodes = jtext._token_codes(col, sort=sort)
    np.testing.assert_array_equal(guniq, wuniq)
    np.testing.assert_array_equal(gcodes, wcodes)
    np.testing.assert_array_equal(guniq[gcodes], np.asarray(col).reshape(-1))


def test_token_codes_past_the_factorize_cap(monkeypatch):
    from flink_ml_tpu_torch import native

    col = _token_matrix(3, n=50, w=4, k=20)
    monkeypatch.setattr(native, "FACTORIZE_UNIQ_CAP", 3)
    for sort in (True, False):
        guniq, gcodes = ptext._token_codes(col, sort=sort)
        wuniq, wcodes = jtext._token_codes(col, sort=sort)
        np.testing.assert_array_equal(guniq, wuniq)
        np.testing.assert_array_equal(gcodes, wcodes)


@pytest.mark.parametrize("domain,dtype", [(5, np.uint8), (60, np.uint8),
                                          (300, np.uint16), (900, np.int32),
                                          (5000, np.int64), (None, np.int64)])
def test_rowwise_counts_engines_match_jax(domain, dtype):
    u = domain or 700
    mat = np.random.default_rng(u).integers(0, u, (333, 17)).astype(dtype)
    got = ptext._rowwise_counts(mat.copy(), domain=domain)
    want = jtext._rowwise_counts(mat.copy(), domain=domain)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_merge_token_shards_matches_jax():
    a = _token_matrix(1, n=5, w=3)
    b = _token_matrix(2, n=4, w=3)
    c = _token_matrix(3, n=2, w=2)
    for parts in ([a, b], [a, c], [a, _ragged(1, n=3)]):
        assert _cells(ptext._merge_token_shards(parts)) == \
            _cells(jtext._merge_token_shards(parts))


# -- the stages ---------------------------------------------------------------

@pytest.mark.parametrize("form", ["texts", "alnum", "object"])
def test_tokenizer_matches_jax(pool, form):
    col = _texts(1)
    if form == "alnum":
        col = np.char.upper(np.array([f"Ab{v}" for v in range(700)]))
    elif form == "object":
        col = col.astype(object)
    got, want = _run(jf.Tokenizer(input_col="t", output_col="o"),
                     pf.Tokenizer(input_col="t", output_col="o",
                                  device="cpu"), col)
    assert _cells(got.column("o")) == _cells(want.column("o"))


@pytest.mark.parametrize("params", [
    dict(pattern="\\s+"), dict(pattern="1+"),
    dict(pattern="[a-z]+", gaps=False, min_token_length=2),
    dict(pattern="\\W", to_lowercase=False, min_token_length=0)])
@pytest.mark.parametrize("form", ["strings", "object"])
def test_regex_tokenizer_matches_jax(pool, params, form):
    col = _texts(2, n=600)
    if form == "object":
        col = col.astype(object)
    got, want = _run(jf.RegexTokenizer(input_col="t", output_col="o",
                                       **params),
                     pf.RegexTokenizer(input_col="t", output_col="o",
                                       device="cpu", **params), col)
    assert _cells(got.column("o")) == _cells(want.column("o"))


@pytest.mark.parametrize("n", [1, 2, 3, 13])
@pytest.mark.parametrize("form", ["matrix", "object"])
def test_ngram_matches_jax(pool, n, form):
    col = _token_matrix(4, n=300, w=12) if form == "matrix" else _ragged(4)
    got, want = _run(jf.NGram(input_col="t", output_col="o", n=n),
                     pf.NGram(input_col="t", output_col="o", n=n,
                              device="cpu"), col)
    gcol, wcol = got.column("o"), want.column("o")
    assert type(gcol) is type(wcol)
    assert _cells(gcol) == _cells(wcol)


@pytest.mark.parametrize("params", [
    dict(), dict(case_sensitive=True), dict(locale="tr_TR"),
    dict(stop_words=("w1", "W2", "", "t3"))])
@pytest.mark.parametrize("form", ["matrix", "uniform", "object"])
def test_stop_words_remover_matches_jax(pool, params, form):
    if form == "matrix":
        col = _token_matrix(5, n=300, w=8, k=12)
        col[::3, 2] = "The"
        col[1::5, 0] = "a"
    elif form == "uniform":
        col = _token_matrix(5, n=300, w=8, k=5, prefix="9")  # no candidates
    else:
        col = _ragged(5)
    kw = dict(input_cols=["t"], output_cols=["o"], **params)
    got, want = _run(jf.StopWordsRemover(**kw),
                     pf.StopWordsRemover(device="cpu", **kw), col)
    assert _cells(got.column("o")) == _cells(want.column("o"))
    assert pf.StopWordsRemover.load_default_stop_words("english") == \
        jf.StopWordsRemover.load_default_stop_words("english")


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("form", ["matrix", "object"])
def test_hashing_tf_matches_jax(pool, binary, form):
    col = _token_matrix(6, n=500, w=15) if form == "matrix" else _ragged(6)
    kw = dict(input_col="t", output_col="o", binary=binary, num_features=64)
    got, want = _run(jf.HashingTF(**kw), pf.HashingTF(device="cpu", **kw),
                     col)
    _assert_csr_equal(got.column("o"), want.column("o"))


def _hasher_columns(seed, n=700):
    rng = np.random.default_rng(seed)
    mixed = np.empty(n, dtype=object)
    mixed[:] = [("s" + str(v)) if v % 3 else float(v)
                for v in rng.integers(0, 20, n)]
    return {"f0": rng.integers(0, 10, n).astype(np.float64),
            "f1": rng.normal(size=n),
            "f2": np.array([f"c{v}" for v in rng.integers(0, 5, n)]),
            "f3": rng.integers(0, 2, n).astype(bool),
            "f4": mixed}


@pytest.mark.parametrize("categorical", [(), ("f0",), ("f0", "f1", "f4")])
def test_feature_hasher_host_columns_match_jax(pool, categorical):
    cols = _hasher_columns(7)
    kw = dict(input_cols=list(cols), output_col="o", num_features=50,
              categorical_cols=categorical)
    want = jf.FeatureHasher(**kw).transform(JaxTable.from_columns(**cols))[0]
    got = pf.FeatureHasher(device="cpu", **kw).transform(
        Table.from_columns(**cols))[0]
    _assert_csr_equal(got.column("o"), want.column("o"))


@pytest.mark.parametrize("categorical", [("f0", "f1", "f2"), ()])
def test_feature_hasher_tensor_columns_match_jax(categorical):
    """Numeric tensor columns hash on their device: the same buckets and
    float64 sums as the JAX package on the same float32 values."""
    rng = np.random.default_rng(8)
    cols = {f"f{i}": (rng.integers(0, 4, 900) if i < 3
                      else rng.random(900)).astype(np.float32)
            for i in range(5)}
    cols["f4"][:3] = [0.0, -0.0, 1e30]
    kw = dict(input_cols=list(cols), output_col="o", num_features=7,
              categorical_cols=categorical)
    want = jf.FeatureHasher(**kw).transform(JaxTable.from_columns(
        **{k: jax_columnar.to_device(v) for k, v in cols.items()}))[0]
    got = pf.FeatureHasher(device="cpu", **kw).transform(Table.from_columns(
        **{k: torch.from_numpy(v) for k, v in cols.items()}))[0]
    _assert_csr_equal(got.column("o"), want.column("o"))


@pytest.mark.parametrize("params", [
    dict(), dict(min_df=3.0, vocabulary_size=10),
    dict(min_df=0.2, max_df=0.9), dict(max_df=30.0)])
@pytest.mark.parametrize("form", ["matrix", "object"])
def test_count_vectorizer_fit_matches_jax(pool, params, form):
    col = _token_matrix(9, n=500, w=10, k=40) if form == "matrix" \
        else _ragged(9)
    kw = dict(input_col="t", output_col="o", **params)
    want = jf.CountVectorizer(**kw).fit(JaxTable.from_columns(t=col))
    got = pf.CountVectorizer(device="cpu", **kw).fit(
        Table.from_columns(t=col))
    assert got.vocabulary == want.vocabulary


@pytest.mark.parametrize("path", ["dense", "csr"])
@pytest.mark.parametrize("params", [dict(), dict(min_tf=2.0),
                                    dict(min_tf=0.15), dict(binary=True)])
def test_count_vectorizer_model_matches_jax(pool, monkeypatch, path, params):
    col = _token_matrix(10, n=400, w=12, k=25)
    vocab = [f"w{v}" for v in range(0, 25, 2)] + ["absent"]
    if path == "csr":
        monkeypatch.setenv("FLINK_ML_TPU_DENSE_COUNTS_MAX_BYTES", "1")
    kw = dict(input_col="t", output_col="o", **params)
    got, want = _run(jtext.CountVectorizerModel(vocabulary=vocab, **kw),
                     ptext.CountVectorizerModel(vocabulary=vocab,
                                                device="cpu", **kw), col)
    if path == "dense":
        out = got.column("o")
        assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
        np.testing.assert_array_equal(out.numpy(),
                                      np.asarray(want.column("o")))
    else:
        _assert_csr_equal(got.column("o"), want.column("o"))


def test_dense_counts_chunked_scatter(monkeypatch):
    """Row chunks of any size give the same counts (the int64 index
    temporary is bounded by the chunk); uint16 ids too."""
    col = _token_matrix(12, n=300, w=9, k=400)
    vocab = [f"w{v}" for v in range(300)]
    model = ptext.CountVectorizerModel(vocabulary=vocab, input_col="t",
                                       output_col="o", device="cpu")
    table = Table.from_columns(t=col)
    whole = model.transform(table)[0].column("o")
    monkeypatch.setattr(ptext, "_SCATTER_CHUNK_ELEMS", 20)
    assert torch.equal(model.transform(table)[0].column("o"), whole)
    want = jtext.CountVectorizerModel(vocabulary=vocab, input_col="t",
                                      output_col="o").transform(
        JaxTable.from_columns(t=col))[0].column("o")
    np.testing.assert_array_equal(whole.numpy(), np.asarray(want))


@pytest.mark.parametrize("form", ["object", "csr"])
def test_count_vectorizer_ragged_transform_matches_jax(form):
    col = _ragged(13)
    vocab = ["t1", "t3", "The", "nothere"]
    kw = dict(input_col="t", output_col="o", min_tf=0.3)
    got, want = _run(jtext.CountVectorizerModel(vocabulary=vocab, **kw),
                     ptext.CountVectorizerModel(vocabulary=vocab,
                                                device="cpu", **kw), col)
    _assert_csr_equal(got.column("o"), want.column("o"))


def _idf_input(kind, seed=14):
    rng = np.random.default_rng(seed)
    dense = np.where(rng.random((200, 9)) < 0.4,
                     rng.integers(1, 5, (200, 9)), 0).astype(np.float32)
    if kind == "csr":
        col = _token_matrix(seed, n=200, w=6, k=30)
        j = jf.HashingTF(input_col="t", output_col="x", num_features=32) \
            .transform(JaxTable.from_columns(t=col))[0]
        p = pf.HashingTF(input_col="t", output_col="x", num_features=32,
                         device="cpu").transform(Table.from_columns(t=col))[0]
        return j, p
    if kind == "tensor":
        return (JaxTable.from_columns(x=jax_columnar.to_device(dense)),
                Table.from_columns(x=torch.from_numpy(dense)))
    return (JaxTable.from_columns(x=dense.astype(np.float64)),
            Table.from_columns(x=dense.astype(np.float64)))


@pytest.mark.parametrize("kind", ["host", "tensor", "csr"])
@pytest.mark.parametrize("min_doc_freq", [0, 60])
def test_idf_matches_jax(kind, min_doc_freq):
    jt, pt = _idf_input(kind)
    kw = dict(input_col="x", output_col="o", min_doc_freq=min_doc_freq)
    jm = jf.IDF(**kw).fit(jt)
    pm = pf.IDF(device="cpu", **kw).fit(pt)
    np.testing.assert_array_equal(pm.doc_freq, jm.doc_freq)
    assert pm.num_docs == jm.num_docs
    np.testing.assert_allclose(pm.idf, jm.idf, rtol=HOST_RTOL)
    got, want = pm.transform(pt)[0].column("o"), jm.transform(jt)[0].column("o")
    if kind == "csr":
        _assert_csr_equal(got, want, rtol=HOST_RTOL)
    else:
        assert isinstance(got, torch.Tensor)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TENSOR_RTOL)


@pytest.mark.parametrize("model", ["cv", "idf"])
def test_save_load_and_jax_saved_models(tmp_path, model):
    if model == "cv":
        col = _token_matrix(15, n=100, w=5)
        jm = jf.CountVectorizer(input_col="t", output_col="o").fit(
            JaxTable.from_columns(t=col))
        jt, pt = JaxTable.from_columns(t=col), Table.from_columns(t=col)
    else:
        jt, pt = _idf_input("host")
        jm = jf.IDF(input_col="x", output_col="o").fit(jt)
    jm.save(str(tmp_path / "jax"))
    loaded = rw.load_stage(str(tmp_path / "jax"), device="cpu")
    assert type(loaded).__module__.startswith("flink_ml_tpu_torch.")
    loaded.save(str(tmp_path / "port"))
    again = rw.load_stage(str(tmp_path / "port"), device="cpu")
    want = np.asarray(jm.transform(jt)[0].column("o"))
    for m in (loaded, again):
        got = m.transform(pt)[0].column("o")
        np.testing.assert_allclose(got.numpy(), want, rtol=TENSOR_RTOL)
        for (name, a), (_, b) in zip(m.get_model_data()[0].to_dict().items(),
                                     jm.get_model_data()[0].to_dict().items()):
            assert np.array_equal(np.asarray(a, dtype=object),
                                  np.asarray(b, dtype=object)), name


def test_sparse_text_chain_at_300_docs(monkeypatch):
    """``examples/sparse_text_pipeline_example.py``'s chain on 300 docs:
    Tokenizer → HashingTF (2^18) → FTRL (batch 50), in both packages, on
    the host engine and (threshold lowered) the device-CSR engine."""
    import jax

    from flink_ml_tpu.common.table import as_dense_vector_column as j_dense
    from flink_ml_tpu.models import online as jax_online
    from flink_ml_tpu.models.classification import (
        OnlineLogisticRegression as JaxFtrl)
    from flink_ml_tpu.parallel import create_mesh, set_default_mesh
    from flink_ml_tpu_torch.common.table import as_dense_vector_column
    from flink_ml_tpu_torch.models import online
    from flink_ml_tpu_torch.models.online import OnlineLogisticRegression

    rng = np.random.default_rng(8)
    good = ["great", "excellent", "love", "wonderful", "best"]
    bad = ["terrible", "awful", "hate", "worst", "broken"]
    neutral = ["the", "a", "product", "it", "was", "very"]
    labels = rng.integers(0, 2, 300).astype(np.float64)
    texts = np.asarray([" ".join(rng.choice((good if l else bad) + neutral,
                                            size=8)) for l in labels])

    def chain(F, T, dense, est_cls, **stage_kw):
        t = T.from_columns(text=texts, label=labels)
        words = F.Tokenizer(input_col="text", output_col="w", **stage_kw) \
            .transform(t)[0]
        hashed = F.HashingTF(input_col="w", output_col="features",
                             **stage_kw).transform(words)[0]
        dim = hashed.column("features").to_csr().shape[1]
        init = T.from_columns(coefficient=dense(np.zeros((1, dim))),
                              modelVersion=np.asarray([0]))
        est = est_cls(global_batch_size=50, alpha=0.5, beta=1.0, **stage_kw)
        model = est.set_initial_model_data(init).fit(hashed)
        pred = np.asarray(model.transform(hashed)[0]["prediction"])
        return est, model, float(np.mean(pred == labels))

    set_default_mesh(create_mesh(devices=jax.devices()[:1]))
    try:
        for min_nnz in (1 << 60, 1):
            monkeypatch.setenv("FLINK_ML_TPU_FTRL_SPARSE_MIN_NNZ", str(min_nnz))
            monkeypatch.setattr(online, "FTRL_SPARSE_MIN_NNZ", min_nnz)
            monkeypatch.setattr(jax_online, "_ftrl_sparse_broken", False)
            _, jm, jacc = chain(jf, JaxTable, j_dense, JaxFtrl)
            est, pm, pacc = chain(pf, Table, as_dense_vector_column,
                                  OnlineLogisticRegression, device="cpu")
            assert est.last_execution_path == (
                "host-csr-batches" if min_nnz > 1 else "torch-csr-batches")
            np.testing.assert_allclose(pm.coefficients, jm.coefficients,
                                       rtol=CSR_RTOL, atol=CSR_ATOL)
            assert pacc == jacc and pacc > 0.9
    finally:
        set_default_mesh(None)
