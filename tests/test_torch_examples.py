"""Every example under ``examples/`` held against its JAX run on the port.

``EXAMPLES`` run as they are, their imports mapped onto the port and their
stages on the CPU, and return what they return on the JAX package: the
same columns, token, index and "item,score" values equal, floats within
rtol 1e-6 (float32 device outputs against float64 host ones), a model's
coefficients within the CSR fits' 1e-3 (the JAX package's FTRL runs
float64 on the host), centroids within CENTROID_RTOL/ATOL, a served
``DataFrame``'s columns as a table's.

Six examples get hand twins here. Four of them reduce a prediction column
with numpy (``np.mean(out["prediction"] == y)`` on a ``torch.Tensor``
raises: the port's columns are tensors, a deliberate deviation), so their
twins run the same stages on the port and compare the returned columns
and the accuracy; ``checkpoint`` builds its carry with ``jax.numpy``, so
its twin iterates a float32 tensor. ``graph`` and ``tensor_parallel``
have twins in ``tests/test_torch_pipeline.py`` and
``tests/test_torch_tensor_parallel.py``.
"""

import os
import pathlib
import re
import tempfile
import types

import numpy as np
import pytest
import torch

from flink_ml_tpu import Table as JaxTable

EXAMPLES_DIR = pathlib.Path(__file__).resolve().parent.parent / "examples"

EXAMPLES = (
    # text, discrete and misc ops, the online estimators, host algorithms
    "agglomerative_clustering", "count_vectorizer", "feature_hasher",
    "feature_ops", "hashingtf", "idf", "imputer", "index_to_string",
    "kbins_discretizer", "minhash_lsh", "ngram", "one_hot_encoder",
    "online_kmeans", "online_standard_scaler", "random_splitter",
    "regex_tokenizer", "sparse_text_pipeline", "sql_transformer",
    "stop_words_remover", "string_indexer", "swing", "tokenizer",
    "vector_indexer",
    # dense feature ops, statistics, evaluation, the estimators
    "anova_test", "binarizer", "bucketizer", "chi_sq_test", "dct",
    "elementwise_product", "evaluator", "fvalue_test", "interaction",
    "kmeans", "knn", "max_abs_scaler", "min_max_scaler", "naive_bayes",
    "normalizer", "polynomial_expansion", "robust_scaler",
    "standard_scaler", "univariate_feature_selector",
    "variance_threshold_selector", "vector_assembler", "vector_slicer",
    "linear_regression", "online_logistic_regression_sparse",
    # the package root's functions, the servable
    "array_to_vector", "vector_to_array", "servable")
#: the examples that have a hand twin in this file or another
TWINS = ("logistic_regression", "pipeline", "online_logistic_regression",
         "linearsvc", "checkpoint", "graph", "tensor_parallel")
TENSOR_RTOL = 1e-6
CSR_RTOL, CSR_ATOL = 1e-3, 1e-5
#: OnlineKMeans's centroids: float32 batch partials against float64 ones
CENTROID_RTOL, CENTROID_ATOL = 1e-5, 1e-6
#: a linear model's raw scores after tens of float32 SGD rounds in
#: another reduce order
SCORE_RTOL, SCORE_ATOL = 1e-5, 1e-6


@pytest.fixture
def on_cpu(monkeypatch):
    """The port's default device is the CPU; the JAX default mesh is one
    device for the JAX run, as the examples' own runs are."""
    import jax

    from flink_ml_tpu.models import online as jax_online
    from flink_ml_tpu.parallel import create_mesh, set_default_mesh
    from flink_ml_tpu_torch import device as port_device

    monkeypatch.setattr(port_device, "default_device",
                        lambda: torch.device("cpu"))
    monkeypatch.setattr(jax_online, "_ftrl_sparse_broken", False)

    def jax_run(fn):
        set_default_mesh(create_mesh(devices=jax.devices()[:1]))
        try:
            return fn()
        finally:
            set_default_mesh(None)

    return jax_run


def _example_main(name, port):
    """The example's ``main``, its imports mapped onto the port when
    ``port`` (the examples themselves are the JAX package's)."""
    path = EXAMPLES_DIR / f"{name}_example.py"
    src = path.read_text()
    if port:
        src = re.sub(r"\bflink_ml_tpu\b(?!_torch)", "flink_ml_tpu_torch", src)
    module = types.ModuleType(f"example_{name}_{'port' if port else 'jax'}")
    module.__file__ = str(path)
    exec(compile(src, str(path), "exec"), module.__dict__)
    return module.main


def _host_values(col):
    if isinstance(col, torch.Tensor):
        return col.numpy()
    if getattr(col, "is_csr_vector_column", False):
        return col.to_csr().toarray()
    col = np.asarray(col) if not isinstance(col, np.ndarray) else col
    if col.dtype == object:
        return [str(np.asarray(v.to_array() if hasattr(v, "to_array")
                               else v).tolist()) for v in col]
    return col


def _frame_column(df, name):
    """A servable ``DataFrame``'s column as one float64 array (vectors as
    rows)."""
    return np.stack([np.asarray(v.to_array() if hasattr(v, "to_array")
                                else v, np.float64)
                     for v in df.get(name).values])


def _compare_columns(got, want, names, column, rtol=TENSOR_RTOL,
                     atol=1e-7):
    for c in names:
        g, w = _host_values(column(got, c)), _host_values(column(want, c))
        if isinstance(w, list) or np.asarray(w).dtype.kind in "OUS":
            assert list(map(str, g)) == list(map(str, w)), c
        else:
            np.testing.assert_allclose(
                np.asarray(g, np.float64), np.asarray(w, np.float64),
                rtol=rtol, atol=atol, equal_nan=True, err_msg=c)


def _compare(got, want, name):
    if hasattr(want, "get_index"):  # a servable DataFrame
        assert got.column_names == want.column_names
        _compare_columns(got, want, want.column_names, _frame_column)
    elif hasattr(want, "column_names"):
        assert got.column_names == want.column_names
        _compare_columns(got, want, want.column_names,
                         lambda t, c: t.column(c))
    elif hasattr(want, "coefficients"):
        np.testing.assert_allclose(got.coefficients, want.coefficients,
                                   rtol=CSR_RTOL, atol=CSR_ATOL)
    elif hasattr(want, "centroids"):
        assert type(got).__name__ == type(want).__name__, name
        np.testing.assert_allclose(got.centroids, want.centroids,
                                   rtol=CENTROID_RTOL, atol=CENTROID_ATOL)
        np.testing.assert_allclose(got.weights, want.weights,
                                   rtol=CENTROID_RTOL, atol=CENTROID_ATOL)
    else:
        raise AssertionError(f"{name} returned {type(want).__name__}, "
                             f"which this test does not compare")


def test_every_example_is_held():
    """``EXAMPLES`` and ``TWINS`` together are every file of
    ``examples/``."""
    names = {p.name[:-len("_example.py")]
             for p in EXAMPLES_DIR.glob("*_example.py")}
    assert set(EXAMPLES) | set(TWINS) == names
    assert not set(EXAMPLES) & set(TWINS)


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_run_on_the_port_as_on_jax(on_cpu, capsys, name):
    """Each example, its imports mapped onto the port and its stages on the
    CPU, returns what it returns on the JAX package."""
    want = on_cpu(_example_main(name, port=False))
    got = _example_main(name, port=True)()
    capsys.readouterr()
    _compare(got, want, name)


# -- hand twins ---------------------------------------------------------------

def _accuracy(col, y):
    return float(np.mean(np.asarray(_host_values(col)) == y))


def _logistic_regression_twin():
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.models.classification import LogisticRegression

    rng = np.random.default_rng(1)
    x = rng.normal(size=(500, 4)).astype(np.float32)
    y = (x @ [1.0, -2.0, 0.5, 1.5] > 0).astype(np.float64)
    train = Table.from_columns(features=x, label=y)
    model = LogisticRegression(max_iter=50, global_batch_size=500,
                               learning_rate=0.5).fit(train)
    return model.transform(train)[0], y


def _pipeline_twin():
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.api import Pipeline, PipelineModel
    from flink_ml_tpu_torch.models.classification import LogisticRegression
    from flink_ml_tpu_torch.models.feature import (StandardScaler,
                                                   VectorAssembler)

    rng = np.random.default_rng(4)
    a, b = rng.normal(size=300) * 10, rng.normal(size=300)
    label = (a / 10 + b > 0).astype(np.float64)
    table = Table.from_columns(a=a, b=b, label=label)
    pipeline = Pipeline([
        VectorAssembler(input_cols=["a", "b"], output_col="assembled"),
        StandardScaler(input_col="assembled", output_col="features"),
        LogisticRegression(max_iter=40, global_batch_size=300),
    ])
    model = pipeline.fit(table)
    path = os.path.join(tempfile.mkdtemp(), "pipeline")
    model.save(path)
    return PipelineModel.load(path).transform(table)[0], label


def _linearsvc_twin():
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.models.classification import LinearSVC

    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=(200, 2)),
                        rng.normal(size=(200, 2)) + 3]).astype(np.float32)
    y = np.concatenate([np.zeros(200), np.ones(200)]).astype(np.float32)
    t = Table.from_columns(features=x, label=y)
    model = LinearSVC(max_iter=50, global_batch_size=400,
                      learning_rate=0.1, reg=0.01).fit(t)
    return model.transform(t)[0], y


def _online_logistic_regression_twin():
    from flink_ml_tpu_torch import Table
    from flink_ml_tpu_torch.common.table import as_dense_vector_column
    from flink_ml_tpu_torch.iteration.streaming import StreamTable
    from flink_ml_tpu_torch.models.classification import (
        OnlineLogisticRegression)

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2000, 4))
    y = (x @ [1.0, 1.0, -1.0, 0.5] > 0).astype(np.float64)
    stream = StreamTable.from_table(Table.from_columns(features=x, label=y),
                                    chunk_size=250)
    init = Table.from_columns(
        coefficient=as_dense_vector_column(np.zeros((1, 4))),
        modelVersion=np.asarray([0]))
    model = (OnlineLogisticRegression(global_batch_size=500, alpha=0.5)
             .set_initial_model_data(init).fit(stream))
    out = model.transform(Table.from_columns(features=x, label=y))[0]
    return model, out, x, y


@pytest.mark.parametrize("name,twin", [
    ("logistic_regression", _logistic_regression_twin),
    ("pipeline", _pipeline_twin), ("linearsvc", _linearsvc_twin)])
def test_linear_example_twins(on_cpu, capsys, name, twin):
    """The example's stages on the port return the JAX run's columns (raw
    scores within SCORE_RTOL/ATOL) and the same accuracy, computed on the
    host copy of the prediction tensor."""
    want = on_cpu(_example_main(name, port=False))
    got, y = twin()
    capsys.readouterr()
    assert got.column_names == want.column_names
    _compare_columns(got, want, want.column_names, lambda t, c: t.column(c),
                     rtol=SCORE_RTOL, atol=SCORE_ATOL)
    assert _accuracy(got.column("prediction"), y) == _accuracy(
        want.column("prediction"), y) > 0.5


def test_online_logistic_regression_example_twin(on_cpu, capsys):
    want = on_cpu(_example_main("online_logistic_regression", port=False))
    model, out, x, y = _online_logistic_regression_twin()
    capsys.readouterr()
    assert model.model_version == want.model_version
    np.testing.assert_allclose(model.coefficients, want.coefficients,
                               rtol=CSR_RTOL, atol=CSR_ATOL)
    jax_out = on_cpu(lambda: want.transform(
        JaxTable.from_columns(features=x, label=y))[0])
    assert _accuracy(out.column("prediction"), y) == _accuracy(
        jax_out.column("prediction"), y) > 0.9
    assert int(_host_values(out.column("version"))[0]) == int(
        np.asarray(jax_out.column("version"))[0])


def test_checkpoint_example_twin(capsys, tmp_path):
    """``iterate_bounded`` with host-mode checkpoints every 5 rounds on a
    float32 scalar carry, then a run to 30 rounds with the same manager:
    the checkpoints left and the final value the JAX run prints and
    returns."""
    from flink_ml_tpu_torch.iteration import (CheckpointManager,
                                              IterationConfig,
                                              iterate_bounded)

    want = float(_example_main("checkpoint", port=False)())
    printed = capsys.readouterr().out
    body = lambda carry, epoch: carry * 0.9 + 1.0  # noqa: E731
    mgr = CheckpointManager(str(tmp_path))
    config = IterationConfig(mode="host", checkpoint_interval=5,
                             checkpoint_manager=mgr)
    first = iterate_bounded(torch.tensor(0.0), body, max_iter=20,
                            config=config)
    assert f"checkpoints kept: {mgr.list_checkpoints()}" in printed
    resumed = iterate_bounded(torch.tensor(0.0), body, max_iter=30,
                              config=config)
    assert resumed.dtype == torch.float32
    np.testing.assert_allclose(float(first), 10 * (1 - 0.9 ** 20),
                               rtol=1e-6)
    np.testing.assert_allclose(float(resumed), want, rtol=1e-6)
