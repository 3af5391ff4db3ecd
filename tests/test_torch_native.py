"""The port's native host kernels (``flink_ml_tpu_torch/native/``), held
against the JAX package's (``flink_ml_tpu/native/``).

Both packages build their C++ with ``g++`` here. The port keeps its own
copies of the sources, which must equal the JAX package's byte for byte, and
every kernel must give the JAX package's output on the same numpy inputs
exactly (integer codes, counts and parsed doubles; tolerance 0). Without a
working ``g++`` the port raises ``KernelBuildError`` instead of falling back.
"""

import numpy as np
import pytest

from flink_ml_tpu import native as jax_native
from flink_ml_tpu.common.table import Table as JaxTable
from flink_ml_tpu_torch import native
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.ops import _build
from flink_ml_tpu_torch.resilience import faults
from flink_ml_tpu_torch.resilience.policy import InjectedFault, KernelBuildError

REPO_NATIVE = _build.CSRC_DIR.parent.parent / "flink_ml_tpu" / "native"


@pytest.mark.parametrize("name", ["factorize_kernel.cpp", "csv_kernel.cpp",
                                  "swing_kernel.cpp"])
def test_sources_are_the_jax_packages_byte_for_byte(name):
    assert (_build.HOST_CSRC_DIR / name).read_bytes() == \
        (REPO_NATIVE / name).read_bytes()


def test_library_is_content_addressed_and_in_build_dir():
    path = _build.build_host()
    assert path == _build.host_library_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert path.name.startswith("libhost_native-")


def _keys(case, rng):
    if case == "small_domain":
        return rng.integers(0, 50, 20_000).astype(np.int64)
    if case == "wide":
        return rng.integers(-(1 << 62), 1 << 62, 5_000, dtype=np.int64)
    if case == "sentinel_like":
        return np.array([0, -1, np.iinfo(np.int64).min,
                         np.iinfo(np.int64).max, -1, 0], np.int64)
    return np.zeros(0, np.int64)


@pytest.mark.parametrize("case", ["small_domain", "wide", "sentinel_like",
                                  "empty"])
@pytest.mark.parametrize("threads", [1, 3])
def test_factorize_i64_matches_jax(case, threads):
    keys = _keys(case, np.random.default_rng(1))
    uniq, codes = native.factorize_i64(keys, n_threads=threads)
    juniq, jcodes = jax_native.factorize_i64(keys, n_threads=threads)
    np.testing.assert_array_equal(uniq, juniq)
    np.testing.assert_array_equal(codes, jcodes)
    if len(keys):
        np.testing.assert_array_equal(uniq[codes], keys)


def test_factorize_i64_cap_returns_none(monkeypatch):
    keys = np.arange(100, dtype=np.int64)
    monkeypatch.setattr(native, "FACTORIZE_UNIQ_CAP", 10)
    assert native.factorize_i64(keys) is None


@pytest.mark.parametrize("u,w,threads", [(7, 5, 1), (300, 12, 1),
                                         (300, 12, 4)])
def test_doc_freq_i64_matches_jax(u, w, threads):
    codes = np.random.default_rng(u).integers(0, u, (2_000, w))
    got = native.doc_freq_i64(codes, u, n_threads=threads)
    np.testing.assert_array_equal(
        got, jax_native.doc_freq_i64(codes, u, n_threads=threads))
    want = np.array([(codes == c).any(axis=1).sum() for c in range(u)])
    np.testing.assert_array_equal(got, want)


def test_doc_freq_i64_limits_return_none():
    codes = np.array([[0, 5]], np.int64)
    assert native.doc_freq_i64(codes, 3) is None  # code out of domain
    assert native.doc_freq_i64(codes, 0) is None
    assert native.doc_freq_i64(codes, native.ROWWISE_DOMAIN_CAP + 1) is None


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32, np.int64])
def test_rowwise_counts_matches_jax(dtype):
    mat = np.random.default_rng(3).integers(0, 40, (1_500, 9)).astype(dtype)
    got = native.rowwise_counts(mat, 40)
    want = jax_native.rowwise_counts(mat, 40)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # small chunks give the same triples
    for g, w in zip(native.rowwise_counts(mat, 40, max_chunk_bytes=1 << 10),
                    want):
        np.testing.assert_array_equal(g, w)


def test_rowwise_counts_without_variant_returns_none():
    assert native.rowwise_counts(np.zeros((3, 2), np.int32), 4) is None


@pytest.mark.parametrize("text,n_cols", [
    (b"1,2.5,-3\n4e3,5,6\n", 3),
    (b"1,2,3\r\n4,5,6\r\n", 3),
    (b"0.1,inf,-0.0\n1,2,3", 3),
    (b"1,a,3\n", 3),
    (b"1,2\n3\n", 2),
])
def test_csv_parse_numeric_matches_jax(text, n_cols):
    got = native.csv_parse_numeric(text, n_cols)
    want = jax_native.csv_parse_numeric(text, n_cols)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("content", [
    "a,b,c\n1,2,3\n4.5,-6,7e2\n",
    "a,b\n1,x\n2,y\n",
    "a,b\n",
])
def test_table_from_csv_matches_jax(tmp_path, content):
    path = tmp_path / "t.csv"
    path.write_text(content)
    got, want = Table.from_csv(str(path)), JaxTable.from_csv(str(path))
    assert got.column_names == want.column_names
    for name in got.column_names:
        g, w = got.column(name), want.column(name)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_native_kernel_chaos_site():
    keys = np.arange(10, dtype=np.int64)
    with faults.chaos(at={"native-kernel": [2]}):
        native.factorize_i64(keys)
        with pytest.raises(InjectedFault):
            native.doc_freq_i64(keys.reshape(2, 5), 10)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    """Kernel or raise: without g++ (and no earlier build) every entry
    point raises KernelBuildError; nothing falls back."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    native._lib.cache_clear()
    _build.load_host.cache_clear()
    try:
        with pytest.raises(KernelBuildError, match="g\\+\\+"):
            native.factorize_i64(np.arange(4, dtype=np.int64))
        with pytest.raises(KernelBuildError):
            native.csv_parse_numeric(b"1,2\n", 2)
    finally:
        native._lib.cache_clear()
        _build.load_host.cache_clear()


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "host"
    bad.mkdir()
    (bad / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(_build, "HOST_CSRC_DIR", bad)
    native._lib.cache_clear()
    _build.load_host.cache_clear()
    try:
        with pytest.raises(KernelBuildError, match="g\\+\\+ failed"):
            native.factorize_i64(np.arange(4, dtype=np.int64))
        assert not list((tmp_path / "out").glob("*.so"))
    finally:
        native._lib.cache_clear()
        _build.load_host.cache_clear()


@pytest.mark.parametrize("raw,want", [(None, 1), ("", 1), ("4", 4),
                                      ("0", 1), ("junk", 1), ("999", 256)])
def test_native_threads_env(monkeypatch, raw, want):
    if raw is None:
        monkeypatch.delenv(native.NATIVE_THREADS_ENV, raising=False)
    else:
        monkeypatch.setenv(native.NATIVE_THREADS_ENV, raw)
    assert native.native_threads() == want == jax_native.native_threads()
