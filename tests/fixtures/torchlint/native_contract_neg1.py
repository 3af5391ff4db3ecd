"""torchlint fixture: NEGATIVE for native-contract.

The sanctioned shapes: None-checked wrapper results, a direct None probe,
a clipped gather behind a bounds assert, statuses compared or passed to
the error check, and a handler around a launch that adds context and
raises.
"""
import ctypes

import numpy as np

from flink_ml_tpu_torch import native
from flink_ml_tpu_torch.ops import _build, kernels


def doc_freqs(mat, u, fallback):
    df = native.doc_freq_i64(mat, u)
    if df is None:  # the over-cap case handled
        df = fallback(mat, u)
    return df


def probe(mat, u):
    return native.rowwise_counts(mat, u) is None


def gather(tokens, ints):
    assert ints.size == 0 or ints.max() < len(tokens)
    return np.take(tokens, ints, mode="clip")


def _raise_on_error(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def launch(x_ptr, n):
    lib = _build.load("sgd_kernels")
    _raise_on_error(lib.sgd_batch_terms(x_ptr, ctypes.c_int64(n)), "sgd")
    rc = lib.reduce_partials(x_ptr, ctypes.c_int64(n))
    if rc != 0:
        raise RuntimeError(f"reduce_partials failed with code {rc}")
    nnz = lib.rowwise_counts_i64(x_ptr, ctypes.c_int64(n))
    if nnz < 0:
        return None
    return nnz


def lloyd(x, c):
    try:
        return kernels.lloyd_partial_sums(x, c)
    except RuntimeError as e:
        raise RuntimeError(f"lloyd stage 1 at {tuple(x.shape)}") from e
