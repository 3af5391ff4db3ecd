"""torchlint fixture: POSITIVE for native-contract.

Fallible native wrappers used without the None check, and a clipped
gather with no bounds assert: each fails silently on the inputs its guard
exists for.
"""
import numpy as np

from flink_ml_tpu_torch import native


def doc_freqs(mat, u):
    df = native.doc_freq_i64(mat, u)
    return df + 1  # df is None past the domain cap


def term_triples(mat, u):
    return np.sum(native.rowwise_counts(mat, u)[2])  # inline use


def gather(tokens, ints):
    return np.take(tokens, ints, mode="clip")  # silent clamp
