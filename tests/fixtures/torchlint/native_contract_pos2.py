"""torchlint fixture: POSITIVE for native-contract.

A ctypes entry's status dropped and another bound but never compared, and
an except handler around a kernel launch that goes on to the plain
version — the kernel-or-raise rule.
"""
import ctypes

from flink_ml_tpu_torch.ops import _build
from flink_ml_tpu_torch.ops import kernels


def launch(x_ptr, n):
    lib = _build.load("sgd_kernels")
    lib.sgd_batch_terms(x_ptr, ctypes.c_int64(n))  # status dropped
    rc = lib.reduce_partials(x_ptr, ctypes.c_int64(n))  # never compared
    return x_ptr


def lloyd(x, c):
    try:
        return kernels.lloyd_partial_sums(x, c)
    except RuntimeError:
        return kernels.lloyd_partial_sums_plain(x, c)  # silent fallback


def knn(model, x):
    try:
        out = kernels.knn_topk_indices(x, model.train, 5)
    except Exception:
        model.kernel_broken = True  # a fallback flag
        out = None
    return out
