"""Native (C++) host kernels.

The port of ``flink_ml_tpu/native/__init__.py``: the host-side kernels that
are neither device work nor fast in Python. The sources are the port's own
copies under ``csrc/host/`` (``factorize_kernel.cpp``, ``csv_kernel.cpp``,
``swing_kernel.cpp``);
``ops/_build.py`` compiles them with ``g++`` at first use into the
gitignored ``_build/`` and they are bound with ctypes.

Kernel or raise: where the JAX package lets every caller fall back to a
Python (or pandas) engine when the library is missing, here a missing
``g++`` or a failed build raises ``KernelBuildError`` from every entry
point. The ``None`` returns that remain are the kernels' own semantic
limits (a distinct set past ``FACTORIZE_UNIQ_CAP``, a domain past
``ROWWISE_DOMAIN_CAP``, an out-of-domain code, a dtype without a kernel
variant, a CSV buffer that is not all numeric), and the callers handle
them as the JAX package's do. Every entry point is a ``native-kernel``
chaos site.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
from typing import Optional

import numpy as np

from flink_ml_tpu_torch.ops import _build
from flink_ml_tpu_torch.resilience import faults

__all__ = ["factorize_i64", "doc_freq_i64", "rowwise_counts",
           "csv_parse_numeric", "swing_similarity", "native_threads",
           "FACTORIZE_UNIQ_CAP",
           "ROWWISE_DOMAIN_CAP", "NATIVE_THREADS_ENV"]

#: distinct-set cap for the native factorizer: past this many distinct
#: keys (mostly-distinct corpora) the hash-table win evaporates and the
#: uniq buffer would get large — callers fall back to np.unique
FACTORIZE_UNIQ_CAP = 1 << 24

#: per-domain-entry budget (8 bytes each) shared by the native rowwise
#: counter's cnt array and doc_freq_i64's last-seen stamp — above it the
#: callers' chunked numpy engines bound memory instead
ROWWISE_DOMAIN_CAP = 1 << 22

#: env var: worker-thread count for the threadable native kernels
#: (factorize_i64, doc_freq_i64). Default 1 — the host string tier
#: already shards rows over forked pool workers, and threads multiply
#: per worker; keep threads × workers within the core count.
NATIVE_THREADS_ENV = "FLINK_ML_TPU_NATIVE_THREADS"

#: sanity ceiling on the parsed thread count
_NATIVE_THREADS_MAX = 256

_threads_warned = False

_I64P = ctypes.POINTER(ctypes.c_int64)
_F64P = ctypes.POINTER(ctypes.c_double)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its signatures set; raises
    ``KernelBuildError`` when it cannot be built."""
    lib = _build.load_host()
    lib.swing_similarity.restype = ctypes.c_int
    lib.swing_similarity.argtypes = [
        _I64P,            # user_items
        _I64P,            # user_offsets
        _F64P,            # user_weights
        ctypes.c_int64,   # n_users
        _I64P,            # item_users
        _I64P,            # item_offsets
        _I64P,            # item_ids
        ctypes.c_int64,   # n_items
        ctypes.c_double,  # alpha2
        ctypes.c_int64,   # k
        _I64P,            # out_items
        _F64P,            # out_scores
        _I64P,            # out_counts
    ]
    lib.csv_parse_numeric.restype = ctypes.c_int64
    lib.csv_parse_numeric.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.factorize_i64.restype = ctypes.c_int64
    lib.factorize_i64.argtypes = [_I64P, ctypes.c_int64, _I64P, _I64P,
                                  ctypes.c_int64, ctypes.c_int64]
    lib.doc_freq_i64.restype = ctypes.c_int64
    lib.doc_freq_i64.argtypes = [_I64P, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64, _I64P, ctypes.c_int64]
    for name in ("rowwise_counts_u8", "rowwise_counts_u16",
                 "rowwise_counts_u32", "rowwise_counts_i64"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, _I64P, _I64P, _I64P, ctypes.c_int64]
    return lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(_I64P)


def native_threads() -> int:
    """The validated FLINK_ML_TPU_NATIVE_THREADS value: a positive int,
    capped at 256. Unset/empty → 1. Non-positive or unparsable values →
    1 with one warning per process."""
    global _threads_warned
    raw = os.environ.get(NATIVE_THREADS_ENV)
    if not raw:
        return 1
    try:
        value = int(raw)
    except ValueError:
        value = 0
    if value < 1:
        if not _threads_warned:
            _threads_warned = True
            logging.getLogger(__name__).warning(
                "%s=%r is not a positive integer; native kernels run "
                "single-threaded", NATIVE_THREADS_ENV, raw)
        return 1
    return min(value, _NATIVE_THREADS_MAX)


def swing_similarity(user_items: np.ndarray, user_offsets: np.ndarray,
                     user_weights: np.ndarray, item_users: np.ndarray,
                     item_offsets: np.ndarray, item_ids: np.ndarray,
                     alpha2: float, k: int):
    """Swing scoring over the CSR-packed groupings (sorted item ids per
    user with the users' weights; user indices per item) → (out_items
    (n_items, k), out_scores (n_items, k), out_counts (n_items,)): each
    item's up to k most similar items, by score descending, ties to the
    lower item id."""
    faults.inject("native-kernel", kernel="swing_similarity")
    lib = _lib()
    user_items = np.ascontiguousarray(user_items, np.int64)
    user_offsets = np.ascontiguousarray(user_offsets, np.int64)
    user_weights = np.ascontiguousarray(user_weights, np.float64)
    item_users = np.ascontiguousarray(item_users, np.int64)
    item_offsets = np.ascontiguousarray(item_offsets, np.int64)
    item_ids = np.ascontiguousarray(item_ids, np.int64)
    n_users, n_items = len(user_offsets) - 1, len(item_ids)
    if (len(user_weights) != n_users or len(item_offsets) != n_items + 1
            or user_offsets[-1] != len(user_items)
            or item_offsets[-1] != len(item_users)
            or (len(item_users) and not 0 <= item_users.min()
                <= item_users.max() < n_users)):
        raise ValueError("swing_similarity: the offsets or user indices do "
                         "not match the packed arrays")
    out_items = np.zeros((n_items, k), np.int64)
    out_scores = np.zeros((n_items, k), np.float64)
    out_counts = np.zeros(n_items, np.int64)
    rc = lib.swing_similarity(
        _ptr(user_items), _ptr(user_offsets),
        user_weights.ctypes.data_as(_F64P), ctypes.c_int64(n_users),
        _ptr(item_users), _ptr(item_offsets), _ptr(item_ids),
        ctypes.c_int64(n_items), ctypes.c_double(alpha2), ctypes.c_int64(k),
        _ptr(out_items), out_scores.ctypes.data_as(_F64P), _ptr(out_counts))
    if rc != 0:
        raise RuntimeError(f"swing_similarity failed with code {rc}")
    return out_items, out_scores, out_counts


def csv_parse_numeric(data: bytes, n_cols: int, delimiter: str = ","):
    """All-numeric CSV parse → (n_rows, n_cols) float64 array, or None when
    the buffer is not purely numeric (the caller parses it per column)."""
    faults.inject("native-kernel", kernel="csv_parse_numeric")
    lib = _lib()
    max_rows = data.count(b"\n") + 1
    out = np.empty((max_rows, n_cols), np.float64)
    n = lib.csv_parse_numeric(
        data, ctypes.c_int64(len(data)),
        ctypes.c_char(delimiter.encode()), ctypes.c_int64(n_cols),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(max_rows))
    if n < 0:
        return None
    return out[:n]


def factorize_i64(keys: np.ndarray, n_threads: Optional[int] = None):
    """First-appearance factorization of a 1-D int64 array: (uniq_keys,
    codes) with uniq in appearance order, or None when the distinct count
    exceeds FACTORIZE_UNIQ_CAP. ``n_threads`` (default: the validated
    FLINK_ML_TPU_NATIVE_THREADS) shards the keys across threads with a
    deterministic chunk-order merge: byte-identical to one thread."""
    faults.inject("native-kernel", kernel="factorize_i64")
    lib = _lib()
    keys = np.ascontiguousarray(keys, np.int64)
    n = len(keys)
    cap = int(min(n, FACTORIZE_UNIQ_CAP)) + 1
    codes = np.empty(n, np.int64)
    uniq = np.empty(cap, np.int64)
    nu = lib.factorize_i64(_ptr(keys), ctypes.c_int64(n), _ptr(codes),
                           _ptr(uniq), ctypes.c_int64(cap),
                           ctypes.c_int64(n_threads if n_threads is not None
                                          else native_threads()))
    if nu < 0:
        return None
    return uniq[:nu].copy(), codes


def doc_freq_i64(codes_mat: np.ndarray, u: int,
                 n_threads: Optional[int] = None):
    """Per-code document frequency of an (n_rows, w) code matrix with
    domain [0, u), one native pass with a last-seen-row stamp; None when
    a code falls outside [0, u) or u is outside (0, ROWWISE_DOMAIN_CAP]
    (the stamp is 8·u bytes per forked worker)."""
    faults.inject("native-kernel", kernel="doc_freq_i64")
    if u <= 0 or u > ROWWISE_DOMAIN_CAP:
        return None
    lib = _lib()
    codes_mat = np.ascontiguousarray(codes_mat, np.int64)
    n_rows, w = codes_mat.shape
    df = np.zeros(u, np.int64)
    rc = lib.doc_freq_i64(_ptr(codes_mat), ctypes.c_int64(n_rows),
                          ctypes.c_int64(w), ctypes.c_int64(u), _ptr(df),
                          ctypes.c_int64(n_threads if n_threads is not None
                                         else native_threads()))
    if rc < 0:
        return None
    return df


_ROWWISE_FNS = {"uint8": "rowwise_counts_u8", "uint16": "rowwise_counts_u16",
                "uint32": "rowwise_counts_u32", "int64": "rowwise_counts_i64"}


def rowwise_counts(codes_mat: np.ndarray, u: int,
                   max_chunk_bytes: int = 256 << 20):
    """CSR-canonical (row_of, values, counts) of an (n_rows, w) code matrix
    with domain [0, u) by the per-row stamped counter: one pass, no large
    temporaries; or None when the dtype has no kernel variant, the domain
    is outside (0, ROWWISE_DOMAIN_CAP], or a code is out of range. Values
    come back int64; rows ascend, values ascend within each row."""
    faults.inject("native-kernel", kernel="rowwise_counts")
    if u <= 0 or u > ROWWISE_DOMAIN_CAP:
        return None
    fn_name = _ROWWISE_FNS.get(codes_mat.dtype.name)
    if fn_name is None:
        return None
    fn = getattr(_lib(), fn_name)
    n, w = codes_mat.shape
    if n == 0 or w == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy()
    per_row = int(min(w, u))
    chunk = max(1, max_chunk_bytes // max(24 * per_row, 1))
    rows_p, vals_p, cnts_p = [], [], []
    for r0 in range(0, n, chunk):
        sub = np.ascontiguousarray(codes_mat[r0:r0 + chunk])
        m = sub.shape[0]
        cap = m * per_row  # the true per-chunk maximum
        row_out = np.empty(cap, np.int64)
        val_out = np.empty(cap, np.int64)
        cnt_out = np.empty(cap, np.int64)
        nnz = fn(sub.ctypes.data, ctypes.c_int64(m), ctypes.c_int64(w),
                 ctypes.c_int64(u), _ptr(row_out), _ptr(val_out),
                 _ptr(cnt_out), ctypes.c_int64(cap))
        if nnz < 0:
            return None
        rows_p.append(row_out[:nnz] + r0)
        vals_p.append(val_out[:nnz].copy())
        cnts_p.append(cnt_out[:nnz].copy())
    return (np.concatenate(rows_p), np.concatenate(vals_p),
            np.concatenate(cnts_p))
