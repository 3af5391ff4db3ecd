"""CSR batching for sparse vector columns.

The port of ``flink_ml_tpu/linalg/sparse.py`` (ref: the sparse branches of
BLAS.hDot, flink-ml-servable-core/.../linalg/BLAS.java:78, and of FTRL,
OnlineLogisticRegression.java:364-388). A sparse vector column stays one
host scipy CSR matrix, float64, end to end: a hashed 2^18-wide column
stacked dense would not fit anywhere. The trainers that take CSR (FTRL)
move a batch's stored values to the device themselves; the feature
transformers keep a CSR column CSR (O(nnz)) where their op preserves
sparsity.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from flink_ml_tpu_torch.linalg.vectors import SparseVector, Vector


class CsrVectorColumn:
    """A sparse vector column stored as ONE scipy CSR matrix. Row access
    (``col[i]``, iteration) gives ``SparseVector`` views, so per-row
    consumers see what an object column of sparse vectors would hold."""

    is_csr_vector_column = True  # duck-type marker (Table, is_sparse_column)
    #: quacks like numpy's object-column dtype for code that branches on it
    dtype = np.dtype(object)
    ndim = 1

    def __init__(self, matrix):
        self.matrix = matrix.tocsr()

    def __len__(self):
        return self.matrix.shape[0]

    @property
    def shape(self):
        return (self.matrix.shape[0],)

    def _row(self, i: int) -> SparseVector:
        m = self.matrix
        lo, hi = m.indptr[i], m.indptr[i + 1]
        return SparseVector._unchecked(
            m.shape[1], m.indices[lo:hi].astype(np.int64),
            m.data[lo:hi].astype(np.float64))

    def __getitem__(self, key):
        if isinstance(key, slice):
            return CsrVectorColumn(self.matrix[key])
        if np.ndim(key) == 0:
            i = int(key)
            n = self.matrix.shape[0]
            if i < 0:
                i += n
            if not 0 <= i < n:
                raise IndexError(
                    f"row {key} out of bounds for column of {n} rows")
            return self._row(i)
        return CsrVectorColumn(self.matrix[np.asarray(key)])

    def __iter__(self):
        for i in range(len(self)):
            yield self._row(i)

    def to_csr(self):
        return self.matrix

    def to_object_column(self) -> np.ndarray:
        return csr_to_column(self.matrix)

    def to_dense(self, dtype=np.float64) -> np.ndarray:
        # narrow before densifying: no full-size float64 temporary
        m = self.matrix if self.matrix.dtype == dtype \
            else self.matrix.astype(dtype)
        return m.toarray()

    def concat(self, other) -> "CsrVectorColumn":
        o = other.matrix if isinstance(other, CsrVectorColumn) \
            else column_to_csr(other)
        return CsrVectorColumn(sp.vstack([self.matrix, o], format="csr"))

    def concat_after(self, other) -> "CsrVectorColumn":
        """``other`` (an object or dense vector column) followed by this
        column, still CSR-backed."""
        return CsrVectorColumn(
            sp.vstack([column_to_csr(other), self.matrix], format="csr"))

    def __repr__(self):
        return (f"CsrVectorColumn({self.matrix.shape[0]} rows, "
                f"size={self.matrix.shape[1]}, nnz={self.matrix.nnz})")


def is_csr_column(col) -> bool:
    return getattr(col, "is_csr_vector_column", False)


def column_moments(m):
    """Per-column (mean, centered sum of squares, stored count) of a CSR
    matrix in O(nnz), two-pass: the implicit zeros add (n − nnz_col)·mean²
    to the centered sum. StandardScaler keeps the reference's one-pass
    Σx²−n·mean² instead, for parity."""
    n = m.shape[0]
    mean = np.asarray(m.sum(axis=0)).ravel() / max(n, 1)
    centered = m.data - mean[m.indices]
    nnz_col = np.asarray(m.getnnz(axis=0)).ravel()
    varsum = (np.bincount(m.indices, weights=centered * centered,
                          minlength=m.shape[1])
              + (n - nnz_col) * mean * mean)
    return mean, varsum, nnz_col


def is_sparse_column(col) -> bool:
    """True for a CSR-backed column or an object column holding at least
    one SparseVector row: a column with any sparse row takes the CSR path
    (the reference dispatches per row, OnlineLogisticRegression.java:375)."""
    if is_csr_column(col):
        return True
    return (getattr(col, "dtype", None) == object and len(col) > 0
            and isinstance(col[0], Vector)
            and any(isinstance(v, SparseVector) for v in col))


def _row_parts(v):
    if isinstance(v, SparseVector):
        return v.indices, v.values
    arr = v.to_array() if isinstance(v, Vector) else np.asarray(v)
    return np.arange(arr.shape[0], dtype=np.int64), arr


def column_to_csr(col, dtype=np.float64):
    """A vector column → one scipy CSR matrix (n, size). Dense rows of a
    mixed column become fully present sparse rows; rows of another size
    raise instead of scattering out of bounds."""
    if is_csr_column(col):
        m = col.to_csr()
        return m if m.dtype == dtype else m.astype(dtype)

    n = len(col)
    parts = [_row_parts(v) for v in col]
    size = int(col[0].size if isinstance(col[0], Vector)
               else len(parts[0][1]))
    for i, v in enumerate(col):
        vsize = int(v.size if isinstance(v, Vector) else len(parts[i][1]))
        if vsize != size:
            raise ValueError(
                f"row {i} has size {vsize}, expected {size} (ragged vector "
                "column cannot form a CSR batch)")
    nnz = np.fromiter((len(p[0]) for p in parts), np.int64, n)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(nnz, out=indptr[1:])
    if indptr[-1]:
        indices = np.concatenate([p[0] for p in parts])
        data = np.concatenate([p[1] for p in parts]).astype(dtype)
    else:
        indices = np.zeros(0, np.int64)
        data = np.zeros(0, dtype)
    return sp.csr_matrix((data, indices, indptr), shape=(n, size))


def csr_to_column(matrix) -> np.ndarray:
    """CSR matrix → object column of SparseVectors (the inverse off-ramp)."""
    m = matrix.tocsr()
    n, size = m.shape
    out = np.empty(n, dtype=object)
    for i in range(n):
        lo, hi = m.indptr[i], m.indptr[i + 1]
        out[i] = SparseVector._unchecked(
            size, m.indices[lo:hi].astype(np.int64),
            m.data[lo:hi].astype(np.float64))
    return out


def features_matrix(table, col_name: str, dtype=np.float32):
    """A Table column → a dense (n, d) array or tensor (``Table.vectors``),
    or a scipy CSR matrix when the column is sparse. ``dtype`` applies to
    the dense branch only; the CSR branch is always float64, the host math's
    precision and the reference's double."""
    col = table.column(col_name)
    if is_sparse_column(col):
        return column_to_csr(col, dtype=np.float64)
    return table.vectors(col_name, dtype)


def is_csr(x) -> bool:
    return sp.issparse(x)
