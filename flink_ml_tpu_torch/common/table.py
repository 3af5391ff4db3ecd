"""Columnar Table.

The port of ``flink_ml_tpu/common/table.py``. A column is a host numpy array
(numeric, or an object column of vectors) or a ``torch.Tensor`` — a device
column, kept as it is so that chained stages hand tensors to each other
without a round trip through the host. CSV parsing and the sparse and
streaming column kinds come with later slices.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from flink_ml_tpu_torch.linalg.vectors import DenseVector, Vector, stack_vectors

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}


def _is_device_column(values) -> bool:
    return isinstance(values, torch.Tensor)


def _as_column(values):
    """Normalize a column. Numeric 2-D arrays are kept as-is — a (n, d) array
    IS a vector column (row i = vector i), which avoids materializing n
    DenseVector objects for large tables."""
    if isinstance(values, np.ndarray) or _is_device_column(values):
        return values
    values = list(values)
    if values and isinstance(values[0], Vector):
        arr = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            arr[i] = v
        return arr
    try:
        arr = np.asarray(values)
    except ValueError:
        # ragged nested sequences stay host-side as object columns
        arr = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            arr[i] = v
        return arr
    if arr.ndim == 2 and arr.dtype.kind == "f":
        return arr  # list of equal-length numeric rows → vector column
    if arr.dtype.kind in "OU" or arr.ndim > 1:
        out = np.empty(len(values), dtype=object)
        for i, v in enumerate(values):
            out[i] = v
        return out
    return arr


class Table:
    """An ordered set of named columns of equal length."""

    def __init__(self, columns: Dict[str, object]):
        self._columns: Dict[str, object] = {}
        n = None
        for name, col in columns.items():
            col = _as_column(col)
            if n is None:
                n = len(col)
            elif len(col) != n:
                raise ValueError(
                    f"column {name!r} has {len(col)} rows, expected {n}")
            self._columns[name] = col
        self._num_rows = n or 0

    # -- constructors --------------------------------------------------------
    @staticmethod
    def from_columns(**columns) -> "Table":
        return Table(columns)


    # -- schema / access -----------------------------------------------------
    @property
    def column_names(self) -> List[str]:
        return list(self._columns)

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def __len__(self):
        return self._num_rows

    def __contains__(self, name):
        return name in self._columns

    def column(self, name: str):
        try:
            return self._columns[name]
        except KeyError:
            raise KeyError(
                f"no column {name!r}; available: {self.column_names}")

    def __getitem__(self, name: str):
        return self.column(name)

    def vectors(self, name: str, dtype=np.float32):
        """Column of vectors as one (n, dim) array — the device on-ramp.

        A tensor column whose dtype already matches is returned as-is, on
        its device (residency preserved for chained stages). A tensor column
        requested at a different dtype is brought to the host at the
        requested precision, as the JAX package does for its device
        columns. Host columns come back as numpy arrays.
        """
        col = self.column(name)
        if _is_device_column(col):
            if col.dtype == _TORCH_DTYPES.get(np.dtype(dtype)):
                return col if col.ndim == 2 else col[:, None]
            arr = col.cpu().numpy().astype(dtype)
            return arr[:, None] if arr.ndim == 1 else arr
        if col.dtype != object:
            arr = np.asarray(col, dtype=dtype)
            return arr[:, None] if arr.ndim == 1 else arr
        return stack_vectors(col, dtype=dtype)

    def scalars(self, name: str, dtype=np.float32) -> np.ndarray:
        """Always a host numpy array (the off-ramp for scalar columns)."""
        return np.asarray(self._host_column(name), dtype=dtype)

    # -- functional ops ------------------------------------------------------
    def with_column(self, name: str, values) -> "Table":
        cols = dict(self._columns)
        cols[name] = values
        return Table(cols)

    def _host_column(self, name: str) -> np.ndarray:
        col = self._columns[name]
        return col.cpu().numpy() if _is_device_column(col) else col

    def __repr__(self):
        return f"Table({self.column_names}, num_rows={self._num_rows})"


def as_dense_vector_column(arr: np.ndarray) -> np.ndarray:
    """(n, d) float array → object column of DenseVectors (device off-ramp)."""
    out = np.empty(arr.shape[0], dtype=object)
    for i in range(arr.shape[0]):
        out[i] = DenseVector(np.asarray(arr[i], dtype=np.float64))
    return out
