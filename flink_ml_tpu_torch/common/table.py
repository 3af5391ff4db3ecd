"""Columnar Table.

The port of ``flink_ml_tpu/common/table.py``. A column is a host numpy array
(numeric, or an object column of vectors), a CSR-backed sparse vector column
(``linalg/sparse.py``), or a ``torch.Tensor`` — a device column, kept as it
is so that chained stages hand tensors to each other without a round trip
through the host. CSV files take the native all-numeric parser
(``native.csv_parse_numeric``) first, and are parsed per column (float64
or object) when a cell is not numeric.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

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


def _is_csr_column(values) -> bool:
    """A CsrVectorColumn (``linalg/sparse.py``), duck-typed so that this
    module needs no scipy."""
    return getattr(values, "is_csr_vector_column", False)


def _as_column(values):
    """Normalize a column. Numeric 2-D arrays are kept as-is — a (n, d) array
    IS a vector column (row i = vector i), which avoids materializing n
    DenseVector objects for large tables."""
    if (isinstance(values, np.ndarray) or _is_device_column(values)
            or _is_csr_column(values)):
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


def _take_rows(col, indices):
    """Rows ``indices`` (a host array, or an int64 tensor) of one column: a
    tensor column gathers on its device, a host column on the host."""
    if _is_device_column(col):
        return col[torch.as_tensor(indices, dtype=torch.int64,
                                   device=col.device)]
    if isinstance(indices, torch.Tensor):
        indices = indices.cpu().numpy()
    return col[indices]


def _concat_columns(a, b):
    if _is_csr_column(a):
        return a.concat(b)
    if _is_csr_column(b):
        return b.concat_after(a)  # keep CSR backing either way
    if _is_device_column(a) or _is_device_column(b):
        device = (a if _is_device_column(a) else b).device
        return torch.cat([torch.as_tensor(a, device=device),
                          torch.as_tensor(b, device=device)])
    return np.concatenate([a, b])


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

    @staticmethod
    def from_rows(rows: Iterable[Sequence], names: Sequence[str]) -> "Table":
        rows = list(rows)
        cols = {name: [row[i] for row in rows] for i, name in enumerate(names)}
        return Table(cols)

    @staticmethod
    def from_data_frame(df) -> "Table":
        """From a servable DataFrame (``flink_ml_tpu_torch.servable``)."""
        return Table({name: df.get(name).values for name in df.column_names})

    @staticmethod
    def from_csv(path: str, header: bool = True, delimiter: str = ",",
                 names: Sequence[str] = None) -> "Table":
        """Load a delimiter-separated file. An all-numeric file takes the
        native C++ parse; otherwise a column is float64 when every cell
        parses, an object column of strings otherwise. ``names``
        overrides the column names; with ``header=True`` the header row is
        still skipped."""
        import csv as _csv
        import io as _io

        with open(path, "rb") as f:
            data = f.read()
        first_nl = data.find(b"\n")
        first_line = (data if first_nl < 0 else data[:first_nl]) \
            .decode().rstrip("\r")
        # quote-aware header parse (a quoted cell may contain the delimiter)
        header_cells = next(_csv.reader([first_line], delimiter=delimiter),
                            [])
        n_cols = len(header_cells)
        if header:
            if names is None:
                names = [c.strip() for c in header_cells]
            data = b"" if first_nl < 0 else data[first_nl + 1:]
        elif names is None:
            names = [f"c{i}" for i in range(n_cols)]
        names = list(names)
        if len(names) != n_cols:
            raise ValueError(f"{len(names)} names for {n_cols} columns")
        from flink_ml_tpu_torch import native

        parsed = native.csv_parse_numeric(data, n_cols, delimiter) \
            if data else np.empty((0, n_cols))
        if parsed is not None:
            return Table({name: parsed[:, i].copy()
                          for i, name in enumerate(names)})
        rows = list(_csv.reader(_io.StringIO(data.decode()),
                                delimiter=delimiter))
        rows = [r for r in rows if r]
        cols = {}
        for i, name in enumerate(names):
            raw = [r[i] if i < len(r) else "" for r in rows]
            try:
                cols[name] = np.asarray([float(v) for v in raw],
                                        dtype=np.float64)
            except ValueError:
                cols[name] = np.asarray(raw, dtype=object)
        return Table(cols)

    def to_csv(self, path: str, header: bool = True,
               delimiter: str = ",") -> None:
        """Write scalar columns as delimiter-separated text (vector columns
        are rejected: model data keeps its binary format)."""
        import csv as _csv

        names = self.column_names
        for name in names:
            if _is_csr_column(self._columns[name]):
                raise ValueError(
                    f"column {name!r} is not scalar; to_csv writes scalar "
                    "columns only")
            col = self._host_column(name)
            if col.ndim != 1 or (
                    col.dtype == object and len(col)
                    and isinstance(col[0], (Vector, list, tuple, np.ndarray))):
                raise ValueError(
                    f"column {name!r} is not scalar; to_csv writes scalar "
                    "columns only")
        with open(path, "w", newline="") as f:
            writer = _csv.writer(f, delimiter=delimiter)
            if header:
                writer.writerow(names)
            writer.writerows(zip(*(self._host_column(n) for n in names)))


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
        columns. Host columns come back as numpy arrays; a CSR column comes
        back densified (callers that keep sparsity use
        ``linalg.sparse.features_matrix``).
        """
        col = self.column(name)
        if _is_csr_column(col):
            return col.to_dense(dtype)
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

    def with_columns(self, **columns) -> "Table":
        cols = dict(self._columns)
        cols.update(columns)
        return Table(cols)

    def select(self, *names: str) -> "Table":
        return Table({n: self.column(n) for n in names})

    def drop(self, *names: str) -> "Table":
        return Table({n: c for n, c in self._columns.items()
                      if n not in names})

    def rename(self, mapping: Dict[str, str]) -> "Table":
        return Table({mapping.get(n, n): c for n, c in self._columns.items()})

    def take(self, indices) -> "Table":
        """Row subset. A unit-step ``slice`` gives views: tensor and numpy
        columns share this table's storage (copy a column before writing
        into it), a CSR column slices its matrix. Other slices and index
        arrays copy. An int64 index tensor keeps a device row drop on the
        device: tensor columns gather there, and only host columns bring
        the indices to the host."""
        if isinstance(indices, slice):
            start, stop, step = indices.indices(self._num_rows)
            if step == 1:
                return Table({n: c[start:stop]
                              for n, c in self._columns.items()})
            indices = np.arange(start, stop, step)
        if not isinstance(indices, torch.Tensor):
            indices = np.asarray(indices)
        return Table({n: _take_rows(c, indices)
                      for n, c in self._columns.items()})

    def head(self, n: int) -> "Table":
        """The first ``n`` rows, as views (see :meth:`take`)."""
        # clamp below too: slice(0, -1) would mean "all but the last row"
        return self.take(slice(0, max(0, min(n, self._num_rows))))

    def concat(self, other: "Table") -> "Table":
        """This table's rows, then ``other``'s (same column names). Tensor
        columns stay on their device; a host column joined to a tensor
        column is moved there."""
        if set(self.column_names) != set(other.column_names):
            raise ValueError("cannot concat tables with different schemas")
        if self._num_rows == 0:
            return Table({n: other.column(n) for n in self.column_names})
        if other.num_rows == 0:
            return self
        return Table({n: _concat_columns(self._columns[n], other.column(n))
                      for n in self.column_names})

    # -- row view (collect parity with table.execute().collect()) -----------
    def _host_column(self, name: str) -> np.ndarray:
        col = self._columns[name]
        if _is_csr_column(col):
            return col.to_object_column()
        return col.cpu().numpy() if _is_device_column(col) else col

    def rows(self) -> List[tuple]:
        names = self.column_names
        cols = [self._host_column(n) for n in names]
        return [tuple(c[i] for c in cols) for i in range(self._num_rows)]

    def to_dict(self) -> Dict[str, list]:
        return {n: list(self._host_column(n)) for n in self._columns}

    def __repr__(self):
        return f"Table({self.column_names}, num_rows={self._num_rows})"


def as_dense_vector_column(arr: np.ndarray) -> np.ndarray:
    """(n, d) float array → object column of DenseVectors (device off-ramp)."""
    out = np.empty(arr.shape[0], dtype=object)
    for i in range(arr.shape[0]):
        out[i] = DenseVector(np.asarray(arr[i], dtype=np.float64))
    return out
