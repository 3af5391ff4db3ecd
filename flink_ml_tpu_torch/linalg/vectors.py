"""Dense and sparse vectors on the host.

The port's copy of what ``Table`` and the CSR columns need from
``flink_ml_tpu/linalg/vectors.py`` (ref: linalg/DenseVector.java,
SparseVector.java, DenseMatrix.java, Vectors.java, VectorWithNorm.java),
with the JAX package's byte encoding of a vector (the servable's model
data).
"""

from __future__ import annotations

import struct
from typing import Iterable, Sequence, Union

import numpy as np

__all__ = [
    "Vector", "DenseVector", "SparseVector", "DenseMatrix", "Vectors",
    "VectorWithNorm", "stack_vectors",
]


class Vector:
    """Abstract vector (ref: linalg/Vector.java)."""

    @property
    def size(self) -> int:
        raise NotImplementedError

    def get(self, i: int) -> float:
        raise NotImplementedError

    def to_array(self) -> np.ndarray:
        raise NotImplementedError

    def to_dense(self) -> "DenseVector":
        return DenseVector(self.to_array())

    def to_sparse(self) -> "SparseVector":
        arr = self.to_array()
        idx = np.nonzero(arr)[0]
        return SparseVector(arr.shape[0], idx, arr[idx])

    # -- wire codec (the JAX package's bytes: a kind byte, then little-endian
    # int64 sizes and float64 values) ---------------------------------------
    def to_bytes(self) -> bytes:
        raise NotImplementedError

    @staticmethod
    def from_bytes(data: bytes) -> "Vector":
        kind = data[0]
        if kind == 0:
            return DenseVector._decode(data)
        if kind == 1:
            return SparseVector._decode(data)
        raise ValueError(f"unknown vector kind byte {kind}")


class DenseVector(Vector):
    """Dense float64 vector backed by numpy (ref: DenseVector.java)."""

    __slots__ = ("values",)

    def __init__(self, values: Union[Sequence[float], np.ndarray]):
        self.values = np.asarray(values, dtype=np.float64)
        if self.values.ndim != 1:
            raise ValueError(f"DenseVector must be 1-D, got shape {self.values.shape}")

    @property
    def size(self) -> int:
        return int(self.values.shape[0])

    def get(self, i: int) -> float:
        return float(self.values[i])

    def set(self, i: int, value: float) -> None:
        self.values[i] = value

    def to_array(self) -> np.ndarray:
        return self.values

    def to_dense(self) -> "DenseVector":
        return self

    def clone(self) -> "DenseVector":
        return DenseVector(self.values.copy())

    def __len__(self):
        return self.size

    def __getitem__(self, i):
        return self.values[i]

    def __iter__(self):
        return iter(self.values)

    def __eq__(self, other):
        return isinstance(other, DenseVector) and np.array_equal(self.values, other.values)

    def __hash__(self):
        return hash(self.values.tobytes())

    def __repr__(self):
        return f"DenseVector({self.values.tolist()})"

    def to_bytes(self) -> bytes:
        return (b"\x00" + struct.pack("<q", self.size)
                + self.values.astype("<f8").tobytes())

    @staticmethod
    def _decode(data: bytes) -> "DenseVector":
        (n,) = struct.unpack_from("<q", data, 1)
        values = np.frombuffer(data, dtype="<f8", count=n, offset=9)
        return DenseVector(values.copy())


class SparseVector(Vector):
    """Sparse vector: (size, sorted indices, values) (ref: SparseVector.java)."""

    __slots__ = ("_size", "indices", "values")

    def __init__(self, size: int, indices, values):
        indices = np.asarray(indices, dtype=np.int64)
        values = np.asarray(values, dtype=np.float64)
        if indices.shape != values.shape:
            raise ValueError("indices and values must have equal length")
        if indices.size and (indices.min() < 0 or indices.max() >= size):
            raise ValueError(f"index out of range for size {size}")
        order = np.argsort(indices, kind="stable")
        self._size = int(size)
        self.indices = indices[order]
        self.values = values[order]
        if self.indices.size > 1 and np.any(np.diff(self.indices) == 0):
            raise ValueError("duplicate indices in SparseVector")

    @classmethod
    def _unchecked(cls, size: int, indices, values) -> "SparseVector":
        """From already sorted, in-range, duplicate-free int64/float64
        arrays, without validation (the bulk path of CSR row views)."""
        v = object.__new__(cls)
        v._size = size
        v.indices = indices
        v.values = values
        return v

    @property
    def size(self) -> int:
        return self._size

    def get(self, i: int) -> float:
        pos = np.searchsorted(self.indices, i)
        if pos < len(self.indices) and self.indices[pos] == i:
            return float(self.values[pos])
        return 0.0

    def to_array(self) -> np.ndarray:
        arr = np.zeros(self._size, dtype=np.float64)
        arr[self.indices] = self.values
        return arr

    def to_sparse(self) -> "SparseVector":
        return self

    def __eq__(self, other):
        return (isinstance(other, SparseVector) and self._size == other._size
                and np.array_equal(self.indices, other.indices)
                and np.array_equal(self.values, other.values))

    def __hash__(self):
        return hash((self._size, self.indices.tobytes(), self.values.tobytes()))

    def __repr__(self):
        return (f"SparseVector({self._size}, {self.indices.tolist()}, "
                f"{self.values.tolist()})")

    def to_bytes(self) -> bytes:
        nnz = len(self.indices)
        return (b"\x01" + struct.pack("<qq", self._size, nnz)
                + self.indices.astype("<i8").tobytes()
                + self.values.astype("<f8").tobytes())

    @staticmethod
    def _decode(data: bytes) -> "SparseVector":
        size, nnz = struct.unpack_from("<qq", data, 1)
        indices = np.frombuffer(data, dtype="<i8", count=nnz, offset=17)
        values = np.frombuffer(data, dtype="<f8", count=nnz,
                               offset=17 + 8 * nnz)
        return SparseVector(size, indices.copy(), values.copy())


class DenseMatrix:
    """Dense row-major float64 matrix (ref: DenseMatrix.java, which is
    column-major; row-major here, numpy's native order)."""

    __slots__ = ("values",)

    def __init__(self, num_rows: int = None, num_cols: int = None,
                 values=None):
        if values is None:
            self.values = np.zeros((num_rows, num_cols), dtype=np.float64)
        else:
            arr = np.asarray(values, dtype=np.float64)
            if arr.ndim == 1:
                arr = arr.reshape(num_rows, num_cols)
            self.values = arr

    @property
    def num_rows(self) -> int:
        return self.values.shape[0]

    @property
    def num_cols(self) -> int:
        return self.values.shape[1]

    def get(self, i: int, j: int) -> float:
        return float(self.values[i, j])

    def set(self, i: int, j: int, value: float) -> None:
        self.values[i, j] = value

    def to_array(self) -> np.ndarray:
        return self.values

    def __eq__(self, other):
        return (isinstance(other, DenseMatrix)
                and np.array_equal(self.values, other.values))

    def __repr__(self):
        return f"DenseMatrix({self.num_rows}x{self.num_cols})"

    def to_bytes(self) -> bytes:
        return (b"\x02" + struct.pack("<qq", self.num_rows, self.num_cols)
                + self.values.astype("<f8").tobytes())

    @staticmethod
    def from_bytes(data: bytes) -> "DenseMatrix":
        rows, cols = struct.unpack_from("<qq", data, 1)
        values = np.frombuffer(data, dtype="<f8", count=rows * cols, offset=17)
        return DenseMatrix(rows, cols, values.copy())


class VectorWithNorm:
    """A vector with its cached L2 norm (ref: VectorWithNorm.java)."""

    __slots__ = ("vector", "l2_norm")

    def __init__(self, vector: Vector, l2_norm: float = None):
        self.vector = vector
        if l2_norm is None:
            l2_norm = float(np.linalg.norm(vector.to_array()))
        self.l2_norm = l2_norm


class Vectors:
    """Factory methods (ref: Vectors.java)."""

    @staticmethod
    def dense(*values) -> DenseVector:
        if len(values) == 1 and isinstance(values[0],
                                           (list, tuple, np.ndarray)):
            return DenseVector(values[0])
        return DenseVector(values)

    @staticmethod
    def sparse(size: int, indices, values) -> SparseVector:
        return SparseVector(size, indices, values)


def stack_vectors(vectors: Iterable[Vector], dtype=np.float32) -> np.ndarray:
    """Stack host vectors into one (n, dim) array — the API→device boundary."""
    mats = [v.to_array() if isinstance(v, Vector) else np.asarray(v) for v in vectors]
    return np.stack(mats).astype(dtype) if mats else np.zeros((0, 0), dtype=dtype)
