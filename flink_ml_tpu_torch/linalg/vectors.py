"""Dense vectors on the host.

The port's copy of what ``Table`` needs from ``flink_ml_tpu/linalg/vectors.py``
(ref: linalg/DenseVector.java). Sparse vectors and matrices come with the
slices that use them.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Union

import numpy as np

__all__ = ["Vector", "DenseVector", "stack_vectors"]


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

    def to_array(self) -> np.ndarray:
        return self.values

    def to_dense(self) -> "DenseVector":
        return self

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


def stack_vectors(vectors: Iterable[Vector], dtype=np.float32) -> np.ndarray:
    """Stack host vectors into one (n, dim) array — the API→device boundary."""
    mats = [v.to_array() if isinstance(v, Vector) else np.asarray(v) for v in vectors]
    return np.stack(mats).astype(dtype) if mats else np.zeros((0, 0), dtype=dtype)
