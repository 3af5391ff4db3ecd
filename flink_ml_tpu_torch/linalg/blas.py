"""BLAS-equivalent ops on host vectors.

The port of ``flink_ml_tpu/linalg/blas.py`` (ref: linalg/BLAS.java:30-179):
``asum``, ``axpy`` (with an optional slice length k), ``dot``, ``h_dot``
(Hadamard, sparse-aware), ``norm2``, ``norm(p)``, ``scal`` and ``gemv`` on
``DenseVector`` / ``SparseVector`` / ``DenseMatrix`` / numpy arrays, in
numpy float64: the servables' and model data's small vector arithmetic.
Batched device work uses torch operations directly, as the JAX package's
device tier uses ``jnp``.
"""

from __future__ import annotations

import numpy as np

from flink_ml_tpu_torch.linalg.vectors import DenseMatrix, DenseVector, SparseVector, Vector


def _arr(x) -> np.ndarray:
    if isinstance(x, Vector):
        return x.to_array()
    if isinstance(x, DenseMatrix):
        return x.to_array()
    return np.asarray(x, dtype=np.float64)


def asum(x) -> float:
    """sum(|x_i|) (ref: BLAS.java asum)."""
    return float(np.abs(_arr(x)).sum())


def axpy(a: float, x, y: DenseVector, k: int = None) -> None:
    """y[:k] += a * x[:k], in place (ref: BLAS.java:41 — optional slice length).

    x may be sparse; sparse axpy scatters into y without densifying x.
    """
    n = y.size if k is None else k
    if isinstance(x, SparseVector):
        mask = x.indices < n
        np.add.at(y.values, x.indices[mask], a * x.values[mask])
    else:
        y.values[:n] += a * _arr(x)[:n]


def dot(x, y) -> float:
    """x·y, sparse-aware on either side (ref: BLAS.java dot)."""
    if isinstance(x, SparseVector) and isinstance(y, SparseVector):
        # merge on sorted indices
        common, xi, yi = np.intersect1d(x.indices, y.indices, return_indices=True)
        return float(np.dot(x.values[xi], y.values[yi]))
    if isinstance(x, SparseVector):
        return float(np.dot(x.values, _arr(y)[x.indices]))
    if isinstance(y, SparseVector):
        return float(np.dot(y.values, _arr(x)[y.indices]))
    return float(np.dot(_arr(x), _arr(y)))


def h_dot(x, y: Vector) -> None:
    """Hadamard product y = x ∘ y in place (ref: BLAS.java hDot)."""
    if isinstance(y, SparseVector):
        if isinstance(x, SparseVector):
            xv = np.zeros(y.size)
            xv[x.indices] = x.values
            y.values *= xv[y.indices]
        else:
            y.values *= _arr(x)[y.indices]
    else:
        if isinstance(x, SparseVector):
            dense_x = np.zeros(y.size)
            dense_x[x.indices] = x.values
            y.values *= dense_x
        else:
            y.values *= _arr(x)


def norm2(x) -> float:
    if isinstance(x, SparseVector):
        return float(np.linalg.norm(x.values))
    return float(np.linalg.norm(_arr(x)))


def norm(x, p: float) -> float:
    """p-norm (ref: BLAS.java norm(p)); supports inf."""
    v = x.values if isinstance(x, SparseVector) else _arr(x)
    if np.isinf(p):
        return float(np.abs(v).max()) if v.size else 0.0
    return float(np.power(np.power(np.abs(v), p).sum(), 1.0 / p))


def scal(a: float, x: Vector) -> None:
    """x *= a in place."""
    x.values *= a


def gemv(alpha: float, matrix: DenseMatrix, trans: bool, x, y: DenseVector,
         beta: float = 0.0) -> None:
    """y = alpha * op(M) @ x + beta * y (ref: BLAS.java gemv)."""
    m = matrix.to_array().T if trans else matrix.to_array()
    xv = x.to_array() if isinstance(x, Vector) else np.asarray(x)
    y.values[:] = alpha * (m @ xv) + beta * y.values
