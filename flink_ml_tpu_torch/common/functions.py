"""Table-level vector conversion functions.

The port of ``flink_ml_tpu/common/functions.py`` (ref: flink-ml-lib
Functions.java:39-71, the ``vectorToArray`` / ``arrayToVector`` Table
UDFs), each over a whole column at once, and the shared integer-width
ladder ``narrow_uint``.
"""

from __future__ import annotations

import numpy as np

from flink_ml_tpu_torch.common.table import Table

__all__ = ["vector_to_array", "array_to_vector", "narrow_uint"]


def narrow_uint(n: int):
    """Narrowest integer dtype holding values in [0, n) — the one shared
    ladder for code/label matrices (a 10M x 100 matrix is 1 GB as uint8
    against 8 GB as int64). Signed past uint16 so the result indexes arrays without surprises."""
    if n <= 1 << 8:
        return np.uint8
    if n <= 1 << 16:
        return np.uint16
    if n <= 1 << 31:
        return np.int32
    return np.int64


def vector_to_array(table: Table, input_col: str,
                    output_col: str) -> Table:
    """Convert a vector column (dense matrix or dense/sparse Vector objects)
    into a column of plain Python float lists (ref: Functions.java:41
    vectorToArray)."""
    mat = table.vectors(input_col, np.float64)
    col = np.empty(mat.shape[0], dtype=object)
    for i in range(mat.shape[0]):
        col[i] = mat[i].tolist()
    return table.with_column(output_col, col)


def array_to_vector(table: Table, input_col: str,
                    output_col: str) -> Table:
    """Convert a column of numeric arrays/lists into a dense vector column
    (ref: Functions.java:71 arrayToVector). Uniform-length rows become one
    dense matrix; ragged rows become per-row DenseVectors, matching the
    reference's per-row UDF which allows differing sizes."""
    rows = [np.asarray(v, dtype=np.float64).reshape(-1)
            for v in table.column(input_col)]
    if rows and all(r.shape == rows[0].shape for r in rows):
        return table.with_column(output_col, np.stack(rows))
    from flink_ml_tpu_torch.linalg.vectors import Vectors

    col = np.empty(len(rows), dtype=object)
    for i, r in enumerate(rows):
        col[i] = Vectors.dense(*r)
    return table.with_column(output_col, col)
