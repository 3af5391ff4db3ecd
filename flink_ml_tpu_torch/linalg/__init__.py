"""Vectors and distance measures (the port's ``flink_ml_tpu.linalg``)."""

from flink_ml_tpu_torch.linalg.distance import DistanceMeasure  # noqa: F401
from flink_ml_tpu_torch.linalg.vectors import (  # noqa: F401
    DenseVector,
    Vector,
    stack_vectors,
)
