"""The Stage hierarchy (the port's ``flink_ml_tpu.api``)."""

from flink_ml_tpu_torch.api.stage import (  # noqa: F401
    AlgoOperator,
    Estimator,
    Model,
    Stage,
    Transformer,
)
