"""Evaluators (the port's ``flink_ml_tpu.models.evaluation``)."""

from flink_ml_tpu_torch.models.evaluation.binaryclassification import (  # noqa: F401
    BinaryClassificationEvaluator,
)
