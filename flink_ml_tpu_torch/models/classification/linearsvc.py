"""Linear support vector classifier.

The port of ``flink_ml_tpu/models/classification/linearsvc.py`` (ref:
flink-ml-lib/.../classification/linearsvc/LinearSVC.java: SGD with
HingeLoss; the predict rule of LinearSVCModel.java: prediction = 1 iff
dot ≥ threshold, rawPrediction = dot).
"""

from __future__ import annotations

import torch

from flink_ml_tpu_torch.models.common import (
    LinearEstimatorBase,
    LinearModelBase,
    prediction_dtype,
)
from flink_ml_tpu_torch.ops.losses import HingeLoss
from flink_ml_tpu_torch.params.param import FloatParam, WithParams


class HasThreshold(WithParams):
    """Ref: LinearSVCModelParams.THRESHOLD (default 0.0)."""
    THRESHOLD = FloatParam(
        "threshold",
        "Threshold in binary classification applied to rawPrediction.", 0.0)


class LinearSVCModel(LinearModelBase, HasThreshold):
    def _predict_columns(self, dots: torch.Tensor) -> dict:
        return {
            self.prediction_col: (dots >= self.threshold).to(
                prediction_dtype()),
            self.raw_prediction_col: dots,
        }


class LinearSVC(LinearEstimatorBase, HasThreshold):
    loss = HingeLoss()
    model_class = LinearSVCModel
