"""Logistic regression (binary).

The port of ``flink_ml_tpu/models/classification/logisticregression.py``
(ref: flink-ml-lib/.../classification/logisticregression/
LogisticRegression.java:48, fit:60: weighted samples → SGD with
BinaryLogisticLoss, model = coefficient vector; the predict rule of
LogisticRegressionModelServable.java:106: prediction = 1 iff dot ≥ 0,
rawPrediction = [1-p, p] with p = sigmoid(dot)).
"""

from __future__ import annotations

import torch

from flink_ml_tpu_torch.models.common import (
    LinearEstimatorBase,
    LinearModelBase,
    prediction_dtype,
)
from flink_ml_tpu_torch.ops.losses import BinaryLogisticLoss
from flink_ml_tpu_torch.params.shared import HasMultiClass


class LogisticRegressionModel(LinearModelBase, HasMultiClass):
    def _predict_columns(self, dots: torch.Tensor) -> dict:
        prob = 1.0 - 1.0 / (1.0 + torch.exp(dots))
        # rawPrediction is an (n, 2) vector column on the device: [1-p, p]
        return {
            self.prediction_col: (dots >= 0).to(prediction_dtype()),
            self.raw_prediction_col: torch.stack([1.0 - prob, prob], dim=1),
        }


class LogisticRegression(LinearEstimatorBase, HasMultiClass):
    loss = BinaryLogisticLoss()
    model_class = LogisticRegressionModel
