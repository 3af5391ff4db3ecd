"""Linear regression.

The port of ``flink_ml_tpu/models/regression/linearregression.py`` (ref:
flink-ml-lib/.../regression/linearregression/LinearRegression.java: SGD
with LeastSquareLoss; prediction = dot).
"""

from __future__ import annotations

import torch

from flink_ml_tpu_torch.models.common import LinearEstimatorBase, LinearModelBase
from flink_ml_tpu_torch.ops.losses import LeastSquareLoss


class LinearRegressionModel(LinearModelBase):
    def _predict_columns(self, dots: torch.Tensor) -> dict:
        return {self.prediction_col: dots}


class LinearRegression(LinearEstimatorBase):
    loss = LeastSquareLoss()
    model_class = LinearRegressionModel
