from flink_ml_tpu_torch.models.regression.linearregression import (  # noqa: F401
    LinearRegression,
    LinearRegressionModel,
)
