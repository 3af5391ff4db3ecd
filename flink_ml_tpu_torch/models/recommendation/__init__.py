from flink_ml_tpu_torch.models.recommendation.swing import Swing  # noqa: F401
