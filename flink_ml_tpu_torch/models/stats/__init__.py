"""Statistical tests (the port's ``flink_ml_tpu.models.stats``)."""

from flink_ml_tpu_torch.models.stats.tests import (  # noqa: F401
    ANOVATest,
    ChiSqTest,
    FValueTest,
)
