"""The ported algorithms (this slice: KMeans)."""

from flink_ml_tpu_torch.models import clustering  # noqa: F401
