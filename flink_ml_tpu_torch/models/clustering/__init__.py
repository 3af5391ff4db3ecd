from flink_ml_tpu_torch.models.clustering.kmeans import (  # noqa: F401
    KMeans,
    KMeansModel,
)
