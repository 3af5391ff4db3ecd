from flink_ml_tpu_torch.models.clustering.kmeans import (  # noqa: F401
    KMeans,
    KMeansModel,
)
from flink_ml_tpu_torch.models.clustering.agglomerative import (  # noqa: F401
    AgglomerativeClustering,
)
from flink_ml_tpu_torch.models.online import (  # noqa: F401,E402
    OnlineKMeans,
    OnlineKMeansModel,
)
