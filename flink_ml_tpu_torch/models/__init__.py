"""The ported algorithms (so far: KMeans; LogisticRegression, LinearSVC and
LinearRegression; Knn; OnlineLogisticRegression)."""

from flink_ml_tpu_torch.models import clustering  # noqa: F401
from flink_ml_tpu_torch.models import classification  # noqa: F401
from flink_ml_tpu_torch.models import online  # noqa: F401
from flink_ml_tpu_torch.models import regression  # noqa: F401
