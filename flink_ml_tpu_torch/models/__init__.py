"""The ported algorithms (so far: KMeans; LogisticRegression, LinearSVC and
LinearRegression; Knn; NaiveBayes; OnlineLogisticRegression; the dense
feature scalers, vector ops and selectors; the statistical tests and the
binary classification evaluator)."""

from flink_ml_tpu_torch.models import clustering  # noqa: F401
from flink_ml_tpu_torch.models import classification  # noqa: F401
from flink_ml_tpu_torch.models import evaluation  # noqa: F401
from flink_ml_tpu_torch.models import feature  # noqa: F401
from flink_ml_tpu_torch.models import online  # noqa: F401
from flink_ml_tpu_torch.models import regression  # noqa: F401
from flink_ml_tpu_torch.models import stats  # noqa: F401
