from flink_ml_tpu_torch.models.classification.logisticregression import (  # noqa: F401
    LogisticRegression,
    LogisticRegressionModel,
)
from flink_ml_tpu_torch.models.classification.linearsvc import (  # noqa: F401
    LinearSVC,
    LinearSVCModel,
)
from flink_ml_tpu_torch.models.classification.knn import (  # noqa: F401
    Knn,
    KnnModel,
)
from flink_ml_tpu_torch.models.classification.naivebayes import (  # noqa: F401
    NaiveBayes,
    NaiveBayesModel,
)
from flink_ml_tpu_torch.models.online import (  # noqa: F401,E402
    OnlineLogisticRegression,
    OnlineLogisticRegressionModel,
)
