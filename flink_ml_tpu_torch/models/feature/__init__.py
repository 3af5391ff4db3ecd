"""Feature engineering ops (ref: flink-ml-lib feature/): the dense scalers,
vector ops and selectors, the text ops, the discrete encoders, the
miscellaneous ops and OnlineStandardScaler (``models/online.py``)."""

from flink_ml_tpu_torch.models.feature.scalers import (  # noqa: F401
    MaxAbsScaler,
    MaxAbsScalerModel,
    MinMaxScaler,
    MinMaxScalerModel,
    RobustScaler,
    RobustScalerModel,
    StandardScaler,
    StandardScalerModel,
)
from flink_ml_tpu_torch.models.feature.vectorops import (  # noqa: F401
    Binarizer,
    Bucketizer,
    DCT,
    ElementwiseProduct,
    Interaction,
    Normalizer,
    PolynomialExpansion,
    VectorAssembler,
    VectorSlicer,
)
from flink_ml_tpu_torch.models.feature.text import (  # noqa: F401
    CountVectorizer,
    CountVectorizerModel,
    FeatureHasher,
    HashingTF,
    IDF,
    IDFModel,
    NGram,
    RegexTokenizer,
    StopWordsRemover,
    Tokenizer,
)
from flink_ml_tpu_torch.models.feature.discrete import (  # noqa: F401
    IndexToString,
    IndexToStringModel,
    KBinsDiscretizer,
    KBinsDiscretizerModel,
    OneHotEncoder,
    OneHotEncoderModel,
    StringIndexer,
    StringIndexerModel,
    VectorIndexer,
    VectorIndexerModel,
)
from flink_ml_tpu_torch.models.feature.selectors import (  # noqa: F401
    UnivariateFeatureSelector,
    UnivariateFeatureSelectorModel,
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
)
from flink_ml_tpu_torch.models.feature.misc import (  # noqa: F401
    Imputer,
    ImputerModel,
    MinHashLSH,
    MinHashLSHModel,
    RandomSplitter,
    SQLTransformer,
)
from flink_ml_tpu_torch.models.online import (  # noqa: F401,E402
    OnlineStandardScaler,
    OnlineStandardScalerModel,
)
