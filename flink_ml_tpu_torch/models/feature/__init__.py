"""Feature engineering ops (ref: flink-ml-lib feature/): the dense scalers,
vector ops and selectors. The discrete, text and miscellaneous ops and
OnlineStandardScaler come with later slices of the port."""

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
from flink_ml_tpu_torch.models.feature.selectors import (  # noqa: F401
    UnivariateFeatureSelector,
    UnivariateFeatureSelectorModel,
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
)
