"""Engine-free online inference (the "servable" path).

Ref parity: flink-ml-servable-core/.../servable/api/ (DataFrame.java:33,
Row.java, TransformerServable.java, ModelServable.java, DataTypes.java),
servable/builder/PipelineModelServable.java and flink-ml-servable-lib's
LogisticRegressionModelServable.java:62.

The port of ``flink_ml_tpu/servable``. The serving path has no dependency
on the training runtime: a servable loads model data from files/streams
and transforms in-memory DataFrames, on the host in float64 or, with
``set_device_predict(True)``, with one PyTorch product on the card.
"""

from flink_ml_tpu_torch.servable.api import (  # noqa: F401
    BasicType,
    DataFrame,
    DataTypes,
    ModelServable,
    RejectedRequest,
    Row,
    TransformerServable,
    serving_name,
)
from flink_ml_tpu_torch.servable.builder import (  # noqa: F401
    PipelineModelServable,
    load_servable,
)
from flink_ml_tpu_torch.servable.lr import (  # noqa: F401
    LogisticRegressionModelServable,
)
