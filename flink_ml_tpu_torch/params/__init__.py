"""Typed hyperparameter system (the port's copy of ``flink_ml_tpu.params``)."""

from flink_ml_tpu_torch.params.param import (  # noqa: F401
    ArrayArrayParam,
    ArrayParam,
    BooleanParam,
    FloatArrayArrayParam,
    FloatArrayParam,
    FloatParam,
    IntArrayParam,
    IntParam,
    LongArrayParam,
    LongParam,
    Param,
    ParamValidator,
    ParamValidators,
    StringArrayArrayParam,
    StringArrayParam,
    StringParam,
    VectorParam,
    WindowsParam,
    WithParams,
)
from flink_ml_tpu_torch.params.shared import *  # noqa: F401,F403
