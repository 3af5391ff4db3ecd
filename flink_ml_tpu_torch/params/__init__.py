"""Typed hyperparameter system (the port's copy of ``flink_ml_tpu.params``)."""

from flink_ml_tpu_torch.params.param import (  # noqa: F401
    ArrayArrayParam,
    ArrayParam,
    BooleanParam,
    FloatArrayParam,
    FloatParam,
    IntArrayParam,
    IntParam,
    LongParam,
    Param,
    ParamValidator,
    ParamValidators,
    StringArrayParam,
    StringParam,
    WithParams,
)
