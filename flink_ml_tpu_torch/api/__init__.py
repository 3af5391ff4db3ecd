"""The Stage hierarchy and its composition (the port's ``flink_ml_tpu.api``):
Stage, AlgoOperator, Transformer, Model, Estimator, Pipeline and
PipelineModel, and the GraphBuilder's Graph and GraphModel."""

from flink_ml_tpu_torch.api.stage import (  # noqa: F401
    AlgoOperator,
    Estimator,
    Model,
    Stage,
    Transformer,
)
from flink_ml_tpu_torch.api.pipeline import Pipeline, PipelineModel  # noqa: F401
from flink_ml_tpu_torch.api.graph import (  # noqa: F401
    Graph,
    GraphBuilder,
    GraphModel,
    TableId,
)
