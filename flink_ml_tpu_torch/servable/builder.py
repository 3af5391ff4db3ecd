"""PipelineModelServable.

The port of ``flink_ml_tpu/servable/builder.py`` (ref parity: servable/
builder/PipelineModelServable.java) — chains servable twins of pipeline
stages; ``load(path)`` reads a directory written by ``PipelineModel.save``
(either package's) and resolves each stage to its servable class.
"""

from __future__ import annotations

from typing import List

from flink_ml_tpu_torch.servable.api import DataFrame, TransformerServable
from flink_ml_tpu_torch.utils import io as rw

#: training-model class name → servable class path (the reference resolves
#: via a loadServable() static on each model class)
_SERVABLE_TWINS = {
    "LogisticRegressionModel":
        "flink_ml_tpu_torch.servable.lr.LogisticRegressionModelServable",
    "OnlineLogisticRegressionModel":
        "flink_ml_tpu_torch.servable.lr.LogisticRegressionModelServable",
}


def load_servable(path: str) -> TransformerServable:
    """Load the servable twin of a stage saved at ``path``."""
    meta = rw.load_metadata(path)
    class_name = meta["className"].rsplit(".", 1)[-1]
    if class_name == "PipelineModel":
        return PipelineModelServable.load(path)
    twin = _SERVABLE_TWINS.get(class_name)
    if twin is None:
        raise ValueError(
            f"stage {meta['className']} has no servable; servables exist "
            f"for: {sorted(_SERVABLE_TWINS)} and PipelineModel")
    return rw.load_class(twin).load(path)


class PipelineModelServable(TransformerServable):
    def __init__(self, stages: List[TransformerServable]):
        self.stages = list(stages)

    def transform(self, df: DataFrame) -> DataFrame:
        for stage in self.stages:
            df = stage.transform(df)
        return df

    @classmethod
    def load(cls, path: str) -> "PipelineModelServable":
        meta = rw.load_metadata(path)
        num = meta["extra"]["numStages"]
        return cls([load_servable(rw.stage_path(path, i))
                    for i in range(num)])
