"""Pipeline / PipelineModel.

The port of ``flink_ml_tpu/api/pipeline.py`` (ref: flink-ml-core/.../ml/
builder/Pipeline.java:45 (fit:79-107) and PipelineModel.java): an ordered
list of stages acting as a single Estimator. ``fit`` trains each Estimator
in sequence on the inputs transformed through all previous (fitted)
stages; the result is a PipelineModel of transformers. Tables pass between
stages as they are, so a tensor column one stage leaves on the card is the
next stage's input there. Saved as the JAX package saves it (``numStages``
and ``stages/<i>/``), so either package loads the other's pipelines;
``load`` places every nested stage on ``device``.
"""

from __future__ import annotations

from typing import List

from flink_ml_tpu_torch.api.stage import AlgoOperator, Estimator, Model, Stage
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.device import DeviceLike
from flink_ml_tpu_torch.utils import io as rw


def _save_stages(composite, stages: List[Stage], path: str) -> None:
    rw.save_metadata(composite, path, extra={"numStages": len(stages)})
    for i, stage in enumerate(stages):
        stage.save(rw.stage_path(path, i))


def _load_stages(cls, path: str, device: DeviceLike = None):
    """Returns a cls instance with nested stages and composite params restored."""
    meta = rw.load_metadata(path)
    stages = [rw.load_stage(rw.stage_path(path, i), device=device)
              for i in range(meta["extra"]["numStages"])]
    composite = cls(stages, device=device)
    composite.params_from_json(meta["paramMap"])
    return composite


class Pipeline(Estimator):
    """Ordered stages acting as one Estimator (ref: Pipeline.java:45)."""

    def __init__(self, stages: List[Stage] = None, **kwargs):
        super().__init__(**kwargs)
        self.stages = list(stages or [])

    def fit(self, *inputs: Table) -> "PipelineModel":
        # Ref fit:79-107: transform inputs through each fitted/plain stage up
        # to the last Estimator; collect the transform twin of every stage.
        last_estimator_idx = -1
        for i, stage in enumerate(self.stages):
            if isinstance(stage, Estimator):
                last_estimator_idx = i

        transform_stages: List[AlgoOperator] = []
        current = inputs
        for i, stage in enumerate(self.stages):
            if i <= last_estimator_idx:
                if isinstance(stage, Estimator):
                    op = stage.fit(*current)
                else:
                    op = stage
                if i < last_estimator_idx:
                    current = op.transform(*current)
            else:
                op = stage
            transform_stages.append(op)
        return PipelineModel(transform_stages, device=self._device)

    def save(self, path: str) -> None:
        _save_stages(self, self.stages, path)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "Pipeline":
        return _load_stages(cls, path, device)


class PipelineModel(Model):
    """Applies stages in order (ref: PipelineModel.java)."""

    def __init__(self, stages: List[AlgoOperator] = None, **kwargs):
        super().__init__(**kwargs)
        self.stages = list(stages or [])

    def transform(self, *inputs: Table):
        current = inputs
        for stage in self.stages:
            current = stage.transform(*current)
        return current

    def save(self, path: str) -> None:
        _save_stages(self, self.stages, path)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None) -> "PipelineModel":
        return _load_stages(cls, path, device)
