"""Stage / AlgoOperator / Transformer / Model / Estimator.

The port of ``flink_ml_tpu/api/stage.py`` (ref: flink-ml-core/.../ml/api/):

    Stage (savable, has params, runs on one device)
      └─ AlgoOperator.transform(*tables) -> (table, ...)
           └─ Transformer (one-in-one-out semantics)
                └─ Model (.set_model_data / .get_model_data)
      └─ Estimator.fit(*tables) -> Model

Every stage takes ``device=`` (see ``flink_ml_tpu_torch.device``): ``None``
runs on the CUDA card. An estimator also takes ``mesh=``, the data shards
its fit splits the rows over (``parallel/mesh.py``; a runtime setting like
the device, not a param, not saved); ``None`` is the default mesh, one shard
on the stage's device unless
:func:`~flink_ml_tpu_torch.parallel.set_default_mesh` or
``init_distributed`` set another. The tracing and profiling wrapper the JAX
package puts around fit and transform comes with the observability slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.device import DeviceLike, resolve_device
from flink_ml_tpu_torch.params.param import WithParams
from flink_ml_tpu_torch.utils import io as rw


class Stage(WithParams):
    """A node with params that can be saved/loaded (ref: api/Stage.java)."""

    def __init__(self, device: DeviceLike = None, **kwargs):
        super().__init__(**kwargs)
        self._device = device

    @property
    def device(self) -> torch.device:
        """The device this stage computes on, resolved at each call."""
        return resolve_device(self._device)

    def save(self, path: str) -> None:
        rw.save_metadata(self, path)
        self._save_extra(path)

    @classmethod
    def load(cls, path: str, device: DeviceLike = None):
        stage, meta = rw.load_stage_params(path, device=device)
        if not isinstance(stage, cls):
            raise TypeError(f"saved stage {type(stage).__name__} is not a {cls.__name__}")
        stage._load_extra(path, meta)
        return stage

    # hooks for subclasses with model data / nested stages
    def _save_extra(self, path: str) -> None:
        pass

    def _load_extra(self, path: str, meta: dict) -> None:
        pass


class AlgoOperator(Stage):
    """A Stage computing output tables from input tables (ref: AlgoOperator.java)."""

    def transform(self, *inputs: Table) -> Tuple[Table, ...]:
        raise NotImplementedError


class Transformer(AlgoOperator):
    """Marker for record-wise transforms (ref: Transformer.java)."""


class Model(Transformer):
    """A Transformer with model data (ref: Model.java)."""

    def set_model_data(self, *model_data: Table):
        raise NotImplementedError(f"{type(self).__name__} has no model data")

    def get_model_data(self) -> Tuple[Table, ...]:
        raise NotImplementedError(f"{type(self).__name__} has no model data")


class Estimator(Stage):
    """fit(*tables) -> Model (ref: Estimator.java)."""

    def __init__(self, mesh=None, **kwargs):
        super().__init__(**kwargs)
        self._mesh = mesh

    @property
    def mesh(self):
        """The mesh this estimator fits on, resolved at each call
        (``parallel.mesh.resolve_mesh``)."""
        from flink_ml_tpu_torch.parallel.mesh import resolve_mesh

        return resolve_mesh(self._mesh, self._device)

    def fit(self, *inputs: Table) -> Model:
        raise NotImplementedError
