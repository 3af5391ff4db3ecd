"""Param-driven random data generators.

The port of the generators of ``flink_ml_tpu/benchmark/datagen.py`` that the
KMeans benchmark uses (ref: flink-ml-benchmark/.../datagenerator/common/
InputTableGenerator.java, DenseVectorGenerator.java:34-53).

Below 8 MiB a table is generated on the host with numpy, exactly as the JAX
package generates it, so both packages see identical tables. From 8 MiB up
it is generated on the generator's device (by default the CUDA card) with a
``torch.Generator`` seeded from ``seed``: float32, uniform in [0, 1), never
crossing the host link. Those numbers are torch's, not ``jax.random``'s: the
two packages draw different large tables from the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.device import DeviceLike, resolve_device
from flink_ml_tpu_torch.params.param import (
    ArrayArrayParam,
    IntParam,
    ParamValidators,
    WithParams,
)
from flink_ml_tpu_torch.params.shared import HasSeed

_GENERATORS = {}

# Below this table size host generation and one copy win; past it the copy
# dominates and generating on the device removes it (the JAX package's
# threshold, so both packages switch at the same size).
_DEVICE_DATAGEN_MIN_BYTES = 8 << 20


def _register(cls):
    _GENERATORS[cls.__name__] = cls
    return cls


def resolve_generator(class_name: str):
    """Accepts our class name or the reference's fully-qualified Java name."""
    short = class_name.rsplit(".", 1)[-1]
    try:
        return _GENERATORS[short]
    except KeyError:
        raise ValueError(f"unknown data generator {class_name!r}; "
                         f"known: {sorted(_GENERATORS)}")


class InputTableGenerator(HasSeed):
    """Base: numValues rows, named columns (ref: InputTableGenerator.java)."""

    COL_NAMES = ArrayArrayParam(
        "colNames", "Column names of the generated tables.", None)
    NUM_VALUES = IntParam(
        "numValues", "Number of data rows to generate.", 10,
        ParamValidators.gt(0))

    def __init__(self, device: DeviceLike = None, **kwargs):
        super().__init__(**kwargs)
        self._device = device

    def _rng(self):
        return np.random.default_rng(self.get_seed_or_default())

    def _torch_generator(self, device: torch.device) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(
            self.get_seed_or_default())

    def _col_names(self, table_idx=0):
        names = self.col_names
        if names is None:
            raise ValueError(f"{type(self).__name__} needs colNames")
        return list(names[table_idx])

    def get_data(self) -> Table:
        raise NotImplementedError


class HasVectorDim(WithParams):
    VECTOR_DIM = IntParam("vectorDim", "Dimension of generated vectors.", 1,
                          ParamValidators.gt(0))


@_register
class DenseVectorGenerator(InputTableGenerator, HasVectorDim):
    """Uniform [0,1) dense vectors (ref: DenseVectorGenerator.java:34-53)."""

    def get_data(self) -> Table:
        (name,) = self._col_names()
        n, d = self.num_values, self.vector_dim
        if n * d * 4 >= _DEVICE_DATAGEN_MIN_BYTES:
            device = resolve_device(self._device)
            values = torch.rand((n, d), generator=self._torch_generator(device),
                                dtype=torch.float32, device=device)
            return Table.from_columns(**{name: values})
        values = self._rng().random((n, d), dtype=np.float64)
        # raw (n, d) array IS a vector column — no per-row objects
        return Table.from_columns(**{name: values})
