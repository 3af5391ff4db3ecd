"""Param-driven random data generators.

The port of the generators of ``flink_ml_tpu/benchmark/datagen.py`` that the
KMeans, linear-model, KNN, FTRL, NaiveBayes, feature and text benchmarks use
(ref: flink-ml-benchmark/.../datagenerator/common/InputTableGenerator.java,
DenseVectorGenerator.java:34-53, LabeledPointWithWeightGenerator.java:50-75,
DoubleGenerator.java:37-66, RandomStringGenerator.java,
RandomStringArrayGenerator.java),
and the model-data generators of the KNN, FTRL and KMeans configs, which
stay on the host and draw the JAX package's numbers.

Below 8 MiB a table is generated on the host with numpy, exactly as the JAX
package generates it, so both packages see identical tables. From 8 MiB up
it is generated on the generator's device (by default the CUDA card) with a
``torch.Generator`` seeded from ``seed`` (one stream per column): float32,
uniform in [0, 1), never crossing the host link. Those numbers are torch's,
not ``jax.random``'s: the two packages draw different large tables from the
same seed. Under a default mesh of several shards a device table is split
over the local mesh's shards (``ops/columnar.py``), as the JAX package
generates it sharded over its default mesh: drawn as one tensor on the
shards' device, with the values it has without a mesh, and split into row
views of it. The string generators stay on the host at every size and draw
the JAX package's numbers: their columns are fixed-width ``<U`` numpy
arrays (an ``(n, arraySize)`` token matrix for the array generator), the
form the text transformers' vectorized paths consume.
"""

from __future__ import annotations

import numpy as np
import torch

from flink_ml_tpu_torch.common.functions import narrow_uint
from flink_ml_tpu_torch.common.table import Table, as_dense_vector_column
from flink_ml_tpu_torch.device import DeviceLike, resolve_device
from flink_ml_tpu_torch.parallel import collective as C
from flink_ml_tpu_torch.parallel.mesh import column_mesh
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
#: seed offset between the column streams of one generator: an odd 64-bit
#: constant, so the streams of seeds that differ by less than it never
#: share a generator seed
_STREAM_STRIDE = 0x9E3779B97F4A7C15


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


def _gen_device(device: DeviceLike) -> torch.device:
    """Where a device table is drawn: the column mesh's first local shard
    under a default mesh, else ``device`` (default: the card)."""
    mesh = column_mesh()
    if mesh is None:
        return resolve_device(device)
    return mesh.devices[mesh.local_shards[0]]


def _placed(columns: dict) -> dict:
    """Generated tensor columns split over the column mesh when it has
    several shards (row views, no copy); as they are otherwise."""
    mesh = column_mesh()
    if mesh is None or mesh.size == 1:
        return columns
    return {name: C.split_column(mesh, t) for name, t in columns.items()}


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

    def _torch_generator(self, device: torch.device,
                         stream: int = 0) -> torch.Generator:
        """The generator of one column; ``stream`` decorrelates the columns
        one seed draws (stream 0 is seeded with the seed itself)."""
        seed = self.get_seed_or_default() + stream * _STREAM_STRIDE
        return torch.Generator(device=device).manual_seed(seed % (1 << 64))

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
            device = _gen_device(self._device)
            values = torch.rand((n, d), generator=self._torch_generator(device),
                                dtype=torch.float32, device=device)
            return Table.from_columns(**_placed({name: values}))
        values = self._rng().random((n, d), dtype=np.float64)
        # raw (n, d) array IS a vector column — no per-row objects
        return Table.from_columns(**{name: values})


@_register
class LabeledPointWithWeightGenerator(InputTableGenerator, HasVectorDim):
    """Ref: LabeledPointWithWeightGenerator.java: featureArity/labelArity
    0 → continuous value in [0, 1); positive k → an integer in [0, k), as
    ``floor(u·k)``; the weight is uniform in [0, 1)."""

    FEATURE_ARITY = IntParam(
        "featureArity", "Arity of each feature (0 = continuous).", 2,
        ParamValidators.gt_eq(0))
    LABEL_ARITY = IntParam(
        "labelArity", "Arity of label (0 = continuous).", 2,
        ParamValidators.gt_eq(0))

    def get_data(self) -> Table:
        n, d = self.num_values, self.vector_dim
        f_name, l_name, w_name = self._col_names()
        if n * (d + 2) * 4 >= _DEVICE_DATAGEN_MIN_BYTES:
            device = _gen_device(self._device)

            def column(shape, arity, stream):
                u = torch.rand(shape, dtype=torch.float32, device=device,
                               generator=self._torch_generator(device, stream))
                return torch.floor_(u.mul_(arity)) if arity else u

            return Table.from_columns(**_placed({
                f_name: column((n, d), self.feature_arity, 0),
                l_name: column((n,), self.label_arity, 1),
                w_name: column((n,), 0, 2)}))
        # the JAX package's host order: features, then label, then weight
        rng = self._rng()

        def values(arity, shape):
            if arity == 0:
                return rng.random(shape, dtype=np.float64)
            return np.floor(rng.random(shape) * arity)

        features = values(self.feature_arity, (n, d))
        label = values(self.label_arity, (n,))
        weight = rng.random(n, dtype=np.float64)
        return Table.from_columns(**{
            f_name: features, l_name: label, w_name: weight})


@_register
class DoubleGenerator(InputTableGenerator):
    """arity 0 → uniform [0,1) doubles; arity > 0 → random integers in
    [0, arity) as doubles (ref: DoubleGenerator.java:37-66). From 8 MiB of
    columns up, each column is a float32 tensor drawn on the device from
    its own stream (the 100M-row Bucketizer config never crosses the host
    link); below, float64 numpy columns drawn as the JAX package draws
    them."""

    ARITY = IntParam("arity", "Arity of generated values.", 0,
                     ParamValidators.gt_eq(0))

    def get_data(self) -> Table:
        arity = self.arity
        names = self._col_names()
        n = self.num_values
        if n * len(names) * 4 >= _DEVICE_DATAGEN_MIN_BYTES:
            device = _gen_device(self._device)

            def column(stream):
                u = torch.rand((n,), dtype=torch.float32, device=device,
                               generator=self._torch_generator(device, stream))
                return torch.floor_(u.mul_(arity)) if arity else u

            return Table.from_columns(**_placed({
                name: column(stream) for stream, name in enumerate(names)}))
        rng = self._rng()
        if arity > 0:
            cols = {name: rng.integers(0, arity, n).astype(np.float64)
                    for name in names}
        else:
            cols = {name: rng.random(n, dtype=np.float64) for name in names}
        return Table.from_columns(**cols)


class HasArraySize(WithParams):
    ARRAY_SIZE = IntParam("arraySize", "Size of generated arrays.", 1,
                          ParamValidators.gt(0))


@_register
class DenseVectorArrayGenerator(InputTableGenerator, HasVectorDim,
                                HasArraySize):
    """Each row an array of arraySize uniform [0,1) dense vectors of
    vectorDim dims (ref: DenseVectorArrayGenerator.java): a host object
    column of lists of DenseVectors, drawn from numpy's stream row by row
    as the JAX package draws it."""

    def get_data(self) -> Table:
        rng = self._rng()
        (name,) = self._col_names()
        col = np.empty(self.num_values, dtype=object)
        for i in range(self.num_values):
            col[i] = list(as_dense_vector_column(
                rng.random((self.array_size, self.vector_dim))))
        return Table.from_columns(**{name: col})


class HasNumDistinctValues(WithParams):
    NUM_DISTINCT_VALUES = IntParam(
        "numDistinctValues", "Number of distinct values of the data.", 10,
        ParamValidators.gt(0))


def _codes_to_strings(ints: np.ndarray, k: int) -> np.ndarray:
    """Integer codes → fixed-width '<U' string array: one str() per
    distinct value, then one gather (a sparse draw from a huge domain only
    materializes the codes actually drawn)."""
    if ints.size == 0:
        return np.zeros(ints.shape, dtype="<U1")
    if k > ints.size:
        uniq = np.unique(ints)
        strs = np.array([str(v) for v in uniq])
        return _string_gather(strs, np.searchsorted(uniq, ints))
    tokens = np.array([str(v) for v in range(k)])
    return _string_gather(tokens, ints)


def _string_gather(tokens: np.ndarray, ints: np.ndarray) -> np.ndarray:
    """``tokens[ints]`` through an integer view of the fixed-width string
    buffer, as chunked ``np.take(mode='clip', out=...)`` into one buffer
    (element-wise '<U' fancy indexing and one-shot gathers were several
    times slower at 1e9 tokens in the JAX package's measurements). The
    codes are in range by construction; the assert makes a break of that
    fail loudly instead of clip clamping it."""
    it = tokens.dtype.itemsize  # '<U' itemsize is 4·width
    unit, step = (np.int64, it // 8) if it % 8 == 0 else (np.int32, it // 4)
    tv = np.ascontiguousarray(tokens.view(unit).reshape(len(tokens), step))
    flat = ints.reshape(-1)
    assert flat.size == 0 or (int(flat.max()) < len(tokens)
                              and int(flat.min()) >= 0), (
        f"token codes out of range: [{flat.min()}, {flat.max()}] vs "
        f"{len(tokens)} tokens")
    out = np.empty((flat.shape[0], step), unit)
    chunk = 8 << 20
    if step == 1:
        tv1, out1 = tv.reshape(-1), out.reshape(-1)
        for lo in range(0, flat.shape[0], chunk):
            np.take(tv1, flat[lo:lo + chunk], mode="clip",
                    out=out1[lo:lo + chunk])
    else:
        for lo in range(0, flat.shape[0], chunk):
            np.take(tv, flat[lo:lo + chunk], axis=0, mode="clip",
                    out=out[lo:lo + chunk])
    return out.view(tokens.dtype).reshape(ints.shape)


@_register
class RandomStringGenerator(InputTableGenerator, HasNumDistinctValues):
    """Strings drawn from numDistinctValues distinct tokens
    (ref: RandomStringGenerator.java); a host '<U' column."""

    def get_data(self) -> Table:
        rng = self._rng()
        k = self.num_distinct_values
        cols = {name: _codes_to_strings(
                    rng.integers(0, k, self.num_values, dtype=narrow_uint(k)),
                    k)
                for name in self._col_names()}
        return Table.from_columns(**cols)


@_register
class RandomStringArrayGenerator(InputTableGenerator, HasNumDistinctValues,
                                 HasArraySize):
    """Token arrays of arraySize tokens drawn from numDistinctValues
    distinct tokens (ref: RandomStringArrayGenerator.java), as one
    (numValues, arraySize) host '<U' token matrix: row i is document i."""

    def get_data(self) -> Table:
        rng = self._rng()
        k = self.num_distinct_values
        cols = {name: _codes_to_strings(
                    rng.integers(0, k, (self.num_values, self.array_size),
                                 dtype=narrow_uint(k)), k)
                for name in self._col_names()}
        return Table.from_columns(**cols)


class _ModelDataGenerator(HasSeed):
    """Base of the model-data generators: small host tables, so ``device``
    is accepted as every generator takes it, and not used."""

    def __init__(self, device: DeviceLike = None, **kwargs):
        super().__init__(**kwargs)

    def get_data(self) -> Table:
        raise NotImplementedError


@_register
class LogisticRegressionModelDataGenerator(_ModelDataGenerator, HasVectorDim):
    """Zero LR model data (coefficient vector + modelVersion 0): the
    initial model the online trainer requires
    (OnlineLogisticRegression.java:440 setInitialModelData)."""

    def get_data(self) -> Table:
        return Table.from_columns(
            coefficient=as_dense_vector_column(
                np.zeros((1, self.vector_dim))),
            modelVersion=np.asarray([0], np.int64))


@_register
class KnnModelDataGenerator(_ModelDataGenerator, HasVectorDim, HasArraySize):
    """Random KNN model data: arraySize cached train points of vectorDim
    dims with integer labels in [0, labelArity) (the KnnModel.set_model_data
    schema: packedFeatures + labels), drawn with numpy from the seed as the
    JAX package draws them."""

    LABEL_ARITY = IntParam("labelArity", "Number of distinct labels.", 2,
                           ParamValidators.gt(0))

    def get_data(self) -> Table:
        rng = np.random.default_rng(self.get_seed_or_default())
        n = self.array_size
        return Table.from_columns(
            packedFeatures=rng.random((n, self.vector_dim)),
            labels=np.floor(rng.random(n) * self.label_arity))


@_register
class KMeansModelDataGenerator(_ModelDataGenerator, HasVectorDim,
                               HasArraySize):
    """Random KMeans model data, arraySize centroids of vectorDim dims and
    unit weights (ref: datagenerator/clustering/
    KMeansModelDataGenerator.java), drawn with numpy from the seed as the
    JAX package draws them."""

    def get_data(self) -> Table:
        rng = np.random.default_rng(self.get_seed_or_default())
        k = self.array_size
        centroids = rng.random((k, self.vector_dim))
        return Table.from_columns(
            centroid=as_dense_vector_column(centroids),
            weight=np.ones(k))
