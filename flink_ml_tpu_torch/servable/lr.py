"""Logistic regression servable.

The port of ``flink_ml_tpu/servable/lr.py`` (ref: flink-ml-servable-lib/
.../classification/logisticregression/LogisticRegressionModelServable.java
:62 — transform adds prediction + rawPrediction columns (:106: prediction =
1 iff dot ≥ 0, raw = [1-p, p]); model data loads from a byte stream
(LogisticRegressionModelData encode/decode, byte for byte the JAX
package's) or from a saved model directory).

Host predict is float64 numpy, as in the reference servable.
``set_device_predict(True)`` predicts on a device instead — the card unless
the caller names another (``device="cpu"`` in tests): the coefficient is
placed there once per model version in float32, and ``dots = x @ coef`` is
one PyTorch matrix-vector product whose result comes back as float64, the
JAX package's ``jnp`` product (its ``lr.py:262-271``). That product is not
a Pallas kernel in the JAX package, so it stays a PyTorch call here. The
device path never falls back to host predict: without a card,
``set_device_predict(True)`` raises.

Mesh-sharded dispatch (JAX ``lr.py:149-220``): with :meth:`set_mesh` of an
in-process mesh of N > 1 shards, a batch whose row count N divides (the
micro-batcher's padded buckets) is split by rows over the shards
(``parallel/mapreduce.map_rows``): one product a shard against the
coefficient placed once per (version, mesh) on the shards' devices, the
dots concatenated in row order. Each such dispatch records the real rows a
shard holds (``meshstats.record_shard_rows``, ``bucket / N`` rows a shard,
the real rows filling from shard 0) and the serving view of the same split
(``health.observe_serving_shards``; its ``device`` label is the shard
ordinal, the JAX device id of a one-process JAX mesh, since virtual shards
share one device). Other row counts keep the one-device product.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flink_ml_tpu_torch.device import DeviceLike, resolve_device
from flink_ml_tpu_torch.linalg.vectors import DenseVector, Vector
from flink_ml_tpu_torch.observability import health, meshstats
from flink_ml_tpu_torch.parallel import mapreduce
from flink_ml_tpu_torch.params.shared import (
    HasFeaturesCol,
    HasPredictionCol,
    HasRawPredictionCol,
)
from flink_ml_tpu_torch.servable.api import (
    DataFrame,
    DataTypes,
    ModelServable,
    serving_name,
)
from flink_ml_tpu_torch.utils import io as rw


class LogisticRegressionModelData:
    """Ref: LogisticRegressionModelData with encode/decode."""

    def __init__(self, coefficient: np.ndarray, model_version: int = 0):
        self.coefficient = np.asarray(coefficient, np.float64)
        self.model_version = int(model_version)

    def encode(self) -> bytes:
        vec = DenseVector(self.coefficient).to_bytes()
        return self.model_version.to_bytes(8, "little") + vec

    @staticmethod
    def decode(data: bytes) -> "LogisticRegressionModelData":
        version = int.from_bytes(data[:8], "little")
        vec = Vector.from_bytes(data[8:])
        return LogisticRegressionModelData(vec.to_array(), version)


class LogisticRegressionModelServable(ModelServable, HasFeaturesCol,
                                      HasPredictionCol, HasRawPredictionCol):
    #: route the dot products through one device product instead of host
    #: numpy — the serving runtime flips this so request batches ride one
    #: device dispatch per tick (serving/batcher.py)
    device_predict = False
    #: the device of the device predict (None with host predict); the
    #: micro-batcher names it as its dispatching thread's current CUDA
    #: device
    device: Optional[torch.device] = None

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.model_data: LogisticRegressionModelData = None
        self._coef_dev = None
        self._coef_of = None
        self._mesh = None
        self._n_shards = 1
        self._coef_mesh = None
        self._coef_mesh_of = None

    def set_model_data(self, *streams) -> "LogisticRegressionModelServable":
        (stream,) = streams
        data = stream.read() if hasattr(stream, "read") else bytes(stream)
        self.model_data = LogisticRegressionModelData.decode(data)
        return self

    def set_device_predict(self, enabled: bool = True,
                           device: DeviceLike = None
                           ) -> "LogisticRegressionModelServable":
        """Predict on ``device`` (default: the card; raises without one)
        when ``enabled``, on the host in float64 otherwise. A bare
        ``"cuda"`` resolves to the caller's current card here, so the
        device named later on other threads is this one."""
        self.device_predict = bool(enabled)
        self.device = None
        self._coef_dev = None
        if self.device_predict:
            dev = resolve_device(device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            self.device = dev
        return self

    def set_mesh(self, mesh) -> "LogisticRegressionModelServable":
        """Mesh-sharded dispatch: batches whose row count divides the
        mesh's N > 1 shards predict row-sharded (:meth:`_sharded_dots`),
        other shapes (bucket 1 on 8 shards) keep the one-device product.
        ``None`` or a one-shard mesh reverts to the one-device product.
        Idempotent on the same mesh object, so the micro-batcher re-asserts
        it every tick without moving the coefficient. The shards are this
        process's: a ``torch.distributed`` mesh is refused, as the JAX
        package's prediction tier places batches on ``local_mesh()`` only:
        each process scores its own traffic, and a prediction sharded over
        other processes could never be fetched by its local caller."""
        if mesh is self._mesh:
            return self
        if mesh is not None and mesh.distributed:
            raise ValueError(
                "a torch.distributed mesh is refused: serving shards a "
                "batch over this process's shards only "
                "(parallel.local_mesh(), as the JAX package's prediction "
                "tier), since each process scores its own traffic and a "
                "prediction sharded over other processes could never be "
                "fetched by its local caller")
        self._mesh = mesh
        self._coef_mesh = None
        self._n_shards = 1 if mesh is None else mesh.size
        return self

    def _use_sharded(self, rows: int) -> bool:
        return (self._mesh is not None and self._n_shards > 1
                and rows % self._n_shards == 0)

    def _device_coef(self) -> torch.Tensor:
        # one host-to-device copy per model version, not one per request;
        # keyed by the model data object, which a new version replaces
        data = self.model_data
        if self._coef_dev is None or self._coef_of is not data:
            self._coef_dev = torch.as_tensor(
                data.coefficient, dtype=torch.float32, device=self.device)
            self._coef_of = data
        return self._coef_dev

    def _device_dots(self, x: np.ndarray) -> np.ndarray:
        """``x @ coef`` on the device: the float32 batch goes over in one
        copy, the product is one PyTorch call, and the (n,) float32 dots
        come back to be widened to float64 on the host."""
        xd = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            self.device)
        return (xd @ self._device_coef()).cpu().numpy().astype(np.float64)

    def _mesh_coef(self) -> dict:
        # the sharded products' coefficient: one float32 copy on each of
        # the shards' devices, once per (model version, mesh)
        data = self.model_data
        if self._coef_mesh is None or self._coef_mesh_of is not data:
            self._coef_mesh = {
                str(dev): torch.as_tensor(data.coefficient,
                                          dtype=torch.float32, device=dev)
                for dev in self._mesh.devices}
            self._coef_mesh_of = data
        return self._coef_mesh

    def _sharded_dots(self, x: np.ndarray, real_rows: int,
                      record: bool = True) -> np.ndarray:
        """One row-sharded dispatch: the float32 batch split by rows over
        the mesh (``mapreduce.map_rows``), one product a shard, the dots
        concatenated in row order and fetched once, widened to float64.
        With ``record`` the shards' real rows are recorded (a synthetic
        warm batch records nothing)."""
        coefs = self._mesh_coef()
        dots = mapreduce.map_rows(
            lambda rows: rows @ coefs[str(rows.device)], self._mesh)(
                np.ascontiguousarray(x, np.float32))
        out = dots.cpu().numpy().astype(np.float64)
        if record:
            mesh = self._mesh
            counts = meshstats.record_shard_rows(
                mesh, int(real_rows), local_n=x.shape[0] // self._n_shards,
                skew=False)
            health.observe_serving_shards(serving_name(self), counts,
                                          list(range(mesh.size)))
        return out

    def aot_warm(self, rows: int) -> None:
        """Run the device product once for a ``(rows, dim)`` batch now
        (serving/warmup.py calls this once per bucket shape at server
        start, on the thread that will dispatch that bucket): the
        coefficient's placement, the first launch and the per-thread
        library handles are paid before the first real request, on the
        path this shape takes (row-sharded when the mesh's shards divide
        it). No-op without model data or with host predict."""
        if not self.device_predict or self.model_data is None:
            return
        dim = self.model_data.coefficient.shape[0]
        zeros = np.zeros((int(rows), dim), np.float32)
        if self._use_sharded(int(rows)):
            # the sharded shape warms the path it will take; record=False:
            # a warm batch must not write the per-shard row series
            self._sharded_dots(zeros, int(rows), record=False)
        else:
            self._device_dots(zeros)

    def transform(self, df: DataFrame) -> DataFrame:
        if self.model_data is None:
            raise ValueError("servable has no model data")
        features = df.get(self.features_col).values
        x = np.stack([f.to_array() if isinstance(f, Vector)
                      else np.asarray(f, np.float64) for f in features])
        if self.device_predict:
            if self._use_sharded(x.shape[0]):
                real = getattr(df, "drift_real_rows", None)
                dots = self._sharded_dots(
                    x, int(real) if real is not None else x.shape[0])
            else:
                dots = self._device_dots(x)
        else:
            dots = x @ self.model_data.coefficient
        prob = 1.0 - 1.0 / (1.0 + np.exp(dots))
        # probability-distribution drift baseline (observability/
        # health.py): the 0/1 prediction column the _served wrapper
        # summarizes hides a NaN margin ((nan >= 0) is False), so the
        # probabilities are summarized here explicitly — a model serving
        # garbage raises the ml.health non-finite-probability event
        health.summarize_values(type(self).__name__, "probability", prob)
        predictions = (dots >= 0).astype(np.float64)
        raw = [DenseVector([1 - p, p]) for p in prob]
        df.add_column(self.prediction_col, DataTypes.DOUBLE,
                      predictions.tolist())
        df.add_column(self.raw_prediction_col, DataTypes.vector(), raw)
        return df

    @classmethod
    def load(cls, path: str) -> "LogisticRegressionModelServable":
        meta = rw.load_metadata(path)
        servable = cls()
        servable.params_from_json(meta["paramMap"])
        arrays = rw.load_model_arrays(path, "model")
        version = int(arrays.get("modelVersion", [0])[0]) \
            if "modelVersion" in arrays else 0
        servable.model_data = LogisticRegressionModelData(
            arrays["coefficient"], version)
        return servable
