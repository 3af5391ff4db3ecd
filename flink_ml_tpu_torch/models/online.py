"""Online logistic regression (FTRL-proximal).

The port of the FTRL half of ``flink_ml_tpu/models/online.py`` (ref:
OnlineLogisticRegression.java:75). Per global batch: the per-coordinate
gradient g_i = Σ (σ(x·w) − y)·x_i, normalized by the batch's row count
(dense batches, CalculateLocalGradient:364-388's dense branch, which ignores
the weight column) or by the weight sum at the coordinate's stored values
(sparse batches); then σ = (√(n + g²) − √n)/α, z += g − σ·w, n += g²,
w_i = 0 if |z_i| ≤ l1 else (sign(z_i)·l1 − z_i)/((β + √n_i)/α + l2), with
l1 = elasticNet·reg and l2 = (1 − elasticNet)·reg (UpdateModel:295-319);
the model version goes up by one per batch (CreateLrModelData:235-258).

A batch runs on one of three engines, each named in ``executionPath``:

- ``torch-dense``: a dense batch, on the estimator's device in plain
  PyTorch (two matrix-vector products and the elementwise rule).
- ``cuda-csr``: a sparse batch with at least :data:`FTRL_SPARSE_MIN_NNZ`
  stored values, on the card: its three segment sums (the per-row dots, then
  the per-coordinate gradient and weight sums as two value columns) run the
  hand-written ``segment_reduce_sum`` kernel (``ops/kernels.py``), for any
  row count and feature width. ``torch-csr`` is the same engine on the CPU,
  where the kernel's wrapper runs its plain version.
- ``host-csr``: a smaller sparse batch, in float64 numpy on the host.

The state (w, z, n) stays on the device across device batches; it comes to
the host (float64) only for a host batch, a listener and the end of the
fit. Each batch's coefficients join the model's history; device snapshots
are fetched in stacked copies of up to ``_HISTORY_DEV_CAP``.

An ``IterationConfig`` with a checkpoint manager snapshots the host view
every ``checkpoint_interval`` batches, and a fit restores the newest valid
snapshot before it reads the stream (``iteration/streaming.py``). A retry
policy is stored and, as in the JAX package, not applied to the stream.

One device and no mesh: the sharded update, the health series and the drift
and quality baselines come with later slices of the port.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from flink_ml_tpu_torch.api.stage import Estimator, Model
from flink_ml_tpu_torch.common.table import Table, as_dense_vector_column
from flink_ml_tpu_torch.iteration.streaming import (
    StreamCheckpointer,
    StreamTable,
    generate_batches,
)
from flink_ml_tpu_torch.linalg import sparse
from flink_ml_tpu_torch.models.common import (
    IterationRuntimeMixin,
    predict_dots,
    prediction_dtype,
    scalar_column,
)
from flink_ml_tpu_torch.observability.health import guard_final_state
from flink_ml_tpu_torch.ops import kernels
from flink_ml_tpu_torch.params.param import FloatParam, ParamValidators
from flink_ml_tpu_torch.params.shared import (
    HasBatchStrategy,
    HasElasticNet,
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasMaxAllowedModelDelayMs,
    HasModelVersionCol,
    HasPredictionCol,
    HasRawPredictionCol,
    HasReg,
    HasWeightCol,
)
from flink_ml_tpu_torch.utils import io as rw

#: per-batch coefficient snapshots kept on the device before they are
#: fetched in one stacked copy
_HISTORY_DEV_CAP = 128

#: sparse batches with at least this many stored values update on the
#: device; smaller ones on the host in float64. The JAX package's value,
#: not measured on the card (PERF.md). A module constant, so tests may
#: patch it.
FTRL_SPARSE_MIN_NNZ = 4096

#: the engines of a fit, in the order ``executionPath`` lists them
ENGINES = ("torch-dense", "cuda-csr", "torch-csr", "host-csr")


def _as_stream(data: Union[Table, StreamTable], batch_size: int):
    if isinstance(data, Table):
        data = StreamTable.from_table(data, batch_size)
    return generate_batches(data, batch_size)


def _ftrl_apply(xp, g, coeffs, z, n, alpha, beta, l1, l2):
    """The FTRL-proximal elementwise update (UpdateModel:295-319), shared by
    the three engines: ``xp`` is ``torch`` or ``numpy``."""
    sigma = (xp.sqrt(n + g * g) - xp.sqrt(n)) / alpha
    z = z + g - sigma * coeffs
    n = n + g * g
    coeffs = xp.where(
        xp.abs(z) <= l1, 0.0,
        (xp.sign(z) * l1 - z) / ((beta + xp.sqrt(n)) / alpha + l2))
    return coeffs, z, n


def _dense_step(x, y, coeffs, z, n, alpha, beta, l1, l2):
    """One dense batch (x (rows, d), y (rows,) float32 on the state's
    device): the gradient sum over the batch divided by its row count."""
    dots = x @ coeffs
    p = 1.0 / (1.0 + torch.exp(-dots))
    g = ((p - y) @ x) / max(float(x.shape[0]), 1.0)
    return _ftrl_apply(torch, g, coeffs, z, n, alpha, beta, l1, l2)


def _sparse_step(packed, coeffs, z, n, alpha, beta, l1, l2):
    """One sparse batch on the device: the twin of the host engine
    (gradient and weight sums accumulate only at a row's stored values).
    ``packed`` is one shard of :func:`_pack_csr_shards` as tensors; padded
    slots carry validity 0 and padded rows own no slot."""
    vals, col, row, valid, yb, wb = packed
    rows_s, d = yb.shape[0], coeffs.shape[0]
    rl = row.long()
    dots = kernels.segment_reduce_sum(vals * coeffs[col.long()] * valid, row,
                                      rows_s)
    p = 1.0 / (1.0 + torch.exp(-dots))
    # gradient and weight sums share one pass: two value columns
    gw = kernels.segment_reduce_sum(torch.stack([vals * (p - yb)[rl] * valid,
                                                 wb[rl] * valid], dim=1),
                                    col, d)
    grad, wsum = gw[:, 0], gw[:, 1]
    g = torch.where(wsum != 0, grad / torch.where(wsum != 0, wsum, 1.0), 0.0)
    return _ftrl_apply(torch, g, coeffs, z, n, alpha, beta, l1, l2)


def _pack_csr_shards(x, y, w, n_shards: int):
    """Split a scipy CSR batch into ``n_shards`` row ranges and pack each
    as padded (values, col, local row, valid) rows of one (S, nnz_s) quad
    plus (S, rows_s) y/w blocks, nnz_s and rows_s rounded up to powers of
    two: the host marshalling of the sparse device engine (one shard on one
    device)."""
    n_rows = x.shape[0]
    base, rem = divmod(n_rows, n_shards)
    bounds, lo = [], 0
    for i in range(n_shards):
        hi = lo + base + (1 if i < rem else 0)
        bounds.append((lo, hi))
        lo = hi
    max_nnz = max((x.indptr[hi] - x.indptr[lo] for lo, hi in bounds),
                  default=0)
    max_rows = max((hi - lo for lo, hi in bounds), default=0)
    nnz_s = 1 << max(3, int(max_nnz - 1).bit_length())
    rows_s = 1 << max(3, int(max_rows - 1).bit_length())
    vals = np.zeros((n_shards, nnz_s), np.float32)
    col = np.zeros((n_shards, nnz_s), np.int32)
    row = np.zeros((n_shards, nnz_s), np.int32)
    valid = np.zeros((n_shards, nnz_s), np.float32)
    yb = np.zeros((n_shards, rows_s), np.float32)
    wb = np.zeros((n_shards, rows_s), np.float32)
    for s, (lo, hi) in enumerate(bounds):
        a, b = x.indptr[lo], x.indptr[hi]
        nz = b - a
        vals[s, :nz] = x.data[a:b]
        col[s, :nz] = x.indices[a:b]
        row[s, :nz] = np.repeat(np.arange(hi - lo, dtype=np.int32),
                                np.diff(x.indptr[lo:hi + 1]))
        valid[s, :nz] = 1.0
        yb[s, : hi - lo] = y[lo:hi]
        wb[s, : hi - lo] = w[lo:hi]
    return vals, col, row, valid, yb, wb


def _host_step(x, y, w, coeffs, z, n, alpha, beta, l1, l2):
    """One sparse batch on the host, float64 (ref
    CalculateLocalGradient:364-388): gradient and weight sums accumulate
    only at a row's stored values; never densified."""
    p = 1.0 / (1.0 + np.exp(-(x @ coeffs)))
    row_nnz = np.diff(x.indptr)
    n_cols = x.shape[1]
    grad = np.bincount(x.indices, weights=x.data * np.repeat(p - y, row_nnz),
                       minlength=n_cols)
    weight_sum = np.bincount(x.indices, weights=np.repeat(w, row_nnz),
                             minlength=n_cols)
    g = np.where(weight_sum != 0,
                 grad / np.where(weight_sum != 0, weight_sum, 1), 0)
    return _ftrl_apply(np, g, coeffs, z, n, alpha, beta, l1, l2)


class OnlineLogisticRegressionModelParams(HasFeaturesCol, HasPredictionCol,
                                          HasRawPredictionCol,
                                          HasModelVersionCol,
                                          HasMaxAllowedModelDelayMs):
    pass


class OnlineLogisticRegressionParams(OnlineLogisticRegressionModelParams,
                                     HasLabelCol, HasWeightCol,
                                     HasBatchStrategy, HasGlobalBatchSize,
                                     HasReg, HasElasticNet):
    ALPHA = FloatParam("alpha", "The alpha parameter of ftrl.", 0.1,
                       ParamValidators.gt(0.0))
    BETA = FloatParam("beta", "The beta parameter of ftrl.", 0.1,
                      ParamValidators.gt(0.0))


class OnlineLogisticRegressionModel(Model,
                                    OnlineLogisticRegressionModelParams):
    def __init__(self, coefficients: Optional[np.ndarray] = None,
                 model_version: int = 0, **kwargs):
        super().__init__(**kwargs)
        self.coefficients = (None if coefficients is None
                             else np.asarray(coefficients, np.float64))
        self.model_version = int(model_version)
        #: all versioned snapshots recorded during fit: [(version, coeffs)]
        self.history: List[Tuple[int, np.ndarray]] = []

    def transform(self, table: Table) -> Tuple[Table]:
        """Dense features score on this model's device (tensor columns,
        float32); CSR features on the host (numpy columns, float64), as the
        JAX package scores them (OnlineLogisticRegressionModel.java:67-95)."""
        if self.coefficients is None:
            raise ValueError(
                "OnlineLogisticRegressionModel has no model data")
        x = sparse.features_matrix(table, self.features_col)
        dots = predict_dots(x, self.coefficients, self.device)
        xp = np if isinstance(dots, np.ndarray) else torch
        prob = 1.0 / (1.0 + xp.exp(-dots))
        pred = (dots >= 0)
        pred = (pred.astype(np.float64) if xp is np
                else pred.to(prediction_dtype()))
        return (table.with_columns(**{
            self.prediction_col: pred,
            self.raw_prediction_col: xp.stack([1 - prob, prob], 1),
            self.model_version_col: np.full(table.num_rows,
                                            self.model_version, np.int64)}),)

    def transform_stream(self, stream: StreamTable, model_stream=None,
                         timestamp_col: Optional[str] = None):
        """Unbounded predict: each chunk is scored with the latest model
        version available at that point (the reference's model-broadcast
        join); returns a generator of output Tables.

        With ``model_stream`` (an iterable of ``(timestamp_ms, version,
        coefficients)``) and ``timestamp_col`` (the data's event time), the
        bounded model-delay join of the reference applies
        (HasMaxAllowedModelDelayMs, OnlineLogisticRegressionModel.java:67-95):
        a chunk whose newest event time is ``t`` waits until a model with
        timestamp ``>= t - maxAllowedModelDelayMs`` has arrived, and is
        scored with the latest model received. When the model stream ends,
        the remaining chunks are scored with the last model.
        """
        # checked here, at the call, not at the generator's first step
        if (model_stream is None) != (timestamp_col is None):
            raise ValueError(
                "model_stream and timestamp_col must be given together for "
                "the event-time model-delay join")
        return self._transform_stream_impl(stream, model_stream,
                                           timestamp_col)

    def _transform_stream_impl(self, stream, model_stream, timestamp_col):
        if model_stream is None:
            versions = iter(self.history or [(self.model_version,
                                              self.coefficients)])
            for chunk in stream:
                advanced = next(versions, None)
                if advanced is not None:
                    self.model_version, self.coefficients = advanced
                yield self.transform(chunk)[0]
            return

        max_delay = self.max_allowed_model_delay_ms
        models = iter(model_stream)
        model_ts = None
        pending = None  # one-model peek buffer

        def take(nxt):
            nonlocal model_ts
            model_ts, self.model_version, self.coefficients = (
                nxt[0], nxt[1], np.asarray(nxt[2], np.float64))

        for chunk in stream:
            newest_data_ts = int(np.max(chunk.scalars(timestamp_col, np.int64)))
            # 1) every model that has arrived (ts <= data time) is applied
            while True:
                if pending is None:
                    pending = next(models, None)
                if pending is None or pending[0] > newest_data_ts:
                    break
                take(pending)
                pending = None
            # 2) the delay bound: hold the data until a model fresh enough
            #    (ts >= t - maxDelay) exists
            while model_ts is None or model_ts < newest_data_ts - max_delay:
                nxt = pending or next(models, None)
                pending = None
                if nxt is None:
                    break  # stream over: score with what we have
                take(nxt)
            yield self.transform(chunk)[0]

    def set_model_data(self, model_data: Table):
        col = model_data.column("coefficient")
        self.coefficients = np.asarray(
            col[0].to_array() if col.dtype == object else col[0], np.float64)
        if "modelVersion" in model_data:
            self.model_version = int(model_data.scalars("modelVersion",
                                                        np.int64)[0])
        return self

    def get_model_data(self) -> Tuple[Table]:
        return (Table.from_columns(
            coefficient=as_dense_vector_column(self.coefficients[None, :]),
            modelVersion=np.asarray([self.model_version], np.int64)),)

    def _save_extra(self, path: str) -> None:
        rw.save_model_arrays(path, "model", {
            "coefficient": self.coefficients,
            "modelVersion": np.asarray([self.model_version])})

    def _load_extra(self, path: str, meta: dict) -> None:
        arrays = rw.load_model_arrays(path, "model")
        self.coefficients = arrays["coefficient"]
        self.model_version = int(arrays["modelVersion"][0])


class OnlineLogisticRegression(Estimator, OnlineLogisticRegressionParams,
                               IterationRuntimeMixin):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._initial_model_data: Optional[Table] = None
        self.last_execution_path = None

    def set_initial_model_data(self, model_data: Table):
        """Ref: OnlineLogisticRegression.setInitialModelData:440."""
        self._initial_model_data = model_data
        return self

    def warm_start(self, model, model_version: Optional[int] = None):
        """Seed the next fit from a fitted
        :class:`OnlineLogisticRegressionModel` (its coefficients and
        version) or from a bare coefficient vector (version 0);
        ``model_version`` overrides the seed version."""
        if hasattr(model, "coefficients"):
            coeffs = np.asarray(model.coefficients, np.float64)
            version = int(getattr(model, "model_version", 0))
        else:
            coeffs = np.asarray(model, np.float64)
            version = 0
        if coeffs.ndim != 1:
            raise ValueError(
                f"warm_start expects a 1-D coefficient vector, got "
                f"shape {coeffs.shape}")
        if model_version is not None:
            version = int(model_version)
        return self.set_initial_model_data(Table.from_columns(
            coefficient=as_dense_vector_column(coeffs[None, :]),
            modelVersion=np.asarray([version], np.int64)))

    def fit(self, data: Union[Table, StreamTable]
            ) -> OnlineLogisticRegressionModel:
        if self._initial_model_data is None:
            raise ValueError("initial model data must be set before fit "
                             "(setInitialModelData)")
        seed = OnlineLogisticRegressionModel().set_model_data(
            self._initial_model_data)
        coeffs = np.array(seed.coefficients, np.float64)
        version = seed.model_version
        device = self.device
        hyper = (self.alpha, self.beta, self.elastic_net * self.reg,
                 (1.0 - self.elastic_net) * self.reg)
        z = np.zeros_like(coeffs)
        n = np.zeros_like(coeffs)
        history: List[Tuple[int, object]] = []
        ckpt = StreamCheckpointer(self._iteration_config,
                                  self._iteration_listeners)
        state_dev = None  # (coeffs, z, n) float32 on the device, or None
        dev_pending: List[int] = []  # history entries still on the device

        def to_host():
            nonlocal coeffs, z, n, state_dev
            if state_dev is not None:
                coeffs, z, n = (a.cpu().numpy().astype(np.float64)
                                for a in state_dev)
                state_dev = None

        def device_state():
            if state_dev is not None:
                return state_dev
            return tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                         for a in (coeffs, z, n))

        def materialize_history():
            if dev_pending:
                stacked = torch.stack([history[i][1] for i in dev_pending])
                stacked = stacked.cpu().numpy().astype(np.float64)
                for j, i in enumerate(dev_pending):
                    history[i] = (history[i][0], stacked[j])
                dev_pending.clear()

        def pack():
            to_host()
            materialize_history()
            hv = np.asarray([v for v, _ in history], np.int64)
            hc = (np.stack([c for _, c in history])
                  if history else np.zeros((0,) + coeffs.shape))
            return coeffs, z, n, version, hv, hc

        # a restored state is the host view pack() gives: the trimmed (d,)
        # float64 arrays, the version and the history as stacked arrays,
        # the same bytes whichever engine (or package) wrote it
        restored = ckpt.restore(pack())
        if restored is not None:
            coeffs, z, n, version, hv, hc = restored[0]
            version = int(version)
            history[:] = [(int(v), c) for v, c in zip(hv, hc)]

        def commit_device_state(new_state):
            nonlocal state_dev, version
            state_dev = new_state
            version += 1
            dev_pending.append(len(history))
            history.append((version, state_dev[0]))
            if len(dev_pending) >= _HISTORY_DEV_CAP:
                materialize_history()
            ckpt.after_batch(pack)

        batches = dict.fromkeys(ENGINES, 0)
        self.last_execution_path = None  # a fit of no batch names no engine
        for batch in _as_stream(data, self.global_batch_size):
            # a float32 tensor column passes through as it is; the CSR
            # branch is float64 whatever is asked
            x = sparse.features_matrix(batch, self.features_col, np.float32)
            if not sparse.is_csr(x):
                xb = torch.as_tensor(x, dtype=torch.float32,
                                     device=device).contiguous()
                yb = torch.as_tensor(scalar_column(batch, self.label_col),
                                     dtype=torch.float32, device=device)
                commit_device_state(_dense_step(xb, yb, *device_state(),
                                                *hyper))
                batches["torch-dense"] += 1
                continue
            y = batch.scalars(self.label_col, np.float64)
            w_col = (batch.scalars(self.weight_col, np.float64)
                     if self.weight_col is not None
                     and self.weight_col in batch
                     else np.ones(x.shape[0], np.float64))
            if x.nnz >= FTRL_SPARSE_MIN_NNZ:
                packed = tuple(torch.as_tensor(a[0], device=device)
                               for a in _pack_csr_shards(x, y, w_col, 1))
                commit_device_state(_sparse_step(packed, *device_state(),
                                                 *hyper))
                batches["cuda-csr" if device.type == "cuda"
                        else "torch-csr"] += 1
                continue
            to_host()  # the host engine runs on the float64 host state
            coeffs, z, n = _host_step(x, y, w_col, coeffs, z, n, *hyper)
            version += 1
            batches["host-csr"] += 1
            history.append((version, coeffs.copy()))
            ckpt.after_batch(pack)

        ckpt.complete(pack)
        to_host()
        materialize_history()
        guard_final_state(type(self).__name__, coeffs)
        # benchmark provenance (runner.py executionPath): where the batch
        # updates ran, in the JAX package's form
        active = [(k, v) for k, v in batches.items() if v]
        if len(active) > 1:
            self.last_execution_path = "mixed(" + ",".join(
                f"{k}={v}" for k, v in active) + ")"
        elif active:
            self.last_execution_path = f"{active[0][0]}-batches"
        model = OnlineLogisticRegressionModel(
            coefficients=coeffs, model_version=version, device=self._device)
        model.history = history
        return self.copy_params_to(model)
