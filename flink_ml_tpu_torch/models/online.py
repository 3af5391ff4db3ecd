"""Online (unbounded-stream) algorithms: FTRL logistic regression,
OnlineKMeans and OnlineStandardScaler.

The port of ``flink_ml_tpu/models/online.py``. A fit consumes a
:class:`~flink_ml_tpu_torch.iteration.streaming.StreamTable` (or a bounded
Table chopped into global batches) and the fitted model records every
versioned snapshot, the host-side form of the reference's unbounded
model-data stream.

OnlineKMeans (ref: OnlineKMeans.java:76, ModelDataLocalUpdater:295-324):
per global batch, weights *= decayFactor (the one-task case of
decay/parallelism); a cluster the batch hits gains its row count, λ =
count/weight, centroid = (1−λ)·centroid + λ·mean of its rows; a cluster the
batch misses keeps its weight and position. The batch's per-centroid
``[Σ x | count]`` comes from the hand-written ``lloyd_partial_sums`` kernel
on the card (``cuda-lloyd-stream``; one launch per batch, and its
``reduce_partials`` where the fused route runs) under the euclidean measure,
at every k and d; other measures take KMeans's plain partials
(``torch-lloyd-stream``, as the CPU does). The partials are float32; the centroids and weights are
float64 tensors on the batch's device, updated by ``torch.where`` with no
host copy per batch (the JAX package keeps float64 numpy and assigns by
float64 distances, so near-ties may split differently).

OnlineStandardScaler (ref: feature/standardscaler/OnlineStandardScaler.java):
per window (count, tumbling or session windows, ``windows`` param), the
cumulative mean and unbiased std of all rows seen, emitted as a versioned
model stamped with the window end (time windows) or the wall clock. A
window's column sums and sums of squares are taken where the column lives,
in float64 (a tensor column on its device, a host column in numpy), and
the running totals stay float64: ``(Σx² − n·m²)/(n−1)`` cancels in float32
when |mean| ≫ std. The per-window ``history`` entry is the one (2, d) host
copy of a window.

FTRL (ref: OnlineLogisticRegression.java:75). Per global batch: the per-coordinate
gradient g_i = Σ (σ(x·w) − y)·x_i, normalized by the batch's row count
(dense batches, CalculateLocalGradient:364-388's dense branch, which ignores
the weight column) or by the weight sum at the coordinate's stored values
(sparse batches); then σ = (√(n + g²) − √n)/α, z += g − σ·w, n += g²,
w_i = 0 if |z_i| ≤ l1 else (sign(z_i)·l1 − z_i)/((β + √n_i)/α + l2), with
l1 = elasticNet·reg and l2 = (1 − elasticNet)·reg (UpdateModel:295-319);
the model version goes up by one per batch (CreateLrModelData:235-258).

A batch runs on one of three engines, each named in ``executionPath``:

- ``torch-dense``: a dense batch, on the devices of the estimator's mesh in
  plain PyTorch (two matrix-vector products and the elementwise rule).
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

The device engines run on the estimator's mesh (``parallel/``; by default
one shard), as the JAX package's ``_ftrl_program`` and
``_ftrl_sparse_program`` do: a batch's rows are split over the shards
(dense: contiguous row views; device CSR: one :func:`_pack_csr_shards` row
range per shard), each shard computes its gradient partial, and the partials
are summed over the mesh. With ``FLINK_ML_TPU_UPDATE_SHARDING=1`` the sum is
reduce-scattered and each shard updates its 1/N slice of w, z and n; z and n
stay sharded between batches, while the host view and the checkpoints stay
the trimmed (d,) float64 arrays in both modes. The host engine keeps its own
row-range split.

With health telemetry armed (``observability/health.py``) each device batch
also returns its mean logloss, from the pre-update coefficients; the losses
stay on the device and drain in stacked fetches of up to
``_HISTORY_DEV_CAP`` into the per-batch ``loss`` series of ``ml.health``
(host batches compute theirs in float64), and a non-finite batch raises the
terminal ``NonFiniteState``. While the tracer is armed, ``set_model_data``
records the ``ml.model version`` gauge. A fit of a Table with drift or
quality capture armed attaches the baselines of a row-capped training
sample to the model (``drift_baseline``, ``quality_baseline``), as the JAX
package's fit does; the sample's margins are computed on the fit's device.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from flink_ml_tpu_torch.api.stage import Estimator, Model
from flink_ml_tpu_torch.common import window as W
from flink_ml_tpu_torch.common.metrics import VERSION_GAUGE, metrics
from flink_ml_tpu_torch.common.table import Table, as_dense_vector_column
from flink_ml_tpu_torch.iteration.streaming import (
    StreamCheckpointer,
    StreamTable,
    generate_batches,
    window_stream,
)
from flink_ml_tpu_torch.linalg import sparse
from flink_ml_tpu_torch.linalg.distance import DistanceMeasure
from flink_ml_tpu_torch.models.clustering.kmeans import (
    KMeansModel,
    KMeansModelParams,
    _measure_partials,
)
from flink_ml_tpu_torch.models.common import (
    IterationRuntimeMixin,
    predict_dots,
    prediction_dtype,
    scalar_column,
    to_host,
)
from flink_ml_tpu_torch.observability import health as _health
from flink_ml_tpu_torch.observability import tracing
from flink_ml_tpu_torch.ops import columnar, kernels
from flink_ml_tpu_torch.parallel import collective as C
from flink_ml_tpu_torch.parallel import mapreduce as mr
from flink_ml_tpu_torch.parallel import update_sharding as _upd
from flink_ml_tpu_torch.params.param import (
    BooleanParam,
    FloatParam,
    ParamValidators,
)
from flink_ml_tpu_torch.params.shared import (
    HasBatchStrategy,
    HasDecayFactor,
    HasElasticNet,
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasInputCol,
    HasLabelCol,
    HasMaxAllowedModelDelayMs,
    HasModelVersionCol,
    HasOutputCol,
    HasPredictionCol,
    HasRawPredictionCol,
    HasReg,
    HasSeed,
    HasWeightCol,
    HasWindows,
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


def _sigmoid(dots: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-dots))


def _true_width(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The coefficients a shard's rows multiply: the first ``x.shape[1]``
    (the sharded update pads the state), on x's device."""
    d = x.shape[1]
    c = coeffs if coeffs.shape[0] == d else coeffs[:d]
    return c if c.device == x.device else c.to(x.device)


def _ftrl_update(mesh, sharded: bool, g, coeffs, z, n, hyper):
    """The FTRL rule on the reduced gradient ``g``: on the whole state, or,
    with ``sharded``, on each shard's slices (``g`` then holds this
    process's reduce-scattered slices and z, n are
    :class:`~update_sharding.Sharded`), the coefficients all-gathered."""
    if not sharded:
        return _ftrl_apply(torch, g, coeffs, z, n, *hyper)

    def apply_fn(g_slice, c_slice, zn):
        w2, z2, n2 = _ftrl_apply(torch, g_slice, c_slice, zn[0], zn[1],
                                 *hyper)
        return w2, (z2, n2)

    w, (z, n) = _upd.apply_slices(mesh, g, coeffs, (z, n), apply_fn)
    return w, z, n


def _xent(dots: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-row binary logloss from the margins, stable:
    ``log(1 + e^d) - y·d``."""
    return torch.logaddexp(torch.zeros_like(dots), dots) - y * dots


def _ftrl_program(mesh, hyper, sharded: bool, health: bool = False):
    """One dense FTRL batch as a map-reduce program over the mesh, the port
    of ``_ftrl_program``: ``step(shard_args, n_rows, coeffs, z, n) ->
    (coeffs, z, n)``, ``shard_args`` each shard's (x, y) rows. The map is
    the shard's gradient ``Σ (σ(x·w) − y)·x`` (padded to the state's
    length), the reduce a sum (reduce-scattered with ``sharded``), the
    update the FTRL rule on the gradient divided by the batch's row count
    (the dense branch of CalculateLocalGradient:364-388, which ignores the
    weight column). With ``health`` the step also returns the batch's mean
    logloss (from the pre-update coefficients' margins) as a 0-dim device
    tensor."""
    prog = mr.MapReduceProgram(mesh)

    def map_fn(shard, x, y, n_rows, coeffs, z, n):
        dots = x @ _true_width(coeffs, x)
        p = _sigmoid(dots)
        partials = {"grad": _upd.pad_leading((p - y) @ x, coeffs.shape[0])}
        if health:
            partials["loss"] = torch.sum(_xent(dots, y))
        return partials

    def update_fn(red, n_rows, coeffs, z, n):
        g = red["grad"] / max(float(n_rows), 1.0)
        out = _ftrl_update(mesh, sharded, g, coeffs, z, n, hyper)
        if health:
            return out + (red["loss"] / max(float(n_rows), 1.0),)
        return out

    reduce = {"grad": mr.reduce_scatter if sharded else mr.reduce_sum}
    if health:
        reduce["loss"] = mr.reduce_sum
    return prog.build(map_fn, update_fn, reduce=reduce)


def _ftrl_sparse_program(mesh, hyper, sharded: bool, health: bool = False):
    """One sparse FTRL batch on the device as a map-reduce program, the
    port of ``_ftrl_sparse_program`` and the twin of the host engine:
    ``step(shard_args, coeffs, z, n) -> (coeffs, z, n)``, ``shard_args``
    each shard's :func:`_pack_csr_shards` row as tensors. The map is the
    shard's segment sums on the card's ``segment_reduce_sum`` kernel: the
    per-row dots, then the per-coordinate gradient and weight sums as two
    value columns, accumulated only at a row's stored values; padded slots
    carry validity 0 and padded rows own no slot. The reduce sums the
    (d, 2) gradient and weight columns (reduce-scattered with
    ``sharded``); the update divides by the weight sum where it is not
    0. With ``health`` the step also returns the batch's weighted mean
    logloss (padded rows weigh 0) as a 0-dim device tensor."""
    prog = mr.MapReduceProgram(mesh)

    def map_fn(shard, vals, col, row, valid, yb, wb, coeffs, z, n):
        rl = row.long()
        c = coeffs if coeffs.device == vals.device else coeffs.to(vals.device)
        dots = kernels.segment_reduce_sum(vals * c[col.long()] * valid, row,
                                          yb.shape[0])
        p = _sigmoid(dots)
        # gradient and weight sums share one pass: two value columns
        partials = {"gw": kernels.segment_reduce_sum(
            torch.stack([vals * (p - yb)[rl] * valid, wb[rl] * valid], dim=1),
            col, c.shape[0])}
        if health:
            partials["lossNum"] = torch.sum(wb * _xent(dots, yb))
            partials["lossDen"] = torch.sum(wb)
        return partials

    def update_fn(red, coeffs, z, n):
        gw = red["gw"]
        grad, wsum = gw[..., 0], gw[..., 1]
        g = torch.where(wsum != 0, grad / torch.where(wsum != 0, wsum, 1.0),
                        0.0)
        out = _ftrl_update(mesh, sharded, g, coeffs, z, n, hyper)
        if health:
            return out + (red["lossNum"]
                          / torch.clamp_min(red["lossDen"], 1e-30),)
        return out

    reduce = {"gw": mr.reduce_scatter if sharded else mr.reduce_sum}
    if health:
        reduce["lossNum"] = reduce["lossDen"] = mr.reduce_sum
    return prog.build(map_fn, update_fn, reduce=reduce)


def _pack_csr_shards(x, y, w, n_shards: int):
    """Split a scipy CSR batch into ``n_shards`` row ranges and pack each
    as padded (values, col, local row, valid) rows of one (S, nnz_s) quad
    plus (S, rows_s) y/w blocks, nnz_s and rows_s rounded up to powers of
    two: the host marshalling of the sparse device engine, one row per data
    shard."""
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
        if tracing.tracer.active:
            # only the version gauge: LR model data carries no timestamp,
            # and a wall-clock stand-in would clobber other models' real
            # timestamps
            metrics.model_group().gauge(VERSION_GAUGE, self.model_version)
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


def _capture_baselines(est, model, data: Table, coeffs, version: int,
                       device: torch.device) -> None:
    """The fit-time baselines of the JAX package's FTRL fit (its
    ``models/online.py:939-997``): a row-capped sample of the training
    table's features, the FINAL model's 0/1 predictions on it (drift) and
    its positive-class probabilities against the labels (quality), each
    when armed. Table fits only — an unbounded stream has no finite
    training set to summarize. A failure is logged, never raised: the fit
    just produced a valid model."""
    from flink_ml_tpu_torch.observability import drift, evaluation

    want_drift, want_quality = drift.capture_armed(), \
        evaluation.capture_armed()
    if not (want_drift or want_quality):
        return
    algo = type(est).__name__
    try:
        xs = drift.sample_rows(sparse.features_matrix(data, est.features_col))
        fdots = np.asarray(to_host(predict_dots(xs, coeffs, device)),
                           np.float64)
        if want_drift:
            drift.capture_fit_baseline(
                model, algo, features=to_host(xs),
                predictions=(fdots >= 0).astype(np.float64),
                version=version)
        if want_quality:
            ys = np.asarray(to_host(scalar_column(data, est.label_col)
                                    [:xs.shape[0]]), np.float64)
            evaluation.capture_fit_baseline(
                model, algo, scores=1.0 / (1.0 + np.exp(-fdots)),
                labels=ys, version=version)
    except Exception:  # noqa: BLE001 — see the docstring
        import logging

        logging.getLogger(__name__).warning(
            "fit baseline capture failed", exc_info=True)


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
        d = coeffs.shape[0]  # the model's width; the device state may pad
        mesh = self.mesh
        device = mesh.devices[mesh.local_shards[0]]
        hyper = (self.alpha, self.beta, self.elastic_net * self.reg,
                 (1.0 - self.elastic_net) * self.reg)
        # the cross-replica sharded update: z and n live on the device as
        # 1/N slices per shard, coefficients padded to the shard multiple
        sharded = _upd.enabled()
        dp = _upd.padded_len(d, mesh.size) if sharded else d
        # per-batch model health (observability/health.py): armed, every
        # device batch returns its mean logloss; the scalars stay on the
        # device and drain in stacked fetches at the history's cadence, so
        # no batch waits for the device on their account
        health_on = _health.armed()
        algo = type(self).__name__
        loss_pending: List[torch.Tensor] = []
        loss_series: List[float] = []
        dense_step = _ftrl_program(mesh, hyper, sharded, health_on)
        sparse_step = _ftrl_sparse_program(mesh, hyper, sharded, health_on)

        def check_losses(final=False):
            """Drain the pending device losses (one fetch); a non-finite
            batch records the series and raises NonFiniteState."""
            if loss_pending:
                loss_series.extend(
                    float(v) for v in torch.stack(loss_pending).cpu().numpy())
                loss_pending.clear()
            if loss_series and not all(np.isfinite(loss_series)):
                _health.check_fit(algo, {"loss": loss_series}, finite=False)
            elif final:
                _health.check_fit(algo, {"loss": loss_series}, finite=True)

        def device_batch(out):
            if health_on:
                *out, loss = out
                loss_pending.append(loss)
                if len(loss_pending) >= _HISTORY_DEV_CAP:
                    check_losses()
            commit_device_state(tuple(out))
        z = np.zeros_like(coeffs)
        n = np.zeros_like(coeffs)
        history: List[Tuple[int, object]] = []
        ckpt = StreamCheckpointer(self._iteration_config,
                                  self._iteration_listeners)
        # (coeffs, z, n) float32 on the device, or None; with the sharded
        # update z and n are Sharded. The host view is the trimmed (d,)
        # float64 arrays either way, so checkpoints do not depend on it
        state_dev = None
        dev_pending: List[int] = []  # history entries still on the device

        def to_host():
            nonlocal coeffs, z, n, state_dev
            if state_dev is not None:
                coeffs, z, n = (
                    (a.global_view() if isinstance(a, _upd.Sharded) else a)
                    .cpu().numpy().astype(np.float64)[:d] for a in state_dev)
                state_dev = None

        def device_state():
            if state_dev is not None:
                return state_dev
            w, zz, nn = (torch.as_tensor(np.pad(a, (0, dp - d)),
                                         dtype=torch.float32, device=device)
                         for a in (coeffs, z, n))
            if sharded:
                zz, nn = _upd.place_opt_state(mesh, (zz, nn))
            return w, zz, nn

        def materialize_history():
            if dev_pending:
                stacked = torch.stack([history[i][1] for i in dev_pending])
                stacked = stacked.cpu().numpy().astype(np.float64)
                for j, i in enumerate(dev_pending):
                    history[i] = (history[i][0], stacked[j][:d])
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

        state_recorded = False

        def commit_device_state(new_state):
            nonlocal state_dev, version, state_recorded
            state_dev = new_state
            if not state_recorded:
                # per-replica optimizer-state bytes (benchmark provenance),
                # measured from the committed z/n buffers
                state_recorded = True
                _upd.record_state_bytes(type(self).__name__, new_state[1:],
                                        mesh.size, sharded)
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
                # the batch's rows split over the mesh, each shard's rows a
                # view of the batch placed once
                xb = C.ensure_on_mesh(mesh, x).parts
                yb = C.ensure_on_mesh(
                    mesh, scalar_column(batch, self.label_col)).parts
                device_batch(dense_step(list(zip(xb, yb)), x.shape[0],
                                        *device_state()))
                batches["torch-dense"] += 1
                continue
            y = batch.scalars(self.label_col, np.float64)
            w_col = (batch.scalars(self.weight_col, np.float64)
                     if self.weight_col is not None
                     and self.weight_col in batch
                     else np.ones(x.shape[0], np.float64))
            if x.nnz >= FTRL_SPARSE_MIN_NNZ:
                # one row range of the batch per shard, packed on the host
                packed = _pack_csr_shards(x, y, w_col, mesh.size)
                shard_args = [tuple(torch.as_tensor(a[s],
                                                    device=mesh.devices[s])
                                    for a in packed)
                              for s in mesh.local_shards]
                device_batch(sparse_step(shard_args, *device_state()))
                batches["cuda-csr" if device.type == "cuda"
                        else "torch-csr"] += 1
                continue
            to_host()  # the host engine runs on the float64 host state
            if health_on:
                dots = x @ coeffs
                loss_series.append(float(np.sum(w_col * (
                    np.logaddexp(0.0, dots) - y * dots)))
                    / max(float(w_col.sum()), 1e-30))
                if not math.isfinite(loss_series[-1]):
                    check_losses()
            coeffs, z, n = _host_step(x, y, w_col, coeffs, z, n, *hyper)
            version += 1
            batches["host-csr"] += 1
            history.append((version, coeffs.copy()))
            ckpt.after_batch(pack)

        ckpt.complete(pack)
        to_host()
        materialize_history()
        if health_on:
            # end-of-stream drain: the whole per-batch loss series lands in
            # ml.health; a non-finite batch raises NonFiniteState
            check_losses(final=True)
        # the batch loss comes from the PRE-update coefficients, so a
        # divergence in the last update shows only in the state
        _health.guard_final_state(algo, coeffs)
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
        if isinstance(data, Table):
            _capture_baselines(self, model, data, coeffs, version, device)
        return self.copy_params_to(model)


# ---------------------------------------------------------------------------
# OnlineKMeans
# ---------------------------------------------------------------------------

class OnlineKMeansParams(KMeansModelParams, HasBatchStrategy,
                         HasGlobalBatchSize, HasDecayFactor, HasSeed):
    pass


class OnlineKMeansModel(KMeansModel):
    """Ref: OnlineKMeansModel.java: a KMeansModel fed by a stream of
    versioned model data; it predicts as KMeansModel does, from the
    snapshot consumed last."""


def decayed_centroids(centroids: torch.Tensor, weights: torch.Tensor,
                      packed: torch.Tensor, decay: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One OnlineKMeans update (ModelDataLocalUpdater:295-324) from a
    batch's (k, d+1) ``[Σ x | count]``: float64 (k, d) centroids and (k,)
    weights in, the new ones out, on their device. A cluster the batch
    misses keeps its weight (decayed) and its position."""
    packed = packed.to(torch.float64)
    sums, counts = packed[:, :-1], packed[:, -1]
    weights = weights * decay
    hit = counts > 0
    weights = torch.where(hit, weights + counts, weights)
    lam = torch.where(hit, counts / torch.where(hit, weights, 1.0), 0.0)
    means = sums / torch.clamp_min(counts, 1.0)[:, None]
    centroids = torch.where(
        hit[:, None],
        (1.0 - lam)[:, None] * centroids + lam[:, None] * means, centroids)
    return centroids, weights


class OnlineKMeans(Estimator, OnlineKMeansParams, IterationRuntimeMixin):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._initial_model_data: Optional[Table] = None
        self.last_execution_path = None

    def set_initial_model_data(self, model_data: Table):
        """Ref: OnlineKMeans.setInitialModelData:345."""
        self._initial_model_data = model_data
        return self

    def fit(self, data: Union[Table, StreamTable]) -> OnlineKMeansModel:
        """Folds every global batch of ``data`` into the initial model's
        centroids on this stage's device; the centroids come to the host
        once, at the end (and when a listener or a due checkpoint asks for
        the state)."""
        if self._initial_model_data is None:
            raise ValueError("initial model data must be set before fit "
                             "(setInitialModelData)")
        seed_model = KMeansModel().set_model_data(self._initial_model_data)
        centroids = np.array(seed_model.centroids, np.float64)
        weights = np.array(seed_model.weights, np.float64)
        device = self.device
        decay = self.decay_factor

        ckpt = StreamCheckpointer(self._iteration_config,
                                  self._iteration_listeners)
        restored = ckpt.restore((centroids, weights))
        if restored is not None:
            centroids, weights = restored[0]
        state = tuple(torch.as_tensor(np.asarray(a, np.float64),
                                      device=device)
                      for a in (centroids, weights))

        def host_state():
            return tuple(a.cpu().numpy() for a in state)

        if self.distance_measure == "euclidean":
            partials_fn = kernels.lloyd_partial_sums
            path = ("cuda-lloyd-stream" if device.type == "cuda"
                    else "torch-lloyd-stream")
        else:
            partials_fn = _measure_partials(
                DistanceMeasure.get_instance(self.distance_measure))
            path = "torch-lloyd-stream"
        ones = None
        for batch in _as_stream(data, self.global_batch_size):
            x = torch.as_tensor(
                columnar.joined(batch.vectors(self.features_col)),
                dtype=torch.float32, device=device)
            if ones is None or ones.shape[0] != x.shape[0]:
                ones = torch.ones(x.shape[0], dtype=torch.float32,
                                  device=device)
            packed = partials_fn(x.contiguous(), ones,
                                 state[0].to(torch.float32))
            state = decayed_centroids(state[0], state[1], packed, decay)
            ckpt.after_batch(host_state)
        # benchmark provenance (runner.py executionPath)
        self.last_execution_path = path
        ckpt.complete(host_state)
        centroids, weights = host_state()
        model = OnlineKMeansModel(centroids=centroids, weights=weights,
                                  device=self._device)
        return self.copy_params_to(model)


# ---------------------------------------------------------------------------
# OnlineStandardScaler
# ---------------------------------------------------------------------------

class OnlineStandardScalerModelParams(HasInputCol, HasOutputCol,
                                      HasModelVersionCol,
                                      HasMaxAllowedModelDelayMs):
    pass


class OnlineStandardScalerParams(OnlineStandardScalerModelParams, HasWindows):
    WITH_MEAN = BooleanParam(
        "withMean", "Whether centers the data with mean before scaling.",
        False)
    WITH_STD = BooleanParam(
        "withStd", "Whether scales the data with standard deviation.", True)


def _standardize(x, mean, std, with_mean: bool, with_std: bool):
    if with_mean:
        x = x - mean
    if with_std:
        x = x / torch.where(std > 0, std, torch.ones_like(std))
    return x


class OnlineStandardScalerModel(Model, OnlineStandardScalerModelParams):
    def __init__(self, mean=None, std=None, model_version: int = 0,
                 timestamp: int = 0, with_mean=False, with_std=True,
                 **kwargs):
        super().__init__(**kwargs)
        self.mean = None if mean is None else np.asarray(mean, np.float64)
        self.std = None if std is None else np.asarray(std, np.float64)
        self.model_version = int(model_version)
        self.timestamp = int(timestamp)
        self._with_mean, self._with_std = with_mean, with_std
        self.history: List[Tuple[int, np.ndarray, np.ndarray]] = []
        #: per-snapshot timestamps (the window end for time windows): the
        #: (timestamp, version, data) stream the model-delay join consumes
        self.history_timestamps: List[int] = []

    def transform(self, table: Table) -> Tuple[Table]:
        """The scaled column as a float32 tensor on this model's device
        (a tensor column is scaled where it is), as StandardScalerModel
        gives it; the version column on the host."""
        if self.mean is None:
            raise ValueError("OnlineStandardScalerModel has no model data")
        device = self.device
        x = columnar.input_vectors(table, self.input_col, device)
        out = {self.output_col: columnar.apply(
            _standardize, x, (self.mean, self.std),
            (bool(self._with_mean), bool(self._with_std)), device)}
        if self.model_version_col is not None:
            out[self.model_version_col] = np.full(
                table.num_rows, self.model_version, np.int64)
        return (table.with_columns(**out),)

    def set_model_data(self, model_data: Table):
        self.mean = model_data.vectors("mean", np.float64)[0]
        self.std = model_data.vectors("std", np.float64)[0]
        if "modelVersion" in model_data:
            self.model_version = int(
                model_data.scalars("modelVersion", np.int64)[0])
        if "timestamp" in model_data:
            self.timestamp = int(model_data.scalars("timestamp", np.int64)[0])
        # ref OnlineStandardScalerModel.java:202-210: consuming model data
        # publishes the ml.model version/timestamp gauges
        metrics.report_model(self.model_version, self.timestamp)
        return self

    def get_model_data(self) -> Tuple[Table]:
        return (Table.from_columns(
            mean=self.mean[None, :], std=self.std[None, :],
            modelVersion=np.asarray([self.model_version], np.int64),
            timestamp=np.asarray([self.timestamp], np.int64)),)

    def _save_extra(self, path: str) -> None:
        rw.save_model_arrays(path, "model", {
            "mean": self.mean, "std": self.std,
            "version": np.asarray([self.model_version]),
            "timestamp": np.asarray([self.timestamp]),
            "flags": np.asarray([self._with_mean, self._with_std])})

    def _load_extra(self, path: str, meta: dict) -> None:
        arrays = rw.load_model_arrays(path, "model")
        self.mean, self.std = arrays["mean"], arrays["std"]
        self.model_version = int(arrays["version"][0])
        self.timestamp = int(arrays["timestamp"][0])
        self._with_mean, self._with_std = (bool(v) for v in arrays["flags"])


def _window_sums(chunk: Table, col: str):
    """A window's per-column (Σx, Σx², rows), float64, where the column
    lives: a tensor column on its device (each value widened before it is
    squared, so each square is exact), a host column in numpy."""
    raw = columnar.joined(chunk.column(col))
    if isinstance(raw, torch.Tensor):
        x = (raw if raw.ndim == 2 else raw[:, None]).to(torch.float64)
    else:
        x = chunk.vectors(col, np.float64)
    return x.sum(0), (x * x).sum(0), x.shape[0]


def _add(total, part):
    """``total + part``; a host total joins a tensor part on its device
    (a restored checkpoint's totals meet the first tensor window)."""
    if total is None:
        return part
    if isinstance(part, torch.Tensor) and not isinstance(total, torch.Tensor):
        total = torch.as_tensor(total, dtype=torch.float64,
                                device=part.device)
    return total + part


class OnlineStandardScaler(Estimator, OnlineStandardScalerParams,
                           IterationRuntimeMixin):
    def fit(self, data: Union[Table, StreamTable],
            batch_size: int = 1000,
            timestamp_col: Optional[str] = None
            ) -> OnlineStandardScalerModel:
        """One versioned model per window of ``data``: count windows of
        ``windows.size`` rows (a pre-chunked stream is regrouped to that
        size), tumbling or session time windows (``timestamp_col`` names
        the event time), or, under GlobalWindows, one per chunk of
        ``batch_size`` rows of a Table and one per chunk of a stream."""
        windows = self.windows
        timed = isinstance(windows, (W.EventTimeTumblingWindows,
                                     W.ProcessingTimeTumblingWindows,
                                     W.EventTimeSessionWindows,
                                     W.ProcessingTimeSessionWindows))
        count_windows = isinstance(windows, W.CountTumblingWindows)
        if count_windows:
            batch_size = windows.size
        if isinstance(data, Table):
            data = StreamTable.from_table(data, batch_size)
        elif count_windows:
            data = StreamTable(generate_batches(data, batch_size,
                                                drop_remainder=False))
        if timed:
            data = window_stream(data, windows, timestamp_col,
                                 with_end_ts=True)

        total = sq_total = None
        count = 0
        version = 0
        history = []
        history_timestamps = []
        ckpt = StreamCheckpointer(self._iteration_config,
                                  self._iteration_listeners)

        def moments():
            m = total / count
            if count > 1:
                var = (sq_total - count * m * m) / (count - 1)
                s = (torch.sqrt(torch.clamp_min(var, 0.0))
                     if isinstance(var, torch.Tensor)
                     else np.sqrt(np.maximum(var, 0.0)))
            else:
                s = (torch.zeros_like(m) if isinstance(m, torch.Tensor)
                     else np.zeros_like(m))
            return m, s

        def host(a):
            return a.cpu().numpy() if isinstance(a, torch.Tensor) else a

        def pack():
            hv = np.asarray([v for v, _, _ in history], np.int64)
            hm = (np.stack([m for _, m, _ in history])
                  if history else np.zeros((0, 0)))
            hs = (np.stack([s for _, _, s in history])
                  if history else np.zeros((0, 0)))
            hts = np.asarray(history_timestamps, np.int64)
            return (host(total), host(sq_total), count, version, hv, hm, hs,
                    hts)

        # restore before the stream is read (the arrays' shapes come from
        # the snapshot; the template fixes the tree's structure only)
        restored = ckpt.restore(
            (np.zeros(0), np.zeros(0), 0, 0,
             np.zeros(0, np.int64), np.zeros((0, 0)), np.zeros((0, 0)),
             np.zeros(0, np.int64)))
        if restored is not None:
            total, sq_total, count, version, hv, hm, hs, hts = restored[0]
            count, version = int(count), int(version)
            history[:] = [(int(v), m, s) for v, m, s in zip(hv, hm, hs)]
            history_timestamps[:] = [int(t) for t in hts]

        for item in data:
            window_end_ms, chunk = item if timed else (None, item)
            s1, s2, rows = _window_sums(chunk, self.input_col)
            total, sq_total = _add(total, s1), _add(sq_total, s2)
            count += rows
            m, s = moments()
            if isinstance(m, torch.Tensor):
                m, s = torch.stack([m, s]).cpu().numpy()  # torchlint: disable=host-sync -- one copy a window, not a batch: the scaler's model history is host data the model-delay join reads
            history.append((version, m.copy(), s.copy()))
            # per-model timestamp: the window end for time windows (what
            # the reference stamps and the model-delay join consumes), the
            # wall clock otherwise
            history_timestamps.append(
                window_end_ms if window_end_ms is not None
                else int(time.time() * 1000))
            version += 1
            ckpt.after_batch(pack)
        if count == 0:
            raise ValueError("empty input stream")
        if history:
            _, mean, std = history[-1]
        else:  # resumed onto an already exhausted stream
            mean, std = (host(a) for a in moments())
        ckpt.complete(pack)
        model = OnlineStandardScalerModel(
            mean=mean, std=std, model_version=version - 1,
            timestamp=(history_timestamps[-1] if history_timestamps
                       else int(time.time() * 1000)),
            with_mean=self.with_mean, with_std=self.with_std,
            device=self._device)
        self.copy_params_to(model)
        model.history = history
        model.history_timestamps = history_timestamps
        return model
