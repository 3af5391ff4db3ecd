"""Shared model plumbing: Table → tensors, the linear-model bases, and the
iteration knobs of the iterative estimators.

The port of ``flink_ml_tpu/models/common.py`` (ref: the per-algorithm
boilerplate of flink-ml-lib, XxxParams + Xxx + XxxModel + XxxModelData,
collapsed into two base classes: a concrete linear algorithm declares a
loss and a prediction rule). The iterative estimators take an
``IterationConfig`` with listeners (host rounds, K-round checkpointed
segments, resume) and a ``RetryPolicy`` (supervised restarts) through
:class:`IterationRuntimeMixin`. A traced fit records its spans, metrics and
health series through the port's observability layer (``observability/``),
and attaches the drift and quality baselines of a row-capped training
sample to the fitted model (``drift_baseline``, ``quality_baseline``), as
the JAX package's ``models/common.py:186-230`` does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.stage import Estimator, Model
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.linalg import sparse
from flink_ml_tpu_torch.linalg.vectors import DenseVector
from flink_ml_tpu_torch.ops.losses import LossFunc
from flink_ml_tpu_torch.ops.optimizer import SGD, SGDParams
from flink_ml_tpu_torch.params.shared import (
    HasElasticNet,
    HasFeaturesCol,
    HasGlobalBatchSize,
    HasLabelCol,
    HasLearningRate,
    HasMaxIter,
    HasOptimizerMethod,
    HasPredictionCol,
    HasRawPredictionCol,
    HasReg,
    HasTol,
    HasWeightCol,
)
from flink_ml_tpu_torch.resilience.supervisor import run_supervised
from flink_ml_tpu_torch.utils import io as rw


class IterationRuntimeMixin:
    """Runtime (non-Param) iteration knobs shared by iterative estimators:
    host-mode rounds, listeners, mid-fit checkpoint/resume and supervised
    restarts. Ref: in the reference these are Flink runtime settings
    (checkpoint interval, restart strategy) configured on the environment,
    not stage params, hence not part of the JSON param map here either."""

    _iteration_config = None
    _iteration_listeners = ()
    _retry_policy = None

    def set_iteration_config(self, config, listeners=()):
        self._iteration_config = config
        self._iteration_listeners = tuple(listeners)
        return self

    def set_retry_policy(self, policy):
        """Run ``.fit`` under supervision: retryable failures (injected
        faults, I/O errors) restart the fit, which resumes from the newest
        checkpoint that passes integrity validation when a
        CheckpointManager is configured. Device faults are terminal
        (``resilience/policy.py``). Ref: Flink's per-job
        RestartStrategies, a runtime setting, not a Param."""
        self._retry_policy = policy
        return self

    def _supervised_fit(self, fit_once):
        """Route a zero-argument fit thunk through ``run_supervised`` when a
        retry policy is set; a plain call otherwise."""
        if self._retry_policy is None:
            return fit_once()
        cfg = self._iteration_config
        mgr = cfg.checkpoint_manager if cfg is not None else None
        return run_supervised(fit_once, mgr=mgr, policy=self._retry_policy,
                              listeners=self._iteration_listeners)


def scalar_column(table: Table, name: str):
    """A scalar column: a tensor column as it is, on its device (a device
    label column never goes to the host); a host column as float32 numpy."""
    col = table.column(name)
    return col if isinstance(col, torch.Tensor) else table.scalars(name)


def extract_labeled_points(stage, table: Table):
    """Table → (features (n, d) dense or scipy CSR, labels (n,), weights (n,)
    or None), the reference's Table→LabeledPointWithWeight map
    (LogisticRegression.java:72-99). Tensor columns are returned as they
    are, on their device; a sparse vector column stays CSR, so wide hashed
    features (2^18 dims) are never densified (ref BLAS.java:78)."""
    x = sparse.features_matrix(table, stage.features_col)
    y = scalar_column(table, stage.label_col)
    w = None
    if stage.weight_col is not None and stage.weight_col in table:
        w = scalar_column(table, stage.weight_col)
    return x, y, w


def prediction_dtype() -> torch.dtype:
    """Label-column dtype of the linear and online models' predictions:
    float32, the device width (the JAX package's dense-path dtype)."""
    return torch.float32


def to_host(a):
    """A tensor as a host numpy array (one ``.cpu()``); anything else as it
    is."""
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def predict_dots(x, coefficients, device: torch.device):
    """Margins ``x @ coefficients`` (ref LogisticRegressionModelServable.java
    :106 dot). A dense batch gives a float32 tensor on ``device``: one plain
    matrix-vector product, as the JAX package leaves it to XLA. A scipy CSR
    batch stays a host matvec and gives a float64 numpy array (ref BLAS.hDot,
    sparse branch)."""
    if sparse.is_csr(x):
        return np.asarray(x @ np.asarray(coefficients, np.float64))
    xd = torch.as_tensor(x, dtype=torch.float32, device=device)
    cd = torch.as_tensor(np.asarray(coefficients), dtype=torch.float32,
                         device=device)
    return xd @ cd


def _capture_drift_baseline(estimator, model, x) -> None:
    """The traced-fit drift seam (observability/drift.py): sketch a
    row-capped sample of the training inputs per feature plus the final
    model's predictions on that sample, attaching the
    :class:`~flink_ml_tpu_torch.observability.drift.DriftBaseline` to the
    fitted model — ``serving.publish_model`` ships it beside the
    checkpoint manifest so live traffic is compared against the
    distribution THIS model was trained on. The sample's margins are
    computed on the fit's device; only the sample comes to the host.
    Armed like the rich health tier (trace dir or ``FLINK_ML_TPU_DRIFT``);
    a capture failure is logged and never fails the fit."""
    try:
        from flink_ml_tpu_torch.observability import drift

        if not drift.capture_armed():
            return
        xs = drift.sample_rows(x)
        pred = model._predict_columns(model._dots(xs)).get(
            model.prediction_col)
        drift.capture_fit_baseline(model, type(estimator).__name__,
                                   features=to_host(xs),
                                   predictions=to_host(pred))
    except Exception:  # noqa: BLE001 — telemetry must not sink the fit
        import logging

        logging.getLogger(__name__).warning(
            "drift baseline capture failed", exc_info=True)


def _capture_quality_baseline(estimator, model, x, y) -> None:
    """The traced-fit quality seam (observability/evaluation.py):
    sketch the final model's positive-class scores on the same
    row-capped training sample against the matching labels, attaching
    the :class:`~flink_ml_tpu_torch.observability.evaluation
    .QualityBaseline` to the fitted model — the live-AUC anchor
    ``publish_model`` ships as ``quality-baseline.json``. Non-binary
    labels (regression fits) sketch nothing, so no baseline attaches.
    Armed like drift capture; a failure is logged and never fails the
    fit."""
    try:
        from flink_ml_tpu_torch.observability import drift, evaluation

        if not evaluation.capture_armed():
            return
        xs = drift.sample_rows(x)
        ys = np.asarray(to_host(y)).ravel()[:xs.shape[0]]
        cols = model._predict_columns(model._dots(xs))
        raw = cols.get(getattr(model, "raw_prediction_col", None))
        scores = evaluation.positive_scores(
            raw_values=(None if raw is None else to_host(raw)),
            predictions=to_host(cols.get(model.prediction_col)))
        if scores is not None:
            evaluation.capture_fit_baseline(
                model, type(estimator).__name__, scores=scores,
                labels=ys)
    except Exception:  # noqa: BLE001 — telemetry must not sink the fit
        import logging

        logging.getLogger(__name__).warning(
            "quality baseline capture failed", exc_info=True)


class LinearModelParams(HasFeaturesCol, HasPredictionCol):
    pass


class LinearTrainParams(LinearModelParams, HasLabelCol, HasWeightCol,
                        HasMaxIter, HasReg, HasElasticNet, HasLearningRate,
                        HasGlobalBatchSize, HasTol, HasRawPredictionCol,
                        HasOptimizerMethod):
    pass


class LinearModelBase(Model, LinearTrainParams):
    """A fitted linear model: coefficient vector + a prediction rule."""

    def __init__(self, coefficients: Optional[np.ndarray] = None, **kwargs):
        super().__init__(**kwargs)
        self.coefficients = (None if coefficients is None
                             else np.asarray(coefficients, np.float64))

    # -- prediction rule, overridden per algorithm ---------------------------
    def _predict_columns(self, dots: torch.Tensor) -> dict:
        """The prediction columns, as tensors on the model's device, from
        the (n,) float32 margins."""
        raise NotImplementedError

    def transform(self, table: Table) -> Tuple[Table]:
        """The prediction columns, tensors on this model's device. A sparse
        feature column stays CSR: its margins are a float64 host product
        (:func:`predict_dots`), rounded to float32 on the way to the
        device, so the predictions are the dense column's."""
        if self.coefficients is None:
            raise ValueError(f"{type(self).__name__} has no model data")
        x = sparse.features_matrix(table, self.features_col)
        return (table.with_columns(**self._predict_columns(self._dots(x))),)

    def _dots(self, x) -> torch.Tensor:
        """The (n,) float32 margins of dense or CSR rows, on this model's
        device."""
        dots = predict_dots(x, self.coefficients, self.device)
        if isinstance(dots, np.ndarray):
            dots = torch.as_tensor(dots, dtype=torch.float32,
                                   device=self.device)
        return dots

    # -- model data as a Table (ref: XxxModelData POJO + table) -------------
    def set_model_data(self, model_data: Table):
        col = model_data.column("coefficient")
        self.coefficients = (col[0].to_array() if col.dtype == object
                             else np.asarray(col[0], np.float64))
        return self

    def get_model_data(self) -> Tuple[Table]:
        return (Table.from_columns(
            coefficient=[DenseVector(self.coefficients)]),)

    # -- persistence ---------------------------------------------------------
    def _save_extra(self, path: str) -> None:
        rw.save_model_arrays(path, "model", {"coefficient": self.coefficients})

    def _load_extra(self, path: str, meta: dict) -> None:
        self.coefficients = rw.load_model_arrays(path, "model")["coefficient"]


class LinearEstimatorBase(Estimator, LinearTrainParams,
                          IterationRuntimeMixin):
    """Shared SGD fit path (ref: LogisticRegression.fit:60 → SGD.optimize)."""

    #: subclass hooks
    loss: LossFunc = None
    model_class = None

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.last_execution_path = None

    def fit(self, table: Table):
        return self._supervised_fit(lambda: self._fit_once(table))

    def _fit_once(self, table: Table):
        x, y, w = extract_labeled_points(self, table)  # x may be CSR
        params = SGDParams(
            learning_rate=self.learning_rate,
            global_batch_size=self.global_batch_size,
            max_iter=self.max_iter, tol=self.tol, reg=self.reg,
            elastic_net=self.elastic_net, method=self.optimizer,
            momentum=self.momentum, beta1=self.beta1, beta2=self.beta2,
            eps=self.epsilon)
        sgd = SGD(params)
        coeffs, _ = sgd.optimize(self.loss, np.zeros(x.shape[1], np.float32),
                                 x, y, w, config=self._iteration_config,
                                 listeners=self._iteration_listeners,
                                 tag=type(self).__name__, mesh=self.mesh)
        # benchmark provenance (runner.py executionPath): cuda-sgd[-...]
        # / cuda-csr[-...] when the rounds ran the kernels, torch-sgd[-...]
        # / torch-csr[-...] their plain versions
        self.last_execution_path = sgd.last_execution_path
        model = self.model_class(coefficients=coeffs, device=self._device)
        model = self.copy_params_to(model)
        _capture_drift_baseline(self, model, x)
        _capture_quality_baseline(self, model, x, y)
        return model
