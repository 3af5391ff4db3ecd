"""Shared model plumbing: Table → tensors, the linear-model bases, and the
iteration knobs of the iterative estimators.

The port of ``flink_ml_tpu/models/common.py`` (ref: the per-algorithm
boilerplate of flink-ml-lib, XxxParams + Xxx + XxxModel + XxxModelData,
collapsed into two base classes: a concrete linear algorithm declares a
loss and a prediction rule). The iterative estimators take an
``IterationConfig`` with listeners (host rounds, K-round checkpointed
segments, resume) and a ``RetryPolicy`` (supervised restarts) through
:class:`IterationRuntimeMixin`. A traced fit records its spans, metrics and
health series through the port's observability layer (``observability/``);
the drift and quality baselines a traced JAX fit also captures (its
``models/common.py:186-230``) wait for the port's drift and evaluation
modules.
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
    """Table → (features (n, d), labels (n,), weights (n,) or None), the
    reference's Table→LabeledPointWithWeight map
    (LogisticRegression.java:72-99). Tensor columns are returned as they
    are, on their device."""
    x = table.vectors(stage.features_col)
    y = scalar_column(table, stage.label_col)
    w = None
    if stage.weight_col is not None and stage.weight_col in table:
        w = scalar_column(table, stage.weight_col)
    return x, y, w


def prediction_dtype() -> torch.dtype:
    """Label-column dtype of the linear and online models' predictions:
    float32, the device width (the JAX package's dense-path dtype)."""
    return torch.float32


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
        if self.coefficients is None:
            raise ValueError(f"{type(self).__name__} has no model data")
        x = table.vectors(self.features_col)
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            raise NotImplementedError(
                "sparse features come with a later slice of the port")
        dots = predict_dots(x, self.coefficients, self.device)
        return (table.with_columns(**self._predict_columns(dots)),)

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
        x, y, w = extract_labeled_points(self, table)
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
        # when the rounds ran the kernel, torch-sgd[-...] its plain version
        self.last_execution_path = sgd.last_execution_path
        model = self.model_class(coefficients=coeffs, device=self._device)
        return self.copy_params_to(model)
