"""Scalers: StandardScaler, MinMaxScaler, MaxAbsScaler, RobustScaler.

The port of ``flink_ml_tpu/models/feature/scalers.py`` (ref: flink-ml-lib
feature/{standardscaler,minmaxscaler,maxabsscaler,robustscaler}/): a fit
computes per-dimension statistics over the input vector column, the model
applies an affine map through ``ops/columnar.py``.

- StandardScaler: mean and unbiased std (StandardScaler.java:119-131:
  std = sqrt((Σx²−n·mean²)/(n−1)), 0 when n == 1); withMean default false,
  withStd default true.
- MinMaxScaler: rescale to [min, max] (defaults 0, 1); a constant dimension
  maps to (min+max)/2.
- MaxAbsScaler: divide by max |x| per dimension.
- RobustScaler: center and scale by the median and the [lower, upper]
  quantile range (defaults 0.25/0.75), element-of-dataset quantiles;
  withCentering default false, withScaling true.

The fit statistics follow the column: a host column gives float64 numpy
statistics by the reference's formulas, a tensor column float32
statistics computed where it lives (one pass each: ``var_mean``,
``aminmax``; RobustScaler's rank selection is exact on both). A column
split over a mesh's shards (``ops/columnar.py``) gives per-shard partials
combined across the shards: two passes for the mean and the centered sum
of squares, each a ``reduce_partials`` of the shards' sums, and the
shards' extremes (exact); RobustScaler gathers the column onto the first
shard's device and selects there, with the same bits. A CSR column keeps
its O(nnz) branches.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.stage import Estimator, Model
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.linalg import sparse as sp_mod
from flink_ml_tpu_torch.ops import columnar
from flink_ml_tpu_torch.ops.quantile import approx_quantiles, rank_select_device
from flink_ml_tpu_torch.params.param import (
    BooleanParam,
    FloatParam,
    ParamValidators,
)
from flink_ml_tpu_torch.params.shared import (
    HasInputCol,
    HasOutputCol,
    HasRelativeError,
)
from flink_ml_tpu_torch.utils import io as rw


def _stat_to_host(t: torch.Tensor) -> np.ndarray:
    """A small statistics tensor as float64 numpy (its only host copy)."""
    return t.detach().cpu().numpy().astype(np.float64)


class _VectorStatModelBase(Model, HasInputCol, HasOutputCol):
    """A model holding named per-dimension statistics arrays and an affine
    apply. The apply runs on the model's device through ``ops/columnar.py``:
    ``_kernel`` is a class-level torch function, the statistics are float32
    operands, boolean params plain arguments. The output stays a tensor in
    the Table, so chained stages skip the host round trip."""

    STAT_NAMES: Tuple[str, ...] = ()

    def __init__(self, **kwargs):
        stats = {name: kwargs.pop(name, None) for name in self.STAT_NAMES}
        super().__init__(**kwargs)
        for name, val in stats.items():
            setattr(self, name,
                    None if val is None else np.asarray(val, np.float64))

    @staticmethod
    def _kernel(x, *args):
        raise NotImplementedError

    def _kernel_args(self) -> Tuple[tuple, tuple]:
        """→ (statistics operands, plain arguments)."""
        raise NotImplementedError

    def _sparse_supported(self) -> bool:
        """Whether the configured op keeps zeros at zero, so that a CSR
        column stays CSR (mean centering does not)."""
        return False

    def _sparse_apply(self, m):
        """O(nnz) CSR transform (only when :meth:`_sparse_supported`);
        returns a new scipy CSR, never aliasing the input's values."""
        raise NotImplementedError

    def transform(self, table: Table) -> Tuple[Table]:
        if getattr(self, self.STAT_NAMES[0]) is None:
            raise ValueError(f"{type(self).__name__} has no model data")
        col = table.column(self.input_col)
        if self._sparse_supported() and sp_mod.is_sparse_column(col):
            out_m = self._sparse_apply(sp_mod.column_to_csr(col))
            return (table.with_column(
                self.output_col, sp_mod.CsrVectorColumn(out_m)),)
        device = self.device
        x = columnar.input_vectors(table, self.input_col, device)
        consts, static = self._kernel_args()
        out = columnar.apply(type(self)._kernel, x, consts, static, device)
        return (table.with_column(self.output_col, out),)

    def set_model_data(self, model_data: Table):
        for name in self.STAT_NAMES:
            setattr(self, name, model_data.vectors(name, np.float64)[0])
        return self

    def get_model_data(self) -> Tuple[Table]:
        return (Table.from_columns(**{
            name: np.asarray(getattr(self, name), np.float64)[None, :]
            for name in self.STAT_NAMES}),)

    def _save_extra(self, path: str) -> None:
        rw.save_model_arrays(path, "model", {
            name: getattr(self, name) for name in self.STAT_NAMES})

    def _load_extra(self, path: str, meta: dict) -> None:
        arrays = rw.load_model_arrays(path, "model")
        for name in self.STAT_NAMES:
            setattr(self, name, arrays[name])


# ---------------------------------------------------------------------------
# StandardScaler
# ---------------------------------------------------------------------------

class StandardScalerParams(HasInputCol, HasOutputCol):
    WITH_MEAN = BooleanParam(
        "withMean", "Whether centers the data with mean before scaling.",
        False)
    WITH_STD = BooleanParam(
        "withStd", "Whether scales the data with standard deviation.", True)


class StandardScalerModel(_VectorStatModelBase, StandardScalerParams):
    STAT_NAMES = ("mean", "std")

    @staticmethod
    def _kernel(x, mean, std, with_mean, with_std):
        if with_mean:
            x = x - mean
        if with_std:
            x = x / torch.where(std > 0, std, torch.ones_like(std))
        return x

    def _kernel_args(self):
        return ((self.mean, self.std),
                (bool(self.with_mean), bool(self.with_std)))

    def _sparse_supported(self) -> bool:
        return not self.with_mean  # centering densifies by necessity

    def _sparse_apply(self, m):
        import scipy.sparse as sp

        if self.with_std:
            std = np.where(self.std > 0, self.std, 1.0)
            data = m.data / std[m.indices]
        else:
            data = m.data.copy()  # never alias the input column's values
        return sp.csr_matrix((data, m.indices, m.indptr), shape=m.shape)


def _mean_varsum_kernel(x):
    """(2, d): per-dimension mean and centered sum of squares, in one
    Welford pass (``var_mean``): the stable form of the reference's
    Σx²−n·mean², as the JAX package's two-pass kernel is."""
    var, mean = torch.var_mean(x, dim=0, correction=0)
    return torch.stack([mean, var * x.shape[0]])


def _sum_kernel(x):
    return x.sum(dim=0)


def _centered_sq_kernel(x, mean):
    centered = x - mean
    return (centered * centered).sum(dim=0)


def mean_varsum(x) -> torch.Tensor:
    """(2, d): per-dimension mean and centered sum of squares of a tensor
    (one ``var_mean`` pass) or of a split column (two passes over its
    shards, the shards' sums added by ``collective.all_reduce_sum``)."""
    if not columnar.is_sharded(x):
        return _mean_varsum_kernel(x)
    mean = columnar.sum_over_shards(_sum_kernel, [x]) / max(x.shape[0], 1)
    varsum = columnar.sum_over_shards(_centered_sq_kernel, [x], (mean,))
    return torch.stack([mean, varsum])


def mean_and_std(table, input_col):
    """Per-dimension (mean, unbiased std): on the tensor's device for a
    tensor column; the float64 host branch keeps the reference's exact
    Σx²−n·mean² (StandardScaler.java:119-131). A CSR column reduces over
    its stored values, O(nnz), never densified."""
    col = table.column(input_col)
    if sp_mod.is_sparse_column(col):
        m = sp_mod.column_to_csr(col)
        n = m.shape[0]
        mean = np.asarray(m.sum(axis=0)).ravel() / max(n, 1)
        if n > 1:
            sq = np.asarray(m.multiply(m).sum(axis=0)).ravel()
            std = np.sqrt(np.maximum((sq - n * mean * mean) / (n - 1), 0.0))
        else:
            std = np.zeros_like(mean)
        return mean, std
    x, xp = columnar.fit_vectors(table, input_col)
    n = x.shape[0]
    if xp is torch:
        stats = _stat_to_host(mean_varsum(x))
        mean, varsum = stats[0], stats[1]
        std = (np.sqrt(varsum / (n - 1)) if n > 1
               else np.zeros_like(mean))
        return mean, std
    mean = x.mean(axis=0)
    if n > 1:
        # ref formula: sqrt((Σx² − n·mean²)/(n−1))
        std = np.sqrt(np.maximum(
            ((x * x).sum(axis=0) - n * mean * mean) / (n - 1), 0.0))
    else:
        std = np.zeros_like(mean)
    return mean, std


class StandardScaler(Estimator, StandardScalerParams):
    def fit(self, table: Table) -> StandardScalerModel:
        mean, std = mean_and_std(table, self.input_col)
        model = StandardScalerModel(mean=mean, std=std, device=self._device)
        return self.copy_params_to(model)


# ---------------------------------------------------------------------------
# MinMaxScaler
# ---------------------------------------------------------------------------

class MinMaxScalerParams(HasInputCol, HasOutputCol):
    MIN = FloatParam("min", "Lower bound of the output feature range.", 0.0)
    MAX = FloatParam("max", "Upper bound of the output feature range.", 1.0)


class MinMaxScalerModel(_VectorStatModelBase, MinMaxScalerParams):
    STAT_NAMES = ("data_min", "data_max")

    @staticmethod
    def _kernel(x, lo, hi, out_min, out_max):
        span = hi - lo
        return torch.where(
            span > 0,
            (x - lo) / torch.where(span > 0, span, torch.ones_like(span))
            * (out_max - out_min) + out_min,
            (out_min + out_max) / 2.0)  # constant dims map to the midpoint

    def _kernel_args(self):
        return ((self.data_min, self.data_max,
                 np.float32(self.min), np.float32(self.max)), ())


def _minmax_kernel(x):
    lo, hi = torch.aminmax(x, dim=0)
    return torch.stack([lo, hi])


def _neg_min_max_kernel(x):
    lo, hi = torch.aminmax(x, dim=0)
    return torch.stack([-lo, hi])


def min_max(x) -> torch.Tensor:
    """(2, d) per-dimension min and max of a tensor or a split column."""
    if not columnar.is_sharded(x):
        return _minmax_kernel(x)
    neg_lo, hi = columnar.max_over_shards(_neg_min_max_kernel, [x])
    return torch.stack([-neg_lo, hi])


class MinMaxScaler(Estimator, MinMaxScalerParams):
    def fit(self, table: Table) -> MinMaxScalerModel:
        col = table.column(self.input_col)
        if sp_mod.is_sparse_column(col):
            # scipy's sparse min/max include implicit zeros, O(nnz)
            m = sp_mod.column_to_csr(col)
            model = MinMaxScalerModel(
                data_min=np.asarray(m.min(axis=0).todense()).ravel(),
                data_max=np.asarray(m.max(axis=0).todense()).ravel(),
                device=self._device)
            return self.copy_params_to(model)
        x, xp = columnar.fit_vectors(table, self.input_col)
        if xp is torch:
            lo, hi = _stat_to_host(min_max(x))
        else:
            lo, hi = x.min(axis=0), x.max(axis=0)
        model = MinMaxScalerModel(data_min=lo, data_max=hi,
                                  device=self._device)
        return self.copy_params_to(model)


# ---------------------------------------------------------------------------
# MaxAbsScaler
# ---------------------------------------------------------------------------

class MaxAbsScalerParams(HasInputCol, HasOutputCol):
    pass


class MaxAbsScalerModel(_VectorStatModelBase, MaxAbsScalerParams):
    STAT_NAMES = ("max_abs",)

    @staticmethod
    def _kernel(x, max_abs):
        return x / torch.where(max_abs > 0, max_abs, torch.ones_like(max_abs))

    def _kernel_args(self):
        return ((self.max_abs,), ())

    def _sparse_supported(self) -> bool:
        return True

    def _sparse_apply(self, m):
        import scipy.sparse as sp

        scale = np.where(self.max_abs > 0, self.max_abs, 1.0)
        return sp.csr_matrix((m.data / scale[m.indices], m.indices,
                              m.indptr), shape=m.shape)


def _maxabs_kernel(x):
    """max |x| per dimension from one ``aminmax`` pass (no |x| copy)."""
    lo, hi = torch.aminmax(x, dim=0)
    return torch.maximum(-lo, hi)


class MaxAbsScaler(Estimator, MaxAbsScalerParams):
    def fit(self, table: Table) -> MaxAbsScalerModel:
        col = table.column(self.input_col)
        if sp_mod.is_sparse_column(col):
            # |x| >= 0, so the stored-value max IS the column max, O(nnz)
            m = sp_mod.column_to_csr(col)
            max_abs = np.asarray(abs(m).max(axis=0).todense()).ravel()
            return self.copy_params_to(
                MaxAbsScalerModel(max_abs=max_abs, device=self._device))
        x, xp = columnar.fit_vectors(table, self.input_col)
        if xp is not torch:
            max_abs = np.abs(x).max(axis=0)
        elif columnar.is_sharded(x):
            max_abs = _stat_to_host(
                columnar.max_over_shards(_maxabs_kernel, [x]))
        else:
            max_abs = _stat_to_host(_maxabs_kernel(x))
        model = MaxAbsScalerModel(max_abs=max_abs, device=self._device)
        return self.copy_params_to(model)


# ---------------------------------------------------------------------------
# RobustScaler
# ---------------------------------------------------------------------------

class RobustScalerParams(HasInputCol, HasOutputCol, HasRelativeError):
    LOWER = FloatParam("lower", "Lower quantile to calculate quantile range.",
                       0.25, ParamValidators.in_range(0, 1, False, False))
    UPPER = FloatParam("upper", "Upper quantile to calculate quantile range.",
                       0.75, ParamValidators.in_range(0, 1, False, False))
    WITH_CENTERING = BooleanParam(
        "withCentering", "Whether to center the data with median before "
        "scaling.", False)
    WITH_SCALING = BooleanParam(
        "withScaling", "Whether to scale the data to quantile range.", True)


class RobustScalerModel(_VectorStatModelBase, RobustScalerParams):
    STAT_NAMES = ("medians", "ranges")

    @staticmethod
    def _kernel(x, medians, ranges, with_centering, with_scaling):
        if with_centering:
            x = x - medians
        if with_scaling:
            x = x / torch.where(ranges > 0, ranges, torch.ones_like(ranges))
        return x

    def _kernel_args(self):
        return ((self.medians, self.ranges),
                (bool(self.with_centering), bool(self.with_scaling)))


class RobustScaler(Estimator, RobustScalerParams):
    def fit(self, table: Table) -> RobustScalerModel:
        x, xp = columnar.fit_vectors(table, self.input_col)
        probs = [self.lower, 0.5, self.upper]
        if xp is torch:
            # a tensor column: rank-exact order statistics on the column's
            # device (ops/quantile.rank_select_device), the same elements
            # the host's method='lower' quantiles give
            qs = _stat_to_host(rank_select_device(x, probs))
        else:
            qs = approx_quantiles(x, probs,
                                  relative_error=self.relative_error)
        lo, med, hi = qs[0], qs[1], qs[2]
        model = RobustScalerModel(medians=med, ranges=hi - lo,
                                  device=self._device)
        return self.copy_params_to(model)
