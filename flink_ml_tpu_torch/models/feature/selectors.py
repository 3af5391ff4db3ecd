"""Feature selectors.

The port of ``flink_ml_tpu/models/feature/selectors.py`` (ref: flink-ml-lib
feature/{univariatefeatureselector,variancethresholdselector}/). A tensor
column's statistics are computed on its device, the categorical χ² counts
and the label column included; the selected indices slice the column
there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.stage import Estimator, Model
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.linalg import sparse as sp_mod
from flink_ml_tpu_torch.models.feature.scalers import mean_varsum
from flink_ml_tpu_torch.models.feature.vectorops import _gather_cols_kernel
from flink_ml_tpu_torch.ops import columnar
from flink_ml_tpu_torch.ops.stats import anova_f_test, chi_square_test, f_value_test
from flink_ml_tpu_torch.params.param import (
    FloatParam,
    ParamValidators,
    StringParam,
)
from flink_ml_tpu_torch.params.shared import (
    HasFeaturesCol,
    HasInputCol,
    HasLabelCol,
    HasOutputCol,
)
from flink_ml_tpu_torch.utils import io as rw


class _IndexSelectorModelBase(Model):
    """A model that slices selected feature indices out of a vector column."""

    def __init__(self, indices: Optional[np.ndarray] = None, **kwargs):
        super().__init__(**kwargs)
        self.indices = (None if indices is None
                        else np.asarray(sorted(int(i) for i in indices),
                                        np.int64))

    @property
    def _in_col(self):
        raise NotImplementedError

    @property
    def _out_col(self):
        raise NotImplementedError

    def transform(self, table: Table) -> Tuple[Table]:
        if self.indices is None:
            raise ValueError(f"{type(self).__name__} has no model data")
        col = table.column(self._in_col)
        if sp_mod.is_sparse_column(col):
            # column selection keeps CSR, O(nnz of the slice)
            m = sp_mod.column_to_csr(col)
            # max(), not [-1]: set_model_data may receive unsorted indices
            if len(self.indices) and int(self.indices.max()) >= m.shape[1]:
                raise IndexError(
                    f"selected index {int(self.indices.max())} out of range "
                    f"for vectors of size {m.shape[1]}")
            return (table.with_column(
                self._out_col,
                sp_mod.CsrVectorColumn(m[:, self.indices].tocsr())),)
        device = self.device
        x = columnar.input_vectors(table, self._in_col, device)
        if len(self.indices) and int(self.indices.max()) >= x.shape[1]:
            raise IndexError(
                f"selected index {int(self.indices.max())} out of range for "
                f"vectors of size {x.shape[1]}")
        out = columnar.apply(_gather_cols_kernel, x, (),
                             (tuple(int(i) for i in self.indices),), device)
        return (table.with_column(self._out_col, out),)

    def set_model_data(self, model_data: Table):
        self.indices = np.asarray(
            [int(v) for v in model_data.column("indices")], np.int64)
        return self

    def get_model_data(self) -> Tuple[Table]:
        return (Table.from_columns(
            indices=self.indices.astype(np.float64)),)

    def _save_extra(self, path: str) -> None:
        rw.save_model_arrays(path, "model", {"indices": self.indices})

    def _load_extra(self, path: str, meta: dict) -> None:
        self.indices = rw.load_model_arrays(path, "model")["indices"]


# ---------------------------------------------------------------------------
# UnivariateFeatureSelector
# ---------------------------------------------------------------------------

class UnivariateFeatureSelectorModelParams(HasFeaturesCol, HasOutputCol):
    pass


class UnivariateFeatureSelectorParams(UnivariateFeatureSelectorModelParams,
                                      HasLabelCol):
    CATEGORICAL = "categorical"
    CONTINUOUS = "continuous"
    NUM_TOP_FEATURES = "numTopFeatures"
    PERCENTILE = "percentile"
    FPR = "fpr"
    FDR = "fdr"
    FWE = "fwe"

    FEATURE_TYPE = StringParam(
        "featureType", "The feature type.", None,
        ParamValidators.in_array(CATEGORICAL, CONTINUOUS, None))
    LABEL_TYPE = StringParam(
        "labelType", "The label type.", None,
        ParamValidators.in_array(CATEGORICAL, CONTINUOUS, None))
    SELECTION_MODE = StringParam(
        "selectionMode", "The feature selection mode.", NUM_TOP_FEATURES,
        ParamValidators.in_array(NUM_TOP_FEATURES, PERCENTILE, FPR, FDR, FWE))
    SELECTION_THRESHOLD = FloatParam(
        "selectionThreshold",
        "The upper bound of the features that selector will select. "
        "Defaults per mode at runtime: numTopFeatures→50, percentile→0.1, "
        "fpr/fdr/fwe→0.05.", None)


class UnivariateFeatureSelectorModel(_IndexSelectorModelBase,
                                     UnivariateFeatureSelectorModelParams):
    _in_col = property(lambda self: self.features_col)
    _out_col = property(lambda self: self.output_col)


class UnivariateFeatureSelector(Estimator, UnivariateFeatureSelectorParams):
    """Select features by univariate test p-values (ref:
    feature/univariatefeatureselector/UnivariateFeatureSelector.java):
    chi2 (categorical/categorical), ANOVA (continuous feature? no —
    continuous features vs categorical label), F-value (continuous/
    continuous). Modes: numTopFeatures, percentile, fpr, fdr (Benjamini-
    Hochberg), fwe (Bonferroni)."""

    def fit(self, table: Table) -> UnivariateFeatureSelectorModel:
        ftype, ltype = self.feature_type, self.label_type
        if ftype is None or ltype is None:
            raise ValueError("featureType and labelType must be set")
        # the tests reduce on the device for a tensor column (the χ²
        # contingency counts too), and a label tensor stays there
        x, _ = columnar.fit_vectors(table, self.features_col)
        y = table.column(self.label_col)
        if not columnar.is_device_array(y):
            y = np.asarray(y)
        if ftype == self.CATEGORICAL and ltype == self.CATEGORICAL:
            _, p_values, _ = chi_square_test(x, y)
        elif ftype == self.CONTINUOUS and ltype == self.CATEGORICAL:
            _, p_values, _ = anova_f_test(x, y)
        elif ftype == self.CONTINUOUS and ltype == self.CONTINUOUS:
            _, p_values, _ = f_value_test(
                x, y if columnar.is_device_array(y)
                else y.astype(np.float64))
        else:
            raise ValueError(
                f"unsupported featureType={ftype!r} labelType={ltype!r}")

        mode = self.selection_mode
        thr = self.selection_threshold
        d = x.shape[1]
        order = np.argsort(p_values, kind="stable")
        if mode == self.NUM_TOP_FEATURES:
            k = int(thr) if thr is not None else 50
            indices = order[:k]
        elif mode == self.PERCENTILE:
            frac = thr if thr is not None else 0.1
            indices = order[: int(d * frac)]
        elif mode == self.FPR:
            alpha = thr if thr is not None else 0.05
            indices = np.nonzero(p_values < alpha)[0]
        elif mode == self.FDR:
            alpha = thr if thr is not None else 0.05
            sorted_p = p_values[order]
            below = np.nonzero(
                sorted_p <= alpha * (np.arange(d) + 1) / d)[0]
            indices = order[: below.max() + 1] if len(below) else \
                np.asarray([], np.int64)
        else:  # FWE
            alpha = thr if thr is not None else 0.05
            indices = np.nonzero(p_values < alpha / d)[0]
        model = UnivariateFeatureSelectorModel(indices=indices,
                                               device=self._device)
        return self.copy_params_to(model)


# ---------------------------------------------------------------------------
# VarianceThresholdSelector
# ---------------------------------------------------------------------------

class VarianceThresholdSelectorModelParams(HasInputCol, HasOutputCol):
    pass


class VarianceThresholdSelectorParams(VarianceThresholdSelectorModelParams):
    VARIANCE_THRESHOLD = FloatParam(
        "varianceThreshold",
        "Features with a variance not greater than this threshold will be "
        "removed.", 0.0, ParamValidators.gt_eq(0.0))


class VarianceThresholdSelectorModel(_IndexSelectorModelBase,
                                     VarianceThresholdSelectorModelParams):
    _in_col = property(lambda self: self.input_col)
    _out_col = property(lambda self: self.output_col)


class VarianceThresholdSelector(Estimator, VarianceThresholdSelectorParams):
    """Keep features whose sample variance exceeds the threshold
    (ref: feature/variancethresholdselector/)."""

    def fit(self, table: Table) -> VarianceThresholdSelectorModel:
        col = table.column(self.input_col)
        if sp_mod.is_sparse_column(col):
            # O(nnz) TWO-PASS sample variance (the stability invariant of
            # this fit, see the comment below — not the reference's
            # one-pass parity form StandardScaler keeps)
            m = sp_mod.column_to_csr(col)
            n = m.shape[0]
            if n > 1:
                _, varsum, _ = sp_mod.column_moments(m)
                variances = varsum / (n - 1)
            else:
                variances = np.zeros(m.shape[1])
            indices = np.nonzero(variances > self.variance_threshold)[0]
            return self.copy_params_to(VarianceThresholdSelectorModel(
                indices=indices, device=self._device))

        # a stable variance on both paths (two-pass on the host, one
        # Welford pass on the device, two passes over a split column's
        # shards; the host Σx²−n·mean² form belongs to
        # StandardScaler's reference-formula parity only); a tensor column
        # stays on its device
        x, xp = columnar.fit_vectors(table, self.input_col)
        n = x.shape[0]
        if xp is np:
            variances = x.var(axis=0, ddof=1) if n > 1 \
                else np.zeros(x.shape[1])
        else:
            varsum = mean_varsum(x)[1].cpu().numpy().astype(
                np.float64)
            variances = varsum / (n - 1) if n > 1 else np.zeros(x.shape[1])
        indices = np.nonzero(variances > self.variance_threshold)[0]
        model = VarianceThresholdSelectorModel(indices=indices,
                                               device=self._device)
        return self.copy_params_to(model)
