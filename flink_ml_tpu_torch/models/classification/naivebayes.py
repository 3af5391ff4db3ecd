"""Multinomial naive Bayes over categorical feature values.

The port of ``flink_ml_tpu/models/classification/naivebayes.py`` (ref:
flink-ml-lib classification/naivebayes/{NaiveBayes.java:59,
NaiveBayesModel.java, NaiveBayesModelData.java}):

- features are vectors whose per-dimension *values* are categories;
- theta[l][j][v] = log(count(l,j,v)+smoothing) − log(docCount_l +
  smoothing·|categories_j|) (GenerateModelFunction);
- pi[l] = log(docCount_l·d + smoothing) − log(n·d + L·smoothing);
- predict: argmax_l pi[l] + Σ_j theta[l][j][x_j]
  (NaiveBayesModel.calculateProb).

Deviation (the JAX package's): an unseen feature value at predict time
scores the smoothed floor log(smoothing) − log(docCount_l +
smoothing·|categories_j|) instead of the reference's NullPointerException.

A tensor feature column is counted and predicted on its device: integral
categories in [0, 4096) in one bincount of the whole (dim, label, value)
grid, as the JAX package counts its device arrays; other values one
``unique`` per dimension there (the JAX package takes those to the host).
Only the count tables come to the host; the prediction looks each
dimension's values up in a per-label table on the device, in float64, in
the host path's order of sums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.stage import Estimator, Model
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.ops import columnar
from flink_ml_tpu_torch.params.param import FloatParam, ParamValidators, StringParam
from flink_ml_tpu_torch.params.shared import (
    HasFeaturesCol,
    HasPredictionCol,
)
from flink_ml_tpu_torch.params.shared import HasLabelCol, HasWeightCol
from flink_ml_tpu_torch.utils import io as rw


class NaiveBayesModelParams(HasFeaturesCol, HasPredictionCol):
    MODEL_TYPE = StringParam(
        "modelType", "The model type.", "multinomial",
        ParamValidators.in_array("multinomial"))


class NaiveBayesParams(NaiveBayesModelParams, HasLabelCol, HasWeightCol):
    SMOOTHING = FloatParam("smoothing", "The smoothing parameter.", 1.0,
                           ParamValidators.gt_eq(0.0))


class NaiveBayesModel(Model, NaiveBayesModelParams):
    def __init__(self, theta=None, pi=None, labels=None, floors=None,
                 **kwargs):
        super().__init__(**kwargs)
        self.theta = theta      # [label][feature] dict value→logprob
        self.pi = None if pi is None else np.asarray(pi, np.float64)
        self.labels = None if labels is None else np.asarray(labels,
                                                             np.float64)
        self.floors = (None if floors is None
                       else np.asarray(floors, np.float64))  # (L, d)

    def transform(self, table: Table) -> Tuple[Table]:
        if self.theta is None:
            raise ValueError("NaiveBayesModel has no model data")
        if columnar.is_device_array(table.column(self.features_col)):
            x = columnar.input_vectors(table, self.features_col, self.device)
            return (table.with_column(self.prediction_col, columnar.apply(
                self._predict_device, x, (), (), self.device)),)
        x = table.vectors(self.features_col, np.float64)
        n, d = x.shape
        num_labels = len(self.labels)
        probs = np.tile(self.pi, (n, 1))
        # vectorized: one unique per feature column, then per-label lookup
        # tables over the DISTINCT values + one gather — not n dict probes
        for j in range(d):
            vals, codes = np.unique(x[:, j], return_inverse=True)
            lut = np.empty((num_labels, len(vals)))
            for li in range(num_labels):
                mapping = self.theta[li][j]
                floor = self.floors[li][j]
                lut[li] = [mapping.get(v, floor) for v in vals.tolist()]
            probs += lut[:, codes].T
        pred = self.labels[np.argmax(probs, axis=1)]
        return (table.with_column(self.prediction_col, pred),)

    def _predict_device(self, x: torch.Tensor) -> torch.Tensor:
        """The host transform's sums on ``x``'s device: per dimension, each
        row's value is found among the model's values by a binary search
        (an unseen value takes the floor) and its per-label log
        probabilities are added, dimension by dimension, in float64."""
        device = x.device
        f64 = torch.float64
        num_labels = len(self.labels)
        probs = torch.as_tensor(self.pi, dtype=f64, device=device) \
            .expand(x.shape[0], num_labels).clone()
        for j in range(x.shape[1]):
            vals = np.asarray(sorted(self.theta[0][j]), np.float64)
            lut = np.empty((num_labels, len(vals) + 1))
            for li in range(num_labels):
                mapping = self.theta[li][j]
                lut[li, :-1] = [mapping[v] for v in vals.tolist()]
                lut[li, -1] = self.floors[li][j]
            vals_d = torch.as_tensor(vals, device=device)
            xj = x[:, j].to(f64).contiguous()
            pos = torch.searchsorted(vals_d, xj).clamp_max(
                max(len(vals) - 1, 0))
            seen = (vals_d[pos] == xj) if len(vals) else \
                torch.zeros_like(xj, dtype=torch.bool)
            codes = torch.where(seen, pos, len(vals))
            probs += torch.as_tensor(lut.T, device=device)[codes]
        labels = torch.as_tensor(self.labels, dtype=f64, device=device)
        return labels[torch.argmax(probs, dim=1)]

    def set_model_data(self, model_data: Table):
        row = model_data.column("theta")[0]
        self.theta = row
        self.pi = model_data.vectors("piArray", np.float64)[0]
        self.labels = model_data.vectors("labels", np.float64)[0]
        self.floors = np.asarray(model_data.column("floors")[0], np.float64)
        return self

    def get_model_data(self) -> Tuple[Table]:
        theta_col = np.empty(1, dtype=object)
        theta_col[0] = self.theta
        floors_col = np.empty(1, dtype=object)
        floors_col[0] = self.floors
        return (Table.from_columns(
            theta=theta_col, piArray=self.pi[None, :],
            labels=self.labels[None, :], floors=floors_col),)

    def _save_extra(self, path: str) -> None:
        rw.save_model_json(path, "model", {
            "theta": [[{str(v): lp for v, lp in m.items()} for m in row]
                      for row in self.theta],
            "pi": self.pi.tolist(), "labels": self.labels.tolist(),
            "floors": self.floors.tolist()})

    def _load_extra(self, path: str, meta: dict) -> None:
        data = rw.load_model_json(path, "model")
        self.theta = [[{float(v): lp for v, lp in m.items()} for m in row]
                      for row in data["theta"]]
        self.pi = np.asarray(data["pi"])
        self.labels = np.asarray(data["labels"])
        self.floors = np.asarray(data["floors"])


#: device counting applies when every feature/label value is an integer in
#: [0, _MAX_DEVICE_ARITY) — the (d, L, V) count tensor must stay small
_MAX_DEVICE_ARITY = 4096


def _integral_bounds_kernel(x, y):
    both_int = torch.logical_and(torch.all(x == torch.floor(x)),
                                 torch.all(y == torch.floor(y)))
    return torch.stack([torch.minimum(x.min(), y.min()), x.max(), y.max(),
                        both_int.to(x.dtype)])


def _neg_bounds_kernel(x, y):
    lo, x_hi, y_hi, integral = _integral_bounds_kernel(x, y)
    return torch.stack([-lo, x_hi, y_hi, -integral])


def _cast_kernel(y, dtype):
    return y.to(dtype)


def _category_counts_kernel(x, y, d, L, V):
    """(d·L·V,) count vector in ONE device bincount: flat key
    (dim·L + label)·V + value over the (n, d) grid."""
    xi = x.to(torch.int32)
    yi = y.to(torch.int32)
    dim_idx = torch.arange(d, dtype=torch.int32, device=x.device)[None, :]
    flat = (dim_idx * L + yi[:, None]) * V + xi
    return torch.bincount(flat.reshape(-1), minlength=d * L * V)


class NaiveBayes(Estimator, NaiveBayesParams):
    def _finalize(self, per_dim, doc_counts, labels, n, d
                  ) -> "NaiveBayesModel":
        """Build the model from per-dimension (value list, (L, nv) count
        matrix) pairs — the single home of the smoothing/floor/pi math,
        shared by the host and device counting paths."""
        smoothing = self.smoothing
        num_labels = len(labels)
        theta = [[] for _ in range(num_labels)]
        floors = np.zeros((num_labels, d))
        for j, (val_list, counts) in enumerate(per_dim):
            nv = len(val_list)
            denom = np.log(doc_counts + smoothing * nv)  # (L,)
            logp = np.log(counts + smoothing) - denom[:, None]
            floors[:, j] = (np.log(smoothing) - denom if smoothing > 0
                            else -np.inf)
            for li in range(num_labels):
                theta[li].append(dict(zip(val_list, logp[li].tolist())))
        pi_log = np.log(n * d + num_labels * smoothing)
        pi = np.log(doc_counts * d + smoothing) - pi_log
        model = NaiveBayesModel(theta=theta, pi=pi, labels=labels,
                                floors=floors, device=self._device)
        return self.copy_params_to(model)

    def _fit_device(self, x, y) -> Optional["NaiveBayesModel"]:
        """Device counting path for integral categorical data: the whole
        (dim, label, value) contingency comes back as one (d·L·V,)
        bincount; only that small tensor crosses to the host. Returns None
        when the data does not qualify (non-integral / negative /
        too-wide value range)."""
        n, d = x.shape
        if columnar.is_sharded(x):
            # per shard that holds rows: [-min, max x, max y, -integral],
            # the shards' extremes combined exactly
            neg_lo, x_hi, y_hi, neg_int = columnar.max_over_shards(
                _neg_bounds_kernel, [x, y]).cpu().numpy().astype(np.float64)
            lo, integral = -neg_lo, -neg_int
        else:
            lo, x_hi, y_hi, integral = _integral_bounds_kernel(x, y) \
                .cpu().numpy().astype(np.float64)
        if not integral or lo < 0 or max(x_hi, y_hi) + 1 > \
                _MAX_DEVICE_ARITY:
            return None
        V, L = int(x_hi) + 1, int(y_hi) + 1
        if d * L * V > 50_000_000:  # count-tensor memory guard
            return None
        # labels/values 0..max may be sparse: count every candidate, then
        # keep the ones actually present
        if columnar.is_sharded(x):
            counts = columnar.sum_over_shards(
                _category_counts_kernel, [x, y], (), (d, L, V))
        else:
            counts = _category_counts_kernel(x, y, d, L, V)
        counts = counts.cpu().numpy().astype(np.float64).reshape(
            d, L, V)  # (dim, label, value)
        label_totals = counts[0].sum(axis=1)  # per-label doc counts
        present = np.nonzero(label_totals > 0)[0]
        labels = present.astype(np.float64)
        doc_counts = label_totals[present]

        def per_dim():
            for j in range(d):
                sub = counts[j][present]  # (L, V)
                vals = np.nonzero(sub.sum(axis=0) > 0)[0]
                yield [float(v) for v in vals], sub[:, vals]

        return self._finalize(per_dim(), doc_counts, labels, n, d)

    def _fit_device_unique(self, x, y) -> "NaiveBayesModel":
        """Device counting for any values: one ``unique`` and one (label,
        value) bincount per dimension, the host path's counting on the
        device."""
        n, d = x.shape
        labels, y_idx = torch.unique(y, return_inverse=True)
        num_labels = int(labels.shape[0])
        doc_counts = torch.bincount(y_idx, minlength=num_labels) \
            .cpu().numpy().astype(np.float64)

        def per_dim():
            for j in range(d):
                vals, codes = torch.unique(x[:, j], return_inverse=True)
                nv = int(vals.shape[0])
                counts = torch.bincount(y_idx * nv + codes,
                                        minlength=num_labels * nv)
                yield (vals.cpu().numpy().astype(np.float64).tolist(),
                       counts.cpu().numpy().reshape(num_labels, nv))

        return self._finalize(per_dim(), doc_counts,
                              labels.cpu().numpy().astype(np.float64), n, d)

    def fit(self, table: Table) -> NaiveBayesModel:
        xd, xp = columnar.fit_vectors(table, self.features_col)
        if xp is torch:
            # a tensor column is counted on its device; a host label
            # column joins it there (split alike a split column)
            if columnar.is_sharded(xd):
                y = columnar.to_device(columnar.input_scalars(
                    table, self.label_col, xd.device), xd.mesh)
                y = columnar.map_split(_cast_kernel, y, (), (xd.dtype,))
            else:
                y = columnar.input_scalars(table, self.label_col, xd.device)
                y = y.to(xd.dtype)
            model = self._fit_device(xd, y)
            if model is not None:
                return model
            return self._fit_device_unique(columnar.joined(xd),
                                           columnar.joined(y))
        x = xd
        y = table.scalars(self.label_col, np.float64)
        n, d = x.shape
        labels, y_idx = np.unique(y, return_inverse=True)
        num_labels = len(labels)
        doc_counts = np.bincount(y_idx, minlength=num_labels).astype(
            np.float64)

        def per_dim():
            # vectorized counting: one unique per feature column, then
            # one (label, value) bincount — L·d sub-array uniques become
            # d passes
            for j in range(d):
                vals, codes = np.unique(x[:, j], return_inverse=True)
                nv = len(vals)
                counts = np.bincount(y_idx * nv + codes,
                                     minlength=num_labels * nv) \
                    .reshape(num_labels, nv)
                yield vals.tolist(), counts

        return self._finalize(per_dim(), doc_counts, labels, n, d)
