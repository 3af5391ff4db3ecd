"""Binary classification evaluator.

The port of ``flink_ml_tpu/models/evaluation/binaryclassification.py``
(ref: flink-ml-lib evaluation/binaryclassification/
BinaryClassificationEvaluator.java:79): AUC-ROC, AUC-PR, KS and AUC-Lorenz
over (label, rawPrediction[, weight]) rows, as one sort and a few scans:

- AUC-ROC: the weighted Mann-Whitney statistic with ties counted half
  (the middleAreaUnderROC map);
- PR, KS and Lorenz: one descending-score sweep accumulating trapezoids
  (updateBinaryMetrics: areaUnderPR += ΔTPR·(prec+prec₋₁)/2,
  areaUnderLorenz += ΔposRate·(tpr+tpr₋₁)/2, KS = max|fpr−tpr|).

Host columns are evaluated in float64 numpy, as the JAX package does. When
the score or label column is a tensor, the same sums run in float64 on its
device (only the four metrics come to the host).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.stage import AlgoOperator
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.linalg.vectors import Vector
from flink_ml_tpu_torch.ops import columnar
from flink_ml_tpu_torch.params.param import ParamValidators, StringArrayParam
from flink_ml_tpu_torch.params.shared import (
    HasLabelCol,
    HasRawPredictionCol,
    HasWeightCol,
)


def _host_metrics(scores, labels, weights) -> dict:
    n = len(scores)
    w_pos = weights[labels]
    pos_total = float(w_pos.sum())
    neg_total = float(weights.sum() - pos_total)

    # weighted AUC-ROC: for each positive, the weighted fraction of
    # negatives scored below it (ties count half)
    order = np.argsort(scores, kind="stable")
    s_sorted = scores[order]
    pos_sorted = labels[order].astype(np.float64)
    w_sorted = weights[order]
    w_neg_sorted = w_sorted * (1.0 - pos_sorted)
    # collapse tie groups in one pass: per distinct score, positives count
    # every strictly-lower negative fully and tied negatives half
    starts = np.flatnonzero(
        np.concatenate([[True], s_sorted[1:] != s_sorted[:-1]]))
    grp_pos = np.add.reduceat(w_sorted * pos_sorted, starts)
    grp_neg = np.add.reduceat(w_neg_sorted, starts)
    neg_below = np.concatenate([[0.0], np.cumsum(grp_neg)[:-1]])
    auc_num = float(np.sum(grp_pos * (neg_below + 0.5 * grp_neg)))
    auc_roc = (auc_num / (pos_total * neg_total)
               if pos_total > 0 and neg_total > 0 else float("nan"))

    # weighted descending sweep for PR / KS / Lorenz
    desc = np.argsort(-scores, kind="stable")
    is_pos = labels[desc].astype(np.float64)
    w_desc = weights[desc]
    tp = np.cumsum(w_desc * is_pos)
    fp = np.cumsum(w_desc * (1.0 - is_pos))
    tpr = tp / pos_total if pos_total else np.ones(n)
    fpr = fp / neg_total if neg_total else np.ones(n)
    precision = tp / np.maximum(tp + fp, 1e-300)
    pos_rate = (tp + fp) / float(weights.sum())

    def trapezoid(dx_curve, y_curve, x0, y0):
        xs = np.concatenate([[x0], dx_curve])
        ys = np.concatenate([[y0], y_curve])
        return float(np.sum((xs[1:] - xs[:-1]) * (ys[1:] + ys[:-1]) / 2))

    # the first previous point of updateBinaryMetrics: tpr 0, precision 1,
    # positive rate 0
    return {"roc": auc_roc, "pr": trapezoid(tpr, precision, 0.0, 1.0),
            "lorenz": trapezoid(pos_rate, tpr, 0.0, 0.0),
            "ks": float(np.abs(fpr - tpr).max()) if n else 0.0}


def _device_metrics(scores, labels, weights) -> dict:
    """:func:`_host_metrics` in float64 torch on the tensors' device."""
    n = scores.shape[0]
    f64 = torch.float64
    pos_total = float(weights[labels].sum())
    total = float(weights.sum())
    neg_total = total - pos_total

    order = torch.argsort(scores, stable=True)
    s_sorted = scores[order]
    pos_sorted = labels[order].to(f64)
    w_sorted = weights[order]
    _, group = torch.unique_consecutive(s_sorted, return_inverse=True)
    g = int(group[-1]) + 1
    grp_pos = torch.zeros(g, dtype=f64, device=scores.device).index_add_(
        0, group, w_sorted * pos_sorted)
    grp_neg = torch.zeros(g, dtype=f64, device=scores.device).index_add_(
        0, group, w_sorted * (1.0 - pos_sorted))
    neg_below = torch.cumsum(grp_neg, 0) - grp_neg
    auc_num = float((grp_pos * (neg_below + 0.5 * grp_neg)).sum())
    auc_roc = (auc_num / (pos_total * neg_total)
               if pos_total > 0 and neg_total > 0 else float("nan"))

    desc = torch.argsort(-scores, stable=True)
    is_pos = labels[desc].to(f64)
    w_desc = weights[desc]
    tp = torch.cumsum(w_desc * is_pos, 0)
    fp = torch.cumsum(w_desc * (1.0 - is_pos), 0)
    tpr = tp / pos_total if pos_total else torch.ones_like(tp)
    fpr = fp / neg_total if neg_total else torch.ones_like(fp)
    precision = tp / torch.clamp_min(tp + fp, 1e-300)
    pos_rate = (tp + fp) / total

    def trapezoid(dx_curve, y_curve, x0, y0):
        xs = torch.cat([dx_curve.new_tensor([x0]), dx_curve])
        ys = torch.cat([y_curve.new_tensor([y0]), y_curve])
        return float(((xs[1:] - xs[:-1]) * (ys[1:] + ys[:-1]) / 2).sum())

    return {"roc": auc_roc, "pr": trapezoid(tpr, precision, 0.0, 1.0),
            "lorenz": trapezoid(pos_rate, tpr, 0.0, 0.0),
            "ks": float((fpr - tpr).abs().max()) if n else 0.0}


class BinaryClassificationEvaluator(AlgoOperator, HasLabelCol,
                                    HasRawPredictionCol, HasWeightCol):
    AREA_UNDER_ROC = "areaUnderROC"
    AREA_UNDER_PR = "areaUnderPR"
    KS = "ks"
    AREA_UNDER_LORENZ = "areaUnderLorenz"

    METRICS_NAMES = StringArrayParam(
        "metricsNames", "Names of output metrics.",
        (AREA_UNDER_ROC, AREA_UNDER_PR),
        ParamValidators.is_sub_set(AREA_UNDER_ROC, AREA_UNDER_PR, KS,
                                   AREA_UNDER_LORENZ))

    def _scores(self, table: Table):
        col = columnar.joined(table.column(self.raw_prediction_col))
        if isinstance(col, torch.Tensor):
            return col[:, -1] if col.ndim == 2 else col
        if col.dtype == object:
            first = col[0]
            if isinstance(first, Vector) or hasattr(first, "__len__"):
                # vector rawPrediction: probability of the positive class
                return np.asarray(
                    [(v.to_array()[-1] if isinstance(v, Vector)
                      else np.asarray(v)[-1]) for v in col], np.float64)
        arr = np.asarray(col, np.float64)
        return arr[:, -1] if arr.ndim == 2 else arr

    def transform(self, table: Table) -> Tuple[Table]:
        scores = self._scores(table)
        labels = columnar.joined(table.column(self.label_col))
        n = len(scores)
        if n == 0:
            raise ValueError("empty input")
        weights = (columnar.joined(table.column(self.weight_col))
                   if self.weight_col is not None and self.weight_col in table
                   else None)
        if isinstance(scores, torch.Tensor) or \
                isinstance(labels, torch.Tensor):
            device = (scores if isinstance(scores, torch.Tensor)
                      else labels).device

            def on_device(a):
                return torch.as_tensor(a, device=device).to(torch.float64)

            values = _device_metrics(
                on_device(scores), on_device(labels) > 0.5,
                on_device(weights) if weights is not None else
                torch.ones(n, dtype=torch.float64, device=device))
        else:
            values = _host_metrics(
                scores, table.scalars(self.label_col, np.float64) > 0.5,
                table.scalars(self.weight_col, np.float64)
                if weights is not None else np.ones(n))
        keyed = {self.AREA_UNDER_ROC: values["roc"],
                 self.AREA_UNDER_PR: values["pr"], self.KS: values["ks"],
                 self.AREA_UNDER_LORENZ: values["lorenz"]}
        return (Table.from_columns(**{
            name: np.asarray([keyed[name]], np.float64)
            for name in self.metrics_names}),)
