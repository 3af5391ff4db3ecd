"""K-nearest-neighbors classifier.

The port of ``flink_ml_tpu/models/classification/knn.py`` (ref:
flink-ml-lib/.../classification/knn/{Knn.java, KnnModel.java,
KnnModelData.java}): fit caches the train matrix and labels; predict finds
the k nearest train rows of every test row by ‖t‖² − 2·x·t and takes the
majority vote of their labels, ties to the smallest label.

On the card the neighbours come from the hand-written ``knn_topk_indices``
kernel (``ops/kernels.py``), for every k and width, which never forms the
(n, n_train) distance matrix: ``cuda-knn``. On the CPU the plain PyTorch
version runs over chunks of test rows whose distance block stays under
``_MAX_DIST_ELEMS``: ``torch-knn`` (the full matrix of the benchmark would
be 2 TB).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.api.stage import Estimator, Model
from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.ops import columnar, kernels
from flink_ml_tpu_torch.params.param import IntParam, ParamValidators
from flink_ml_tpu_torch.params.shared import (
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
)
from flink_ml_tpu_torch.utils import io as rw


class KnnModelParams(HasFeaturesCol, HasPredictionCol):
    K = IntParam("k", "The number of nearest neighbors.", 5,
                 ParamValidators.gt(0))


class KnnParams(KnnModelParams, HasLabelCol):
    pass


#: bound on the (chunk, n_train) distance block one plain call may hold
_MAX_DIST_ELEMS = 64 << 20


def _vote(idx: torch.Tensor, label_idx: torch.Tensor,
          num_classes: int) -> torch.Tensor:
    """Majority vote over neighbour indices (n, k) → (n,) class indices;
    ``argmax`` takes the first maximum, so ties go to the smallest label.
    Counts are integers, so their scatter is exact in any order."""
    labels = label_idx[idx.long()]
    votes = torch.zeros((idx.shape[0], num_classes), dtype=torch.int32,
                        device=idx.device)
    votes.scatter_add_(1, labels, torch.ones_like(labels, dtype=torch.int32))
    return torch.argmax(votes, dim=1)


def _knn_predict(x, train, label_idx, classes, k: int):
    """The (n,) float64 predicted labels of the rows ``x``: the k nearest
    train rows' majority vote."""
    x = x.to(torch.float32).contiguous()
    train = train.contiguous()
    n, n_train = x.shape[0], train.shape[0]
    k = min(k, n_train)
    if x.device.type == "cuda":
        # fused distance + top-k over the whole batch
        chunk, topk = max(n, 1), kernels.knn_topk_indices
    else:
        # memory-bounded: no (chunk, n_train) block past _MAX_DIST_ELEMS
        chunk = max(1, _MAX_DIST_ELEMS // max(n_train, 1))
        topk = kernels.knn_topk_indices_plain
    parts = [_vote(topk(x[s:s + chunk], train, k), label_idx, len(classes))
             for s in range(0, n, chunk)]
    pred_idx = (torch.cat(parts) if parts
                else torch.zeros(0, dtype=torch.int64, device=x.device))
    return classes[pred_idx]


class KnnModel(Model, KnnModelParams):
    def __init__(self, features: Optional[np.ndarray] = None,
                 labels: Optional[np.ndarray] = None, **kwargs):
        super().__init__(**kwargs)
        self.features = None if features is None else np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)
        self.last_execution_path = None

    def transform(self, table: Table) -> Tuple[Table]:
        """Adds the prediction column: (n,) float64 labels, a tensor on this
        model's device."""
        if self.features is None:
            raise ValueError("KnnModel has no model data")
        classes, label_idx = np.unique(self.labels, return_inverse=True)
        # where the feature column goes (ops/columnar.py): one tensor on
        # this model's device, or once a shard of a split column, the
        # predictions split alike; the train rows on each shard's device
        pred = columnar.apply(
            _knn_predict, table.vectors(self.features_col),
            (torch.as_tensor(self.features, dtype=torch.float32),
             torch.as_tensor(label_idx.reshape(-1)),
             torch.as_tensor(classes, dtype=torch.float64)),
            (int(self.k),), self.device)
        # benchmark provenance (runner.py executionPath)
        self.last_execution_path = ("cuda-knn" if pred.device.type == "cuda"
                                    else "torch-knn")
        return (table.with_column(self.prediction_col, pred),)

    def set_model_data(self, model_data: Table):
        self.features = model_data.vectors("packedFeatures", np.float64)
        self.labels = model_data.scalars("labels", np.float64)
        return self

    def get_model_data(self) -> Tuple[Table]:
        return (Table.from_columns(
            packedFeatures=np.asarray(self.features, np.float64),
            labels=np.asarray(self.labels, np.float64)),)

    def _save_extra(self, path: str) -> None:
        rw.save_model_arrays(path, "model", {
            "features": self.features, "labels": self.labels})

    def _load_extra(self, path: str, meta: dict) -> None:
        arrays = rw.load_model_arrays(path, "model")
        self.features, self.labels = arrays["features"], arrays["labels"]


class Knn(Estimator, KnnParams):
    """Fit caches the training data: the model is the data (ref: Knn.java)."""

    def fit(self, table: Table) -> KnnModel:
        model = KnnModel(features=table.vectors(self.features_col, np.float64),
                         labels=table.scalars(self.label_col, np.float64),
                         device=self._device)
        return self.copy_params_to(model)
