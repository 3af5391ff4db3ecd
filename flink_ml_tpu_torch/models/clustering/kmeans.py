"""K-means clustering (Lloyd's algorithm).

The port of ``flink_ml_tpu/models/clustering/kmeans.py`` (ref:
flink-ml-lib/.../clustering/kmeans/{KMeans.java:79, KMeansModel.java,
KMeansModelData.java, KMeansParams.java}):

- init: k distinct random input rows, drawn on the host with numpy from the
  seed exactly as the JAX package draws them (selectRandomCentroids);
- per round: assign every row to the nearest centroid; the new centroid is
  the mean of its rows, and the model weights are the assignment counts;
  an empty cluster keeps its previous centroid instead of becoming NaN;
- termination: maxIter rounds (TerminateOnMaxIter);
- predict: nearest-centroid index.

The input moves to the device once; the rounds run through the iteration
runtime (``iteration/iteration.py``) with the carry ``(centroids, counts)``:
as a Python loop over device tensors with no host synchronisation until the
final centroids are fetched (``cuda-lloyd``), as K-round segments between
checkpoints (``-segments``), or as host rounds with listeners (``-rounds``);
the same rounds in the same order, so every mode gives the same bits. For
the euclidean measure each round's partials come from the hand-written
``lloyd_partial_sums`` kernel in every mode, host rounds included (where
the JAX package's host rounds use XLA partials), and transform from
``assign_nearest`` (``ops/kernels.py``). The other measures, and shapes
whose tile does not fit a block's shared memory, run plain PyTorch
(``torch-lloyd``), as the JAX package runs them in XLA.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from flink_ml_tpu_torch.api.stage import Estimator, Model
from flink_ml_tpu_torch.common.table import Table, as_dense_vector_column
from flink_ml_tpu_torch.iteration import iteration
from flink_ml_tpu_torch.linalg.distance import DistanceMeasure
from flink_ml_tpu_torch.models.common import IterationRuntimeMixin
from flink_ml_tpu_torch.observability.health import guard_final_state
from flink_ml_tpu_torch.ops import kernels
from flink_ml_tpu_torch.params.param import IntParam, ParamValidators, StringParam
from flink_ml_tpu_torch.params.shared import (
    HasDistanceMeasure,
    HasFeaturesCol,
    HasMaxIter,
    HasPredictionCol,
    HasSeed,
)
from flink_ml_tpu_torch.utils import io as rw

Partials = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class KMeansModelParams(HasDistanceMeasure, HasFeaturesCol, HasPredictionCol):
    K = IntParam("k", "The max number of clusters to create.", 2,
                 ParamValidators.gt(1))


class KMeansParams(KMeansModelParams, HasSeed, HasMaxIter):
    INIT_MODE = StringParam(
        "initMode", "The initialization algorithm.", "random",
        ParamValidators.in_array("random"))


def _on_device(x, device: torch.device) -> torch.Tensor:
    """Features as a contiguous float32 tensor on ``device``: host arrays are
    placed once; a tensor already there is used as it is."""
    return torch.as_tensor(x, dtype=torch.float32, device=device).contiguous()


def _measure_partials(measure: DistanceMeasure) -> Partials:
    """Plain PyTorch partials for any measure (the JAX package's
    ``local_partials``)."""

    def partials(x, v, centroids):
        k = centroids.shape[0]
        a = torch.argmin(measure.pairwise(x, centroids), dim=1)
        one_hot = F.one_hot(a, k).to(x.dtype) * v[:, None]
        return torch.cat([one_hot.T @ x, one_hot.sum(0)[:, None]], dim=1)

    return partials


def lloyd_round(partials_fn: Partials, x: torch.Tensor, v: torch.Tensor,
                centroids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd round — the port's ``_lloyd_round_math``: the local
    [weighted sums | counts], then the renormalization in which an empty
    cluster keeps its position (ref CentroidsUpdateAccumulator)."""
    packed = partials_fn(x, v, centroids)
    sums, counts = packed[:, :-1], packed[:, -1]
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp_min(counts[:, None], 1), centroids)
    return new, counts


def initial_centroids(x: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """k distinct random rows of x (ref selectRandomCentroids), drawn with
    numpy's ``default_rng(seed).choice`` as the JAX package draws them; with
    fewer rows than clusters the rows repeat cyclically."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=min(k, n), replace=False)
    if len(idx) < k:
        idx = np.resize(idx, k)
    return x[torch.as_tensor(idx, device=x.device)].clone()


class KMeansModel(Model, KMeansModelParams):
    def __init__(self, centroids: Optional[np.ndarray] = None,
                 weights: Optional[np.ndarray] = None, **kwargs):
        super().__init__(**kwargs)
        self.centroids = None if centroids is None else np.asarray(centroids)
        self.weights = None if weights is None else np.asarray(weights)
        self.last_execution_path = None

    def transform(self, table: Table) -> Tuple[Table]:
        """Adds the prediction column: (n,) int64 labels, a tensor on this
        model's device."""
        if self.centroids is None:
            raise ValueError("KMeansModel has no model data")
        device = self.device
        x = _on_device(table.vectors(self.features_col), device)
        c = _on_device(self.centroids, device)
        if (self.distance_measure == "euclidean"
                and kernels.assign_kernel_fits(c.shape[0], c.shape[1])):
            # fused distance + argmin: no (n, k) distances in device memory
            labels = kernels.assign_nearest(x, c)
            path = "cuda-assign" if device.type == "cuda" else "torch-assign"
        else:
            measure = DistanceMeasure.get_instance(self.distance_measure)
            labels = torch.argmin(measure.pairwise(x, c), dim=1)
            path = "torch-assign"
        # benchmark provenance (runner.py executionPath)
        self.last_execution_path = path
        return (table.with_column(self.prediction_col, labels.to(torch.int64)),)

    # -- model data (ref: KMeansModelData = centroids[] + weights) ----------
    def set_model_data(self, model_data: Table):
        cents = model_data.vectors("centroid", dtype=np.float64)
        self.centroids = cents
        self.weights = (model_data.scalars("weight", np.float64)
                        if "weight" in model_data
                        else np.ones(len(cents)))
        return self

    def get_model_data(self) -> Tuple[Table]:
        return (Table.from_columns(
            centroid=as_dense_vector_column(self.centroids),
            weight=np.asarray(self.weights, np.float64)),)

    def _save_extra(self, path: str) -> None:
        rw.save_model_arrays(path, "model", {
            "centroids": self.centroids, "weights": self.weights})

    def _load_extra(self, path: str, meta: dict) -> None:
        arrays = rw.load_model_arrays(path, "model")
        self.centroids, self.weights = arrays["centroids"], arrays["weights"]


class KMeans(Estimator, KMeansParams, IterationRuntimeMixin):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.last_execution_path = None

    def fit(self, table: Table) -> KMeansModel:
        return self._supervised_fit(lambda: self._fit_once(table))

    def _fit_once(self, table: Table) -> KMeansModel:
        device = self.device
        x = _on_device(table.vectors(self.features_col), device)
        n, dim = x.shape
        k = self.k
        v = torch.ones(n, dtype=torch.float32, device=device)

        if (self.distance_measure == "euclidean"
                and kernels.lloyd_kernel_fits(k, dim)):
            partials_fn = kernels.lloyd_partial_sums
            path = "cuda-lloyd" if device.type == "cuda" else "torch-lloyd"
        else:
            partials_fn = _measure_partials(
                DistanceMeasure.get_instance(self.distance_measure))
            path = "torch-lloyd"

        def body(carry, epoch):
            centroids, _ = carry
            return lloyd_round(partials_fn, x, v, centroids)

        config, listeners = self._iteration_config, self._iteration_listeners
        if iteration.device_checkpoint_segment(config, listeners):
            path += "-segments"
        elif iteration.needs_host_loop(config, listeners):
            path += "-rounds"
        # a fresh carry per attempt, the JAX package's leaves: (centroids
        # (k, d) f32, counts (k,) f32); the rounds never update it in place
        init = (initial_centroids(x, k, self.get_seed_or_default()),
                torch.zeros(k, dtype=torch.float32, device=device))
        centroids, counts = iteration.iterate_bounded(
            init, body, max_iter=self.max_iter, config=config,
            listeners=listeners)
        # benchmark provenance (runner.py executionPath)
        self.last_execution_path = path

        # the one host synchronisation of the fit
        centroids = centroids.cpu().numpy().astype(np.float64)
        counts = counts.cpu().numpy().astype(np.float64)
        guard_final_state("KMeans", centroids)
        model = KMeansModel(centroids=centroids, weights=counts,
                            device=self._device)
        return self.copy_params_to(model)
