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

The input moves to the device once, split by rows over the estimator's mesh
(``parallel/``; by default one shard), and each round sums the shards'
partials over the mesh (or, with ``FLINK_ML_TPU_UPDATE_SHARDING=1``, updates
the centroid rows sharded, ``parallel/update_sharding.py``); sharding only
reassociates the sums. The rounds run through the iteration runtime
(``iteration/iteration.py``) with the carry ``(centroids, counts)``: as a
Python loop over device tensors with no host synchronisation until the
final centroids are fetched (``cuda-lloyd``), as K-round segments between
checkpoints (``-segments``), or as host rounds with listeners (``-rounds``);
the same rounds in the same order, so every mode gives the same bits. For
the euclidean measure each round's partials come from the hand-written
``lloyd_partial_sums`` kernel in every mode, host rounds included (where
the JAX package's host rounds use XLA partials), and transform from
``assign_nearest`` (``ops/kernels.py``). The other measures, and shapes
whose tile does not fit a block's shared memory, run plain PyTorch
(``torch-lloyd``), as the JAX package runs them in XLA.

With health telemetry armed (``observability/health.py``) each round also
computes its Frobenius centre shift on the device: the all-device fit and
its segments fetch the shifts with the final centroids (one transfer) and
record the ``centerShift`` series; host rounds take the JAX package's
:meth:`~health.ConvergenceListener.for_centroids`. The JAX package keeps
only the final-state guard in its segment mode; the port records the
series there too, at no extra transfer.
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
from flink_ml_tpu_torch.observability import health as _health
from flink_ml_tpu_torch.observability import meshstats, tracing
from flink_ml_tpu_torch.ops import kernels
from flink_ml_tpu_torch.parallel import collective as C
from flink_ml_tpu_torch.parallel import update_sharding as _upd
from flink_ml_tpu_torch.parallel.mesh import Mesh
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


def _renormalize(sums, counts, centroids):
    """ref CentroidsUpdateAccumulator: the mean of each cluster's rows; an
    empty cluster keeps its position."""
    return torch.where(counts[:, None] > 0,
                       sums / torch.clamp_min(counts[:, None], 1), centroids)


def lloyd_round(partials_fn: Partials, x, v, centroids: torch.Tensor,
                mesh=None, sharded: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd round, the port of ``_lloyd_round_math``: each local
    shard's [weighted sums | counts] (``x`` and ``v`` are lists of the
    shards' rows and weights, or one shard's tensors), their sum over the
    mesh, then the renormalization. With ``sharded`` the centroid update is
    cross-replica sharded: the (k, d+1) partials reduce-scatter over
    centroid rows padded to the shard multiple (padded rows count 0), each
    shard renormalizes its own rows, and the centroids all-gather and are
    trimmed to k. Each shard's partials are followed by its ready mark
    (``meshstats.mark_shard_ready``, armed only)."""
    if isinstance(x, torch.Tensor):
        x, v = [x], [v]
    mesh = mesh if mesh is not None else Mesh([centroids.device])
    parts = []
    for s, xs, vs in zip(mesh.local_shards, x, v):
        parts.append(partials_fn(xs, vs, centroids.to(xs.device)))
        meshstats.mark_shard_ready(mesh, s, parts[-1])
    if not sharded:
        packed = C.sum_shards(parts, mesh)
        sums, counts = packed[:, :-1], packed[:, -1]
        return _renormalize(sums, counts, centroids), counts
    stack = C.stack_shards(mesh, parts)
    k = centroids.shape[0]
    kp = _upd.padded_len(k, mesh.size)

    def apply_fn(p_slice, c_slice, _state):
        sums, counts = p_slice[:, :-1], p_slice[:, -1]
        return (_renormalize(sums, counts, c_slice), counts[:, None]), None

    (new_c, counts_col), _ = _upd.sharded_apply(
        mesh, _upd.pad_leading(stack, kp, dim=1),
        _upd.pad_leading(centroids, kp), None, apply_fn)
    return new_c[:k], counts_col[:k, 0]


def initial_centroids(x, k: int, seed: int,
                      device: Optional[torch.device] = None) -> torch.Tensor:
    """k distinct random rows of x (a tensor or a host array; ref
    selectRandomCentroids), drawn with numpy's ``default_rng(seed).choice``
    as the JAX package draws them, float32 on ``device`` (default: x's);
    with fewer rows than clusters the rows repeat cyclically."""
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=min(k, n), replace=False)
    if len(idx) < k:
        idx = np.resize(idx, k)
    if isinstance(x, torch.Tensor):
        rows = x[torch.as_tensor(idx, device=x.device)]
    else:
        rows = torch.as_tensor(np.asarray(x)[idx])
    return rows.to(device=device or rows.device,
                   dtype=torch.float32).clone()


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
        mesh = self.mesh
        features = table.vectors(self.features_col)
        rows = C.ensure_on_mesh(mesh, features)
        if tracing.tracer.enabled:
            # mesh telemetry at the fit boundary: per-shard row counts and
            # non-finite input counts, so a bad shard is identifiable
            # before the fit consumes it
            meshstats.record_shard_rows(mesh, rows.n)
            meshstats.record_input_health("KMeans", mesh, rows)
        x = rows.parts
        device = x[0].device
        dim = x[0].shape[1]
        k = self.k
        v = C.ones_on_mesh(mesh, rows.n).parts
        # the cross-replica sharded centroid update (update_sharding.py);
        # the carry stays (k, d) either way
        sharded = _upd.enabled()

        if (self.distance_measure == "euclidean"
                and kernels.lloyd_kernel_fits(k, dim)):
            partials_fn = kernels.lloyd_partial_sums
            path = "cuda-lloyd" if device.type == "cuda" else "torch-lloyd"
        else:
            partials_fn = _measure_partials(
                DistanceMeasure.get_instance(self.distance_measure))
            path = "torch-lloyd"

        config, listeners = self._iteration_config, self._iteration_listeners
        seg = iteration.device_checkpoint_segment(config, listeners)
        host_rounds = not seg and iteration.needs_host_loop(config, listeners)
        health_on = _health.armed()
        # armed, every device-mode round's centre shift: (epoch, 0-dim
        # tensor) pairs, fetched with the final centroids
        shifts = [] if health_on and not host_rounds else None

        def body(carry, epoch):
            centroids, _ = carry
            new = lloyd_round(partials_fn, x, v, centroids, mesh, sharded)
            if shifts is not None:
                shifts.append((epoch, torch.linalg.vector_norm(
                    new[0] - centroids)))
            return new

        if seg:
            path += "-segments"
        elif host_rounds:
            path += "-rounds"
        # a fresh carry per attempt, the JAX package's leaves: (centroids
        # (k, d) f32, counts (k,) f32); the rounds never update it in place
        init = (initial_centroids(features, k, self.get_seed_or_default(),
                                  device),
                torch.zeros(k, dtype=torch.float32, device=device))
        if health_on and host_rounds:
            listeners = tuple(listeners) + (
                _health.ConvergenceListener.for_centroids("KMeans", init[0]),)
        centroids, counts = iteration.iterate_bounded(
            init, body, max_iter=self.max_iter, config=config,
            listeners=listeners)
        # benchmark provenance (runner.py executionPath)
        self.last_execution_path = path

        # per-replica update-state accounting (benchmark provenance): the
        # centroid carry is all-gathered every round, so it is full size
        _upd.record_state_bytes("KMeans", (centroids, counts), mesh.size,
                                sharded)
        # the one host synchronisation of the fit (the shifts ride along)
        parts = [centroids.flatten(), counts]
        if shifts:
            parts.append(torch.stack([shift for _, shift in shifts]))
        final = torch.cat(parts).cpu().numpy().astype(np.float64)
        centroids = final[:k * dim].reshape(k, dim)
        counts = final[k * dim:k * dim + k]
        if not health_on:
            _health.guard_final_state("KMeans", centroids)
        elif shifts is not None:
            s = final[k * dim + k:]
            _health.check_fit("KMeans", {"centerShift": s},
                              finite=bool(np.isfinite(s).all()),
                              epoch0=shifts[0][0] if shifts else 0)
        model = KMeansModel(centroids=centroids, weights=counts,
                            device=self._device)
        return self.copy_params_to(model)
