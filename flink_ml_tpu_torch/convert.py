"""Carries model state from the JAX package into the port.

The JAX package's model state, given as numpy arrays (for example
``model.centroids`` and ``model.weights`` of its ``KMeansModel``), becomes
the port's model, so that both packages compute on the same model. Saved
models cross the packages through ``utils/io.py`` instead.
"""

from __future__ import annotations

import numpy as np

from flink_ml_tpu_torch.device import DeviceLike
from flink_ml_tpu_torch.models.clustering.kmeans import KMeansModel


def kmeans_model_from_arrays(centroids, weights, device: DeviceLike = None,
                             **params) -> KMeansModel:
    """A port ``KMeansModel`` from (k, d) centroids and (k,) weights;
    ``params`` are its params by name (``k``, ``distance_measure``, ...)."""
    centroids = np.asarray(centroids, np.float64)
    weights = np.asarray(weights, np.float64)
    if centroids.ndim != 2 or weights.shape != (centroids.shape[0],):
        raise ValueError(f"centroids must be (k, d) and weights (k,), got "
                         f"{centroids.shape} and {weights.shape}")
    return KMeansModel(centroids=centroids, weights=weights, device=device,
                       **params)
