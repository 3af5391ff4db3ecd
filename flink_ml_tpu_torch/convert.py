"""Carries model state from the JAX package into the port.

The JAX package's model state, given as numpy arrays (for example
``model.centroids`` and ``model.weights`` of its ``KMeansModel``, the
``coefficients`` of a linear model, the cached ``features`` and ``labels`` of
a ``KnnModel``, or the ``coefficients`` and ``model_version`` of an FTRL
model), becomes the port's model, so that both packages compute on the same
model. Saved models cross the packages through
``utils/io.py`` instead.
"""

from __future__ import annotations

import numpy as np

from flink_ml_tpu_torch.device import DeviceLike
from flink_ml_tpu_torch.models.classification.knn import KnnModel
from flink_ml_tpu_torch.models.clustering.kmeans import KMeansModel
from flink_ml_tpu_torch.models.common import LinearModelBase
from flink_ml_tpu_torch.models.online import OnlineLogisticRegressionModel


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


def linear_model_from_arrays(model_cls, coefficients,
                             device: DeviceLike = None,
                             **params) -> LinearModelBase:
    """A port linear model of class ``model_cls`` (for example
    ``LogisticRegressionModel``) from (d,) coefficients; ``params`` are its
    params by name (``threshold``, ``prediction_col``, ...)."""
    if not (isinstance(model_cls, type)
            and issubclass(model_cls, LinearModelBase)):
        raise TypeError(f"{model_cls!r} is not a linear model class of the port")
    coefficients = np.asarray(coefficients, np.float64)
    if coefficients.ndim != 1:
        raise ValueError(f"coefficients must be (d,), got {coefficients.shape}")
    return model_cls(coefficients=coefficients, device=device, **params)


def knn_model_from_arrays(features, labels, device: DeviceLike = None,
                          **params) -> KnnModel:
    """A port ``KnnModel`` from its (n_train, d) train rows and (n_train,)
    labels; ``params`` are its params by name (``k``, ``features_col``,
    ...)."""
    features = np.asarray(features, np.float64)
    labels = np.asarray(labels, np.float64)
    if features.ndim != 2 or labels.shape != (features.shape[0],):
        raise ValueError(f"features must be (n, d) and labels (n,), got "
                         f"{features.shape} and {labels.shape}")
    return KnnModel(features=features, labels=labels, device=device, **params)


def online_lr_model_from_arrays(coefficients, model_version: int = 0,
                                device: DeviceLike = None,
                                **params) -> OnlineLogisticRegressionModel:
    """A port ``OnlineLogisticRegressionModel`` from (d,) coefficients and
    the model version; ``params`` are its params by name."""
    coefficients = np.asarray(coefficients, np.float64)
    if coefficients.ndim != 1:
        raise ValueError(f"coefficients must be (d,), got {coefficients.shape}")
    return OnlineLogisticRegressionModel(
        coefficients=coefficients, model_version=model_version, device=device,
        **params)
