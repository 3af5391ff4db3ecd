"""Carries model state from the JAX package into the port.

The JAX package's model state, given as numpy arrays (for example
``model.centroids`` and ``model.weights`` of its ``KMeansModel``, the
``coefficients`` of a linear model, the cached ``features`` and ``labels`` of
a ``KnnModel``, the ``coefficients`` and ``model_version`` of an FTRL
model, the per-dimension statistics of a scaler model, the selected
``indices`` of a selector model, or the ``theta``, ``pi``, ``labels`` and
``floors`` of a ``NaiveBayesModel``), becomes the port's model, so that
both packages compute on the same model. Saved models cross the packages
through ``utils/io.py`` instead.
"""

from __future__ import annotations

import numpy as np

from flink_ml_tpu_torch.device import DeviceLike
from flink_ml_tpu_torch.models.classification.knn import KnnModel
from flink_ml_tpu_torch.models.classification.naivebayes import NaiveBayesModel
from flink_ml_tpu_torch.models.clustering.kmeans import KMeansModel
from flink_ml_tpu_torch.models.common import LinearModelBase
from flink_ml_tpu_torch.models.feature.scalers import (
    MaxAbsScalerModel,
    MinMaxScalerModel,
    RobustScalerModel,
    StandardScalerModel,
)
from flink_ml_tpu_torch.models.feature.selectors import (
    UnivariateFeatureSelectorModel,
    VarianceThresholdSelectorModel,
)
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


def _stat_model(model_cls, stats: dict, device: DeviceLike, params: dict):
    """A scaler model from its named (d,) statistics arrays."""
    stats = {k: np.asarray(v, np.float64) for k, v in stats.items()}
    shapes = {v.shape for v in stats.values()}
    if len(shapes) != 1 or len(next(iter(shapes))) != 1:
        raise ValueError(f"statistics must be (d,) arrays of one size, got "
                         f"{ {k: v.shape for k, v in stats.items()} }")
    return model_cls(device=device, **stats, **params)


def standard_scaler_model_from_arrays(mean, std, device: DeviceLike = None,
                                      **params) -> StandardScalerModel:
    """A port ``StandardScalerModel`` from (d,) ``mean`` and ``std``;
    ``params`` are its params by name (``with_mean``, ``input_col``, ...)."""
    return _stat_model(StandardScalerModel, {"mean": mean, "std": std},
                       device, params)


def min_max_scaler_model_from_arrays(data_min, data_max,
                                     device: DeviceLike = None,
                                     **params) -> MinMaxScalerModel:
    """A port ``MinMaxScalerModel`` from (d,) ``data_min`` and ``data_max``."""
    return _stat_model(MinMaxScalerModel,
                       {"data_min": data_min, "data_max": data_max},
                       device, params)


def max_abs_scaler_model_from_arrays(max_abs, device: DeviceLike = None,
                                     **params) -> MaxAbsScalerModel:
    """A port ``MaxAbsScalerModel`` from (d,) ``max_abs``."""
    return _stat_model(MaxAbsScalerModel, {"max_abs": max_abs}, device,
                       params)


def robust_scaler_model_from_arrays(medians, ranges,
                                    device: DeviceLike = None,
                                    **params) -> RobustScalerModel:
    """A port ``RobustScalerModel`` from (d,) ``medians`` and ``ranges``."""
    return _stat_model(RobustScalerModel,
                       {"medians": medians, "ranges": ranges}, device, params)


def _selector_indices(indices) -> np.ndarray:
    indices = np.asarray(indices, np.int64)
    if indices.ndim != 1:
        raise ValueError(f"indices must be (k,), got {indices.shape}")
    return indices


def univariate_feature_selector_model_from_arrays(
        indices, device: DeviceLike = None,
        **params) -> UnivariateFeatureSelectorModel:
    """A port ``UnivariateFeatureSelectorModel`` from its selected
    ``indices``."""
    return UnivariateFeatureSelectorModel(
        indices=_selector_indices(indices), device=device, **params)


def variance_threshold_selector_model_from_arrays(
        indices, device: DeviceLike = None,
        **params) -> VarianceThresholdSelectorModel:
    """A port ``VarianceThresholdSelectorModel`` from its selected
    ``indices``."""
    return VarianceThresholdSelectorModel(
        indices=_selector_indices(indices), device=device, **params)


def naive_bayes_model_from_arrays(theta, pi, labels, floors,
                                  device: DeviceLike = None,
                                  **params) -> NaiveBayesModel:
    """A port ``NaiveBayesModel`` from ``theta`` (per label, per dimension,
    a dict of value → log probability), (L,) ``pi`` and ``labels``, and
    (L, d) ``floors`` (the unseen value's log probability)."""
    pi = np.asarray(pi, np.float64)
    labels = np.asarray(labels, np.float64)
    floors = np.asarray(floors, np.float64)
    if (pi.shape != labels.shape or floors.ndim != 2
            or floors.shape[0] != pi.shape[0] or len(theta) != pi.shape[0]):
        raise ValueError(f"pi and labels must be (L,), floors (L, d) and "
                         f"theta L lists, got {pi.shape}, {labels.shape}, "
                         f"{floors.shape} and {len(theta)}")
    theta = [[{float(v): float(lp) for v, lp in m.items()} for m in row]
             for row in theta]
    return NaiveBayesModel(theta=theta, pi=pi, labels=labels, floors=floors,
                           device=device, **params)
