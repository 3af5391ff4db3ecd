"""Shared ``Has*`` param mixins.

The port's copy of the mixins from ``flink_ml_tpu/params/shared.py`` that the
ported stages use (KMeans and the benchmark generators). The names,
descriptions, defaults and validators are the JAX package's, so the JSON
param maps match. The other mixins come with the slices that use them.
"""

from __future__ import annotations

import zlib

from flink_ml_tpu_torch.params.param import (
    IntParam,
    LongParam,
    ParamValidators,
    StringParam,
    WithParams,
)

__all__ = [
    "HasDistanceMeasure", "HasFeaturesCol", "HasMaxIter",
    "HasPredictionCol", "HasSeed",
]


class HasDistanceMeasure(WithParams):
    DISTANCE_MEASURE = StringParam(
        "distanceMeasure", "Distance measure.", "euclidean",
        ParamValidators.in_array("euclidean", "manhattan", "cosine"))


class HasFeaturesCol(WithParams):
    FEATURES_COL = StringParam(
        "featuresCol", "Features column name.", "features", ParamValidators.not_null())


class HasMaxIter(WithParams):
    MAX_ITER = IntParam(
        "maxIter", "Maximum number of iterations.", 20, ParamValidators.gt(0))


class HasPredictionCol(WithParams):
    PREDICTION_COL = StringParam(
        "predictionCol", "Prediction column name.", "prediction",
        ParamValidators.not_null())


class HasSeed(WithParams):
    SEED = LongParam("seed", "The random seed.", None)

    def get_seed_or_default(self) -> int:
        """Reference semantics: a null seed means 'pick one' deterministically
        (class-name hash). Stable across processes and hosts — crc32, not
        Python's salted hash() — so both packages pick the same seed."""
        seed = self.get(HasSeed.SEED)
        if seed is None:
            return zlib.crc32(type(self).__name__.encode()) % (2 ** 31)
        return seed
