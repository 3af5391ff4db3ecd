"""Shared ``Has*`` param mixins.

The port's copy of ``flink_ml_tpu/params/shared.py``: every mixin of the JAX
package, flink-ml-lib's HasWindows included. The names, descriptions, defaults and validators are
the JAX package's, so the JSON param maps match.
"""

from __future__ import annotations

import zlib

from flink_ml_tpu_torch.params.param import (
    BooleanParam,
    FloatParam,
    IntParam,
    LongParam,
    ParamValidators,
    StringArrayParam,
    StringParam,
    WindowsParam,
    WithParams,
)

__all__ = [
    "HasBatchStrategy", "HasCategoricalCols", "HasDecayFactor",
    "HasDistanceMeasure", "HasElasticNet",
    "HasFeaturesCol", "HasFlatten", "HasGlobalBatchSize", "HasHandleInvalid",
    "HasInputCol", "HasInputCols", "HasLabelCol", "HasLearningRate",
    "HasMaxAllowedModelDelayMs", "HasMaxIter", "HasModelVersionCol",
    "HasMultiClass", "HasNumFeatures", "HasOptimizerMethod", "HasOutputCol", "HasOutputCols",
    "HasPredictionCol", "HasRawPredictionCol", "HasReg", "HasRelativeError",
    "HasSeed", "HasTol", "HasWeightCol", "HasWindows",
]


class HasBatchStrategy(WithParams):
    COUNT_STRATEGY = "count"
    BATCH_STRATEGY = StringParam(
        "batchStrategy", "Strategy to create mini batch from online train data.",
        COUNT_STRATEGY, ParamValidators.in_array(COUNT_STRATEGY))


class HasCategoricalCols(WithParams):
    CATEGORICAL_COLS = StringArrayParam(
        "categoricalCols", "Categorical column names.", (), ParamValidators.not_null())


class HasDecayFactor(WithParams):
    DECAY_FACTOR = FloatParam(
        "decayFactor", "The forgetfulness of the previous centroids.", 0.0,
        ParamValidators.in_range(0, 1))


class HasDistanceMeasure(WithParams):
    DISTANCE_MEASURE = StringParam(
        "distanceMeasure", "Distance measure.", "euclidean",
        ParamValidators.in_array("euclidean", "manhattan", "cosine"))


class HasElasticNet(WithParams):
    ELASTIC_NET = FloatParam(
        "elasticNet", "ElasticNet parameter.", 0.0, ParamValidators.in_range(0.0, 1.0))


class HasFeaturesCol(WithParams):
    FEATURES_COL = StringParam(
        "featuresCol", "Features column name.", "features", ParamValidators.not_null())


class HasFlatten(WithParams):
    FLATTEN = BooleanParam(
        "flatten",
        "If false, the returned table contains only a single row, otherwise, "
        "one row per feature.", False)


class HasGlobalBatchSize(WithParams):
    GLOBAL_BATCH_SIZE = IntParam(
        "globalBatchSize", "Global batch size of training algorithms.", 32,
        ParamValidators.gt(0))


class HasHandleInvalid(WithParams):
    ERROR_INVALID = "error"
    SKIP_INVALID = "skip"
    KEEP_INVALID = "keep"
    HANDLE_INVALID = StringParam(
        "handleInvalid", "Strategy to handle invalid entries.", ERROR_INVALID,
        ParamValidators.in_array(ERROR_INVALID, SKIP_INVALID, KEEP_INVALID))


class HasInputCol(WithParams):
    INPUT_COL = StringParam(
        "inputCol", "Input column name.", "input", ParamValidators.not_null())


class HasInputCols(WithParams):
    INPUT_COLS = StringArrayParam(
        "inputCols", "Input column names.", None, ParamValidators.non_empty_array())


class HasLabelCol(WithParams):
    LABEL_COL = StringParam(
        "labelCol", "Label column name.", "label", ParamValidators.not_null())


class HasLearningRate(WithParams):
    LEARNING_RATE = FloatParam(
        "learningRate", "Learning rate of optimization method.", 0.1,
        ParamValidators.gt(0))


class HasMaxAllowedModelDelayMs(WithParams):
    MAX_ALLOWED_MODEL_DELAY_MS = LongParam(
        "maxAllowedModelDelayMs",
        "The maximum difference allowed between the timestamps of the input "
        "record and the model data that is used to predict that input record.",
        0, ParamValidators.gt_eq(0))


class HasMaxIter(WithParams):
    MAX_ITER = IntParam(
        "maxIter", "Maximum number of iterations.", 20, ParamValidators.gt(0))


class HasModelVersionCol(WithParams):
    MODEL_VERSION_COL = StringParam(
        "modelVersionCol",
        "The name of the column which contains the version of the model data "
        "that the input data is predicted with.", "version")


class HasMultiClass(WithParams):
    MULTI_CLASS = StringParam(
        "multiClass", "Classification type.", "auto",
        ParamValidators.in_array("auto", "binomial", "multinomial"))


class HasNumFeatures(WithParams):
    NUM_FEATURES = IntParam(
        "numFeatures",
        "The number of features. It will be the length of the output vector.",
        262144, ParamValidators.gt(0))


class HasOptimizerMethod(WithParams):
    """The gradient update rule of the SGD family (``ops/optimizer.py``):
    the reference's stateless "sgd", heavy-ball "momentum", or "adam"; the
    stateful rules carry per-coordinate moments through the fit."""

    OPTIMIZER = StringParam(
        "optimizer", "Gradient update rule: sgd, momentum or adam.",
        "sgd", ParamValidators.in_array("sgd", "momentum", "adam"))
    MOMENTUM = FloatParam(
        "momentum", "Heavy-ball decay of the momentum rule.", 0.9,
        ParamValidators.in_range(0.0, 1.0))
    BETA1 = FloatParam(
        "beta1", "Adam first-moment decay.", 0.9,
        ParamValidators.in_range(0.0, 1.0))
    BETA2 = FloatParam(
        "beta2", "Adam second-moment decay.", 0.999,
        ParamValidators.in_range(0.0, 1.0))
    EPSILON = FloatParam(
        "epsilon", "Adam denominator fuzz term.", 1e-8,
        ParamValidators.gt(0))


class HasOutputCol(WithParams):
    OUTPUT_COL = StringParam(
        "outputCol", "Output column name.", "output", ParamValidators.not_null())


class HasOutputCols(WithParams):
    OUTPUT_COLS = StringArrayParam(
        "outputCols", "Output column names.", None, ParamValidators.non_empty_array())


class HasPredictionCol(WithParams):
    PREDICTION_COL = StringParam(
        "predictionCol", "Prediction column name.", "prediction",
        ParamValidators.not_null())


class HasRawPredictionCol(WithParams):
    RAW_PREDICTION_COL = StringParam(
        "rawPredictionCol", "Raw prediction column name.", "rawPrediction")


class HasReg(WithParams):
    REG = FloatParam(
        "reg", "Regularization parameter.", 0.0, ParamValidators.gt_eq(0.0))


class HasRelativeError(WithParams):
    RELATIVE_ERROR = FloatParam(
        "relativeError",
        "The relative target precision for the approximate quantile algorithm.",
        0.001, ParamValidators.in_range(0, 1))


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


class HasTol(WithParams):
    TOL = FloatParam(
        "tol", "Convergence tolerance for iterative algorithms.", 1e-6,
        ParamValidators.gt_eq(0))


class HasWeightCol(WithParams):
    WEIGHT_COL = StringParam("weightCol", "Weight column name.", None)


def _global_windows_default():
    from flink_ml_tpu_torch.common.window import GlobalWindows
    return GlobalWindows.get_instance()


class HasWindows(WithParams):
    """Ref: flink-ml-lib/.../common/param/HasWindows.java:30 (default GlobalWindows)."""
    WINDOWS = WindowsParam(
        "windows", "Windowing strategy that determines how to create "
        "mini-batches from input data.", _global_windows_default())
