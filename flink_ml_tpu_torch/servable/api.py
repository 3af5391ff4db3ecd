"""Servable API: DataFrame / Row / TransformerServable / ModelServable.

The port of ``flink_ml_tpu/servable/api.py`` (ref: servable/api/
DataFrame.java:33 (addColumn:100, collect:119), Row.java,
TransformerServable.java, ModelServable.java, servable/types/
DataTypes.java). Pure host code: the frames hold Python rows, and a
servable's ``transform`` decides where its arithmetic runs.
"""

from __future__ import annotations

import enum
import functools
import logging
import time
from typing import Any, List, Optional, Sequence


class RejectedRequest(Exception):
    """A serving request was shed by admission control (serving/
    batcher.py): its deadline expired before dispatch, the queue was
    full, or its shape doesn't fit the bucket table. Carries the
    servable name and a machine-readable ``reason`` so the
    ``rejected{servable=,reason=}`` windowed counter (observability/
    health.py) can distinguish shed load from real errors — a loadgen
    SLO verdict must not count deliberate load-shedding against the
    error budget."""

    def __init__(self, servable: str, reason: str, detail: str = ""):
        self.servable = servable
        self.reason = reason
        tail = f": {detail}" if detail else ""
        super().__init__(
            f"request rejected by {servable} ({reason}){tail}")


def serving_name(servable) -> str:
    """The name a servable's telemetry is labeled with: the deployed
    ``serving_name`` attribute when the model registry (serving/
    registry.py) set one (``<model>@v<N>``), else the class name — so
    span attrs, latency histograms and SLO verdicts distinguish model
    versions, not just servable classes."""
    return (getattr(servable, "serving_name", None)
            or type(servable).__name__)


class BasicType(enum.Enum):
    """Ref: servable/types/BasicType.java."""
    BOOLEAN = "boolean"
    BYTE = "byte"
    SHORT = "short"
    INT = "int"
    LONG = "long"
    FLOAT = "float"
    DOUBLE = "double"
    STRING = "string"


class DataType:
    def __init__(self, basic: BasicType, shape: str = "scalar"):
        self.basic = basic
        self.shape = shape  # scalar | vector | matrix

    def __repr__(self):
        return f"DataType({self.basic.value}, {self.shape})"

    def __eq__(self, other):
        return (isinstance(other, DataType) and self.basic == other.basic
                and self.shape == other.shape)


class DataTypes:
    """Ref: servable/types/DataTypes.java factory constants."""
    BOOLEAN = DataType(BasicType.BOOLEAN)
    INT = DataType(BasicType.INT)
    LONG = DataType(BasicType.LONG)
    FLOAT = DataType(BasicType.FLOAT)
    DOUBLE = DataType(BasicType.DOUBLE)
    STRING = DataType(BasicType.STRING)

    @staticmethod
    def vector(basic: BasicType = BasicType.DOUBLE) -> DataType:
        return DataType(basic, "vector")

    @staticmethod
    def matrix(basic: BasicType = BasicType.DOUBLE) -> DataType:
        return DataType(basic, "matrix")


class Row:
    """Ref: servable/api/Row.java — positional values with add/get/set."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def get(self, index: int):
        return self.values[index]

    def get_as(self, index: int, _type=None):
        return self.values[index]

    def set(self, index: int, value) -> "Row":
        self.values[index] = value
        return self

    def add(self, value) -> "Row":
        self.values.append(value)
        return self

    def size(self) -> int:
        return len(self.values)

    def __eq__(self, other):
        return isinstance(other, Row) and self.values == other.values

    def __repr__(self):
        return f"Row({self.values})"


class _Column:
    def __init__(self, name, dtype, values):
        self.name = name
        self.dtype = dtype
        self.values = values


class DataFrame:
    """Ref: servable/api/DataFrame.java:33 — in-memory rows + schema."""

    def __init__(self, column_names: List[str],
                 data_types: List[DataType], rows: List[Row]):
        if len(column_names) != len(data_types):
            raise ValueError("columnNames and dataTypes must align")
        for row in rows:
            if row.size() != len(column_names):
                raise ValueError("row arity does not match schema")
        self._names = list(column_names)
        self._types = list(data_types)
        self._rows = list(rows)

    @property
    def column_names(self) -> List[str]:
        return list(self._names)

    @property
    def data_types(self) -> List[DataType]:
        return list(self._types)

    def get_index(self, name: str) -> int:
        try:
            return self._names.index(name)
        except ValueError:
            raise ValueError(f"no column {name!r}; available {self._names}")

    def get_data_type(self, name: str) -> DataType:
        return self._types[self.get_index(name)]

    def add_column(self, name: str, dtype: DataType,
                   values: Sequence[Any]) -> "DataFrame":
        """Ref: DataFrame.addColumn:100 — appends a column in place."""
        if len(values) != len(self._rows):
            raise ValueError("column length must equal number of rows")
        self._names.append(name)
        self._types.append(dtype)
        for row, v in zip(self._rows, values):
            row.add(v)
        return self

    def get(self, name: str) -> "_Column":
        idx = self.get_index(name)
        return _Column(name, self._types[idx],
                       [row.get(idx) for row in self._rows])

    def collect(self) -> List[Row]:
        """Ref: DataFrame.collect:119."""
        return list(self._rows)

    def num_rows(self) -> int:
        return len(self._rows)


def _served(method):
    """Wrap a servable ``transform`` with the live serving telemetry
    (observability/health.py; docs/observability.md "Live telemetry &
    SLOs"): windowed latency + row-count histograms and a
    prediction-distribution summary labeled by servable class — the
    ``MLMetrics`` role of the reference's servable core — feeds the
    windowed live sketches drift detection compares against the
    training-time baseline (observability/drift.py) — plus an
    in-flight gauge, per-exception-class
    error counters (the error-rate SLO input; the exception re-raises
    after being counted), a request-scoped span sampled at
    ``FLINK_ML_TPU_TRACE_SAMPLE``, and a best-effort start of the
    embedded metrics endpoint (``FLINK_ML_TPU_METRICS_PORT``).
    Telemetry failures are logged, never raised: recording must not
    sink a serving call."""

    @functools.wraps(method)
    def wrapper(self, df: DataFrame) -> DataFrame:
        servable = serving_name(self)
        log = logging.getLogger(__name__)
        span_cm, entered = None, False
        try:
            from flink_ml_tpu_torch.observability import (health, server,
                                                          tracing)

            server.maybe_start()
            health.serving_inflight(servable, +1)
            entered = True
            if tracing.tracer.active and health.trace_sampled():
                rows_in = df.num_rows() if isinstance(df, DataFrame) \
                    else 0
                span_cm = tracing.tracer.span(
                    "serving.request", servable=servable,
                    rows_in=rows_in)
        except Exception:  # noqa: BLE001 — see docstring
            span_cm = None
            log.warning("serving telemetry setup failed", exc_info=True)
        start = time.perf_counter()
        try:
            if span_cm is not None:
                with span_cm:
                    out = method(self, df)
            else:
                out = method(self, df)
        except Exception as e:
            elapsed_ms = (time.perf_counter() - start) * 1000.0
            try:
                from flink_ml_tpu_torch.observability import health

                if isinstance(e, RejectedRequest):
                    # shed load is not an error: admission failures get
                    # their own windowed counter so SLO error budgets
                    # only pay for real failures
                    health.observe_serving_rejected(servable, e.reason)
                else:
                    health.observe_serving_error(servable,
                                                 type(e).__name__,
                                                 elapsed_ms)
            except Exception:  # noqa: BLE001 — see docstring
                log.warning("serving error recording failed",
                            exc_info=True)
            raise
        finally:
            if entered:
                try:
                    from flink_ml_tpu_torch.observability import health

                    health.serving_inflight(servable, -1)
                except Exception:  # noqa: BLE001 — see docstring
                    log.warning("serving in-flight recording failed",
                                exc_info=True)
        elapsed_ms = (time.perf_counter() - start) * 1000.0
        try:
            from flink_ml_tpu_torch.observability import health

            predictions = None
            rows = df.num_rows() if isinstance(df, DataFrame) else 0
            if isinstance(out, DataFrame):
                rows = out.num_rows()
                col = getattr(self, "prediction_col", None)
                if col and col in out.column_names:
                    predictions = out.get(col).values
            health.observe_serving(servable, rows, elapsed_ms,
                                   predictions=predictions)
            # drift: sketch this transform's feature columns +
            # predictions into the servable's windowed live sketches
            # (observability/drift.py) — the live half the training-time
            # baseline is compared against
            from flink_ml_tpu_torch.observability import drift

            # the micro-batcher pads batches by duplicating the tail
            # row and marks the real count — sketch only real rows, or
            # a 1-row request padded to bucket 8 would overweight one
            # sample 8x and inflate the min-count floor
            real = getattr(df, "drift_real_rows", None)
            features = None
            fcol = getattr(self, "features_col", None)
            if (fcol and isinstance(df, DataFrame)
                    and fcol in df.column_names):
                features = df.get(fcol).values
                if real is not None:
                    features = features[:real]
            drift_preds = predictions
            if real is not None and drift_preds is not None:
                drift_preds = list(drift_preds)[:real]
            if features is not None or drift_preds is not None:
                drift.observe_transform(servable, features=features,
                                        predictions=drift_preds)
            # quality: park this request's positive-class scores in the
            # evaluation join ring, keyed by the batcher's per-request
            # ordinals, so record_feedback(request_id, label) can join
            # delayed ground truth back to what was actually served
            from flink_ml_tpu_torch.observability import evaluation

            segments = getattr(df, "request_segments", None)
            if segments and isinstance(out, DataFrame):
                raw_values = None
                rcol = getattr(self, "raw_prediction_col", None)
                if rcol and rcol in out.column_names:
                    raw_values = out.get(rcol).values
                scores = evaluation.positive_scores(
                    raw_values=raw_values, predictions=predictions)
                if scores is not None:
                    evaluation.observe_served(servable, scores,
                                              segments=segments)
        except Exception:  # noqa: BLE001 — see docstring
            logging.getLogger(__name__).warning(
                "serving metrics recording failed", exc_info=True)
        return out

    wrapper._served = True
    return wrapper


class TransformerServable:
    """Ref: servable/api/TransformerServable.java.

    Beyond the reference's interface: every concrete ``transform`` is
    wrapped with the ``ml.serving`` metrics of observability/health.py
    (latency/row histograms + prediction-distribution summary), the
    same pattern api/stage.py applies to Estimator/AlgoOperator."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        impl = cls.__dict__.get("transform")
        if impl is not None and not getattr(impl, "_served", False):
            cls.transform = _served(impl)

    def transform(self, df: DataFrame) -> DataFrame:
        raise NotImplementedError


class ModelServable(TransformerServable):
    """Ref: servable/api/ModelServable.java — loads model data from
    streams/files; ``load(path)`` restores params + model data."""

    def set_model_data(self, *streams) -> "ModelServable":
        raise NotImplementedError

    @classmethod
    def load(cls, path: str) -> "ModelServable":
        raise NotImplementedError
