"""Window specs.

The port's copy of ``flink_ml_tpu/common/window.py`` (ref: flink-ml-core
common/window/*.java, 7 files): GlobalWindows, CountTumblingWindows, the
event- and processing-time tumbling and session windows. They are the value
of the ``windows`` param and tell the online estimators how to cut an
unbounded stream into mini-batches; the host stream loop
(``iteration/streaming.py``) reads them. The JSON codec is the JAX
package's, so a saved ``windows`` param crosses the two packages.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar


@dataclasses.dataclass(frozen=True)
class Windows:
    """Base class; JSON codec mirrors param/WindowsParam.java."""

    kind: ClassVar[str] = "global"

    def to_json(self) -> dict:
        out = {"kind": type(self).kind}
        out.update(dataclasses.asdict(self))
        return out

    @staticmethod
    def from_json(data: dict) -> "Windows":
        kinds = {c.kind: c for c in (
            GlobalWindows, CountTumblingWindows, EventTimeTumblingWindows,
            ProcessingTimeTumblingWindows, EventTimeSessionWindows,
            ProcessingTimeSessionWindows)}
        data = dict(data)
        klass = kinds[data.pop("kind")]
        return klass(**data)


@dataclasses.dataclass(frozen=True)
class GlobalWindows(Windows):
    """One window over the whole (bounded) input."""
    kind: ClassVar[str] = "global"

    @classmethod
    def get_instance(cls) -> "GlobalWindows":
        return cls()  # frozen dataclass: all instances are equal


@dataclasses.dataclass(frozen=True)
class CountTumblingWindows(Windows):
    """Fixed-size count windows (ref: CountTumblingWindows.of(size))."""
    size: int = 1
    kind: ClassVar[str] = "count_tumbling"

    @staticmethod
    def of(size: int) -> "CountTumblingWindows":
        return CountTumblingWindows(size=size)


@dataclasses.dataclass(frozen=True)
class EventTimeTumblingWindows(Windows):
    size_ms: int = 1000
    kind: ClassVar[str] = "event_time_tumbling"

    @staticmethod
    def of(size_ms: int) -> "EventTimeTumblingWindows":
        return EventTimeTumblingWindows(size_ms=size_ms)


@dataclasses.dataclass(frozen=True)
class ProcessingTimeTumblingWindows(Windows):
    size_ms: int = 1000
    kind: ClassVar[str] = "processing_time_tumbling"

    @staticmethod
    def of(size_ms: int) -> "ProcessingTimeTumblingWindows":
        return ProcessingTimeTumblingWindows(size_ms=size_ms)


@dataclasses.dataclass(frozen=True)
class EventTimeSessionWindows(Windows):
    gap_ms: int = 1000
    kind: ClassVar[str] = "event_time_session"

    @staticmethod
    def with_gap(gap_ms: int) -> "EventTimeSessionWindows":
        return EventTimeSessionWindows(gap_ms=gap_ms)


@dataclasses.dataclass(frozen=True)
class ProcessingTimeSessionWindows(Windows):
    gap_ms: int = 1000
    kind: ClassVar[str] = "processing_time_session"

    @staticmethod
    def with_gap(gap_ms: int) -> "ProcessingTimeSessionWindows":
        return ProcessingTimeSessionWindows(gap_ms=gap_ms)
