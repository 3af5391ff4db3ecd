"""Unbounded (online) runtime.

The port of the stream plumbing of ``flink_ml_tpu/iteration/streaming.py``
that the online trainers need:

- ``StreamTable``: an unbounded source, an iterator of bounded Tables
  (micro-batches), the counterpart of an unbounded DataStream.
- ``generate_batches``: re-chunks arbitrary micro-batches into exact
  ``global_batch_size`` batches, the semantics of
  ``DataStreamUtils.generateBatchData`` (DataStreamUtils.java:734). Tensor
  columns stay on their device.
- ``window_stream``: regroups a stream's rows into tumbling or session time
  windows (the ``windows`` param of OnlineStandardScaler).
- ``StreamCheckpointer``: the per-batch listener and checkpoint plumbing of
  an unbounded fit (restore, due saves, and the clear at the end of the
  stream).
- ``iterate_unbounded``: the unbounded iteration loop
  (Iterations.iterateUnboundedStreams, Iterations.java:123): per batch,
  update the model carry and emit a versioned snapshot.

Windows are assigned on the host, once per arriving chunk: event time reads
the chunk's timestamp column there (one copy of a tensor column), processing
time reads :func:`now_ms`. The rows of a window are cut from the chunk with
``Table.take``, so tensor columns stay on their device.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.common.table import Table


class StreamTable:
    """An unbounded table: iterable of bounded Table chunks."""

    def __init__(self, chunks: Iterable[Table]):
        self._chunks = chunks

    def __iter__(self) -> Iterator[Table]:
        return iter(self._chunks)

    @staticmethod
    def from_table(table: Table, chunk_size: int) -> "StreamTable":
        """Chop a bounded table into a stream of ``chunk_size``-row chunks
        (a test and benchmark fixture)."""
        def gen():
            for start in range(0, table.num_rows, chunk_size):
                yield table.take(slice(start, min(start + chunk_size,
                                                  table.num_rows)))
        return StreamTable(gen())


def generate_batches(stream: StreamTable, global_batch_size: int,
                     drop_remainder: bool = True) -> Iterator[Table]:
    """Re-chunk a stream into exact global batches.

    Ref: DataStreamUtils.generateBatchData (DataStreamUtils.java:734). A
    trailing partial batch is dropped (an unbounded stream never ends in the
    reference); ``drop_remainder=False`` keeps it, for bounded fixtures.
    """
    buffer: Optional[Table] = None
    cursor = 0  # consumed prefix of buffer
    for chunk in stream:
        if buffer is None or cursor == buffer.num_rows:
            # a fully consumed buffer starts afresh, which also keeps the
            # chunk's column representation as it is
            buffer, cursor = chunk, 0
        else:
            remaining = buffer.take(slice(cursor, buffer.num_rows)) \
                if cursor else buffer
            buffer, cursor = remaining.concat(chunk), 0
        while buffer.num_rows - cursor >= global_batch_size:
            yield buffer.take(slice(cursor, cursor + global_batch_size))
            cursor += global_batch_size
    if buffer is not None and buffer.num_rows - cursor > 0 and not drop_remainder:
        yield buffer.take(slice(cursor, buffer.num_rows))


def now_ms() -> int:
    """The processing-time clock of :func:`window_stream`, in ms."""
    return int(time.time() * 1000)


def _timestamps(chunk: Table, col: str) -> np.ndarray:
    """A chunk's event timestamps as host int64 (one copy of a tensor
    column)."""
    ts = chunk.column(col)
    if isinstance(ts, torch.Tensor):
        ts = ts.cpu().numpy()
    return np.asarray(ts, np.int64)


def window_stream(stream: StreamTable, windows,
                  timestamp_col: Optional[str] = None,
                  with_end_ts: bool = False) -> Iterator:
    """Regroup a stream's rows into tumbling or session time windows.

    Ref: the Windows param consumed by OnlineStandardScaler
    (feature/standardscaler/OnlineStandardScaler.java: one model per
    window); session specs per common/window/SessionWindows.java.

    - Event-time tumbling windows bucket rows by ``timestamp_col //
      size_ms``; a window is emitted when a later window's first row
      arrives (in-order streams: the reference's watermark with zero
      out-of-orderness), the trailing window at the end of the stream.
    - Processing-time tumbling windows bucket whole chunks by their arrival
      time (:func:`now_ms`); no timestamp column is read.
    - Session windows close when the gap to the next row (event time) or
      next chunk arrival (processing time) exceeds ``gap_ms``, or when the
      stream ends (Flink instead holds the last session until a watermark
      passes its end). A session ends at its last element's time + gap,
      Flink's session merge rule.

    Yields Tables, or ``(window_end_ms, Table)`` with ``with_end_ts=True``
    (the timestamp the reference stamps on each per-window model).
    """
    from flink_ml_tpu_torch.common.window import (
        EventTimeSessionWindows,
        EventTimeTumblingWindows,
        ProcessingTimeSessionWindows,
        ProcessingTimeTumblingWindows,
    )

    event_time = isinstance(windows, (EventTimeTumblingWindows,
                                      EventTimeSessionWindows))
    session = isinstance(windows, (EventTimeSessionWindows,
                                   ProcessingTimeSessionWindows))
    if not (event_time or isinstance(windows, (
            ProcessingTimeTumblingWindows, ProcessingTimeSessionWindows))):
        raise ValueError(f"window_stream supports tumbling and session time "
                         f"windows, got {type(windows).__name__}")
    if event_time and timestamp_col is None:
        raise ValueError(
            "event-time windows need timestamp_col to assign rows to "
            "windows")

    def emit(end_ms, table):
        return (int(end_ms), table) if with_end_ts else table

    if session:
        yield from _session_windows(stream, windows.gap_ms, event_time,
                                    timestamp_col, emit)
        return

    size_ms = windows.size_ms
    pending: Optional[Table] = None
    pending_window = None
    for chunk in stream:
        if event_time:
            wids = _timestamps(chunk, timestamp_col) // size_ms
            chunk_windows = [(wid, chunk.take(np.nonzero(wids == wid)[0]))
                             for wid in np.unique(wids)]
        else:
            chunk_windows = [(now_ms() // size_ms, chunk)]
        for window_id, rows in chunk_windows:
            if pending_window is None or window_id == pending_window:
                pending = rows if pending is None else pending.concat(rows)
                pending_window = window_id
            else:
                yield emit((pending_window + 1) * size_ms, pending)
                pending, pending_window = rows, window_id
    if pending is not None and pending.num_rows:
        yield emit((pending_window + 1) * size_ms, pending)


def _session_windows(stream, gap_ms, event_time, timestamp_col, emit):
    """Gap-based session assignment over an in-order stream. Event time: a
    gap between consecutive row timestamps > gap_ms closes the session;
    processing time: a gap between chunk arrivals does. The last session is
    emitted at the end of the stream."""
    pending: Optional[Table] = None
    last_ts = None  # last event timestamp / last chunk arrival, ms
    for chunk in stream:
        if chunk.num_rows == 0:
            continue
        if event_time:
            ts = _timestamps(chunk, timestamp_col)
            # split the chunk at its inner gaps; the pending session joins
            # the first piece
            starts = np.nonzero(np.diff(ts) > gap_ms)[0] + 1
            bounds = [0, *starts.tolist(), len(ts)]
            for i in range(len(bounds) - 1):
                seg = chunk if len(bounds) == 2 else chunk.take(
                    slice(bounds[i], bounds[i + 1]))
                seg_first, seg_last = int(ts[bounds[i]]), \
                    int(ts[bounds[i + 1] - 1])
                if pending is not None and seg_first - last_ts > gap_ms:
                    yield emit(last_ts + gap_ms, pending)
                    pending = None
                pending = seg if pending is None else pending.concat(seg)
                last_ts = seg_last
        else:
            now = now_ms()
            if pending is not None and now - last_ts > gap_ms:
                yield emit(last_ts + gap_ms, pending)
                pending = None
            pending = chunk if pending is None else pending.concat(chunk)
            last_ts = now
    if pending is not None and pending.num_rows:
        yield emit(last_ts + gap_ms, pending)


class StreamCheckpointer:
    """Listener and checkpoint plumbing for unbounded fits: a checkpoint is
    the (state, batch count) snapshot between batches.

    Resume semantics are at-least-once: the restored state continues from
    wherever the incoming stream currently is; replaying the exact source
    position is the source's concern, as in the reference.
    """

    def __init__(self, config=None, listeners=()):
        self.mgr = getattr(config, "checkpoint_manager", None)
        self.interval = getattr(config, "checkpoint_interval", 0)
        self.listeners = tuple(listeners)
        self.batches = 0

    def restore(self, template_state):
        """The newest valid (state, batch count), or None."""
        if self.mgr is None:
            return None
        restored = self.mgr.restore(template_state)
        if restored is not None:
            self.batches = restored[1]
        return restored

    def after_batch(self, state_fn) -> None:
        """``state_fn`` is a zero-argument thunk giving the state; it runs
        only when a listener or a due checkpoint needs the state, so an
        inert checkpointer adds no per-batch cost."""
        self.batches += 1
        due = (self.mgr is not None and self.interval
               and self.batches % self.interval == 0)
        if not self.listeners and not due:
            return
        state = state_fn()
        for lst in self.listeners:
            lst.on_epoch_watermark_incremented(self.batches - 1, state)
        if due:
            self.mgr.save(state, self.batches)

    def complete(self, state_fn) -> None:
        """The stream ended (a bounded fixture's end): notify listeners and
        discard the checkpoints. A crash mid-stream skips this, keeping the
        resume point."""
        if self.listeners:
            state = state_fn()
            for lst in self.listeners:
                lst.on_iteration_terminated(state)
        if self.mgr is not None:
            self.mgr.clear()


def iterate_unbounded(initial_model: Any,
                      batches: Iterable[Any],
                      step: Callable[[Any, Any], Any],
                      on_model: Optional[Callable[[Any, int], None]] = None,
                      initial_version: int = 0,
                      checkpointer: Optional[StreamCheckpointer] = None
                      ) -> Iterator[Tuple[Any, int]]:
    """Unbounded iteration: fold ``step`` over batches, yielding
    (model carry, version) after every batch, the feedback edge of
    Iterations.iterateUnboundedStreams as a host generator. With a
    ``checkpointer`` the newest snapshot is restored first, every due batch
    saved, and the checkpoints cleared when the batches end."""
    model = initial_model
    version = initial_version
    if checkpointer is not None:
        restored = checkpointer.restore((model, version))
        if restored is not None:
            model, version = restored[0]
            version = int(version)  # a numpy round trip keeps the type
    for batch in batches:
        model = step(model, batch)
        version += 1
        if on_model is not None:
            on_model(model, version)
        if checkpointer is not None:
            checkpointer.after_batch(lambda: (model, version))
        yield model, version
    if checkpointer is not None:
        checkpointer.complete(lambda: (model, version))
