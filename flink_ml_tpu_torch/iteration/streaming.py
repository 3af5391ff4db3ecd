"""Unbounded (online) runtime.

The port of the stream plumbing of ``flink_ml_tpu/iteration/streaming.py``
that the online trainers need:

- ``StreamTable``: an unbounded source, an iterator of bounded Tables
  (micro-batches), the counterpart of an unbounded DataStream.
- ``generate_batches``: re-chunks arbitrary micro-batches into exact
  ``global_batch_size`` batches, the semantics of
  ``DataStreamUtils.generateBatchData`` (DataStreamUtils.java:734). Tensor
  columns stay on their device.
- ``StreamCheckpointer``: the per-batch listener and checkpoint plumbing of
  an unbounded fit (restore, due saves, and the clear at the end of the
  stream).

``window_stream`` and ``iterate_unbounded`` come with the slice that ports
the windowed online estimators.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

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
