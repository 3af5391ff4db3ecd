"""Batch-on-stream dataset primitives.

The port's copy of ``flink_ml_tpu/common/dataset.py`` (ref:
flink-ml-core/.../common/datastream/DataStreamUtils.java:91, the utility
belt the reference's algorithms are built from): ``mapPartition:118``,
``reduce:153`` (+ keyed variant :192), ``aggregate:236``, ``sample:298``
(reservoir), ``windowAllAndProcess:354``, ``coGroup:409`` (sort-merge);
``allReduceSum:105`` is ``parallel.collective`` and ``generateBatchData:734``
``iteration.streaming.generate_batches``.

A "partition" is a contiguous row range of a Table. ``sample`` draws with
``np.random.default_rng(seed)`` as the JAX package does, so both pick the
same rows.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.common.table import Table
from flink_ml_tpu_torch.common.window import CountTumblingWindows, GlobalWindows, Windows
from flink_ml_tpu_torch.iteration.streaming import StreamTable, generate_batches


def partition(table: Table, num_partitions: int) -> List[Table]:
    """Split a table into contiguous shards (subtask-partition analog)."""
    bounds = np.linspace(0, table.num_rows, num_partitions + 1).astype(int)
    # slices: views of the table's columns, on their device
    return [table.take(slice(int(bounds[i]), int(bounds[i + 1])))
            for i in range(num_partitions)]


def map_partition(table: Table, fn: Callable[[Table], Table],
                  num_partitions: int = 1) -> Table:
    """Apply ``fn`` once per partition and concatenate
    (ref: mapPartition:118 — the operator caches the partition, processes at
    end-of-input)."""
    parts = [fn(p) for p in partition(table, num_partitions)]
    out = parts[0]
    for p in parts[1:]:
        out = out.concat(p)
    return out


def reduce(rows: Iterable[Any], fn: Callable[[Any, Any], Any]) -> Any:
    """Global reduce (ref: reduce:153)."""
    it = iter(rows)
    try:
        acc = next(it)
    except StopIteration:
        raise ValueError("reduce on empty input")
    for value in it:
        acc = fn(acc, value)
    return acc


def reduce_keyed(rows: Iterable[Any], key_fn: Callable[[Any], Any],
                 fn: Callable[[Any, Any], Any]) -> Dict[Any, Any]:
    """Per-key reduce (ref: reduce(KeyedStream):192)."""
    out: Dict[Any, Any] = {}
    for value in rows:
        k = key_fn(value)
        out[k] = value if k not in out else fn(out[k], value)
    return out


def aggregate(rows: Iterable[Any],
              create_accumulator: Callable[[], Any],
              add: Callable[[Any, Any], Any],
              merge: Callable[[Any, Any], Any] = None,
              get_result: Callable[[Any], Any] = lambda acc: acc,
              num_partitions: int = 1) -> Any:
    """AggregateFunction protocol (ref: aggregate:236): one accumulator per
    partition built with ``add``, combined with ``merge`` (defaults to
    treating the second accumulator's result as values is not possible, so
    with num_partitions == 1 merge is unused, matching a single subtask)."""
    rows = list(rows)
    bounds = np.linspace(0, len(rows), max(num_partitions, 1) + 1).astype(int)
    accs = []
    for i in range(len(bounds) - 1):
        acc = create_accumulator()
        for value in rows[bounds[i]:bounds[i + 1]]:
            acc = add(acc, value)
        accs.append(acc)
    result = accs[0]
    for acc in accs[1:]:
        if merge is None:
            raise ValueError("merge is required when num_partitions > 1")
        result = merge(result, acc)
    return get_result(result)


def sample(table: Table, num_samples: int, seed: int = 0) -> Table:
    """Uniform sample without replacement via reservoir semantics
    (ref: sample:298, SamplingOperator:796)."""
    n = table.num_rows
    if num_samples >= n:
        return table
    rng = np.random.default_rng(seed)
    # vectorized reservoir: uniform keys, keep smallest num_samples
    keys = rng.random(n)
    idx = np.sort(np.argpartition(keys, num_samples)[:num_samples])
    return table.take(idx)


def co_group(table_a: Table, table_b: Table, key_a: str, key_b: str,
             fn: Callable[[Any, Table, Table], Sequence[Tuple]],
             out_names: Sequence[str]) -> Table:
    """Sort-merge co-group (ref: coGroup:409 + sort/CoGroupOperator): group
    both tables by key, call ``fn(key, rows_a, rows_b)`` per key in sorted
    key order, flatten results into one table. Keys are read on the host."""
    def groups(table, key_col):
        keys = table.column(key_col)
        if isinstance(keys, torch.Tensor):
            keys = keys.cpu().numpy()
        order = np.argsort(keys, kind="stable")
        sorted_keys = keys[order]
        out = {}
        start = 0
        for i in range(1, len(sorted_keys) + 1):
            if i == len(sorted_keys) or sorted_keys[i] != sorted_keys[start]:
                out[sorted_keys[start]] = order[start:i]
                start = i
        return out

    ga, gb = groups(table_a, key_a), groups(table_b, key_b)
    all_keys = sorted(set(ga) | set(gb))
    empty_a = table_a.take(np.asarray([], int))
    empty_b = table_b.take(np.asarray([], int))
    rows: List[Tuple] = []
    for k in all_keys:
        rows_a = table_a.take(ga[k]) if k in ga else empty_a
        rows_b = table_b.take(gb[k]) if k in gb else empty_b
        rows.extend(fn(k, rows_a, rows_b))
    return Table.from_rows(rows, out_names)


def window_all_and_process(stream, windows: Windows,
                           fn: Callable[[Table], Any]) -> List[Any]:
    """Apply ``fn`` per window of an unbounded stream
    (ref: windowAllAndProcess:354). Count windows re-chunk exactly; global
    windows process each arriving chunk (the bounded analog)."""
    if isinstance(stream, Table):
        stream = StreamTable.from_table(stream, max(stream.num_rows, 1))
    if isinstance(windows, CountTumblingWindows):
        chunks = generate_batches(stream, windows.size,
                                  drop_remainder=False)
    elif isinstance(windows, GlobalWindows):
        # one window over the whole (bounded) input
        whole = None
        for chunk in stream:
            whole = chunk if whole is None else whole.concat(chunk)
        chunks = iter(() if whole is None else (whole,))
    else:
        # time-based windows degrade to per-chunk processing in the host
        # runtime (chunk boundaries are the event-time boundaries)
        chunks = iter(stream)
    return [fn(chunk) for chunk in chunks]
