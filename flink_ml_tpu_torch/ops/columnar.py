"""The device on-ramp of the dense feature transformers.

The port of ``flink_ml_tpu/ops/columnar.py``. Dense numeric feature
transforms (the scalers, Normalizer, ElementwiseProduct,
PolynomialExpansion, DCT, Binarizer, Bucketizer, Interaction, the slicers
and selectors) run as one module-level torch function per op over the
(n, d) column.

Placement, the JAX module's: with no default mesh set, a column is one
tensor on the stage's device (the CUDA card unless the stage names
another). Once a default mesh is set, the columns go where
``parallel.mesh.column_mesh()`` (the local mesh) says: one tensor on its
device when it has one shard; with several, a column is split by rows over
its shards (``parallel.collective.ShardedColumn``, the split
``ensure_on_mesh`` makes: contiguous row views of one tensor on one
device, the last shard short, shards past the end empty), the op runs once
per shard on that shard's rows (:func:`apply_multi`, the one per-shard
loop) with the constants on the shards' device, and its output is split
the same way. Under ``torch.distributed`` the local mesh is the rank's own
shards, so a rank's columns never span processes. The statistics of a
split column are per-shard partials combined across the shards
(:func:`sum_over_shards`, :func:`max_over_shards`).

Residency: outputs stay tensors or split columns inside the Table, so
chained Pipeline stages (scale → normalize → classify) hand device tensors
to each other with no host round trip, and a fit whose mesh splits rows
alike takes a split column's parts as they are; the host off-ramp happens
only when a consumer reads rows or asks for numpy.

Dtype policy (the JAX package's): device transforms compute in float32,
so host float arrays are cast to float32 on their way in, while the fit
statistics of a host column stay float64 numpy. The fit statistics of a
tensor column are computed where the tensor lives, in its dtype
(:func:`fit_vectors`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.device import DeviceLike, resolve_device
from flink_ml_tpu_torch.parallel import collective as C
from flink_ml_tpu_torch.parallel.mesh import Mesh, column_mesh


def is_device_array(x) -> bool:
    """A tensor column (on the card or on the CPU) or a split column: it
    keeps its place."""
    return isinstance(x, torch.Tensor) or is_sharded(x)


def is_sharded(x) -> bool:
    """A column split by rows over a mesh (``collective.ShardedColumn``)."""
    return isinstance(x, C.ShardedColumn)


def _where(mesh=None, device: DeviceLike = None):
    """(mesh, device) of a placement: an explicit mesh; else the column
    mesh of a set default mesh, its device when it has one shard; else the
    stage's ``device`` (which ``mesh`` may also name, positionally)."""
    if isinstance(mesh, Mesh):
        m = mesh
    else:
        if mesh is not None:
            device = mesh
        m = column_mesh()
        if m is None:
            return None, resolve_device(device)
    if m.size == 1:
        return None, m.devices[m.local_shards[0]]
    return m, None


def _host_float32(x):
    x = np.asarray(x)
    if x.dtype.kind == "f" and x.dtype != np.float32:
        x = x.astype(np.float32)
    return x


def to_device(x, mesh=None, device: DeviceLike = None):
    """A column placed where :func:`_where` says. With no mesh (or one
    shard): a tensor there passes through untouched, a split column is
    joined there, a host array is cast to float32 when it is a float array
    (the module's dtype policy) and copied over once. Over a mesh of
    several shards: a column already split alike passes through, a tensor
    on the shards' device is viewed, a host array is placed as
    ``ensure_on_mesh`` places it."""
    mesh, device = _where(mesh, device)
    if mesh is not None:
        if not is_device_array(x):
            x = _host_float32(x)
        return C.split_column(mesh, x)
    if is_sharded(x):
        x = x.whole()
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device)
    return torch.as_tensor(_host_float32(x), device=device)


def replicated(c, mesh=None, device: DeviceLike = None):
    """Model statistics and constants (float32 for float values) on every
    device of the placement: one tensor on the stage's device or on the
    one shards' device; ``collective.replicate`` over a mesh whose shards
    sit on several devices."""
    mesh, device = _where(mesh, device)
    if mesh is not None:
        return C.replicate(mesh, c)
    if not isinstance(c, torch.Tensor):
        c = np.asarray(c)
    return to_device(c, device=device)


def _on(c, device: torch.device) -> torch.Tensor:
    if isinstance(c, torch.Tensor):
        return c if c.device == device else c.to(device)
    return torch.as_tensor(_host_float32(c), device=device)


def _map_parts(fn, cols, consts: Sequence = (), static: Tuple = (),
               nonempty: bool = False):
    """The per-shard loop: ``fn(*parts, *consts, *static)`` once per local
    shard of the split ``cols`` (split alike; with ``nonempty`` only the
    shards that hold rows), the constants on each shard's device (placed
    once a device)."""
    mesh = cols[0].mesh
    real = cols[0].rows.real
    placed = {}
    outs = []
    for i, s in enumerate(mesh.local_shards):
        if nonempty and not real[s]:
            continue
        dev = mesh.devices[s]
        key = str(dev)
        if key not in placed:
            placed[key] = tuple(_on(c, dev) for c in consts)
        outs.append(fn(*(col.parts[i] for col in cols), *placed[key],
                       *static))
    return outs


def _rejoin(outs, like: C.ShardedColumn):
    """Per-shard outputs (tensors, or tuples or dicts of them) → split
    columns with ``like``'s rows and mesh."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _rejoin([o[k] for o in outs], like) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_rejoin([o[i] for o in outs], like)
                           for i in range(len(first)))
    return C.ShardedColumn(like.rows._replace(parts=list(outs)), like.mesh)


def map_split(fn, x: C.ShardedColumn, consts: Sequence = (),
              static: Tuple = ()):
    """``fn`` over a split column's own shards, its outputs split alike."""
    return _rejoin(_map_parts(fn, [x], consts, static), x)


def apply(fn, x, consts: Sequence = (), static: Tuple = (),
          device: DeviceLike = None):
    """``fn(x, *consts, *static)`` where the column goes (:func:`to_device`):
    ``x`` is the column (a tensor, a split column, or a host array placed
    there), ``consts`` the model statistics, ``static`` plain Python
    arguments (flags, dims). Over a mesh of several shards ``fn`` runs once
    per shard and the output (a tensor, or a tuple or dict of them, row
    for row) is split alike."""
    return apply_multi(fn, (x,), consts, static, device)


def apply_multi(fn, xs: Sequence, consts: Sequence = (), static: Tuple = (),
                device: DeviceLike = None):
    """Like :func:`apply`, with several row-aligned inputs (the Interaction
    op's columns, a label column): ``fn(*xs, *consts, *static)``."""
    mesh, device = _where(None, device)
    if mesh is None:
        xs_d = tuple(to_device(x, device=device) for x in xs)
        consts_d = tuple(replicated(c, device=device) for c in consts)
        return fn(*xs_d, *consts_d, *static)
    cols = [to_device(x, mesh) for x in xs]
    return _rejoin(_map_parts(fn, cols, consts, static), cols[0])


def sum_over_shards(fn, xs: Sequence, consts: Sequence = (),
                    static: Tuple = ()) -> torch.Tensor:
    """Σ over the shards of ``fn(*parts, *consts, *static)`` for split
    columns ``xs``: per-shard partials (an empty shard's must be zeros),
    combined by ``collective.all_reduce_sum`` on the first shard's device,
    as the JAX package's reduce over a sharded array combines them."""
    mesh = xs[0].mesh
    parts = _map_parts(fn, xs, consts, static)
    return C.all_reduce_sum(C.stack_shards(mesh, parts), mesh)


def max_over_shards(fn, xs: Sequence, consts: Sequence = (),
                    static: Tuple = ()) -> torch.Tensor:
    """The elementwise max over the shards that hold rows of ``fn``'s
    partials (``collective.all_reduce_max``); negate a minimum to take
    it."""
    mesh = xs[0].mesh
    parts = _map_parts(fn, xs, consts, static, nonempty=True)
    return C.all_reduce_max(C.stack_shards(mesh, parts), mesh)


def as_matrix(x):
    """A device column as (n, d) rows: a 1-D tensor or split column as
    (n, 1) views."""
    if is_sharded(x):
        return x.as_vectors()
    return x if x.ndim == 2 else x[:, None]


def joined(x) -> torch.Tensor:
    """A split column as one tensor on its first shard's device
    (``ShardedColumn.whole``: a view, or the parts joined there); a tensor
    as it is. For the small row masks whose few rows the host reads."""
    return x.whole() if is_sharded(x) else x


def take_rows(x, indices):
    """Rows ``indices`` (an int64 tensor) of a tensor, or of a split column
    as a column split over the same mesh."""
    return x.take(indices) if is_sharded(x) else x[indices]


def fit_vectors(table, col: str):
    """The fit statistics' on-ramp: ``(x, torch)`` for a tensor or split
    column, which stays where it is (the statistics are computed there, in
    float32; a split column's per shard, :func:`is_sharded`), and ``(x
    float64, np)`` for a host column (the float64 host contract). The
    namespace tells the caller which path it got."""
    raw = table.column(col)
    if is_device_array(raw):
        return as_matrix(raw), torch
    return table.vectors(col, np.float64), np


def input_vectors(table, col: str, device: DeviceLike = None):
    """Table → (n, d) column placed by :func:`to_device` (the on-ramp for
    vector columns; a tensor or split column a previous stage left there
    passes through)."""
    raw = table.column(col)
    if is_device_array(raw):
        return to_device(as_matrix(raw), device=device)
    return to_device(table.vectors(col, np.float32), device=device)


def input_scalars(table, col: str, device: DeviceLike = None):
    raw = table.column(col)
    if is_device_array(raw):
        return to_device(raw, device=device)
    return to_device(table.scalars(col, np.float32), device=device)


def to_host(x) -> np.ndarray:
    """Explicit off-ramp (one device-to-host copy)."""
    if is_sharded(x):
        return np.asarray(x)
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def head_rows(x, n: int):
    """The first ``n`` rows of a tensor (a view), or of a split column as
    one tensor on its first shard's device (a view when its parts are
    views of one tensor, else a copy of those rows only)."""
    n = int(min(n, x.shape[0]))
    if is_sharded(x):
        return x.rows_range(0, n)
    return x[:n]


def dynamic_rows(x, start: int, size: int):
    """Rows ``[start, start + size)`` of a tensor (a view), or of a split
    column as :func:`head_rows` gives them."""
    if is_sharded(x):
        return x.rows_range(start, start + size)
    return x[start:start + size]


def _take_dims_kernel(x, dims):
    return x.index_select(1, torch.as_tensor(dims, dtype=torch.int64,
                                             device=x.device))


def take_dims(x, dims):
    """The columns ``dims`` of an (n, d) tensor, gathered on its device; of
    a split column, on each shard, split alike."""
    dims = [int(d) for d in dims]
    if is_sharded(x):
        return map_split(_take_dims_kernel, x, (), (dims,))
    return _take_dims_kernel(x, dims)
