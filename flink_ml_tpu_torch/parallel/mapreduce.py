"""Named map-reduce training primitives: the programming layer of the fits.

The port of ``flink_ml_tpu/parallel/mapreduce.py:65-256`` (DrJAX,
arXiv:2403.07128: map-reduce learning programs as named ``broadcast`` /
``map`` / ``reduce`` primitives):

- the primitives :func:`broadcast`, :func:`reduce_sum` /
  :func:`reduce_mean` / :func:`reduce_max`, :func:`reduce_scatter`,
  :func:`renormalized_sum`, :func:`all_gather`, :func:`shard_index` /
  :func:`shard_count`, from ``collective.py``: each takes this process's
  per-shard values stacked on dim 0 and the mesh; and the padding-mask
  helper :func:`local_valid_mask`;
- :func:`map_shards`: a per-shard body run once per local shard;
- :func:`map_rows`: the row-parallel apply of serving;
- :class:`MapReduceProgram`: *partition → map → reduce → update*.

The phases are split, not fused: an in-process mesh cannot run one SPMD body
with a collective in its middle, so a program runs ``map_fn`` on each local
shard, stacks the partials, reduces them leaf by leaf, then runs
``update_fn`` once on the reduced values. Under ``torch.distributed`` the
same program runs ``map_fn`` on the rank's own shards and the reduce crosses
the ranks. At one shard the reduce is the identity, so the layer costs a
1-shard fit nothing.

On an N-D mesh the shards are the positions along the data axes (``dcn``
then ``data``; ``Mesh.shard_axes``), each replicated over a ``model`` axis,
as the JAX programs' ``P(data_axes)`` specs place them; the reduces run over
the data axes, through the two-level route where it is armed
(``collective.py``). ``shardmap.py`` is the name seam over :func:`map_shards`
with the JAX package's ``shard_map(f, mesh, in_specs, out_specs)`` shape.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from flink_ml_tpu_torch.observability import meshstats
from flink_ml_tpu_torch.parallel import collective as _c
from flink_ml_tpu_torch.parallel.mesh import Mesh, default_mesh

__all__ = [
    "broadcast", "map_shards", "map_rows", "reduce_sum", "reduce_mean",
    "reduce_max", "reduce_scatter", "renormalized_sum", "all_gather",
    "shard_index", "shard_count", "local_valid_mask", "MapReduceProgram",
]


# -- the primitives -----------------------------------------------------------

def broadcast(x: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Shard ``src``'s value on every shard."""
    return _c.broadcast_from(x, mesh, src=src)


def reduce_sum(x: torch.Tensor, mesh: Mesh, axes=None) -> torch.Tensor:
    """Sum of the per-shard partials (map → reduce) over ``axes`` (default:
    the data axes)."""
    return _c.all_reduce_sum(x, mesh, axes=axes)


def reduce_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _c.all_reduce_mean(x, mesh)


def reduce_max(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _c.all_reduce_max(x, mesh)


def reduce_scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of the per-shard partials, each shard keeping its 1/N slice of
    dim 0 (see ``collective.reduce_scatter``)."""
    return _c.reduce_scatter(x, mesh)


def renormalized_sum(x: torch.Tensor, include: torch.Tensor,
                     mesh: Mesh) -> torch.Tensor:
    """Partial-participation reduce (see ``collective.renormalized_sum``)."""
    return _c.renormalized_sum(x, include, mesh)


def all_gather(x, mesh: Mesh) -> torch.Tensor:
    return _c.all_gather(x, mesh)


def shard_index(mesh: Mesh) -> tuple:
    """The shards this process computes (dim-0 order of the stacks)."""
    return _c.shard_index(mesh)


def shard_count(mesh: Mesh) -> int:
    return mesh.size


def local_valid_mask(shard: int, local_n: int, n_valid: int,
                     device=None) -> torch.Tensor:
    """For shard ``shard`` of ``local_n`` rows of a zero-padded batch: 1 for
    rows whose global index is below ``n_valid``, float32. (The port's own
    placement never pads: ``collective.ensure_on_mesh``.)"""
    idx = shard * local_n + torch.arange(local_n, device=device)
    return (idx < n_valid).to(torch.float32)


# -- the map ------------------------------------------------------------------

def map_shards(fn: Callable, mesh: Mesh) -> Callable:
    """The named map: ``map_shards(fn, mesh)(shard_args, *shared)`` runs
    ``fn(shard, *shard_args[i], *shared)`` once per local shard ``shard =
    mesh.local_shards[i]`` and returns the list of results. ``shard_args``
    holds each local shard's own arguments (its rows, from
    ``collective.ensure_on_mesh``); ``shared`` are replicated values.
    While the iteration runtime collects ready times (armed), each shard's
    call is followed by its ready mark (``meshstats.mark_shard_ready``)."""

    def mapped(shard_args, *shared):
        out = []
        for s, args in zip(mesh.local_shards, shard_args):
            out.append(fn(s, *args, *shared))
            meshstats.mark_shard_ready(mesh, s)
        return out

    return mapped


def map_rows(fn: Callable, mesh: Mesh) -> Callable:
    """Row-parallel apply, the serving dispatch shape: ``map_rows(fn,
    mesh)(x, *params)`` splits x by rows over the mesh as float32
    (``collective.ensure_on_mesh``), runs ``fn(rows, *params)`` on each
    local shard's rows and concatenates the outputs in row order. Under
    ``torch.distributed`` each rank returns the outputs of its own rows. No
    collective: each shard predicts its own rows."""

    def mapped(x, *params):
        rows = _c.ensure_on_mesh(mesh, x)
        outs = [fn(part, *params) for part in rows.parts]
        return outs[0] if len(outs) == 1 else torch.cat(
            [o.to(outs[0].device) for o in outs])

    return mapped


def _stack_tree(mesh: Mesh, partials):
    """Per-shard partial trees (dicts, tuples or tensors) → one tree of
    (L, ...) stacks."""
    first = partials[0]
    if isinstance(first, dict):
        return {k: _stack_tree(mesh, [p[k] for p in partials]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_tree(mesh, [p[i] for p in partials])
                           for i in range(len(first)))
    return _c.stack_shards(mesh, partials)


def _reduce_tree(mesh: Mesh, reducers, stacked):
    if callable(reducers):
        if isinstance(stacked, dict):
            return {k: _reduce_tree(mesh, reducers, v)
                    for k, v in stacked.items()}
        if isinstance(stacked, (tuple, list)):
            return type(stacked)(_reduce_tree(mesh, reducers, v)
                                 for v in stacked)
        return reducers(stacked, mesh)
    if isinstance(reducers, dict):
        return {k: _reduce_tree(mesh, reducers[k], stacked[k])
                for k in stacked}
    return type(reducers)(_reduce_tree(mesh, r, v)
                          for r, v in zip(reducers, stacked))


class MapReduceProgram:
    """*partition → map → reduce → update* as one step::

        prog = MapReduceProgram(mesh)
        step = prog.build(map_fn, update_fn, reduce={...})
        new_state = step(prog.partition(x).parts ..., *state)

    - ``map_fn(shard, *shard_args, *state) -> partials`` runs on each local
      shard and returns a tree (dict, tuple or tensor) of partials;
    - ``reduce`` (default :func:`reduce_sum`) is applied leaf by leaf to
      the partials stacked over the local shards; a tree of reducers
      matching the partials mixes them, e.g. :func:`reduce_scatter` for the
      gradient and :func:`reduce_sum` for the loss;
    - ``update_fn(reduced, *state) -> outputs`` runs once on the reduced
      values (a :func:`reduce_scatter` leaf arrives as this process's (L,
      chunk, ...) slices).

    The same program runs on a 1-shard and an N-shard mesh; at one shard
    the reduce is the identity.
    """

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else default_mesh()
        self.n_shards = self.mesh.size

    def partition(self, array, dtype=torch.float32) -> _c.RowShards:
        """A batch split over the mesh by rows (contiguous views)."""
        return _c.ensure_on_mesh(self.mesh, array, dtype)

    def build(self, map_fn: Callable, update_fn: Callable, *,
              reduce=None) -> Callable:
        reducers = reduce if reduce is not None else reduce_sum
        mapped = map_shards(map_fn, self.mesh)
        mesh = self.mesh

        def step(shard_args, *state):
            partials = mapped(shard_args, *state)
            reduced = _reduce_tree(mesh, reducers,
                                   _stack_tree(mesh, partials))
            return update_fn(reduced, *state)

        return step
