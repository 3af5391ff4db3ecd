"""``shard_map``: the name seam every SPMD program of the JAX package builds
on, over the port's :func:`mapreduce.map_shards`.

The port of ``flink_ml_tpu/parallel/shardmap.py:28-52``. The JAX module
exists to hide where ``jax.shard_map`` lives across JAX versions; that part
has no counterpart here. What stays is the shape of the call and the
mesh-telemetry seam: wrapping a program over a mesh records its topology
once per mesh (``observability/meshstats.py``) when a trace dir is armed.

A spec (:class:`P`, the JAX package's ``PartitionSpec`` shape) names how an
argument or a result lies over the mesh: ``P("data")`` or ``P(("dcn",
"data"))`` (the mesh's shard axes) splits dim 0 over the shards, contiguous
and in shard order; ``P()`` (or ``None``) is replicated. The body runs once
per local shard, in shard order; inside it :func:`axis_size` reads the size
of a named axis of the mesh being mapped.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch

from flink_ml_tpu_torch.parallel import collective as _c
from flink_ml_tpu_torch.parallel.mapreduce import map_shards
from flink_ml_tpu_torch.parallel.mesh import Mesh

__all__ = ["P", "shard_map", "axis_size"]

_bound = threading.local()


class P(tuple):
    """A partition spec: entry 0 names the axis (or tuple of axes) dim 0 is
    split over; ``P()`` is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


def _sharded(spec) -> bool:
    return spec is not None and len(spec) > 0 and spec[0] is not None


def _split(mesh: Mesh, arg, spec) -> list:
    """This process's shards' dim-0 blocks of ``arg`` (a tensor or host
    array) split as ``spec`` names."""
    axes = (spec[0],) if isinstance(spec[0], str) else tuple(spec[0])
    if set(axes) != set(mesh.shard_axes):
        raise ValueError(f"spec {spec!r} must name the shard axes "
                         f"{mesh.shard_axes} of {mesh}")
    if arg.shape[0] % mesh.size:
        raise ValueError(f"dim 0 of {arg.shape[0]} does not split over the "
                         f"{mesh.size} shards of {mesh}")
    dtype = (arg.dtype if isinstance(arg, torch.Tensor)
             else torch.from_numpy(np.zeros(0, np.asarray(arg).dtype)).dtype)
    return _c.ensure_on_mesh(mesh, arg, dtype=dtype).parts


def shard_map(f: Callable, mesh: Mesh, in_specs=P(), out_specs=P()
              ) -> Callable:
    """``f`` mapped over the mesh's local shards: ``shard_map(f, mesh,
    in_specs, out_specs)(*args)`` splits each argument as its spec says,
    runs ``f(*blocks)`` once per local shard and joins each result as its
    out spec says (split results concatenate in shard order, gathered over
    the ranks under ``torch.distributed``; a replicated result is the first
    shard's). ``in_specs`` and ``out_specs`` are one :class:`P` (for every
    argument, or the one result) or a tuple of them."""
    _record_mesh(mesh)
    single_in = in_specs is None or isinstance(in_specs, P)
    single_out = out_specs is None or isinstance(out_specs, P)

    def body(shard, *args):
        prev = getattr(_bound, "mesh", None)
        _bound.mesh = mesh
        try:
            return f(*args)
        finally:
            _bound.mesh = prev

    mapped = map_shards(body, mesh)

    def run(*args):
        specs = ((in_specs,) * len(args) if single_in and args
                 else tuple(in_specs))
        if len(specs) != len(args):
            raise ValueError(f"{len(args)} arguments, {len(specs)} in_specs")
        per_shard = [[] for _ in mesh.local_shards]
        for arg, spec in zip(args, specs):
            blocks = (_split(mesh, arg, spec) if _sharded(spec)
                      else [arg] * len(mesh.local_shards))
            for i, block in enumerate(blocks):
                per_shard[i].append(block)
        outs = mapped(per_shard)
        results = [outs] if single_out else [list(r) for r in zip(*outs)]
        ospecs = (out_specs,) if single_out else out_specs
        joined = [_c.all_gather(r, mesh) if _sharded(spec) else r[0]
                  for r, spec in zip(results, ospecs)]
        return joined[0] if single_out else tuple(joined)

    return run


def axis_size(axis_name) -> int:
    """The size of a named axis (or the product over a tuple of axes) of
    the mesh being mapped, from inside a :func:`shard_map` body."""
    mesh = getattr(_bound, "mesh", None)
    if mesh is None:
        raise RuntimeError("axis_size is only defined inside a shard_map "
                           "body")
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _record_mesh(mesh: Mesh) -> None:
    """Mesh-topology telemetry at the program-build seam: free when the
    tracer is disarmed, once per mesh when armed."""
    try:  # telemetry must never sink a program build
        from flink_ml_tpu_torch.observability import meshstats

        meshstats.ensure_mesh_recorded(mesh)
    except Exception:
        pass
