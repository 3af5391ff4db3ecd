"""The parallel layer: meshes, collectives, map-reduce programs, the
cross-replica sharded update, sequence-parallel attention and the
multi-process and elastic runtimes (the port of ``flink_ml_tpu/parallel/``).

The mesh names are imported here; the collectives, ``shard_map``,
``MapReduceProgram`` and the ``update_sharding``, ``distributed`` and
``elastic`` modules (with ``build_mesh``) load on first use, so that
importing the mesh pulls in neither the kernels nor the process runtime."""

from flink_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DCN_AXIS,
    MODEL_AXIS,
    SEQ_AXIS,
    Mesh,
    create_hybrid_mesh,
    create_mesh,
    data_axes,
    data_pspec,
    data_shard_count,
    default_mesh,
    init_distributed,
    local_device_count,
    local_mesh,
    model_axis_of,
    resolve_mesh,
    set_default_mesh,
    shutdown_distributed,
)

__all__ = [
    "DATA_AXIS", "DCN_AXIS", "MODEL_AXIS", "SEQ_AXIS", "Mesh",
    "create_hybrid_mesh", "create_mesh", "data_axes", "data_pspec",
    "data_shard_count", "default_mesh", "init_distributed",
    "local_device_count", "local_mesh", "model_axis_of", "resolve_mesh",
    "set_default_mesh", "shutdown_distributed",
    # loaded on first use (see __getattr__)
    "all_gather", "all_reduce_max", "all_reduce_mean", "all_reduce_sum",
    "broadcast_from", "reduce_scatter", "renormalized_sum", "shard_batch",
    "shard_index", "replicate", "termination_vote", "axis_size",
    "shard_map", "MapReduceProgram", "map_shards", "update_sharding",
    "distributed", "build_mesh", "elastic",
]

#: name → (module, attribute or None for the module itself)
_LAZY = {
    **{name: ("collective", name) for name in (
        "all_gather", "all_reduce_max", "all_reduce_mean", "all_reduce_sum",
        "broadcast_from", "reduce_scatter", "renormalized_sum",
        "shard_batch", "shard_index", "replicate", "termination_vote")},
    "axis_size": ("shardmap", "axis_size"),
    "shard_map": ("shardmap", "shard_map"),
    "MapReduceProgram": ("mapreduce", "MapReduceProgram"),
    "map_shards": ("mapreduce", "map_shards"),
    "build_mesh": ("distributed", "build_mesh"),
    "update_sharding": ("update_sharding", None),
    "distributed": ("distributed", None),
    "elastic": ("elastic", None),
}


def __getattr__(name):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}") from None
    import importlib

    mod = importlib.import_module(f"{__name__}.{module}")
    return mod if attr is None else getattr(mod, attr)
