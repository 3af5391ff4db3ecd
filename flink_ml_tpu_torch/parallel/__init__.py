"""The data-parallel layer: meshes, collectives, map-reduce programs and the
cross-replica sharded update (the port of ``flink_ml_tpu/parallel/``)."""

from flink_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DCN_AXIS,
    MODEL_AXIS,
    Mesh,
    create_mesh,
    data_axes,
    data_shard_count,
    default_mesh,
    init_distributed,
    local_mesh,
    resolve_mesh,
    set_default_mesh,
    shutdown_distributed,
)

__all__ = [
    "DATA_AXIS", "DCN_AXIS", "MODEL_AXIS", "Mesh", "create_mesh",
    "data_axes", "data_shard_count", "default_mesh", "init_distributed",
    "local_mesh", "resolve_mesh", "set_default_mesh", "shutdown_distributed",
]
