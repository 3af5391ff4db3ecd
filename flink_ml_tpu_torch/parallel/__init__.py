"""The parallel layer: meshes, collectives, map-reduce programs, the
cross-replica sharded update, sequence-parallel attention and the
multi-process and elastic runtimes (the port of ``flink_ml_tpu/parallel/``).

``distributed`` and ``elastic`` are imported as modules when used
(``from flink_ml_tpu_torch.parallel import elastic``)."""

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
    local_mesh,
    model_axis_of,
    resolve_mesh,
    set_default_mesh,
    shutdown_distributed,
)

__all__ = [
    "DATA_AXIS", "DCN_AXIS", "MODEL_AXIS", "SEQ_AXIS", "Mesh",
    "create_hybrid_mesh", "create_mesh", "data_axes", "data_pspec",
    "data_shard_count", "default_mesh", "init_distributed", "local_mesh",
    "model_axis_of", "resolve_mesh", "set_default_mesh",
    "shutdown_distributed",
]
