"""NEGATIVE fixture: a fit built entirely through the parallel layer's
seams — raw-collective must stay silent, including on the seam functions
whose NAMES match raw ops (``all_gather`` imported from the collective
layer is the seam, not the hazard), and on torch.distributed calls that
only ask about the process group."""

import torch.distributed as dist

from flink_ml_tpu_torch.parallel import mapreduce as mr
from flink_ml_tpu_torch.parallel.collective import all_gather


def build_program(mesh):
    def per_shard(xl, coeffs):
        grad = xl.T @ (xl @ coeffs)
        total = mr.reduce_sum(grad, mesh)
        part = mr.reduce_scatter(total, mesh)
        return all_gather(part, mesh)

    return mr.map_shards(per_shard, mesh)


def world():
    return dist.get_world_size() if dist.is_initialized() else 1
