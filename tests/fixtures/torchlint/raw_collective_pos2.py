"""POSITIVE fixture: point-to-point calls, barriers and groups outside the
parallel layer, and a direct shard_map wrap — all fire raw-collective."""

import torch.distributed as dist

from flink_ml_tpu_torch.parallel.shardmap import P, shard_map


def ring_step(buf, recv, rank, world):
    ops = [dist.P2POp(dist.isend, buf, (rank + 1) % world),
           dist.P2POp(dist.irecv, recv, (rank - 1) % world)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    dist.send(buf, 0)
    dist.monitored_barrier()
    return dist.new_group([0, 1])


def body(x):
    return x * 2.0


def build(mesh):
    return shard_map(body, mesh, in_specs=P("data"), out_specs=P("data"))
