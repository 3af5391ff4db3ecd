"""POSITIVE fixture: raw torch.distributed collectives in a fit outside
flink_ml_tpu_torch/parallel/ — every spelling must fire raw-collective."""

import torch
import torch.distributed as dist
from torch.distributed import all_gather as gather_alias
from torch.distributed import all_reduce


def fit_round(grad, world):
    dist.all_reduce(grad)                          # aliased module
    torch.distributed.broadcast(grad, 0)           # dotted form
    all_reduce(grad)                               # imported name
    outs = [torch.empty_like(grad) for _ in range(world)]
    gather_alias(outs, grad)                       # as-alias
    out = torch.empty(grad.numel() * world)
    dist.all_gather_into_tensor(out, grad)
    part = torch.empty(grad.numel() // world)
    dist.reduce_scatter_tensor(part, grad)
    return outs, out, part
