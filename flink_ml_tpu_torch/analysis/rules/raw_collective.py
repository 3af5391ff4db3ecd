"""Rule TL108 ``raw-collective``: raw ``torch.distributed`` calls / a
direct ``shard_map`` outside the parallel layer.

The port of ``flink_ml_tpu/analysis/rules/raw_collective.py`` (JL108).
Fit programs must build through the NAMED seams of
``flink_ml_tpu_torch/parallel/`` — ``collective.py``'s ``all_reduce_sum``,
``all_gather``, ``reduce_scatter``, ``broadcast_from``, the
``mapreduce.py`` primitives and ``map_shards`` — not raw
``torch.distributed`` collectives or a direct ``shard_map`` wrap. The
seams are where three guarantees live, and a raw call silently forfeits
all of them:

- the backend's quirks: which gloo collectives take CUDA tensors as they
  are and which must be staged through pinned host buffers
  (``collective.GLOO_CUDA_OPS``), the two-level sum over a hybrid mesh;
- ``ml.collective`` accounting and mesh telemetry — a raw ``all_reduce``
  is invisible to the trace CLI's ``shards`` view and the payload budget;
- the sharded update (``update_sharding.py``) composes from the named
  primitives; a raw collective bypasses its 1/N state accounting.

Point-to-point calls and barriers (``send``/``recv``/``isend``/
``irecv``/``batch_isend_irecv``/``barrier``/``monitored_barrier``) and
``new_group`` count too: ranks that meet outside the seams meet without
the layer's timeouts, and a group made outside it outlives the layer's
teardown. Calls are resolved through the file's import table, so
``dist.all_reduce`` under ``import torch.distributed as dist`` is the raw
call. Files under ``flink_ml_tpu_torch/parallel/`` are exempt — they ARE
the seams.
"""

from __future__ import annotations

import ast
from pathlib import PurePath
from typing import Iterator

from flink_ml_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    call_name,
    register,
)
from flink_ml_tpu_torch.analysis.rules._shared import (
    origins_of,
    resolve,
)

#: torch.distributed members whose raw use is the hazard
_RAW_DIST = {"all_reduce", "all_gather", "all_gather_into_tensor",
             "broadcast", "reduce_scatter", "reduce_scatter_tensor",
             "all_to_all_single", "send", "recv", "isend", "irecv",
             "batch_isend_irecv", "barrier", "monitored_barrier",
             "new_group"}

#: seam suggested per raw call, surfaced in the message
_SEAM_OF = {
    "all_reduce": "collective.all_reduce_sum / mapreduce.reduce_sum",
    "all_gather": "collective.all_gather",
    "all_gather_into_tensor": "collective.all_gather",
    "broadcast": "collective.broadcast_from",
    "reduce_scatter": "collective.reduce_scatter",
    "reduce_scatter_tensor": "collective.reduce_scatter",
    "all_to_all_single": "parallel.sequence's seams",
    "send": "parallel.sequence's seams",
    "recv": "parallel.sequence's seams",
    "isend": "parallel.sequence's seams",
    "irecv": "parallel.sequence's seams",
    "batch_isend_irecv": "parallel.sequence's seams",
    "barrier": "mesh.shutdown_distributed's monitored barrier",
    "monitored_barrier": "mesh.shutdown_distributed's monitored barrier",
    "new_group": "a Mesh over the default group (mesh.init_distributed)",
}


def _exempt_path(path: str) -> bool:
    """True for the seam implementation itself: any file under a
    ``parallel`` package directory (flink_ml_tpu_torch/parallel/...)."""
    return "parallel" in PurePath(path).parts


@register
class RawCollectiveRule(Rule):
    name = "raw-collective"
    code = "TL108"
    rationale = (
        "raw torch.distributed collectives, point-to-point calls, "
        "barriers and groups, or a direct shard_map, outside "
        "flink_ml_tpu_torch/parallel/ bypass the named seams — backend "
        "quirks, ml.collective accounting and the sharded update all "
        "live there")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if _exempt_path(ctx.path):
            return
        origins = origins_of(ctx)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None:
                continue
            # resolve through the import table FIRST so aliases
            # (`from torch.distributed import all_reduce as ar`) are still
            # raw collectives
            resolved = resolve(name, origins)
            last = resolved.rsplit(".", 1)[-1]
            if last == "shard_map":
                yield self.finding(
                    ctx, node,
                    "direct `shard_map(...)` outside flink_ml_tpu_torch/"
                    "parallel/ — build the SPMD program through "
                    "`parallel/mapreduce.map_shards` (the named seam "
                    "with mesh telemetry)")
                continue
            if last in _RAW_DIST and resolved in (
                    f"torch.distributed.{last}",
                    f"torch.distributed.distributed_c10d.{last}"):
                yield self.finding(
                    ctx, node,
                    f"raw `torch.distributed.{last}(...)` outside "
                    f"flink_ml_tpu_torch/parallel/ — use "
                    f"`{_SEAM_OF[last]}` so the op is counted in "
                    "ml.collective and meets the backend's rules")
