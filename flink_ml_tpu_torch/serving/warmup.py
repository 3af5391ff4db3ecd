"""Warmup: run every serving bucket shape before traffic.

The port of ``flink_ml_tpu/serving/warmup.py``. The micro-batcher
(serving/batcher.py) guarantees steady-state serving presents the device
with a closed set of batch shapes; this module runs that whole set once at
server start, so the FIRST request into each bucket finds the coefficient
placed, the kernels of its product loaded and, through the batcher, the
library handles of the thread that will serve it created. Each bucket warms
through the servable's own predict path — ``aot_warm(rows)`` when the
servable exposes one (servable/lr.py), else one synthetic ``transform`` per
bucket via the caller's ``frame_factory``.

Where the JAX package pays XLA compiles here, the port has no per-shape
compile: its steady-state probe, :func:`compile_count`, counts the port's
kernel builds (``ml.compile``, observability/compilestats.py), so "zero
compiles after warmup" reads "zero new kernel builds after warmup". And
PyTorch keeps its cuBLAS handles and workspaces per thread: given a running
:class:`~flink_ml_tpu_torch.serving.batcher.MicroBatcher`, each bucket warms
ON the batcher's dispatching thread (``MicroBatcher.run_on_stage``), so the
first real tick does not create them; a batcher not yet started, or a bare
servable, warms on the caller's thread as the JAX package does.

Readiness: :func:`warm` registers the ``serving-warmup`` gate with the
live endpoint (observability/server.py) before warming and releases it
after — ``/healthz`` answers 503 with the gate's reason until every
bucket is warm.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

from flink_ml_tpu_torch.common.metrics import ML_GROUP, metrics
from flink_ml_tpu_torch.observability import profiling, tracing
from flink_ml_tpu_torch.observability.compilestats import compile_totals_split

__all__ = ["WARMUP_GATE", "compile_count", "warm"]

#: the readiness gate name ``/healthz`` reports while warming
WARMUP_GATE = "serving-warmup"


def compile_count() -> int:
    """Total per-function builds recorded so far (the ``ml.compile
    compileMs{fn=...}`` series: in the port, kernel builds) — the
    before/after probe for the steady-state zero-build assertion: read
    once after :func:`warm`, again after a load run, and the delta is the
    number of builds real traffic paid."""
    return int(compile_totals_split()["perfn"]["count"])


def warm(target,
         frame_factory: Optional[Callable[[int], "object"]] = None,
         buckets: Optional[Sequence[int]] = None,
         gate: bool = True, mesh=None) -> dict:
    """Warm every bucket shape; returns a report dict.

    ``target`` is a :class:`~flink_ml_tpu_torch.serving.batcher
    .MicroBatcher` (buckets, servable AND dispatch mesh are taken from
    it; a running batcher warms on its dispatching thread) or a servable
    (pass ``buckets`` explicitly). Per bucket the servable's ``aot_warm``
    is preferred; ``frame_factory(rows)`` (a synthetic request frame of
    that many rows) is the generic fallback — pure-host servables warm
    trivially through it.

    The report holds the JAX package's keys (``buckets`` ms per bucket,
    ``total_ms``, ``compiles``, ``mesh_devices``, ``sharded_buckets``)
    and ``thread``: ``"device-stage"`` or ``"caller"``, where the buckets
    ran.

    With ``gate`` (default) the ``serving-warmup`` readiness gate is
    held closed while warming and released on success; a warmup failure
    leaves the gate closed with the failure as its reason and re-raises —
    a server that could not warm must not report ready.
    """
    from flink_ml_tpu_torch.observability import server
    from flink_ml_tpu_torch.serving.batcher import MicroBatcher

    run = None
    if isinstance(target, MicroBatcher):
        servable = target._provider()
        if buckets is None:
            buckets = target.config.buckets
        if mesh is None:
            mesh = target._mesh
        if target._thread is not None:
            def run(fn):
                def on_stage():
                    # the thread names the card as its ticks will
                    target._bind_device(servable)
                    fn()

                target.run_on_stage(on_stage)
    else:
        servable = target
    if servable is None:
        raise ValueError("cannot warm: no active servable "
                         "(publish a model to the registry first)")
    if mesh is not None and hasattr(servable, "set_mesh"):
        servable.set_mesh(mesh)
    bucket_list = [int(b) for b in (buckets or (1,))]
    if gate:
        server.set_gate(WARMUP_GATE, False,
                        f"warming {len(bucket_list)} bucket shape(s)")
    n_shards = mesh.size if mesh is not None else 1
    report = {"buckets": {}, "total_ms": 0.0, "compiles": 0,
              "mesh_devices": n_shards,
              "sharded_buckets": [b for b in bucket_list
                                  if n_shards > 1
                                  and b % n_shards == 0],
              "thread": "device-stage" if run is not None else "caller"}
    before = compile_count()
    t_start = time.perf_counter()
    try:
        # the warmup-compile rung of the boot ladder (ml.boot
        # phaseMs{phase="warmup-compile"}, observability/profiling.py)
        with profiling.boot_phase("warmup-compile"):
            for rows in bucket_list:
                if hasattr(servable, "aot_warm"):
                    def fn(rows=rows):
                        servable.aot_warm(rows)
                elif frame_factory is not None:
                    def fn(rows=rows):
                        servable.transform(frame_factory(rows))
                else:
                    raise ValueError(
                        f"servable {type(servable).__name__} has no "
                        f"aot_warm and no frame_factory was given")
                t0 = time.perf_counter()
                if run is not None:
                    run(fn)
                else:
                    fn()
                report["buckets"][rows] = round(
                    (time.perf_counter() - t0) * 1000.0, 3)
    except Exception as e:
        if gate:
            server.set_gate(WARMUP_GATE, False,
                            f"warmup failed: {type(e).__name__}: {e}")
        raise
    report["total_ms"] = round((time.perf_counter() - t_start) * 1000.0,
                               3)
    report["compiles"] = compile_count() - before
    grp = metrics.group(ML_GROUP, "serving")
    grp.gauge("warmupMs", report["total_ms"])
    grp.gauge("warmupCompiles", report["compiles"])
    tracing.tracer.event("serving.warmup",
                         buckets=",".join(str(b) for b in bucket_list),
                         ms=report["total_ms"],
                         compiles=report["compiles"],
                         mesh_devices=n_shards)
    if gate:
        # gate-open closes the boot ladder: the process is ready for
        # traffic
        with profiling.boot_phase("gate-open"):
            server.set_gate(WARMUP_GATE, True)
        profiling.mark_ready()
    return report
