"""Build & device telemetry: the port's kernel builds, per-launch cost and
device-memory watermarks.

The port of ``flink_ml_tpu/observability/compilestats.py``. The JAX package
accounts XLA compiles and the XLA cost model; the port compiles each CUDA
source once per process with ``nvcc`` and never traces, so the same
registry series carry what the port has:

- **Builds.** ``ops/_build.py`` reports every source it compiles, or finds
  already built, to :func:`note_build`: ``ml.compile compiles{fn=<source>}``
  and ``compileMs{fn=}`` for an ``nvcc`` run, ``cached{fn=}`` for a library
  found on disk, and a ``compile`` tracer event. Recording is armed by
  :func:`install` (every traced fit and every benchmark run call it, as the
  JAX package subscribes to its compile channels there); until then builds
  record nothing. :func:`compile_totals_split`, :func:`compile_totals` and
  :func:`compile_totals_from_snapshot` read those series, and read a JAX
  package snapshot the same way.
- **Cost.** :func:`capture_cost` records one kernel launch's bytes and
  operations (``ops/kernels.py`` ``launch_cost``) as the ``ml.device
  programBytes{fn=}`` / ``programFlops{fn=}`` gauges of the last launch and
  the ``launches{fn=}`` / ``launchBytes{fn=}`` / ``launchFlops{fn=}``
  counters of all of them — the numbers the efficiency report
  (``profiling.efficiency_report``) holds a profile's device time against.
  The wrappers call it only while the tracer is enabled.
- **Memory.** :func:`sample_memory` reads the CUDA caching allocator's
  current and peak bytes per card at segment boundaries and when a root
  span closes. It never initialises CUDA: on a CPU-only fit (or before the
  first CUDA call) it is a no-op.

The JAX package's ``instrumented_jit``, ``aot_compile``,
``abstract_signature`` and recompile-storm detector have no counterpart:
nothing here is traced or recompiled per shape.
"""

from __future__ import annotations

from typing import Dict, Optional

from flink_ml_tpu_torch.common.locks import make_lock
from flink_ml_tpu_torch.common.metrics import ML_GROUP, MetricsRegistry, metrics
from flink_ml_tpu_torch.observability import tracing

#: registry subgroup names: ml.compile / ml.device
COMPILE_GROUP = "compile"
DEVICE_GROUP = "device"

#: compile-time histogram buckets (ms), the JAX package's: builds are
#: slower-tailed than the latency-shaped DEFAULT_BUCKETS
COMPILE_BUCKETS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                   1000.0, 2500.0, 5000.0, 15000.0, 60000.0, 300000.0)


class CompileStats:
    """Process-wide build accounting state: whether :func:`install` armed
    it. Thread-safe."""

    def __init__(self, registry: MetricsRegistry = metrics):
        self._registry = registry
        self._lock = make_lock("observability.compilestats")
        self._enabled = False

    def install(self) -> bool:
        """Arm build accounting (idempotent). Returns False: the port has
        no compile-phase channel, so totals read the per-source series
        (the JAX package's ``perfn`` source)."""
        with self._lock:
            self._enabled = True
        return False

    def uninstall(self) -> None:
        with self._lock:
            self._enabled = False

    @property
    def enabled(self) -> bool:
        return self._enabled  # torchlint: disable=unguarded-shared-state -- one atomic bool read; a stale value is as good as a read an instant earlier

    def note_build(self, source: str, ms: float, cached: bool) -> None:
        """Record one source's build (``cached``: its library was on disk
        and nothing compiled). A no-op until :func:`install`."""
        if not self._enabled:  # torchlint: disable=unguarded-shared-state -- lock-free bool fast path on the per-build hook; a stale read delays disarm by one build
            return
        grp = self._registry.group(ML_GROUP, COMPILE_GROUP)
        labels = {"fn": source}
        if cached:
            grp.counter("cached", labels=labels)
        else:
            grp.counter("compiles", labels=labels)
            grp.histogram("compileMs", buckets=COMPILE_BUCKETS,
                          labels=labels).observe(ms)
        tracing.tracer.event("compile", fn=source, ms=round(ms, 3),
                             cached=bool(cached))


#: default process-wide build accounting state
compile_stats = CompileStats()


def install() -> bool:
    """Module-level convenience: :meth:`CompileStats.install`."""
    return compile_stats.install()


def uninstall() -> None:
    compile_stats.uninstall()


def note_build(source: str, ms: float, cached: bool) -> None:
    """Module-level convenience: :meth:`CompileStats.note_build`."""
    compile_stats.note_build(source, ms, cached)


# -- device telemetry ---------------------------------------------------------
def capture_cost(name: str, nbytes: int, flops: int,
                 registry: MetricsRegistry = metrics) -> dict:
    """Record one launch of kernel ``name``: the bytes it must move and the
    operations it does (``ops/kernels.py`` ``launch_cost``) as the
    ``ml.device programBytes/programFlops{fn=}`` gauges (this launch) and
    the ``launches/launchBytes/launchFlops{fn=}`` counters (every launch).
    Returns ``{'flops', 'bytes'}``."""
    grp = registry.group(ML_GROUP, DEVICE_GROUP)
    labels = {"fn": name}
    grp.gauge("programFlops", float(flops), labels=labels)
    grp.gauge("programBytes", float(nbytes), labels=labels)
    grp.counter("launches", labels=labels)
    grp.counter("launchBytes", int(nbytes), labels=labels)
    grp.counter("launchFlops", int(flops), labels=labels)
    return {"flops": float(flops), "bytes": float(nbytes)}


def sample_memory(site: str, span=None,
                  registry: MetricsRegistry = metrics) -> dict:
    """Sample every card's allocated and peak allocated bytes (the caching
    allocator's statistics, ``torch.cuda.memory_stats_as_nested_dict``:
    what ``memory_allocated`` and ``max_memory_allocated`` read) into the
    JAX package's
    ``ml.device`` gauges (``hbmBytesInUse{device=}``,
    ``hbmPeakBytes{device=}``, ``hbmBytesInUseTotal{site=}``,
    ``hbmPeakBytesMax{site=}``) and, optionally, attributes on ``span``.
    Returns ``{'bytes_in_use', 'peak_bytes_in_use'}`` (sum / max), or
    ``{}`` when CUDA was never initialised in this process: telemetry must
    not open a CUDA context for a CPU fit."""
    import torch

    if not torch.cuda.is_initialized():
        return {}
    grp = registry.group(ML_GROUP, DEVICE_GROUP)
    in_use = peak = 0
    for dev in range(torch.cuda.device_count()):
        # one read of the allocator's statistics gives both numbers (the
        # nested form: memory_stats would flatten all of them first)
        allocated = torch.cuda.memory_stats_as_nested_dict(dev).get(
            "allocated_bytes", {}).get("all", {})
        dev_in_use = int(allocated.get("current", 0))
        dev_peak = int(allocated.get("peak", 0))
        in_use += dev_in_use
        peak = max(peak, dev_peak)
        label = {"device": str(dev)}
        grp.gauge("hbmBytesInUse", dev_in_use, labels=label)
        grp.gauge("hbmPeakBytes", dev_peak, labels=label)
    grp.gauge("hbmBytesInUseTotal", in_use, labels={"site": site})
    grp.gauge("hbmPeakBytesMax", peak, labels={"site": site})
    if span is not None:
        span.set_attribute("hbm_bytes_in_use", in_use)
        span.set_attribute("hbm_peak_bytes", peak)
    return {"bytes_in_use": in_use, "peak_bytes_in_use": peak}


# -- aggregates for the benchmark rows ----------------------------------------
def compile_totals_split(
        snapshot: Optional[Dict[str, dict]] = None,
        registry: MetricsRegistry = metrics) -> Dict[str, dict]:
    """Compile totals per source: ``{'phase': {count, timeMs}, 'perfn':
    {count, timeMs}}`` — the JAX package's monitoring ``backend_compile``
    channel (never written by the port) and the per-function (per CUDA
    source, in the port) ``compileMs`` series. Kept apart because a
    before/after delta must subtract within ONE source."""
    if snapshot is None:
        snapshot = registry.snapshot()
    gsnap = (snapshot or {}).get(f"{ML_GROUP}.{COMPILE_GROUP}", {})
    phase = {"count": 0, "timeMs": 0.0}
    perfn = {"count": 0, "timeMs": 0.0}
    for key, hist in gsnap.get("histograms", {}).items():
        if key.startswith("phaseMs") and 'phase="backend_compile"' in key:
            phase["count"] += int(hist.get("count", 0))
            phase["timeMs"] += float(hist.get("sum", 0.0))
        elif key.startswith("compileMs"):
            perfn["count"] += int(hist.get("count", 0))
            perfn["timeMs"] += float(hist.get("sum", 0.0))
    return {"phase": phase, "perfn": perfn}


def compile_totals_from_snapshot(snapshot: Optional[Dict[str, dict]]) -> dict:
    """``{'count', 'timeMs'}`` of ALL compile work in one registry
    snapshot: the phase channel when it has counts (a JAX package
    snapshot), else the per-function series. The two are never summed."""
    totals = compile_totals_split(snapshot)
    src = totals["phase"] if totals["phase"]["count"] else totals["perfn"]
    return {"count": src["count"], "timeMs": src["timeMs"]}


def compile_totals(registry: MetricsRegistry = metrics) -> dict:
    """Live-registry :func:`compile_totals_from_snapshot`."""
    return compile_totals_from_snapshot(registry.snapshot())
