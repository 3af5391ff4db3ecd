"""Mesh telemetry: topology snapshots, per-shard metrics, skew detection.

The port of ``flink_ml_tpu/observability/meshstats.py``, under the JAX
package's artifact and metric names, so either package's readers read what
the other wrote:

- **Topology**: :func:`ensure_mesh_recorded`, called from the collective
  layer's host-op seam (``parallel/collective.py``), writes a mesh's
  snapshot once per (process, trace dir, mesh) as ``ml.mesh
  deviceCount/axisSize`` gauges, root-span attributes and the
  ``mesh.json`` trace artifact.
  ``device_count`` is the mesh's shard count, as in the JAX package, where
  a shard is a device; each ``devices`` entry names its shard's torch
  device index and ``platform`` uses the JAX vocabulary (``"gpu"`` for
  CUDA, ``"cpu"``), so eight virtual shards on one card read as eight
  entries with ``id`` 0.
- **Per-shard labels**: ``ml.shard`` gauges and histograms carry
  ``shard=`` (the dim-0 block index) and ``device=`` (the torch device
  index) labels.
- **Skew/straggler detection**: :func:`detect_skew` gauges the max/median
  spread of a per-shard series and emits an ``ml.skew`` event past
  ``FLINK_ML_TPU_SKEW_FACTOR`` (default 4.0x) and an absolute floor.
- **Per-shard health**: :func:`record_input_health` counts each shard's
  non-finite input elements into one ``(shards,)`` int32 tensor, fetched
  once (gathered over the ranks under ``torch.distributed``).

Time-to-ready, the port's design: the JAX package times
``block_until_ready`` on each addressable shard of a sharded array. The
port's virtual shards share one device and one stream, where one
synchronisation would wait for all of them at once. So while the iteration
runtime collects (:func:`collect_ready`, armed only), each per-shard loop
records one CUDA event after its shard's work (:func:`mark_shard_ready`),
and :func:`observe_shard_ready` waits on those events in shard order and
times each wait: after an asynchronous round the waits approximate each
shard's remaining work. On the CPU, and for a rank's one shard under
``torch.distributed``, the work is done by then and the times come out
about 0, as on the JAX package's CPU mesh. Unarmed, nothing is recorded and
nothing synchronises; the events never change what a fit computes.

Inspect with ``flink-ml-tpu-torch-trace shards <dir>``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from flink_ml_tpu_torch.common.metrics import ML_GROUP, metrics
from flink_ml_tpu_torch.observability import tracing

__all__ = [
    "MESH_FILE",
    "SKEW_EVENT",
    "SKEW_FACTOR_ENV",
    "SKEW_FLOOR_MS_ENV",
    "collect_ready",
    "detect_skew",
    "ensure_mesh_recorded",
    "mark_shard_ready",
    "mesh_snapshot",
    "observe_shard_ready",
    "read_mesh",
    "record_input_health",
    "record_shard_rows",
    "shard_row_counts",
    "skew_factor",
]

#: the mesh-topology artifact in a trace dir (one file, every mesh the
#: traced processes built, newest last)
MESH_FILE = "mesh.json"

#: instant-event name for a detected straggler or imbalance
SKEW_EVENT = "ml.skew"

#: max/median ratio above which a per-shard spread is skew (default 4.0)
SKEW_FACTOR_ENV = "FLINK_ML_TPU_SKEW_FACTOR"

#: absolute ready-time spread floor (ms) below which the ratio never fires:
#: near-zero medians (a CPU mesh, shards already done) are not stragglers
#: (default 50 ms)
SKEW_FLOOR_MS_ENV = "FLINK_ML_TPU_SKEW_FLOOR_MS"

#: meshes already recorded by THIS process, per trace dir (pid in the key:
#: a forked child re-records into its own artifacts)
_recorded: set = set()

#: per-thread ready marks: ``marks`` is ``{shard: (device, event)}`` while
#: the iteration runtime collects on this thread, else None
_local = threading.local()


def _shard_group():
    return metrics.group(ML_GROUP, "shard")


def _mesh_group():
    return metrics.group(ML_GROUP, "mesh")


def skew_factor() -> float:
    try:
        return float(os.environ.get(SKEW_FACTOR_ENV, "4.0"))
    except ValueError:
        return 4.0


def _skew_floor_ms() -> float:
    try:
        return float(os.environ.get(SKEW_FLOOR_MS_ENV, "50.0"))
    except ValueError:
        return 50.0


def _device_id(device: torch.device) -> int:
    return device.index if device.index is not None else 0


def _platform(device: torch.device) -> str:
    return "gpu" if device.type == "cuda" else device.type


# -- topology -----------------------------------------------------------------

def mesh_snapshot(mesh) -> dict:
    """The JSON-ready topology of one mesh: position count, axis layout,
    platform and, per grid position (row-major over the axes), its device
    index and owning process (the rank under ``torch.distributed``, else
    0)."""
    devices = list(mesh.grid)
    per = max(len(devices) // max(mesh.processes, 1), 1)
    return {
        "device_count": len(devices),
        "axis_names": list(mesh.axis_names),
        "shape": {name: int(mesh.shape[name]) for name in mesh.axis_names},
        "platform": _platform(devices[0]) if devices else None,
        "devices": [{"id": _device_id(d),
                     "process": s // per if mesh.distributed else 0,
                     "platform": _platform(d)}
                    for s, d in enumerate(devices)],
    }


def _mesh_key(mesh, trace_dir: str):
    return (os.getpid(), trace_dir, tuple(mesh.axis_names),
            tuple(mesh.axis_sizes), tuple(str(d) for d in mesh.grid),
            mesh.distributed)


def ensure_mesh_recorded(mesh) -> None:
    """Record one mesh's topology (gauges, root-span attributes,
    ``mesh.json``) once per (process, trace dir, mesh): a process that
    traces into several dirs leaves the topology in each (the JAX package
    records once per process). No-op when the tracer is disarmed."""
    tracer = tracing.tracer
    if mesh is None or not tracer.enabled:
        return
    key = _mesh_key(mesh, tracer.trace_dir)
    if key in _recorded:
        return
    _recorded.add(key)
    snap = mesh_snapshot(mesh)
    group = _mesh_group()
    group.gauge("deviceCount", snap["device_count"])
    for name, size in snap["shape"].items():
        group.gauge("axisSize", size, labels={"axis": name})
    root = tracer.root()
    if root is not None:
        root.set_attribute("mesh_devices", snap["device_count"])
        root.set_attribute("mesh_axes", ",".join(
            f"{k}={v}" for k, v in snap["shape"].items()))
        if snap["platform"]:
            root.set_attribute("mesh_platform", snap["platform"])
    _append_mesh_file(tracer.trace_dir, snap)


def _append_mesh_file(trace_dir: str, snap: dict) -> None:
    """Append ``snap`` to the dir's ``mesh.json`` (read-modify-replace:
    concurrent traced processes at worst drop a duplicate topology, never
    tear the file)."""
    path = os.path.join(trace_dir, MESH_FILE)
    doc = {"meshes": []}
    try:
        with open(path, "r", encoding="utf-8") as f:
            existing = json.load(f)
        if isinstance(existing, dict) and \
                isinstance(existing.get("meshes"), list):
            doc = existing
    except (OSError, json.JSONDecodeError):
        pass
    if snap in doc["meshes"]:
        return
    doc["meshes"].append(snap)
    os.makedirs(trace_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2)
    os.replace(tmp, path)


def read_mesh(trace_dir: str) -> Optional[dict]:
    """The newest mesh snapshot of a trace dir's ``mesh.json``, or None when
    the artifact is absent or unreadable."""
    path = os.path.join(trace_dir, MESH_FILE)
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
        meshes = doc.get("meshes") or []
        return meshes[-1] if meshes else None
    except (OSError, json.JSONDecodeError, AttributeError):
        return None


# -- skew/straggler detection -------------------------------------------------

def detect_skew(kind: str, values: Sequence[float],
                floor: float = 0.0, **attrs) -> Optional[float]:
    """Gauge the max/median spread of a per-shard series and emit an
    ``ml.skew`` event when it exceeds the configured factor and the
    absolute max-median gap clears ``floor``. Returns the spread, or None
    for a series of fewer than two finite values."""
    vals = [float(v) for v in values if math.isfinite(float(v))]
    if len(vals) < 2:
        return None
    med = float(np.median(vals))
    mx = max(vals)
    if med <= 0.0:
        spread = math.inf if mx > 0 else 1.0
    else:
        spread = mx / med
    group = _shard_group()
    group.gauge("skew", spread if math.isfinite(spread) else -1.0,
                labels={"kind": kind})
    factor = skew_factor()
    if spread > factor and (mx - med) > floor:
        group.counter("skewEvents", labels={"kind": kind})
        tracing.tracer.event(
            SKEW_EVENT, kind=kind, spread=round(spread, 2)
            if math.isfinite(spread) else "inf",
            max=round(mx, 3), median=round(med, 3),
            shard=int(np.argmax(vals)), factor=factor, **attrs)
    return spread


# -- per-shard series ---------------------------------------------------------

def shard_row_counts(mesh, n: int,
                     local_n: Optional[int] = None) -> List[int]:
    """Real rows each shard holds when ``n`` rows are split as
    ``collective.ensure_on_mesh`` splits them (``ceil(n / shards)`` a
    shard, the short shards at the tail), in shard order. ``local_n``
    overrides the rows a shard owns: the serving micro-batcher pads to a
    bucket, so each shard owns ``bucket / N`` rows and the real rows fill
    from shard 0. (The port's shards are the positions along the data
    axes, so the JAX function's ``axis_name`` has no counterpart.)"""
    shards = mesh.size
    if local_n is None:
        local_n = -(-n // shards)
    return [int(min(max(n - i * local_n, 0), local_n))
            for i in range(shards)]


def record_shard_rows(mesh, n: int, local_n: Optional[int] = None,
                      skew: bool = True) -> List[int]:
    """Per-shard row-count gauges (``ml.shard rows{shard=,device=}``) and
    the row-imbalance skew check; returns the counts. ``skew=False``
    records the series without the detector: the serving dispatcher's
    partly filled buckets load shard 0 first by design."""
    counts = shard_row_counts(mesh, n, local_n=local_n)
    devices = list(mesh.devices)
    group = _shard_group()
    for i, rows in enumerate(counts):
        dev = devices[i] if i < len(devices) else None
        group.gauge("rows", rows, labels={
            "shard": str(i),
            "device": str(_device_id(dev)) if dev is not None else "?"})
    if skew:
        detect_skew("rows", counts)
    return counts


@contextlib.contextmanager
def collect_ready():
    """Collect this thread's :func:`mark_shard_ready` marks for
    :func:`observe_shard_ready` (the iteration runtime's armed loops).
    Nested use keeps the outer collection."""
    if getattr(_local, "marks", None) is not None:
        yield
        return
    _local.marks = {}
    try:
        yield
    finally:
        _local.marks = None


def mark_shard_ready(mesh, shard: int, value=None) -> None:
    """Mark the point in the stream where shard ``shard``'s work of this
    round was enqueued: one CUDA event on its device's current stream
    (none on the CPU). Records only while this thread collects and the
    mesh has more than one shard; a later mark of the same shard replaces
    the earlier one."""
    marks = getattr(_local, "marks", None)
    if marks is None or mesh.size < 2:
        return
    dev = (value.device if isinstance(value, torch.Tensor)
           else mesh.devices[shard])
    event = None
    if dev.type == "cuda":
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
    marks[shard] = (dev, event)


def observe_shard_ready(span=None, phase: str = "epoch"
                        ) -> Optional[List[float]]:
    """Per-shard time-to-ready of the marks collected since the last
    observation: each shard's event is waited on in shard order and the
    wait timed. Records ``ml.shard readyMs{shard=,device=,phase=}``
    histograms, the ready-time skew check and, on ``span``, the times and
    the spread. Returns the times (ms), or None when nothing was marked."""
    marks = getattr(_local, "marks", None)
    if not marks:
        return None
    _local.marks = {}
    group = _shard_group()
    times = []
    for shard in sorted(marks):
        dev, event = marks[shard]
        t0 = time.perf_counter()
        if event is not None:
            event.synchronize()
        ms = (time.perf_counter() - t0) * 1000.0
        times.append(ms)
        group.histogram("readyMs", labels={
            "shard": str(shard), "device": str(_device_id(dev)),
            "phase": phase}).observe(ms)
    spread = detect_skew("readyMs", times, floor=_skew_floor_ms(),
                         phase=phase)
    if span is not None:
        span.set_attribute("shard_ready_ms", [round(t, 3) for t in times])
        if spread is not None and math.isfinite(spread):
            span.set_attribute("shard_skew", round(spread, 2))
    return times


# -- per-shard health ---------------------------------------------------------

def record_input_health(algo: str, mesh, parts) -> Optional[List[int]]:
    """Per-shard non-finite counts of a mesh-resident input (``parts``: this
    process's per-shard row tensors, or the ``RowShards`` that holds them)
    as ``ml.shard nonFinite{algo=,shard=,device=}`` gauges, so corrupt data
    is attributable to a shard before the fit consumes it. The counts are
    one (shards,) int32 tensor, gathered over the ranks under
    ``torch.distributed`` so every rank has all of them, and fetched once.
    Returns the counts, or None on a one-shard mesh."""
    if mesh is None or mesh.size < 2:
        return None
    parts = list(getattr(parts, "parts", parts))
    home = parts[0].device
    local = torch.stack([
        torch.logical_not(torch.isfinite(p)).sum().to(
            device=home, dtype=torch.int32) for p in parts])
    if mesh.distributed:
        from flink_ml_tpu_torch.parallel import collective

        # this rank's (1,) count as its slice: the gather is (shards,)
        local = collective.all_gather(local[:, None], mesh)
    counts = local.cpu().numpy()
    devices = list(mesh.devices)
    group = _shard_group()
    for i, bad in enumerate(counts):
        group.gauge("nonFinite", int(bad), labels={
            "algo": algo, "shard": str(i),
            "device": str(_device_id(devices[i]))})
    if counts.any():
        tracing.tracer.event(
            "ml.health", algo=algo, kind="non-finite-input",
            shards=",".join(str(i) for i in np.nonzero(counts)[0]),
            total=int(counts.sum()))
    return [int(c) for c in counts]
