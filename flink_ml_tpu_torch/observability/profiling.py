"""Device profiling & efficiency plane: capture, attribution, efficiency.

The port of ``flink_ml_tpu/observability/profiling.py`` on ``torch.profiler``.
Spans time the *host*; ``compilestats.capture_cost`` records each kernel
launch's bytes and operations. Neither measures how fast the card ran. This
module closes the loop in three layers, under the JAX package's env switches
and artifact names:

- **Capture.** :func:`profile_window` wraps a ``torch.profiler`` window (CPU
  and, with a card, CUDA activities; exported as a Chrome-format trace)
  behind the process-wide single-window claim shared with
  ``common.metrics.profile`` — driver only, one window at a time, never
  raising into the workload. Arming paths: :data:`CAPTURE_ENV` profiles the
  next traced fit (:func:`maybe_profile_fit`, api/stage.py) or the next N
  batcher ticks (:func:`batch_tick`); :func:`capture_now` is the body of the
  live ``/profilez`` route (observability/server.py).
  :func:`capture_incident_profile` grabs a short window into a flight
  recorder incident bundle (observability/flightrecorder.py).
  ``CAPTURE_ENV=0`` is the kill-switch for every path. :func:`main` is
  the ``flink-ml-tpu-torch-trace efficiency`` view (``--check --min-util
  F``: 4 when a measured kernel's share sits below F, 2 on missing or torn
  artifacts, 0 on an honest ``host-fallback`` profile).

- **Attribution.** A stdlib-only parser of the exported trace
  (:func:`parse_profile_dir`) folds the device-lane events (``cat:
  "kernel"``: one per kernel the card ran) into per-kernel device-time
  tables: the CUDA symbols of the port's sources map to the ``KERNELS``
  names of ``ops/kernels.py`` (``ops`` rows keep the symbol), PyTorch's own
  kernels fold into ``fn="torch"``. The result lands as ``ml.deviceop
  selfMs{fn=,op=}`` histograms plus a ``profile.json`` artifact beside
  spans/metrics. A trace without device lanes (a CPU capture) reports
  ``source: host-fallback``: host ops are attributed, and nothing
  downstream calls them device time.

- **Efficiency.** :func:`efficiency_report` joins each kernel's measured
  device ms with the bytes and operations its launches in the window had to
  move and do (the ``ml.device launchBytes/launchFlops`` counters over the
  window, else the per-launch ``programBytes/programFlops`` gauges) into
  achieved rates and a roofline share against :data:`PEAK_FLOPS_ENV` /
  :data:`PEAK_BW_ENV` (defaults: one H100 SXM's data-sheet fp32 rate outside
  the tensor cores and its memory rate).

Boot-to-ready phase telemetry rides here too: :func:`boot_phase` wraps the
cold-start ladder in ``boot.*`` spans + ``ml.boot phaseMs{phase=}``
histograms, and :func:`mark_ready` latches ``bootToReadyMs``.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import re
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from flink_ml_tpu_torch.common import metrics as metrics_mod
from flink_ml_tpu_torch.common.locks import make_lock
from flink_ml_tpu_torch.common.metrics import ML_GROUP, metrics
from flink_ml_tpu_torch.observability import tracing
from flink_ml_tpu_torch.observability.compilestats import (
    COMPILE_BUCKETS,
    DEVICE_GROUP,
)

#: registry subgroup names: ml.deviceop / ml.efficiency / ml.boot
DEVICEOP_GROUP = "deviceop"
EFFICIENCY_GROUP = "efficiency"
BOOT_GROUP = "boot"

#: env var: "1" arms the next traced fit / next N batcher ticks for
#: capture; "0" is the kill-switch disabling EVERY capture path
#: (/profilez and incident capture included); unset leaves on-demand
#: and incident capture available but arms nothing
CAPTURE_ENV = "FLINK_ML_TPU_PROFILE_CAPTURE"
#: env var: batcher ticks one armed capture spans (default 3)
TICKS_ENV = "FLINK_ML_TPU_PROFILE_TICKS"
DEFAULT_TICKS = 3
#: env var: length of the bounded window a flight-recorder incident
#: captures into its bundle (default 200 ms; 0 disables)
INCIDENT_MS_ENV = "FLINK_ML_TPU_INCIDENT_PROFILE_MS"
DEFAULT_INCIDENT_MS = 200
#: env var: upper bound the /profilez route clamps requests to
PROFILEZ_MAX_MS_ENV = "FLINK_ML_TPU_PROFILEZ_MAX_MS"
DEFAULT_PROFILEZ_MAX_MS = 2000
#: env vars: hardware peaks the roofline measures against — defaults are
#: one H100 SXM's data-sheet rates at its full 700 W: 67 TFLOP/s in float32
#: outside the tensor cores (every kernel of the port computes in fp32 on
#: the CUDA cores) and 3.35 TB/s of device memory
PEAK_FLOPS_ENV = "FLINK_ML_TPU_PEAK_FLOPS"
DEFAULT_PEAK_FLOPS = 67e12
PEAK_BW_ENV = "FLINK_ML_TPU_PEAK_BW"
DEFAULT_PEAK_BW = 3.35e12

#: the attribution artifact written beside spans-*/metrics-* files
PROFILE_ARTIFACT = "profile.json"

#: ``efficiency`` exit codes: 4 a kernel below the --min-util floor, 2
#: missing or torn artifacts
EXIT_OK = 0
EXIT_INVALID = 2
EXIT_BELOW_FLOOR = 4

# module state: arming latches, live tick capture, boot latches — all
# guarded by _lock (short holds only; profiler calls stay outside)
_lock = make_lock("observability.profiling")
_owner_pid = os.getpid()
_fit_consumed = False
_tick_consumed = False
_tick_handle: Optional["CaptureHandle"] = None
_tick_remaining = 0
_boot_t0: Optional[float] = None
_boot_ready_ms: Optional[float] = None


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def capture_disabled() -> bool:
    """The kill-switch: ``CAPTURE_ENV=0`` turns every capture path off."""
    return os.environ.get(CAPTURE_ENV, "") == "0"


def _capture_armed() -> bool:
    return os.environ.get(CAPTURE_ENV, "") == "1"


def peak_flops() -> float:
    return _env_float(PEAK_FLOPS_ENV, DEFAULT_PEAK_FLOPS)


def peak_bw() -> float:
    return _env_float(PEAK_BW_ENV, DEFAULT_PEAK_BW)


# -- capture ------------------------------------------------------------------
_active_trace: Optional[Tuple[object, str]] = None  # (profiler, out dir)


def _profiler_start(log_dir: str) -> None:
    """Seam over ``common.metrics.start_trace`` — tests monkeypatch this to
    a fake that drops a fixture trace file, so capture-path coverage does
    not depend on the host's profiler producing device lanes."""
    global _active_trace
    _active_trace = (metrics_mod.start_trace(), log_dir)


def _profiler_stop() -> None:
    """Seam over ``common.metrics.stop_trace`` (see
    :func:`_profiler_start`): writes the window's Chrome trace into the
    directory the window started with."""
    global _active_trace
    active, _active_trace = _active_trace, None
    if active is not None:
        metrics_mod.stop_trace(*active)


_DEVICE_KEY = re.compile(r'^(\w+)\{fn="((?:[^"\\]|\\.)*)"\}$')


def _device_series(snapshot: Optional[dict], section: str,
                   names) -> Dict[str, Dict[str, float]]:
    """``fn → {name: value}`` of the ``ml.device`` series ``names`` (keys
    ``name{fn="..."}``) in one section of a registry snapshot: the launch
    counters and per-launch cost gauges of compilestats.capture_cost."""
    entries = ((snapshot or {}).get(f"{ML_GROUP}.{DEVICE_GROUP}") or {}
               ).get(section, {})
    out: Dict[str, Dict[str, float]] = {}
    for key, val in entries.items():
        m = _DEVICE_KEY.match(key)
        if m is not None and m.group(1) in names:
            try:
                out.setdefault(m.group(2), {})[m.group(1)] = float(val)
            except (TypeError, ValueError):
                continue
    return out


def _launch_costs() -> Dict[str, Dict[str, int]]:
    """``fn → {launches, bytes, flops}`` of the ``ml.device`` launch
    counters now."""
    fields = {"launches": "launches", "launchBytes": "bytes",
              "launchFlops": "flops"}
    return {fn: {fields[k]: int(v) for k, v in series.items()}
            for fn, series in _device_series(
                metrics.snapshot(), "counters", fields).items()}


class CaptureHandle:
    """One in-flight capture: where the raw trace lands (``dir``), where
    ``profile.json`` is published (``artifact_dir``), the launch counters
    when the window opened, and — after the window closes — the parsed
    attribution ``report`` (None when the capture produced nothing
    parseable)."""

    def __init__(self, label: str, dir: str, artifact_dir: str):
        self.label = label
        self.dir = dir
        self.artifact_dir = artifact_dir
        self.report: Optional[dict] = None
        self.costs_before = _launch_costs()


def _begin_capture(label: str, out_dir: Optional[str] = None,
                   artifact_dir: Optional[str] = None
                   ) -> Optional[CaptureHandle]:
    """Claim the profiler and start a trace. Returns None (refusing,
    never raising) when capture is killed, this is not the driver
    process, another trace is active, or the profiler fails to start."""
    if capture_disabled():
        return None
    if os.getpid() != _owner_pid:
        return None  # forked children never profile (reseed_child)
    safe = re.sub(r"[^A-Za-z0-9_.-]+", "-", label) or "capture"
    if out_dir is None:
        trace_dir = tracing.tracer.trace_dir
        if trace_dir:
            from flink_ml_tpu_torch.observability.exporters import (
                artifact_suffix)

            out_dir = os.path.join(
                trace_dir, f"profile-{safe}-{artifact_suffix()}")
            artifact_dir = artifact_dir or trace_dir
        else:
            out_dir = tempfile.mkdtemp(prefix=f"flink-ml-tpu-{safe}-")
    artifact_dir = artifact_dir or out_dir
    if not metrics_mod.claim_profiler():
        return None  # one trace at a time — shared with metrics.profile()
    handle = CaptureHandle(label, out_dir, artifact_dir)
    try:
        os.makedirs(out_dir, exist_ok=True)
        _profiler_start(out_dir)
    except Exception:  # noqa: BLE001 — capture must not sink the workload
        metrics_mod.release_profiler()
        return None
    return handle


def _finish_capture(handle: CaptureHandle) -> Optional[dict]:
    """Stop the trace, release the claim, parse + publish attribution.
    Best-effort end to end: a torn capture leaves no artifact and no
    exception in the caller."""
    try:
        _profiler_stop()
    except Exception:  # noqa: BLE001 — a failed stop must still release
        metrics_mod.release_profiler()
        return None
    metrics_mod.release_profiler()
    try:
        report = parse_profile_dir(handle.dir)
    except ProfileParseError:
        return None
    report["label"] = handle.label
    _attach_window_costs(report, handle.costs_before, _launch_costs())
    try:
        write_profile_artifact(handle.artifact_dir, report)
    except OSError:
        pass  # the in-registry histograms below are still worth having
    _record_report(report)
    handle.report = report
    return report


def _attach_window_costs(report: dict, before: dict, after: dict) -> None:
    """Give each fn row the launches, bytes and operations of its kernel
    launches inside the window (the launch counters' deltas), where the
    window saw any."""
    for row in report.get("fns", []):
        now, then = after.get(row["fn"], {}), before.get(row["fn"], {})
        launches = now.get("launches", 0) - then.get("launches", 0)
        if launches > 0:
            row["launches"] = launches
            row["bytes"] = now.get("bytes", 0) - then.get("bytes", 0)
            row["flops"] = now.get("flops", 0) - then.get("flops", 0)


def _record_report(report: dict) -> None:
    """Fold a parsed report into the live registry: ``ml.deviceop``
    self-time histograms always; ``ml.efficiency`` gauges only when the
    report carries real device lanes (host-fallback must not claim
    utilization)."""
    grp = metrics.group(ML_GROUP, DEVICEOP_GROUP)
    for row in report.get("ops", []):
        grp.histogram("selfMs", buckets=COMPILE_BUCKETS,
                      labels={"fn": row["fn"], "op": row["op"]}
                      ).observe(row["selfMs"])
    if report.get("source") != "device":
        return
    try:
        eff = efficiency_report(None, profile=report,
                                snapshot=metrics.snapshot())
    except ProfileParseError:
        return
    grp = metrics.group(ML_GROUP, EFFICIENCY_GROUP)
    for row in eff["fns"]:
        labels = {"fn": row["fn"]}
        for field in ("achievedFlops", "achievedBw", "utilization"):
            if row.get(field) is not None:
                grp.gauge(field, row[field], labels=labels)


@contextlib.contextmanager
def profile_window(label: str, out_dir: Optional[str] = None,
                   artifact_dir: Optional[str] = None):
    """Capture a device profile around a region. Yields a
    :class:`CaptureHandle` (its ``report`` is filled in after the block
    exits) or None when capture was refused — killed, non-driver
    process, or another trace already active. Never raises into the
    workload; the region body runs either way."""
    handle = _begin_capture(label, out_dir=out_dir, artifact_dir=artifact_dir)
    try:
        yield handle
    finally:
        if handle is not None:
            _finish_capture(handle)


def capture_now(ms: int) -> Optional[dict]:
    """The ``/profilez?ms=`` body: a bounded wall-clock capture window.
    Returns ``{"label", "dir", "ms", "report"}`` on success (``report``
    None when the capture parsed to nothing) or None when refused —
    the route answers 409 then."""
    if capture_disabled():
        return None
    max_ms = max(1, _env_int(PROFILEZ_MAX_MS_ENV, DEFAULT_PROFILEZ_MAX_MS))
    ms = max(1, min(int(ms), max_ms))
    with profile_window(f"profilez-{ms}ms") as handle:
        if handle is None:
            return None
        time.sleep(ms / 1000.0)
    return {"label": handle.label, "dir": handle.dir, "ms": ms,
            "report": handle.report}


def _backend_ready() -> bool:
    """True when a capture cannot initialize the card: no card is
    present (the window records the host alone), or CUDA is already
    initialized in this process. Telemetry never initializes a backend —
    a profiler window with CUDA activities on a process that has not
    touched the card yet would bring up its context (and CUPTI) from
    inside an incident dump."""
    import torch

    return (not torch.cuda.is_available()) or torch.cuda.is_initialized()


def capture_incident_profile(bundle_dir: str) -> bool:
    """Flight-recorder hook: grab a short bounded profile into an
    incident bundle (raw trace under ``<bundle>/profile/``, attribution
    at ``<bundle>/profile.json``). Refuses — returning False, never
    raising or initializing the card — when capture is killed,
    :data:`INCIDENT_MS_ENV` is 0, or the card is present but this
    process has not initialized CUDA yet."""
    if capture_disabled():
        return False
    ms = _env_int(INCIDENT_MS_ENV, DEFAULT_INCIDENT_MS)
    if ms <= 0:
        return False
    if not _backend_ready():
        return False  # never initialize a backend from telemetry
    ms = min(ms, DEFAULT_PROFILEZ_MAX_MS)
    out = os.path.join(bundle_dir, "profile")
    with profile_window("incident", out_dir=out,
                        artifact_dir=bundle_dir) as handle:
        if handle is None:
            return False
        time.sleep(ms / 1000.0)
    return True


def _ticks() -> int:
    return max(1, _env_int(TICKS_ENV, DEFAULT_TICKS))


def batch_tick() -> None:
    """Per-dispatch hook (serving/batcher.py): when :data:`CAPTURE_ENV`
    armed this process, start a capture at the next tick and stop it
    after N ticks — once per process (reset with :func:`reset`). The
    unarmed steady state costs one env read."""
    global _tick_handle, _tick_remaining, _tick_consumed
    if _tick_handle is None and not _capture_armed():
        return
    handle = None
    start = False
    with _lock:
        if _tick_handle is not None:
            _tick_remaining -= 1
            if _tick_remaining <= 0:
                handle, _tick_handle = _tick_handle, None
        elif _capture_armed() and not _tick_consumed:
            _tick_consumed = True
            start = True
    if handle is not None:
        _finish_capture(handle)
        return
    if start:
        n = _ticks()
        new = _begin_capture(f"batcher-{n}ticks")
        if new is not None:
            with _lock:
                _tick_handle = new
                _tick_remaining = n


@contextlib.contextmanager
def maybe_profile_fit(region: str):
    """Arm-next-fit seam (api/stage.py ``_profiled``): with
    :data:`CAPTURE_ENV` armed, wrap the next traced fit/transform in a
    :func:`profile_window` — one-shot per process."""
    global _fit_consumed
    fire = False
    if _capture_armed():
        with _lock:
            if not _fit_consumed:
                _fit_consumed = True
                fire = True
    if not fire:
        yield None
        return
    with profile_window(f"fit-{region}") as handle:
        yield handle


def reset() -> None:
    """Re-arm the one-shot fit/tick latches (tests)."""
    global _fit_consumed, _tick_consumed, _tick_handle, _tick_remaining
    with _lock:
        _fit_consumed = False
        _tick_consumed = False
        _tick_handle = None
        _tick_remaining = 0


def reseed_child() -> None:
    """Fork boundary (common/hostpool.py ``_child_main``): children
    never profile — the driver owns the single profiler slot — and
    the inherited lock may have been held at fork time, so replace it
    rather than acquire it (the common/metrics reseed pattern)."""
    global _lock, _owner_pid, _tick_handle, _tick_remaining
    _lock = make_lock("observability.profiling")
    _owner_pid = -1
    _tick_handle = None
    _tick_remaining = 0


# -- attribution --------------------------------------------------------------
class ProfileParseError(ValueError):
    """A profile artifact that cannot be read/parsed — the exit-2 class."""


#: Chrome-trace event categories that are the card's own lanes
DEVICE_CATEGORIES = ("kernel",)

#: host-side categories whose kernel launches are matched to the device lane
_LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")

_SYMBOL = re.compile(r"([A-Za-z_][A-Za-z0-9_]*)\s*(?:<|\()")


def find_trace_file(profile_dir: str) -> Optional[str]:
    """The newest Chrome-format trace under ``profile_dir``:
    ``*.trace.json`` (what ``torch.profiler`` exports) or
    ``*.trace.json.gz`` (what the JAX package's profiler writes)."""
    newest, newest_m = None, -1.0
    for root, _dirs, files in os.walk(profile_dir):
        for name in files:
            if not name.endswith((".trace.json", ".trace.json.gz")):
                continue
            path = os.path.join(root, name)
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                continue
            if mtime >= newest_m:
                newest, newest_m = path, mtime
    return newest


_MANGLED = re.compile(r"^_Z(\d+)")


def kernel_symbol(name: str) -> str:
    """The bare function name of a CUDA kernel symbol: demangled
    (``void sgd_rows_kernel<0, 4, 1>(float const*, ...)``) or mangled
    (``_Z15sgd_rows_kernelILi0E...``) → ``sgd_rows_kernel``; a name
    without a signature is returned as is."""
    m = _MANGLED.match(name)
    if m is not None:
        start = m.end()
        return name[start:start + int(m.group(1))]
    for m in _SYMBOL.finditer(name):
        if m.group(1) not in ("void", "const", "unsigned"):
            return m.group(1)
    return name.strip()


def _kernel_fn(symbol: str) -> str:
    """The ``KERNELS`` name of one of the port's CUDA symbols, else
    ``torch`` (a kernel of PyTorch's own operators)."""
    from flink_ml_tpu_torch.ops.kernels import KERNEL_SYMBOLS

    return KERNEL_SYMBOLS.get(symbol, "torch")


def _load_trace(path: str) -> dict:
    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            doc = json.loads(f.read().decode("utf-8"))
    except (OSError, EOFError, ValueError) as exc:
        raise ProfileParseError(f"unreadable profile trace {path}: {exc}")
    if not isinstance(doc, dict) or \
            not isinstance(doc.get("traceEvents"), list):
        raise ProfileParseError(
            f"{path}: not a Chrome-format trace (no traceEvents list)")
    return doc


def parse_trace_file(path: str) -> dict:
    """Fold one Chrome-format trace into per-op and per-fn device-time
    tables (see module doc). Device lanes are the complete events of
    :data:`DEVICE_CATEGORIES` (the kernels CUPTI saw the card run); with
    none present (a CPU capture) every complete event is folded instead,
    under ``fn="host"``, and the report says so (``source:
    host-fallback``). ``launches`` counts the host's kernel launches and
    ``launchesWithoutKernel`` those whose kernel the device lane lacks."""
    events = _load_trace(path)["traceEvents"]
    device = any(isinstance(ev, dict) and ev.get("ph") == "X"
                 and ev.get("cat") in DEVICE_CATEGORIES for ev in events)
    launched, ran = _launch_correlations(events)
    source = "device" if device else "host-fallback"
    op_ms: Dict[Tuple[str, str], float] = {}
    op_count: Dict[Tuple[str, str], int] = {}
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        if device and ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        try:
            dur_ms = float(ev.get("dur", 0.0)) / 1000.0  # trace dur is µs
        except (TypeError, ValueError):
            continue
        if dur_ms <= 0:
            continue
        name = str(ev.get("name", ""))
        if device:
            op = kernel_symbol(name)
            fn = _kernel_fn(op)
        else:
            op, fn = name, "host"
        key = (op, fn)
        op_ms[key] = op_ms.get(key, 0.0) + dur_ms
        op_count[key] = op_count.get(key, 0) + 1
    fns: Dict[str, dict] = {}
    for (op, fn), ms in op_ms.items():
        if not device:
            continue  # host time is attributed per op, never as an fn
        row = fns.setdefault(fn, {"fn": fn, "deviceMs": 0.0, "count": 0})
        row["deviceMs"] += ms
        row["count"] += op_count[(op, fn)]
    for row in fns.values():
        row["deviceMs"] = round(row["deviceMs"], 6)
    ops = [{"op": op, "fn": fn, "selfMs": round(ms, 6),
            "count": op_count[(op, fn)]}
           for (op, fn), ms in op_ms.items()]
    ops.sort(key=lambda r: (-r["selfMs"], r["op"], r["fn"]))
    fn_rows = sorted(fns.values(),
                     key=lambda r: (-r["deviceMs"], r["fn"]))
    total = sum(r["deviceMs"] for r in fn_rows) if fn_rows else \
        sum(r["selfMs"] for r in ops)
    return {"source": source, "totalMs": round(total, 6),
            "ops": ops, "fns": fn_rows, "launches": len(launched),
            "launchesWithoutKernel": len(launched - ran)}


def _launch_correlations(events) -> Tuple[set, set]:
    """(correlation ids of the host's kernel launches, correlation ids of
    the kernels on the device lane). A launch whose id the device lane
    lacks is a kernel the capture dropped: a ``host-fallback`` window with
    launches in it lost its kernels, one without launched none."""
    launched, ran = set(), set()
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        args = ev.get("args")
        corr = args.get("correlation") if isinstance(args, dict) else None
        if corr is None:
            continue
        cat = ev.get("cat")
        if cat in DEVICE_CATEGORIES:
            ran.add(corr)
        elif cat in _LAUNCH_CATEGORIES and \
                "LaunchKernel" in str(ev.get("name", "")):
            launched.add(corr)
    return launched, ran


def parse_profile_dir(profile_dir: str) -> dict:
    """Parse the newest trace file under ``profile_dir``; raises
    :class:`ProfileParseError` when there is none or it is torn."""
    trace_file = find_trace_file(profile_dir)
    if trace_file is None:
        raise ProfileParseError(
            f"no *.trace.json or *.trace.json.gz under {profile_dir}")
    report = parse_trace_file(trace_file)
    report["traceFile"] = os.path.relpath(trace_file, profile_dir)
    return report


def write_profile_artifact(trace_dir: str, report: dict) -> str:
    """Publish ``profile.json`` atomically beside the trace artifacts."""
    path = os.path.join(trace_dir, PROFILE_ARTIFACT)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def read_profile(trace_dir: str) -> dict:
    """Load ``profile.json`` from a trace dir; raises
    :class:`ProfileParseError` (the exit-2 class) when missing/torn."""
    path = os.path.join(trace_dir, PROFILE_ARTIFACT)
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except FileNotFoundError:
        raise ProfileParseError(f"no {PROFILE_ARTIFACT} in {trace_dir}")
    except (OSError, ValueError) as exc:
        raise ProfileParseError(f"unreadable {path}: {exc}")
    if not isinstance(doc, dict) or not isinstance(doc.get("fns"), list) \
            or "source" not in doc:
        raise ProfileParseError(f"{path}: not a profile attribution artifact")
    return doc


# -- efficiency ---------------------------------------------------------------
def efficiency_report(trace_dir: Optional[str],
                      profile: Optional[dict] = None,
                      snapshot: Optional[dict] = None,
                      pf: Optional[float] = None,
                      pb: Optional[float] = None) -> dict:
    """Join a profile's measured per-kernel device ms with the bytes and
    operations those launches had to move and do into achieved rates and
    a roofline share. A row's work is its window's launch totals
    (``bytes``/``flops``/``launches`` on the profile row), else the
    ``programBytes``/``programFlops`` gauges of the snapshot times the
    row's ``launches`` when known (one launch otherwise). The least time
    the card could take is the larger of bytes over the memory rate and
    operations over the operation rate; ``utilization`` is that time over
    the measured time, and ``bound`` names the larger term ("bandwidth" or
    "compute"). On ``host-fallback`` profiles every achieved/utilization
    field is None: host ms against device peaks would be a lie. Raises
    :class:`ProfileParseError` when the artifacts are missing/torn."""
    if profile is None:
        profile = read_profile(trace_dir)
    if snapshot is None:
        from flink_ml_tpu_torch.observability.exporters import read_metrics

        snapshot = read_metrics(trace_dir)
    pf = pf if pf else peak_flops()
    pb = pb if pb else peak_bw()
    costs = _device_series(snapshot, "gauges",
                           ("programBytes", "programFlops"))
    measured = profile.get("source") == "device"
    rows: List[dict] = []
    for fn_row in profile.get("fns", []):
        fn = fn_row["fn"]
        ms = float(fn_row.get("deviceMs", 0.0))
        launches = fn_row.get("launches")
        if "bytes" in fn_row or "flops" in fn_row:
            nbytes, flops = fn_row.get("bytes"), fn_row.get("flops")
        else:
            cost = costs.get(fn, {})
            times = launches or 1
            nbytes = (cost["programBytes"] * times
                      if "programBytes" in cost else None)
            flops = (cost["programFlops"] * times
                     if "programFlops" in cost else None)
        row = {"fn": fn, "deviceMs": ms, "launches": launches,
               "programFlops": flops, "programBytes": nbytes,
               "achievedFlops": None, "achievedBw": None,
               "boundMs": None, "utilization": None, "bound": None}
        if measured and ms > 0 and (flops or nbytes):
            secs = ms / 1000.0
            by_bytes = (nbytes or 0.0) / pb
            by_ops = (flops or 0.0) / pf
            if flops:
                row["achievedFlops"] = flops / secs
            if nbytes:
                row["achievedBw"] = nbytes / secs
            row["bound"] = "bandwidth" if by_bytes >= by_ops else "compute"
            row["boundMs"] = max(by_bytes, by_ops) * 1000.0
            row["utilization"] = max(by_bytes, by_ops) / secs
        rows.append(row)
    return {"source": profile.get("source"), "peakFlops": pf, "peakBw": pb,
            "ridge": pf / pb, "fns": rows}


def _fmt(val, pattern: str = "{:.3g}") -> str:
    return "—" if val is None else pattern.format(val)


def render_efficiency(report: dict) -> str:
    """The human rendering: one roofline header + one row per fn."""
    lines = [
        "source: {}  peaks {:.3g} FLOP/s / {:.3g} B/s  "
        "ridge {:.4g} FLOP/B".format(report["source"], report["peakFlops"],
                                     report["peakBw"], report["ridge"]),
        "{:<24} {:>10} {:>14} {:>12} {:>8}  {}".format(
            "fn", "deviceMs", "achievedFlops", "achievedBw", "util",
            "bound"),
    ]
    for row in report["fns"]:
        util = row["utilization"]
        lines.append("{:<24} {:>10.3f} {:>14} {:>12} {:>8}  {}".format(
            row["fn"], row["deviceMs"], _fmt(row["achievedFlops"]),
            _fmt(row["achievedBw"]),
            "—" if util is None else f"{util * 100.0:.1f}%",
            row["bound"] or "—"))
    if not report["fns"]:
        lines.append("(no per-fn device time attributed)")
    if report["source"] != "device":
        lines.append("host-fallback profile: no device lanes — achieved "
                     "rates and utilization are not claimed")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    """``flink-ml-tpu-torch-trace efficiency <dir> [--json|--check
    --min-util F]`` — exit 0 ok (including honest host-fallback), 2 on
    missing/torn artifacts, 4 when any measured fn's utilization sits
    below the floor."""
    parser = argparse.ArgumentParser(
        prog="flink-ml-tpu-torch-trace efficiency",
        description="Measured device time against each kernel's bytes "
                    "and operations: achieved rates and roofline share "
                    "per kernel.")
    parser.add_argument("dir", help="trace dir holding profile.json "
                                    "and metrics-*.json")
    parser.add_argument("--latest", action="store_true",
                        help="treat DIR as a root; use its newest trace dir")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable report on stdout")
    parser.add_argument("--check", action="store_true",
                        help="gate: exit 4 when a measured fn's "
                             "utilization is below --min-util")
    parser.add_argument("--min-util", type=float, default=0.0,
                        metavar="F",
                        help="utilization floor as a fraction (0.4 = 40%%)")
    parser.add_argument("--peak-flops", type=float, default=None,
                        help=f"override {PEAK_FLOPS_ENV}")
    parser.add_argument("--peak-bw", type=float, default=None,
                        help=f"override {PEAK_BW_ENV}")
    args = parser.parse_args(argv)

    from flink_ml_tpu_torch.observability.exporters import resolve_trace_dir

    try:
        trace_dir = resolve_trace_dir(args.dir, latest=args.latest)
        report = efficiency_report(trace_dir, pf=args.peak_flops,
                                   pb=args.peak_bw)
    except (ProfileParseError, OSError) as exc:
        print(f"efficiency: {exc}", file=sys.stderr)
        return EXIT_INVALID
    if args.as_json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(render_efficiency(report))
    if args.check:
        low = [r for r in report["fns"]
               if r["utilization"] is not None
               and r["utilization"] < args.min_util]
        if low:
            for row in low:
                print("efficiency: {} utilization {:.1f}% below floor "
                      "{:.1f}%".format(row["fn"],
                                       row["utilization"] * 100.0,
                                       args.min_util * 100.0),
                      file=sys.stderr)
            return EXIT_BELOW_FLOOR
    return EXIT_OK


# -- boot-to-ready phase telemetry --------------------------------------------
#: the cold-start ladder, in boot order (docs/observability.md)
BOOT_PHASES = ("distributed-init", "mesh-build", "warmup-compile",
               "registry-adopt", "gate-open")


@contextlib.contextmanager
def boot_phase(phase: str):
    """Time one boot phase: a ``boot.<phase>`` span plus an ``ml.boot
    phaseMs{phase=}`` observation. The first call starts the
    boot-to-ready clock; after :func:`mark_ready` latches, a no-op —
    steady-state re-adopts/re-warms must not pollute boot telemetry."""
    global _boot_t0
    with _lock:
        live = _boot_ready_ms is None
        if live and _boot_t0 is None:
            _boot_t0 = time.monotonic()
    if not live:
        yield
        return
    span = tracing.tracer.span(f"boot.{phase}", phase=phase) \
        if tracing.tracer.active else contextlib.nullcontext()
    start = time.perf_counter()
    with span:
        try:
            yield
        finally:
            elapsed_ms = (time.perf_counter() - start) * 1000.0
            metrics.group(ML_GROUP, BOOT_GROUP).histogram(
                "phaseMs", buckets=COMPILE_BUCKETS,
                labels={"phase": phase}).observe(elapsed_ms)


def mark_ready() -> None:
    """Latch boot completion (first call wins): the gate is open and the
    process serves/fits. Records the ``bootToReadyMs`` gauge fleet
    beacons carry and a ``boot.ready`` event."""
    global _boot_ready_ms
    with _lock:
        if _boot_ready_ms is not None:
            return
        _boot_ready_ms = 0.0 if _boot_t0 is None else \
            (time.monotonic() - _boot_t0) * 1000.0
        ready_ms = _boot_ready_ms
    metrics.group(ML_GROUP, BOOT_GROUP).gauge("bootToReadyMs", ready_ms)
    tracing.event("boot.ready", bootToReadyMs=round(ready_ms, 3))


def boot_to_ready_ms() -> Optional[float]:
    """The latched boot-to-ready duration; None before :func:`mark_ready`
    (the fleet beacon's per-member field)."""
    with _lock:
        return _boot_ready_ms


def reset_boot() -> None:
    """Clear the boot latches (tests)."""
    global _boot_t0, _boot_ready_ms
    with _lock:
        _boot_t0 = None
        _boot_ready_ms = None


if __name__ == "__main__":
    sys.exit(main())
