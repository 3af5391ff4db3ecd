"""The traced window: ``torch.profiler`` over whole calls, and what the
per-layer metrics read from it.

The window runs calls back to back for a fixed time under the profiler
(CPU and CUDA activities), each call inside the harness's own spans
(``portbench.<name>``, ``record_function``), ends with a synchronize, and
exports a Chrome trace. From the trace: the device operations (kernels,
copies, sets) and their union over the window (busy time), the idle time
between them split by what the host did meanwhile (the harness span and
the outermost host operation), the device time of the kernels that are not
PyTorch's own, and the count of device operations.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."
#: namespaces of the kernels PyTorch launches for its own operators (its
#: elementwise, reduction, indexing and sort kernels, its copy of CUB)
TORCH_NAMESPACES = ("at::", "at_cuda_detail::", "c10::")


def _interval(ev: dict) -> Tuple[float, float]:
    start = float(ev["ts"])
    return start, start + float(ev.get("dur", 0.0))


def _unqualified(name: str) -> str:
    return re.sub(r"^(void|__global__)\s+", "",
                  name.replace("(anonymous namespace)::", "").strip())


def is_program_kernel(name: str) -> bool:
    """A kernel's trace name is not one of PyTorch's own operators."""
    bare = re.sub(r"^(void|__global__)\s+", "", name.strip())
    return not bare.startswith(TORCH_NAMESPACES)


def _short(name: str) -> str:
    """A device operation's name without its argument list."""
    name = _unqualified(name)
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


def _outermost(intervals) -> List[Tuple[float, float, str]]:
    """The intervals no other one contains, sorted by start (they do not
    overlap where the host ran one thread)."""
    out: List[Tuple[float, float, str]] = []
    for iv in sorted(intervals, key=lambda t: (t[0], -t[1])):
        if not out or iv[0] >= out[-1][1]:
            out.append(iv)
    return out


def _covering(intervals, at: float):
    """The interval of the sorted, disjoint ``intervals`` holding ``at``."""
    i = bisect.bisect_right(intervals, at, key=lambda iv: iv[0]) - 1
    return intervals[i] if i >= 0 and at < intervals[i][1] else None


class TraceWindow:
    """What one traced window holds. Times in seconds."""

    def __init__(self, events: List[dict], calls: int):
        self.calls = calls
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith(SPAN_PREFIX)]
        self.device_ops = sorted(
            (_interval(e) + (str(e.get("name", "")),) for e in events
             if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS),
            key=lambda t: t[0])
        self.kernels = [_interval(e) + (str(e.get("name", "")),)
                        for e in events
                        if e.get("ph") == "X" and e.get("cat") == "kernel"]
        self.host_ops = _outermost(
            _interval(e) + (str(e.get("name", "")),) for e in events
            if e.get("ph") == "X" and e.get("cat") == "cpu_op")
        self.spans = [_interval(e) + (str(e["name"])[len(SPAN_PREFIX):],)
                      for e in spans]
        self._inner_spans = _outermost(s for s in self.spans
                                       if s[2] != "call")
        calls_spans = [s for s in self.spans if s[2] == "call"]
        if calls_spans:
            self.start = min(s[0] for s in calls_spans)
            self.end = max(s[1] for s in calls_spans)
        else:
            self.start = self.end = 0.0
        self._merged = self._merge()

    def _merge(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for s, e, _ in self.device_ops:
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._merged) * 1e-6

    def operations(self) -> int:
        """Device operations (kernels, copies, sets) that began in the
        window: what the host enqueued."""
        return sum(1 for s, _, _ in self.device_ops
                   if self.start <= s < self.end)

    def program_kernel_seconds(self) -> float:
        """Device seconds of every kernel in the window that is not one of
        PyTorch's own operators (:data:`TORCH_NAMESPACES`): the kernels the
        program built and launched itself, and any library kernel it
        called."""
        return sum(min(e, self.end) - max(s, self.start)
                   for s, e, name in self.kernels
                   if is_program_kernel(name)
                   and min(e, self.end) > max(s, self.start)) * 1e-6

    def top_device_ops(self, count: int = 10) -> list:
        by_name: Dict[str, float] = defaultdict(float)
        for s, e, name in self.device_ops:
            by_name[_short(name)] += (e - s) * 1e-6
        return sorted(([n, t] for n, t in by_name.items()),
                      key=lambda nt: -nt[1])[:count]

    def idle_gaps(self, count: int = 10) -> list:
        """Idle device time by what the host was doing meanwhile: the
        harness span open and the outermost host operation, or ``python``
        between operations; the ``count`` largest totals."""
        edges = [self.start] + [t for iv in self._merged for t in iv] \
            + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        by_label: Dict[str, float] = defaultdict(float)
        ops, j = self.host_ops, 0
        for s, e in gaps:
            while j < len(ops) and ops[j][1] <= s:
                j += 1
            at, k = s, j
            while at < e:
                if k < len(ops) and ops[k][0] <= at:
                    stop, what = min(e, ops[k][1]), ops[k][2]
                    k += 1
                else:
                    stop = min(e, ops[k][0]) if k < len(ops) else e
                    what = "python"
                span = _covering(self._inner_spans, at)
                by_label[f"{span[2] if span else 'loop'}:{what}"] += \
                    (stop - at) * 1e-6
                at = stop
        return sorted(([n, t] for n, t in by_label.items()),
                      key=lambda nt: -nt[1])[:count]


def traced_window(drive: Callable[[float], int], seconds: float,
                  out_path: Path) -> TraceWindow:
    """Runs ``drive(seconds)`` (the cell's loop, each call inside a
    ``call`` span; it returns the number of calls) under the profiler,
    writes the Chrome trace to ``out_path`` and reads it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        calls = drive(seconds)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_path))
    with open(out_path) as f:
        events = json.load(f)["traceEvents"]
    return TraceWindow(events, calls)
