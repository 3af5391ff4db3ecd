"""One run of one cell: set-up, the measured window, the traced window, the
check against the reference, and the result line.

``run_cell`` does the work and returns the result; ``main`` is the command
line of ``portbench/run.py``. A cell of ``BENCHMARK.json`` names a
configuration and a traffic mix, found by name under ``portbench/``
(``configs/``, ``traffic/``). The traffic mix names its loop
(``loops/<loop>.py``: how calls arrive in the window) and its call
(``calls/<call>.py``: what one call does and how its answers are judged);
the configuration names its algorithm (``reference/<algorithm>.py``, the
plain reference; ``cost/<algorithm>.py``, the bytes and operations of one
call); each metric that applies to the cell is read by
``metrics/<name>.py``.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch

from portbench.harness import datagen
from portbench.harness.trace import SPAN_PREFIX, traced_window

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
OUT = BENCH / "out"
PROGRAM = "flink_ml_tpu_torch"
#: window answers a run judges besides the last one
SAMPLE = 16
#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "flink_ml_tpu")


class BenchError(Exception):
    """A run that cannot give a result (no card, a forbidden module, a cell
    that does not resolve); its message goes to standard error."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.is_file():
        raise BenchError(f"no {kind} file {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve(spec: dict, workload: str):
    """The cell's entry, its configuration's entry, and its metrics: the
    end-to-end and per-layer entries that apply to it."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise BenchError(f"no workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}

    def applies(m):
        return workload in m.get("workloads", cells)

    return (cell, configs[cell["config"]],
            [m for m in spec["end_to_end"] if applies(m)],
            [m for m in spec["per_layer"] if applies(m)])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (the port's own name begins with ``flink_ml_tpu``)."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".", 1)[0] in FORBIDDEN)


def derived_seed(seed: int) -> int:
    """A stage's seed param from the run's seed: a non-negative 63-bit int."""
    return seed % (1 << 63)


class Run:
    """What a call module's ``judge`` and the metric readers see of a run.

    The judge: ``inputs`` (the generated columns, name → tensor on the
    device), ``params`` (the stage's, as run), ``limits`` (the check's),
    ``answers`` (the answers of a seeded sample of the window's calls and
    of the last) and ``call(**params)`` (the answer of one more call of the
    program after the window, some params changed).

    The readers: ``on_card``; the window's ``calls``, ``window_s``,
    ``latencies_s`` and ``rows_per_call``; ``setup_s``; ``call_bytes`` and
    ``call_ops`` of one call (the call module's ``cost``); ``trace``, a
    :class:`~portbench.harness.trace.TraceWindow` in a traced run, else
    None.
    """

    trace = None


def _check_program() -> None:
    """The program is importable and comes from this checkout."""
    try:
        package = importlib.import_module(PROGRAM)
    except ImportError as e:
        raise BenchError(f"{PROGRAM} cannot be imported: {e}") from e
    if not Path(package.__file__).resolve().is_relative_to(ROOT):
        raise BenchError(f"{PROGRAM} was loaded from {package.__file__}, "
                         f"not from the checkout at {ROOT}")


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def power_limit() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card, if it answers."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


class Cell:
    """One cell resolved: its entries, configuration, traffic with its loop
    and call, reference and cost. ``spec`` and ``config`` replace
    ``BENCHMARK.json`` and the cell's configuration file (tests run tiny
    copies on the CPU)."""

    def __init__(self, workload: str, device: str = "cuda",
                 spec: Optional[dict] = None, config: Optional[dict] = None):
        spec = spec if spec is not None else load_json(
            ROOT / "BENCHMARK.json")
        self.name, self.device = workload, device
        self.entry, conf_entry, self.end_to_end, self.per_layer = resolve(
            spec, workload)
        self.config = config if config is not None else load_json(
            ROOT / conf_entry["file"])
        self.traffic = load_json(
            BENCH / "traffic" / f"{self.entry['traffic']}.json")
        self.loop = load_module("loops", self.traffic["loop"])
        self.calls = load_module("calls", self.traffic["call"])
        if device == "cuda":
            if not torch.cuda.is_available():
                raise BenchError("no CUDA device")
            if torch.cuda.device_count() < self.entry["chips"]:
                raise BenchError(f"{self.entry['chips']} cards asked for, "
                                 f"{torch.cuda.device_count()} present")
        self.reference = load_module("reference", self.config["algorithm"])
        self.cost = load_module("cost", self.config["algorithm"])
        _check_program()

    def inputs(self, seed: int) -> dict:
        """The cell's input columns drawn from ``seed`` on the device."""
        return datagen.generate(self.config["inputData"], seed, self.device)

    def params(self, seed: int) -> dict:
        """The stage's params as run with ``seed``."""
        stage = self.config["stage"]
        params = dict(stage["paramMap"])
        for name in stage.get("seeded", ()):
            params[name] = derived_seed(seed)
        return params

    def caller(self, inputs: dict, params: dict):
        """``call(**changed)``: one call of the traffic (``calls/<call>.py``)
        → its answer."""
        return self.calls.make(self, inputs, params)

    def judge(self, inputs: dict, params: dict, answers: list, call):
        """The numbers of ``answers`` and ``call`` (the program's, or the
        control's) → (numbers, failed)."""
        run = Run()
        run.inputs, run.params, run.limits = inputs, params, \
            self.config["limits"]
        run.answers, run.call = answers, call
        return self.calls.judge(self, run)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spec: Optional[dict] = None,
             config: Optional[dict] = None, t0: Optional[float] = None
             ) -> dict:
    """One run of ``workload``; returns the result line's object. ``t0`` is
    when set-up began (default: now)."""
    t0 = time.perf_counter() if t0 is None else t0
    phases = {"imports": time.perf_counter() - t0}
    cell = Cell(workload, device, spec, config)
    config, traffic = cell.config, cell.traffic
    metrics_run = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: load_module("metrics", m["name"])
               for m in metrics_run}
    if device == "cuda":
        torch.cuda.init()
    phases["cell"] = time.perf_counter() - t0

    # -- set-up: the inputs, the stage, the warm-up calls --------------------
    inputs = cell.inputs(seed)
    params = cell.params(seed)
    call = cell.caller(inputs, params)
    _sync(device)
    phases["inputs"] = time.perf_counter() - t0
    for _ in range(traffic["warmup_calls"]):
        call()
    _sync(device)
    gc.collect()
    setup_s = time.perf_counter() - t0
    phases["warmup"] = setup_s

    # -- the measured window --------------------------------------------------
    latencies, answers, window_s = cell.loop.window(call, seconds, seed,
                                                    SAMPLE)

    run = Run()
    run.on_card = device == "cuda"
    run.calls, run.window_s, run.latencies_s = len(latencies), window_s, \
        latencies
    run.setup_s = setup_s
    run.rows_per_call = config["inputData"]["paramMap"]["numValues"]
    run.call_bytes, run.call_ops = cell.calls.cost(cell, inputs, params)
    if trace:
        def spanned():
            with torch.profiler.record_function(SPAN_PREFIX + "call"):
                return call()

        run.trace = traced_window(
            lambda s: len(cell.loop.window(spanned, s, seed, 0)[0]),
            traffic["profile_seconds"], OUT / f"{workload}.trace.json")
    memory_peak = torch.cuda.max_memory_allocated() if run.on_card else 0

    # -- the check, after the window ------------------------------------------
    numbers, failed = cell.judge(inputs, params, answers, call)
    del answers
    check = {name: {"value": numbers[name], "limit": limit}
             for name, limit in config["limits"].items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in check.values())

    metrics = {}
    for m in metrics_run:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": run.calls, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if run.on_card else device,
                         "kind": (torch.cuda.get_device_name(0)
                                  if run.on_card else device),
                         "count": cell.entry["chips"],
                         "memory_peak_bytes": memory_peak}}
    if trace:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    if run.on_card:
        result["power"] = power_limit()
    result["setup_phases_s"] = phases
    result["readings"] = {k: v for k, v in numbers.items()
                          if k not in check and isinstance(v, float)}
    result["check"] = check
    found = forbidden_modules()
    if found:
        raise BenchError("forbidden modules loaded: " + ", ".join(found))
    return result


def main(argv, t0: float) -> int:
    parser = argparse.ArgumentParser(prog="portbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), t0=t0)
    except BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
