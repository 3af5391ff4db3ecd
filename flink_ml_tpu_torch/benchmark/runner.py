"""Benchmark runner CLI.

The port of ``flink_ml_tpu/benchmark/runner.py`` (ref:
Benchmark.java:41/main:129 + BenchmarkUtils.java:47): parse a JSON config
(version 1; named benchmarks each holding stage / inputData and optional
modelData specs with className + paramMap), instantiate through the param
system, run, and report {totalTimeMs, inputRecordNum, inputThroughput,
outputRecordNum, outputThroughput} (BenchmarkUtils.java:130-143) plus the
JAX package's extra columns that apply here. Estimators are timed as
``fit(input).get_model_data()``, other stages as ``transform(input)``,
datagen included, as in the reference. A modelData table seeds an online
trainer (``set_initial_model_data``) or becomes a Model's model data
(``set_model_data``), and its bytes count into ``inputBytes``.

It reads the JAX package's config files in place as data, e.g.
``flink_ml_tpu/benchmark/configs/kmeans-benchmark.json``. Timing ends with a
``torch.cuda.synchronize()``. The row names the device it ran on; the mesh,
native-kernel and compile provenance of the JAX rows has no counterpart
here yet and is left out.

    python -m flink_ml_tpu_torch.benchmark.runner CONFIG [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from typing import Dict

import numpy as np
import torch

from flink_ml_tpu_torch.api.stage import AlgoOperator, Estimator, Stage
from flink_ml_tpu_torch.benchmark.datagen import resolve_generator
from flink_ml_tpu_torch.device import DeviceLike, resolve_device, synchronize
from flink_ml_tpu_torch.linalg.sparse import is_csr_column

_STAGES: Dict[str, type] = {}


def _stage_registry() -> Dict[str, type]:
    """Short class name → Stage class, discovered from the models package
    (the reflective instantiation of ParamUtils.instantiateWithParams)."""
    if _STAGES:
        return _STAGES
    import flink_ml_tpu_torch.models  # noqa: F401 — registers the stages

    def walk(cls):
        for sub in cls.__subclasses__():
            if (not sub.__name__.startswith("_")
                    and "Base" not in sub.__name__
                    and ".models." in sub.__module__):
                _STAGES[sub.__name__] = sub
            walk(sub)

    walk(Stage)
    return _STAGES


def resolve_stage(class_name: str) -> type:
    short = class_name.rsplit(".", 1)[-1]
    registry = _stage_registry()
    try:
        return registry[short]
    except KeyError:
        raise ValueError(f"unknown stage {class_name!r}; known in the port: "
                         f"{sorted(registry)}")


def load_config(path: str) -> dict:
    """Reference configs carry // license comments; strip them."""
    with open(path) as f:
        text = f.read()
    text = re.sub(r"^\s*//.*$", "", text, flags=re.M)
    config = json.loads(text)
    if config.pop("version", 1) != 1:
        raise ValueError("unsupported benchmark config version")
    return config


def build_stage(spec: dict, device: DeviceLike = None) -> Stage:
    """The spec's stage, with its params, on ``device``."""
    stage = resolve_stage(spec["stage"]["className"])(device=device)
    stage.params_from_json(spec["stage"].get("paramMap", {}), strict=True)
    return stage


def build_generator(spec: dict, device: DeviceLike = None, key="inputData"):
    """The spec's ``key`` generator (inputData or modelData), with its
    params, on ``device``."""
    gen = resolve_generator(spec[key]["className"])(device=device)
    gen.params_from_json(spec[key].get("paramMap", {}), strict=True)
    return gen


def run_benchmark(name: str, spec: dict, device: DeviceLike = None) -> dict:
    """One named benchmark, datagen included in the measured time."""
    device = resolve_device(device)
    stage = build_stage(spec, device)
    if not isinstance(stage, (Estimator, AlgoOperator)):
        raise ValueError(f"{name}: unsupported stage class {type(stage)}")
    gen = build_generator(spec, device)
    model_gen = (build_generator(spec, device, "modelData")
                 if "modelData" in spec else None)

    synchronize(device)
    start = time.perf_counter()
    input_table = gen.get_data()
    model_table = None if model_gen is None else model_gen.get_data()
    synchronize(device)  # honest datagen/execute split
    datagen_ms = (time.perf_counter() - start) * 1000.0
    if model_table is not None:
        if isinstance(stage, Estimator) and hasattr(
                stage, "set_initial_model_data"):
            # online trainers start from model data instead of consuming it
            # as a fitted model (OnlineLogisticRegression.java:440)
            stage.set_initial_model_data(model_table)
        else:
            stage.set_model_data(model_table)
    if isinstance(stage, Estimator):
        outputs = stage.fit(input_table).get_model_data()
    else:
        outputs = stage.transform(input_table)
    synchronize(device)  # every output column is computed
    total_ms = (time.perf_counter() - start) * 1000.0

    output_num = sum(t.num_rows for t in outputs)
    input_num = gen.num_values
    exec_ms = total_ms - datagen_ms
    input_bytes = _table_bytes(input_table)
    if model_table is not None:
        input_bytes += _table_bytes(model_table)
    return {
        "device": str(device),
        "deviceName": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
        "totalTimeMs": total_ms,
        "inputRecordNum": input_num,
        "inputThroughput": input_num * 1000.0 / total_ms,
        "outputRecordNum": output_num,
        "outputThroughput": output_num * 1000.0 / total_ms,
        "dataGenTimeMs": datagen_ms,
        "executeTimeMs": exec_ms,
        # the stage must read its input at least once, so inputBytes /
        # executeTime is a lower bound on the bandwidth it achieved
        "inputBytes": input_bytes,
        "achievedGBps": input_bytes / max(exec_ms, 1e-9) / 1e6,
        **({"executionPath": stage.last_execution_path}
           if getattr(stage, "last_execution_path", None) else {}),
    }


def _table_bytes(table) -> int:
    """Byte size of a Table's columns (tensor, numpy, CSR); object columns
    are estimated from a 256-row sample."""
    total = 0
    for name in table.column_names:
        col = table.column(name)
        if isinstance(col, torch.Tensor):
            total += col.numel() * col.element_size()
            continue
        if is_csr_column(col):
            m = col.to_csr()
            total += m.data.nbytes + m.indices.nbytes + m.indptr.nbytes
            continue
        if col.dtype != np.dtype(object):
            total += int(col.nbytes)
            continue
        n = len(col)
        if n:
            sample = min(n, 256)
            per_row = sum(np.asarray(col[i]).nbytes for i in range(sample))
            total += per_row * n // sample
    return total


def best_of(name: str, spec: dict, runs: int = 3,
            device: DeviceLike = None) -> dict:
    """The measurement protocol of the JAX package: one identical warmup
    run, then the best inputThroughput of ``runs``. The warmup's time rides
    on the row as ``warmupTimeMs`` (it includes building the kernels when
    this process has not built them yet)."""
    warmup = run_benchmark(name, spec, device)
    best = None
    for _ in range(runs):
        r = run_benchmark(name, spec, device)
        if best is None or r["inputThroughput"] > best["inputThroughput"]:
            best = r
    best["warmupTimeMs"] = warmup["totalTimeMs"]
    return best


def run_benchmarks(config: dict, device: DeviceLike = None) -> dict:
    """One failing benchmark doesn't abort the rest (the reference demo
    config deliberately includes broken entries)."""
    results = {}
    for name, spec in config.items():
        entry = {}
        try:
            entry["stage"] = spec["stage"]
            entry["inputData"] = spec["inputData"]
            entry["results"] = run_benchmark(name, spec, device)
        except Exception as e:  # noqa: BLE001 — report and continue
            entry["exception"] = f"{type(e).__name__}: {e}"
        results[name] = entry
    return results


def main(argv=None) -> int:
    """CLI parity with bin/benchmark-run.sh <config> [--output-file r.json]."""
    parser = argparse.ArgumentParser(prog="flink-ml-tpu-torch-benchmark")
    parser.add_argument("config", help="benchmark config JSON file")
    parser.add_argument("--output-file", default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    results = run_benchmarks(load_config(args.config), args.device)
    text = json.dumps(results, indent=2)
    print(text)
    if args.output_file:
        with open(args.output_file, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
