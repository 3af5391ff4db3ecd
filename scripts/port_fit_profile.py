#!/usr/bin/env python3
"""Where the time of one linear-model fit of the PyTorch/CUDA port goes.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/port_fit_profile.py [--config logisticregression] [--out F]

Builds the benchmark config's table on the card (the reference benchmark's
LogisticRegression config by default: 10,000,000 x 100 rows, 20 rounds of
100,000), fits it once to build the kernels, then fits it again twice: once
timed with the host clock alone, and once under ``torch.profiler`` with CPU
and CUDA activities. It prints one JSON object: the card, the fit's wall
time unprofiled and profiled, the device time by kernel name, the device
time in the ``sgd_batch_terms`` kernels (stage 1 and the reduce), and the
device's busy share of the profiled fit (the sum of kernel times over its
wall time; the kernels run one after another on one stream, so the sum
does not count any time twice).
Exits nonzero without a card.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CONFIGS = REPO / "flink_ml_tpu" / "benchmark" / "configs"


def _device_us(event) -> float:
    """An event's own device time in microseconds, under either name that
    PyTorch's profiler has used for it."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(event, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="port_fit_profile")
    parser.add_argument("--config", default="logisticregression")
    parser.add_argument("--out", default=None, help="also write the JSON here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_fit_profile: no CUDA device", file=sys.stderr)
        return 2

    from torch.profiler import ProfilerActivity, profile

    from flink_ml_tpu_torch.benchmark import runner
    from flink_ml_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = runner.load_config(
        str(CONFIGS / f"{args.config}-benchmark.json"))[args.config]
    table = runner.build_generator(spec).get_data()
    estimator = runner.build_stage(spec)
    estimator.fit(table)  # builds the kernels
    torch.cuda.synchronize()

    start = time.perf_counter()
    estimator.fit(table)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - start) * 1e3

    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        estimator.fit(table)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - start) * 1e3
    launches = dict(kernels.launch_counts)

    by_name = {}
    for event in prof.key_averages():
        us = _device_us(event)
        if us > 0 and event.device_type == torch.autograd.DeviceType.CUDA:
            by_name[event.key] = by_name.get(event.key, 0.0) + us / 1e3
    device_ms = sum(by_name.values())
    # stage 1 and the in-order reduce (a linear fit runs no other reduce)
    sgd_ms = sum(ms for name, ms in by_name.items()
                 if "sgd_" in name or "reduce_partials" in name)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    result = {
        "card": card,
        "config": args.config,
        "executionPath": estimator.last_execution_path,
        "fitWallMs": wall_ms,
        "fitWallMsProfiled": profiled_ms,
        "deviceMs": device_ms,
        "sgdKernelDeviceMs": sgd_ms,
        "deviceBusyShare": device_ms / profiled_ms if device_ms else None,
        "launches": launches,
        "deviceMsByKernel": dict(sorted(by_name.items(),
                                        key=lambda kv: -kv[1])),
    }
    text = json.dumps(result)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0 if device_ms > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
