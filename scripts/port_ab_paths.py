#!/usr/bin/env python3
"""The port's host-bound fits and its reduce wrapper, timed for one tree of
the repository, so that two trees can be held against each other on one
card in one call.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/port_ab_paths.py --tree DIR [--runs N] [--out FILE]

Imports ``flink_ml_tpu_torch`` from DIR (the repository itself, or a
``git archive`` of another commit unpacked somewhere), builds its kernels,
and prints one JSON line: the tree, the card's name and power limit, the
runner's executeTimeMs for N runs after one warmup of the
logistic-regression and the FTRL benchmark configs (10,000,000 x 100 rows
each), and the eager times (CUDA events around batches of back-to-back
calls, host enqueue included) of ``reduce_partials`` and of ``torch.sum`` on
seeded partials of the four shapes the main paths give the reduce: Lloyd
(391, 10, 101), SGD (782, 102), FTRL's gradient sums (1024, 100, 2) and its
per-row dots (25, 131072, 1). Run it for parent, change, change, parent,
each in a process of its own, and compare within the call.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REDUCE_SHAPES = {"Lloyd": (391, 10, 101), "SGD": (782, 102),
                 "FTRL gradient": (1024, 100, 2),
                 "FTRL per-row dots": (25, 131072, 1)}
FITS = {"logisticregression": "logisticregression-benchmark.json",
        "OnlineLogisticRegression": "onlinelogisticregression-benchmark.json"}


def time_ms(fn, batches=7, per_batch=10, warmup=3):
    """Median per-call time over batches of back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", required=True,
                        help="root of the repository tree to import")
    parser.add_argument("--runs", type=int, default=5,
                        help="timed runs of each fit after one warmup")
    parser.add_argument("--out", help="also append the JSON line to FILE")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_ab_paths: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    torch.backends.cuda.matmul.allow_tf32 = False
    from flink_ml_tpu_torch.benchmark import runner
    from flink_ml_tpu_torch.ops import kernels as K
    assert Path(K.__file__).resolve().is_relative_to(tree), K.__file__

    K.build_kernels()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(3)
    reduce_ms = {}
    for tag, shape in REDUCE_SHAPES.items():
        p = torch.randn(shape, generator=g, device="cuda")
        reduce_ms[tag] = {
            "reduce_partials": time_ms(lambda: K.reduce_partials(p)),
            "torch.sum": time_ms(lambda: torch.sum(p, dim=0))}
    fits = {}
    configs = tree / "flink_ml_tpu" / "benchmark" / "configs"
    for name, config in FITS.items():
        spec = runner.load_config(str(configs / config))[name]
        runner.run_benchmark(name, spec)  # warmup
        rows = [runner.run_benchmark(name, spec) for _ in range(args.runs)]
        times = [r["executeTimeMs"] for r in rows]
        fits[name] = {"executeTimeMs": times,
                      "median": statistics.median(times),
                      "executionPath": rows[0]["executionPath"]}
    line = json.dumps({"tree": str(args.tree), "card": card,
                       "reduce_eager_ms": reduce_ms, "fits": fits})
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
