#!/usr/bin/env python3
"""What arming the port's observability costs a fit, and where that goes.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 scripts/port_obs_overhead.py [--runs N] [--out FILE]

Builds the kernels, makes the LR (10,000,000 x 100, 20 rounds) and KMeans
(1,000,000 x 100, k = 10, 10 rounds) benchmark tables on the card, and fits
each as ``chip_smoke.py`` phase 12 does: K-round segments (K = 5 and 3)
between checkpoints, supervised, with a fault at the second boundary. It
alternates unarmed fits and fits with tracing and health armed
(``FLINK_ML_TPU_TRACE_DIR``, ``FLINK_ML_TPU_HEALTH=1``), N of each (host
clock around ``fit``, ended by a synchronize), and then runs one more armed
fit with the observability seams wrapped in host timers: span ends and
their file writes, the metrics dump, device-memory samples, launch-cost
records, the SGD health rows (``health_row``; KMeans computes its centre
shift inline), the health tail (``check_fit``) and the boundary fetches
(which the unarmed fit makes too). One unarmed and one armed fit come
first as warmups (the first armed fit creates its files and imports what
the seams use). It prints one JSON line: the card's name and power limit,
each fit's unarmed and armed times (all runs, and the medians) and the
armed split in host ms. Exits nonzero without a card.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

CONFIGS = REPO / "flink_ml_tpu" / "benchmark" / "configs"
CASES = (("LR", "logisticregression-benchmark.json", "logisticregression",
          5), ("KMeans", "kmeans-benchmark.json", "KMeans", 3))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="port_obs_overhead")
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--out", default=None, help="also append the line")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_obs_overhead: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False

    from flink_ml_tpu_torch.benchmark import runner
    from flink_ml_tpu_torch.iteration import iteration
    from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager
    from flink_ml_tpu_torch.observability import (compilestats, exporters,
                                                  health, tracing)
    from flink_ml_tpu_torch.ops import kernels
    from flink_ml_tpu_torch.resilience import RetryPolicy, faults

    kernels.build_kernels()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    workdir = tempfile.mkdtemp(prefix="port_obs_overhead_")
    seams = [("spans", tracing.Tracer, "_end"),
             ("metrics dump", exporters, "dump_metrics"),
             ("memory samples", compilestats, "sample_memory"),
             ("launch costs", compilestats, "capture_cost"),
             ("health rows", health, "health_row"),
             ("health tail", health, "check_fit"),
             ("boundary fetches", iteration, "read_boundary")]
    out = {"card": card, "fits": {}}
    try:
        for name, config, key, k in CASES:
            spec = runner.load_config(str(CONFIGS / config))[key]
            table = runner.build_generator(spec).get_data()
            runs = 0

            def fit(armed):
                nonlocal runs
                runs += 1
                mgr = CheckpointManager(f"{workdir}/{name}-ckpt-{runs}")
                est = (runner.build_stage(spec)
                       .set_iteration_config(iteration.IterationConfig(
                           checkpoint_interval=k, checkpoint_manager=mgr))
                       .set_retry_policy(RetryPolicy(backoff_s=0)))
                env = ({tracing.TRACE_DIR_ENV: f"{workdir}/{name}-t{runs}",
                        health.HEALTH_ENV: "1"} if armed else {})
                with mock.patch.dict(os.environ, env), \
                        faults.chaos(at={"epoch-boundary": [2]}):
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                    est.fit(table)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - start) * 1e3
                tracing.tracer.shutdown()
                exporters.metrics.clear()
                return ms

            fit(False)  # warmups
            fit(True)
            times = {"unarmed": [], "armed": []}
            for i in range(args.runs):
                for armed in ((False, True) if i % 2 == 0 else (True, False)):
                    times["armed" if armed else "unarmed"].append(fit(armed))

            spent = {part: 0.0 for part, _, _ in seams}
            undo = []
            for part, owner, attr in seams:
                real = getattr(owner, attr)

                def timed(*a, _real=real, _part=part, **kw):
                    start = time.perf_counter()
                    try:
                        return _real(*a, **kw)
                    finally:
                        spent[_part] += (time.perf_counter() - start) * 1e3

                setattr(owner, attr, timed)
                undo.append((owner, attr, real))
            try:
                split_ms = fit(True)
            finally:
                for owner, attr, real in reversed(undo):
                    setattr(owner, attr, real)
            spent = {part: round(ms, 4) for part, ms in spent.items()}
            out["fits"][name] = {
                "unarmed_ms": times["unarmed"], "armed_ms": times["armed"],
                "unarmed_median": statistics.median(times["unarmed"]),
                "armed_median": statistics.median(times["armed"]),
                "split_fit_ms": split_ms, "split_ms": spent}
            print(f"{name}: {json.dumps(out['fits'][name])}", file=sys.stderr,
                  flush=True)
            del table
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
