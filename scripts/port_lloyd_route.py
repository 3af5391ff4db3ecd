#!/usr/bin/env python3
"""Where the tiled KMeans Lloyd route's time goes, by part, on one CUDA card:
the labels, the stable counting sort by label (its two counting passes and
the scan of the offsets) and the sums over pieces of the sorted rows
(``kmeans_lloyd_sorted`` of ``flink_ml_tpu_torch/csrc/kmeans_kernels.cu``).
No kernel is changed or rebuilt: the parts are told apart by kernel name.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/port_lloyd_route.py [--out FILE]

At 1,000,000 x 768 with k = 64 and at 200,000 x 1,536 with k = 1,024
(float32 rows in [0, 1), unit weights, from one seed), it times the whole
call as device time (calls captured in a CUDA graph and replayed), then
captures ten calls with ``torch.profiler`` and sums each kernel's device
time by part: labels (``lloyd_label_kernel``), sort (``label_sort_kernel``
and ``scan_*_kernel``) and sums (``piece_sums_kernel`` and
``piece_combine_kernel``). Beside each part its bound at 3.35 TB/s and 67
TFLOP/s fp32: the labels read x and the centroids once and do 2·n·k·d
operations; the sort reads the labels and writes the row order and the
offsets once; the sums read x, the weights and the row order once and
write the (k, d + 1) sums. Also the labels alone as ``assign_nearest``'s
tiled call (device time), as a check on the profiler's labels. Prints the
card's name and power limit and one JSON line.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
SHAPES = ((1_000_000, 768, 64), (200_000, 1_536, 1_024))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM, at 700 W
PEAK_FP32_PER_S = 67e12
PARTS = {"labels": ("lloyd_label_kernel",),
         "sort": ("label_sort_kernel", "scan_reduce_kernel",
                  "scan_top_kernel", "scan_down_kernel"),
         "sums": ("piece_sums_kernel", "piece_combine_kernel")}
PROFILED_CALLS = 10


def time_ms(fn, batches=5, per_batch=5, warmup=2):
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


def graph_ms(fn, reps=5):
    """Device time per call: ``reps`` calls captured in a CUDA graph and
    replayed, so that the host's enqueue time does not hide the card's."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = time_ms(graph.replay, batches=5, per_batch=2, warmup=1) / reps
    del graph
    return ms


def bound(nbytes, ops):
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FP32_PER_S * 1e3
    return ({"bound_ms": by_bytes, "bound_by": "bytes"} if by_bytes >= by_ops
            else {"bound_ms": by_ops, "bound_by": "operations"})


def profiled_parts(fn):
    """Device ms a call of each part, from ``torch.profiler``'s kernel
    events over PROFILED_CALLS calls, and the kernels seen by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    by_kernel = {}
    for event in prof.key_averages():
        us = getattr(event, "device_time_total", None)
        if us is None:
            us = getattr(event, "cuda_time_total", 0.0)
        if us:
            by_kernel[event.key] = by_kernel.get(event.key, 0.0) + us
    parts = {}
    for part, names in PARTS.items():
        us = sum(t for key, t in by_kernel.items()
                 if any(name in key for name in names))
        parts[part] = us / 1e3 / PROFILED_CALLS if us else None
    return parts, {key: t / 1e3 / PROFILED_CALLS
                   for key, t in by_kernel.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="also write the JSON line to FILE")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_lloyd_route: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from flink_ml_tpu_torch.ops import kernels as K

    K.build_kernels()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print("card:", card, flush=True)
    result = {"card": card, "shapes": {}}
    g = torch.Generator(device="cuda").manual_seed(26)
    for n, d, k in SHAPES:
        x = torch.rand((n, d), generator=g, device="cuda")
        v = torch.ones(n, device="cuda")
        c = torch.rand((k, d), generator=g, device="cuda")
        plan = K.kmeans_plan(n, k, d, True)
        assert plan.route == "tiled", plan
        aplan = K.kmeans_plan(n, k, d, False)

        def whole():
            return K._launch_lloyd_sorted(x, v, c, plan)[0]

        def labels():
            return K._launch_assign_tiled(x, c, aplan)

        parts, kernels = profiled_parts(whole)
        row = {"plan": plan._asdict(), "whole_device_ms": graph_ms(whole),
               "assign_tiled_device_ms": graph_ms(labels),
               "parts_device_ms": parts, "kernels_device_ms": kernels,
               "labels": bound(4 * (n * d + k * d + k + n), 2 * n * k * d),
               "sort": bound(4 * (n + n + k * plan.nchunks), 0),
               "sums": bound(4 * (n * d + 3 * n + k * (d + 1)),
                             n * (d + 1))}
        for part in PARTS:
            ms = parts[part]
            row[part]["device_ms"] = ms
            row[part]["share_of_bound"] = (row[part]["bound_ms"] / ms
                                           if ms else None)
        print(f"{n} x {d}, k={k}:", json.dumps(row), flush=True)
        result["shapes"][f"{n}x{d}k{k}"] = row
        del x, v, c
        torch.cuda.empty_cache()
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
