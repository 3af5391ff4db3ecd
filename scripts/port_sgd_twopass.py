#!/usr/bin/env python3
"""The port's SGD two-pass set (``sgd_twopass_dots_kernel``,
``sgd_twopass_mult_kernel`` and ``sgd_twopass_axpy_kernel`` of
``flink_ml_tpu_torch/csrc/sgd_kernels.cu``: rows past what a grid of one CTA
an SM holds, the window read twice), held against its plain version and
timed on one CUDA card, beside the library pair and the grid instance.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/port_sgd_twopass.py [--quick] [--out FILE]

1. Builds the kernels and prints the card's name and power limit and
   ptxas' registers and spills of the two-pass kernels.
2. Holds ``sgd_batch_terms`` against ``sgd_batch_terms_plain`` (within
   SUM_RTOL/SUM_ATOL, as ``chip_smoke.py`` does) at d = 2,000,001 (d % 4 =
   1), 2,097,152, 2,500,000 and 4,194,304, for every loss, at a full
   window (a ragged last band of 32 rows), a ragged clipped, an
   end-clipped and a one-row window: a rerun bit-identical, the output
   bit-identical to ``reduce_partials_plain`` of its one partial row, and
   the same rows from an x 4 bytes off 16-byte alignment (4-byte loads).
   Then the set by hand at the grid's widths (d = 106,000 and 150,001)
   against the plain version.
3. Unless ``--quick``, times each call on the next window of its table
   (cold in L2; device time of calls captured in a CUDA graph and
   replayed): (a) the set's own widths, d = 2,097,152, 2,500,000 and
   4,194,304 over windows of 1.28 GB (lb = 152, 128, 76) and phase 23's fit
   window, all 1,250 rows of 2,097,152 (10.49 GB), beside the library pair
   (``x @ c``, then ``xᵀ @ mult`` given the multipliers), the byte bound
   (x, y, w, the coefficients and the output once at 3.35 TB/s) and the
   set's floor (the window read twice), with each kernel's share of the
   device time from ``torch.profiler``; (b) the grid's widths, d = 106,000,
   131,072, 262,144 and 1,048,576 over windows of 1.28 GB, the planned grid
   instance beside the set by hand and the library pair.

Prints one JSON line (also appended to FILE with ``--out``).
"""

import argparse
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
SUM_RTOL, SUM_ATOL = 1e-4, 1e-3
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory, at 700 W
LOSSES = ("logistic", "hinge", "least_square")
CHECK_WIDTHS = ((2_000_001, 45), (2_097_152, 45), (2_500_000, 45),
                (4_194_304, 40))
BY_HAND_CHECKS = ((106_000, 400), (150_001, 280))
#: (d, lb, table rows): the set's own widths (1.28 GB windows of two-window
#: tables, then phase 23's fit window, its whole table)
OWN = ((2_097_152, 152, 304), (2_500_000, 128, 256), (4_194_304, 76, 152),
       (2_097_152, 1_250, 1_250))
#: (d, lb, table rows): the grid instance's widths, windows of 1.28 GB
GRID = ((106_000, 3_019, 6_038), (131_072, 2_441, 4_882),
        (262_144, 1_220, 2_440), (1_048_576, 305, 610))


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


def graph_ms(fn, reps=20):
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
    ms = time_ms(graph.replay, batches=5, per_batch=5, warmup=1) / reps
    del graph
    return ms


def rolling(n, lb):
    """Window starts that move on by lb at every call, wrapping at n (the
    one start where the table holds one window)."""
    starts = itertools.cycle(range(0, n - lb + 1, lb))
    return lambda: next(starts)


def within(got, want, tag):
    excess = float(((got - want).abs() - SUM_RTOL * want.abs()
                    - SUM_ATOL).max())
    assert excess <= 0, f"{tag}: off by {excess} over tolerance"
    return float((got - want).abs().max())


def sgd_ptxas(log):
    """kernel -> ptxas' register and spill lines, for the two-pass set."""
    out, current = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if "'" in line else line.strip()
        elif (("registers" in line or "spill" in line)
              and "twopass" in current):
            out.setdefault(current, []).append(line.strip())
    return out


def table(g, n, d):
    x = torch.rand((n, d), generator=g, device="cuda")
    y = torch.floor(torch.rand(n, generator=g, device="cuda") * 2)
    w = torch.rand(n, generator=g, device="cuda")
    c = (torch.rand(d, generator=g, device="cuda") - 0.5) / d ** 0.5
    return x, y, w, c


def twopass_plan(K, x):
    """The set's plan for x at any width past the register instance's."""
    return K._sgd_twopass_plan(x.shape[1], K._card_sms(0),
                               int(x.data_ptr() % 16 == 0))


def check(K, g):
    """Step 2."""
    out = {}
    for d, rows in CHECK_WIDTHS:
        x, y, w, c = table(g, rows, d)
        flat = torch.empty(rows * d + 1, device="cuda")
        xu = flat[1:].view(rows, d)  # rows 4 bytes off alignment
        xu.copy_(x)
        errs = []
        for loss in LOSSES:
            for start, clip, lb in [(0, 0, rows), (5, 3, rows - 9),
                                    (rows // 2, rows // 4, rows - rows // 2),
                                    (17, 0, 1)]:
                call = (y, w, c, start, clip, lb, loss)
                plan = K._sgd_card_plan(x, lb, loss)
                assert plan.instance == "twopass" and plan.vec4 == 1, plan
                got = K.sgd_batch_terms(x, *call)
                assert torch.isfinite(got).all(), (d, loss, start)
                assert torch.equal(got, K.sgd_batch_terms(x, *call)), (
                    f"d={d} {loss} start={start}: rerun not bit-identical")
                errs.append(within(got, K.sgd_batch_terms_plain(x, *call),
                                   f"d={d} {loss} start={start}"))
                # the set writes its one row as the output itself
                part = K._launch_sgd_terms(x, *call, combine=False)[:-1]
                assert part.shape[0] == 1 and torch.equal(part[0], got)
                assert torch.equal(got, K.reduce_partials_plain(part))
                unaligned = K._sgd_card_plan(xu, lb, loss)
                assert (unaligned.vec4, unaligned.instance) == (0, "twopass")
                gu = K.sgd_batch_terms(xu, *call)
                assert torch.equal(gu, K.sgd_batch_terms(xu, *call))
                errs.append(within(gu, K.sgd_batch_terms_plain(xu, *call),
                                   f"d={d} {loss} unaligned"))
        plan = K._sgd_card_plan(x, rows, "logistic")
        out[d] = {"plan": plan._asdict(), "max_abs_err": max(errs)}
        print(f"check d={d}: {json.dumps(out[d])}", file=sys.stderr,
              flush=True)
        del x, xu, flat
        torch.cuda.empty_cache()
    for d, rows in BY_HAND_CHECKS:
        x, y, w, c = table(g, rows, d)
        plan = twopass_plan(K, x)
        errs = []
        for loss in LOSSES:
            call = (y, w, c, 5, 3, rows - 9, loss)
            got = K._launch_sgd_terms(x, *call, plan=plan)[-1]
            assert torch.equal(got, K._launch_sgd_terms(x, *call,
                                                        plan=plan)[-1])
            errs.append(within(got, K.sgd_batch_terms_plain(x, *call),
                               f"by hand d={d} {loss}"))
        out[f"by hand {d}"] = {"plan": plan._asdict(),
                               "max_abs_err": max(errs)}
        print(f"check by hand d={d}: {json.dumps(out[f'by hand {d}'])}",
              file=sys.stderr, flush=True)
        del x
        torch.cuda.empty_cache()
    return out


def kernel_split(fn, calls=10):
    """Device ms a call of each kernel ``fn`` launches, from
    ``torch.profiler`` over ``calls`` calls (empty where it sees none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for event in prof.key_averages():
        us = getattr(event, "self_device_time_total",
                     getattr(event, "self_cuda_time_total", 0))
        if us:
            split[event.key] = us / 1e3 / calls
    return split


def timed(K, g, LossFunc):
    """Step 3."""
    out = {"own": {}, "grid": {}}
    loss = "logistic"
    for part, shapes in (("own", OWN), ("grid", GRID)):
        for d, lb, n in shapes:
            x, y, w, c = table(g, n, d)
            mult = LossFunc.by_name(loss).terms(x @ c, y, w)[1]
            bound = 4 * (lb * d + 2 * lb + 2 * d + 2) / PEAK_BYTES_PER_S * 1e3

            def call(plan=None):
                starts = rolling(n, lb)
                return lambda: K._launch_sgd_terms(x, y, w, c, starts(), 0,
                                                   lb, loss, plan=plan)

            def library():
                starts = rolling(n, lb)

                def run():
                    s = starts()
                    xb = x[s:s + lb]
                    torch.mv(xb, c)  # the forward dots, then the gradient
                    return torch.mv(xb.T, mult[s:s + lb])
                return run

            plan = K._sgd_card_plan(x, lb, loss)
            row = {"lb": lb, "bound_ms": bound,
                   "two_read_floor_ms": 8 * lb * d / PEAK_BYTES_PER_S * 1e3,
                   "plan": plan._asdict(),
                   "device_ms": graph_ms(call()),
                   "library_device_ms": graph_ms(library())}
            if part == "own":
                assert plan.instance == "twopass", plan
                row["ms"] = time_ms(call())
                row["kernels_ms"] = kernel_split(call())
            else:
                assert plan.instance == "grid", plan
                tp = twopass_plan(K, x)
                got = K._launch_sgd_terms(x, y, w, c, 0, 0, lb, loss,
                                          plan=tp)[-1]
                row.update({
                    "twopass_max_abs_err": within(
                        got, K.sgd_batch_terms_plain(x, y, w, c, 0, 0, lb,
                                                     loss),
                        f"by hand d={d}"),
                    "twopass_device_ms": graph_ms(call(tp)),
                    "twopass_kernels_ms": kernel_split(call(tp))})
            out[part][f"{d}x{lb}"] = row
            print(f"timed {part} d={d} lb={lb}: {json.dumps(row)}",
                  file=sys.stderr, flush=True)
            del x, y, w, mult
            torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="build and check only")
    parser.add_argument("--out", help="also append the JSON line to FILE")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_sgd_twopass: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(REPO))
    from flink_ml_tpu_torch.ops import kernels as K
    from flink_ml_tpu_torch.ops.losses import LossFunc

    logs = K.build_kernels()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    result = {"card": card,
              "ptxas": sgd_ptxas(logs.get(K.SGD_SOURCE, ""))}
    print(f"card: {card}\nptxas: {json.dumps(result['ptxas'], indent=1)}",
          file=sys.stderr, flush=True)
    g = torch.Generator(device="cuda").manual_seed(28)
    result["check"] = check(K, g)
    if not args.quick:
        result["timed"] = timed(K, g, LossFunc)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
