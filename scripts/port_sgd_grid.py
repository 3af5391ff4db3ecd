#!/usr/bin/env python3
"""The port's SGD grid instance (``sgd_grid_kernel`` of
``flink_ml_tpu_torch/csrc/sgd_kernels.cu``: rows past 105,568 columns, each
row's columns split over every CTA the card holds, the partial dots meeting
through device memory once a stage), held against its plain version and
timed on one CUDA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/port_sgd_grid.py [--quick] [--out FILE]

1. Builds the kernels and prints the card's name and power limit and
   ptxas' registers and spills of the grid instances.
2. Holds ``sgd_batch_terms`` against ``sgd_batch_terms_plain`` (within
   SUM_RTOL/SUM_ATOL, as ``chip_smoke.py`` does) at d = 106,000, 131,072,
   150,001, 262,144 and 1,048,576, for every loss, at a full, a ragged
   clipped, an end-clipped and a one-row window: a rerun bit-identical,
   the C entry's output bit-identical to ``reduce_partials_plain`` of its
   one partial row, and the same rows from an x 4 bytes off 16-byte
   alignment. Then captures one grid launch in a CUDA graph and replays
   it (the timing below takes device time from replayed graphs where the
   capture takes the cooperative launch, else from CUDA events over
   back-to-back launches, which at these widths hide the host's enqueue).
3. Unless ``--quick``, times each call on the next window of its table
   (cold in L2): at d = 106,000, 131,072, 262,144 and 1,048,576 over
   windows of the same 1.28 GB (lb = 3,019, 2,441, 1,220, 305), the
   planned grid instance (whole call and stage 1, device and eager), the
   library pair (``x @ c``, then ``xᵀ @ mult`` given the multipliers) and,
   at 262,144, the plain version; each with the byte bound (x, y, w, the
   coefficients and the output once at 3.35 TB/s). Then the grid instance
   by hand at d = 50,001 and 100,000 (lb = 6,400 and 3,200) beside the
   cluster instance the plan takes there.
4. Unless ``--quick``, the phase split: builds the source once more with
   its switch ``-DSGD_PHASE_CLOCKS`` (CTA 0 reads ``clock64()`` between the
   phases of each iteration: the wait at the last stage's first grid
   barrier, the owners' sums of its partials and the second arrive, the
   copy wait of this stage, its partial dots, the first arrive, the wait
   at the last stage's second barrier, its dots' reads and terms, its
   mult · x, and the copy issue of a later stage), runs the planned
   launch at d
   = 106,000, 262,144 and 1,048,576 with it and prints the mean cycles
   per stage of each phase over CTA 0's threads and over each of its
   warps, beside both builds' device times.

Prints one JSON line (also appended to FILE with ``--out``).
"""

import argparse
import contextlib
import ctypes
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
SUM_RTOL, SUM_ATOL = 1e-4, 1e-3
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory, at 700 W
LOSSES = ("logistic", "hinge", "least_square")
CHECK_WIDTHS = ((106_000, 400), (131_072, 320), (150_001, 280),
                (262_144, 160), (1_048_576, 48))
#: timed shapes: d -> lb, each window 1.28 GB of x
TIMED = {106_000: 3_019, 131_072: 2_441, 262_144: 1_220, 1_048_576: 305}
#: the grid instance by hand at the cluster instance's widths
BY_HAND = {50_001: 6_400, 100_000: 3_200}
PHASED = ((106_000, 3_019), (262_144, 1_220), (1_048_576, 305))
PHASES = ("first wait", "owner sums and second arrive", "copy wait",
          "dots", "first arrive", "second wait", "dot reads and terms",
          "mult x", "copy issue")


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
    """Window starts that move on by lb at every call, wrapping at n."""
    starts = itertools.cycle(range(0, n - lb + 1, lb))
    return lambda: next(starts)


def within(got, want, tag):
    excess = float(((got - want).abs() - SUM_RTOL * want.abs()
                    - SUM_ATOL).max())
    assert excess <= 0, f"{tag}: off by {excess} over tolerance"
    return float((got - want).abs().max())


def sgd_ptxas(log):
    """kernel -> ptxas' register and spill lines, for the grid kernels."""
    out, current = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if "'" in line else line.strip()
        elif (("registers" in line or "spill" in line)
              and "sgd_grid" in current):
            out.setdefault(current, []).append(line.strip())
    return out


def grid_plan(K, x, loss):
    """The grid instance's plan for x at any width it holds: one CTA on each
    of the card's SMs, once the occupancy query finds that one fits."""
    d, sms = x.shape[1], K._card_sms(0)
    K._sgd_resident_grid(0, K.SGD_LOSSES[loss], d,
                         K._sgd_grid_layout(d, sms)[1])
    return K._sgd_grid_plan(d, sms, int(x.data_ptr() % 16 == 0))


def table(g, n, d):
    x = torch.rand((n, d), generator=g, device="cuda")
    y = torch.floor(torch.rand(n, generator=g, device="cuda") * 2)
    w = torch.rand(n, generator=g, device="cuda")
    c = (torch.rand(d, generator=g, device="cuda") - 0.5) / d ** 0.5
    return x, y, w, c


def check(K, g):
    """Step 2: every loss and window at the check widths."""
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
                assert plan.instance == "grid" and plan.vec4 == 1, plan
                got = K.sgd_batch_terms(x, *call)
                assert torch.isfinite(got).all(), (d, loss, start)
                assert torch.equal(got, K.sgd_batch_terms(x, *call)), (
                    f"d={d} {loss} start={start}: rerun not bit-identical")
                errs.append(within(got, K.sgd_batch_terms_plain(x, *call),
                                   f"d={d} {loss} start={start}"))
                # stage 1 writes its one row as the output itself
                part = K._launch_sgd_terms(x, *call, combine=False)[:-1]
                assert part.shape[0] == 1 and torch.equal(part[0], got)
                assert torch.equal(got, K.reduce_partials_plain(part)), (
                    f"d={d} {loss}: the output differs from its partial")
                unaligned = K._sgd_card_plan(xu, lb, loss)
                assert unaligned.vec4 == 0 and unaligned.instance == "grid"
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
    return out


def capture_probe(K, g):
    """Step 2's last part: one grid call captured in a CUDA graph and
    replayed against the eager call's bits; the error text where the
    capture refuses the launch."""
    x, y, w, c = table(g, 40, 262_144)
    try:
        want = K.sgd_batch_terms(x, y, w, c, 0, 0, 40, "logistic")
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            K.sgd_batch_terms(x, y, w, c, 0, 0, 40, "logistic")
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            got = K.sgd_batch_terms(x, y, w, c, 0, 0, 40, "logistic")
        graph.replay()
        torch.cuda.synchronize()
        result = {"captured": True, "equal": bool(torch.equal(got, want))}
    except RuntimeError as e:  # the capture's refusal is the finding
        result = {"captured": False, "error": str(e)[:500]}
    print(f"capture: {json.dumps(result)}", file=sys.stderr, flush=True)
    return result


def timed(K, g, LossFunc, device_ms):
    """Step 3."""
    out = {}
    loss = "logistic"
    for d, lb in {**TIMED, **BY_HAND}.items():
        n = 2 * lb
        x, y, w, c = table(g, n, d)
        mult = LossFunc.by_name(loss).terms(x @ c, y, w)[1]
        bound = 4 * (lb * d + 2 * lb + 2 * d + 2) / PEAK_BYTES_PER_S * 1e3

        def call(plan=None, combine=True):
            starts = rolling(n, lb)
            return lambda: K._launch_sgd_terms(x, y, w, c, starts(), 0, lb,
                                               loss, combine=combine,
                                               plan=plan)

        def library():
            starts = rolling(n, lb)

            def run():
                s = starts()
                xb = x[s:s + lb]
                torch.mv(xb, c)  # the forward dots, then the gradient
                return torch.mv(xb.T, mult[s:s + lb])
            return run

        plan = K._sgd_card_plan(x, lb, loss)
        row = {"lb": lb, "bound_ms": bound, "plan": plan._asdict(),
               "device_ms": device_ms(call()),
               "stage1_device_ms": device_ms(call(combine=False)),
               "ms": time_ms(call()),
               "library_device_ms": device_ms(library()),
               "library_ms": time_ms(library())}
        if d in BY_HAND:
            assert plan.instance == "cluster", plan
            gp = grid_plan(K, x, loss)
            got = K._launch_sgd_terms(x, y, w, c, 0, 0, lb, loss, plan=gp)
            row.update({
                "grid_plan": gp._asdict(),
                "grid_max_abs_err": within(got[-1], K.sgd_batch_terms_plain(
                    x, y, w, c, 0, 0, lb, loss), f"grid by hand d={d}"),
                "grid_device_ms": device_ms(call(gp)),
                "grid_stage1_device_ms": device_ms(call(gp, False))})
        else:
            assert plan.instance == "grid", plan
            if d == 262_144:
                row["plain_ms"] = time_ms(lambda s=rolling(n, lb): (
                    K.sgd_batch_terms_plain(x, y, w, c, s(), 0, lb, loss)))
        row["share_of_bound"] = bound / row["device_ms"]
        out[d] = row
        print(f"timed d={d}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del x, y, w, mult
        torch.cuda.empty_cache()
    return out


def phases(K, _build, g, device_ms):
    """Step 4: the clocked build at the PHASED shapes."""
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = Path(tmp) / "libsgd-phase-clocks.so"
        built = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-DSGD_PHASE_CLOCKS", "-o",
             str(lib_path), str(_build.CSRC_DIR / f"{K.SGD_SOURCE}.cu")],
            capture_output=True, text=True)
        if built.returncode != 0:
            raise SystemExit(built.stderr)
        clocked = ctypes.CDLL(str(lib_path))
    for fn, (argtypes, restype) in K._SIGNATURES[K.SGD_SOURCE].items():
        getattr(clocked, fn).argtypes = argtypes
        getattr(clocked, fn).restype = restype
    clocked.sgd_grid_phase_cycles_read.argtypes = [ctypes.c_void_p]
    ptxas = sgd_ptxas(built.stdout + built.stderr)
    return {d: phase_split(K, clocked, g, d, lb, ptxas, device_ms)
            for d, lb in PHASED}


def phase_split(K, clocked, g, d, lb, ptxas, device_ms):
    """One width's clocked run (step 4)."""
    loss = "logistic"
    n = 2 * lb
    x, y, w, c = table(g, n, d)
    plan = K._sgd_card_plan(x, lb, loss)
    count = ctypes.c_int(0)
    assert clocked.sgd_grid_ctas_on_card(
        K.SGD_LOSSES[loss], d, plan.dc, plan.smem,
        ctypes.byref(count)) == 0  # sets the clocked build's smem limit
    assert count.value == plan.grid, (count.value, plan)

    def launch(lib):
        starts = rolling(n, lb)

        def run():
            with library(K, lib):
                return K._launch_sgd_terms(x, y, w, c, starts(), 0, lb, loss,
                                           plan=plan)
        return run

    real = K._lib(K.SGD_SOURCE)
    want = K._launch_sgd_terms(x, y, w, c, 0, 0, lb, loss, plan=plan)
    with library(K, clocked):
        got = K._launch_sgd_terms(x, y, w, c, 0, 0, lb, loss, plan=plan)
    # the output rows (a one-row plan leaves the partial row unwritten)
    assert torch.equal(got[-1], want[-1]), "the clocked build's terms differ"
    row = {"plan": plan._asdict(),
           "device_ms": {"real": device_ms(launch(real)),
                         "clocked": device_ms(launch(clocked))}}
    launch(clocked)()
    torch.cuda.synchronize()
    threads = K.SGD_GRID_THREADS
    buf = (ctypes.c_longlong * (threads * len(PHASES)))()
    assert clocked.sgd_grid_phase_cycles_read(buf) == 0
    stages = -(-lb // plan.rows) + 1  # iterations of the kernel's loop

    def mean(q, ts):
        return statistics.mean(buf[t * len(PHASES) + q] for t in ts) / stages

    every = [mean(q, range(threads)) for q in range(len(PHASES))]
    by_warp = {p: [round(mean(q, range(32 * k, 32 * k + 32)))
                   for k in range(threads // 32)]
               for q, p in enumerate(PHASES)}
    row.update({"stages": stages,
                "cycles_per_stage": dict(zip(PHASES, every)),
                "cycles_per_stage_by_warp": by_warp,
                "cycles_per_stage_total": sum(every), "ptxas": ptxas})
    print(f"phases d={d}: {json.dumps(row)}", file=sys.stderr, flush=True)
    del x, y, w
    torch.cuda.empty_cache()
    return row


@contextlib.contextmanager
def library(K, lib):
    """``K``'s launches go to the library ``lib`` inside the block."""
    saved = K._lib
    K._lib = lambda source: lib
    try:
        yield
    finally:
        K._lib = saved


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="build, check and probe the capture only")
    parser.add_argument("--out", help="also append the JSON line to FILE")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_sgd_grid: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(REPO))
    from flink_ml_tpu_torch.ops import _build
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
    g = torch.Generator(device="cuda").manual_seed(27)
    result["check"] = check(K, g)
    result["capture"] = capture_probe(K, g)
    device_ms = graph_ms if result["capture"].get("equal") else time_ms
    result["device_time_from"] = ("replayed CUDA graphs"
                                  if device_ms is graph_ms
                                  else "CUDA events over back-to-back calls")
    if not args.quick:
        result["timed"] = timed(K, g, LossFunc, device_ms)
        result["phases"] = phases(K, _build, g, device_ms)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
