#!/usr/bin/env python3
"""The port's SGD cluster instance (``sgd_cluster_kernel`` of
``flink_ml_tpu_torch/csrc/sgd_kernels.cu``: rows past 13,209 columns, each
row's columns split over a thread block cluster of 2, 4 or 8 CTAs), held
against its plain version and timed on one CUDA card.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/port_sgd_cluster.py [--quick] [--out FILE]

1. Builds the kernels and prints the card's name and power limit and
   ptxas' registers and spills of every SGD stage-1 instance.
2. Holds ``sgd_batch_terms`` against ``sgd_batch_terms_plain`` (within
   SUM_RTOL/SUM_ATOL, as ``chip_smoke.py`` does) at d = 13,210, 16,000,
   50,001 and 100,000, for every loss, at a full, a ragged clipped, an
   end-clipped and a one-row window: a rerun bit-identical, the C entry's
   combine bit-identical to ``reduce_partials_plain`` of its partials, the
   same rows from an x 4 bytes off 16-byte alignment, and at 16,000 every
   cluster size run by hand.
3. Unless ``--quick``, times with CUDA events, each timed call on the next
   window of its table (cold in L2), device time from calls captured in a
   CUDA graph and replayed, and the eager call (host enqueue included):
   at d = 16,000, lb = 20,000 and at d = 13,210, 50,001 and 100,000
   (windows of the same 1.28 GB), the planned instance and the library
   pair (``x @ c``, then ``xᵀ @ mult`` given the multipliers), and the
   cluster instance in every cluster size whose slice fits (whole call
   and stage 1, the clusters the card holds); at 16,000 also the plain
   version; each with the byte bound (x, y, w, the coefficients and the
   output once at 3.35 TB/s).
4. Unless ``--quick``, the phase split: builds the source once more with
   its switch ``-DSGD_PHASE_CLOCKS`` (CTA 0 reads ``clock64()`` between the
   phases of each stage: the copy wait and barrier, the partial dots, the
   cluster barrier's arrive, the copy issue after it, its wait, the dots'
   sum and terms, mult · x),
   runs the planned launch at d = 16,000 and 100,000 with it and prints
   the mean cycles per stage of each phase over CTA 0's threads, beside
   both builds' device times.

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
CHECK_WIDTHS = ((13_210, 1_200), (16_000, 1_000), (50_001, 400),
                (100_000, 300))
#: timed shapes: d -> lb, each window 1.28 GB of x
TIMED = {16_000: 20_000, 13_210: 24_224, 50_001: 6_400, 100_000: 3_200}
PHASES = ("copy wait", "dots", "cluster arrive", "copy issue",
          "cluster wait", "terms", "mult x")


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
    """kernel -> ptxas' register and spill lines, for the stage-1 kernels."""
    out, current = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if "'" in line else line.strip()
        elif ("registers" in line or "spill" in line) and "sgd_" in current:
            out.setdefault(current, []).append(line.strip())
    return out


def cluster_plan(K, x, lb, loss, c):
    """The cluster instance's plan in clusters of ``c`` for x."""
    d = x.shape[1]
    ds = K._sgd_cluster_slice(d, c)
    smem = K._sgd_cluster_layout(ds)[1]
    resident = K._sgd_resident_clusters(0, K.SGD_LOSSES[loss], d, c, smem)
    return K._sgd_cluster_plan(lb, d, resident, int(x.data_ptr() % 16 == 0),
                               c)


def check(K, g):
    """Step 2: every loss and window at the check widths."""
    out = {}
    for d, rows in CHECK_WIDTHS:
        x = torch.rand((rows, d), generator=g, device="cuda")
        y = torch.floor(torch.rand(rows, generator=g, device="cuda") * 2)
        w = torch.rand(rows, generator=g, device="cuda")
        c = (torch.rand(d, generator=g, device="cuda") - 0.5) / d ** 0.5
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
                assert plan.instance == "cluster", plan
                got = K.sgd_batch_terms(x, *call)
                assert torch.isfinite(got).all(), (d, loss, start)
                assert torch.equal(got, K.sgd_batch_terms(x, *call)), (
                    f"d={d} {loss} start={start}: rerun not bit-identical")
                errs.append(within(got, K.sgd_batch_terms_plain(x, *call),
                                   f"d={d} {loss} start={start}"))
                part = K._launch_sgd_terms(x, *call, combine=False)[:-1]
                assert torch.equal(got, K.reduce_partials_plain(part)), (
                    f"d={d} {loss}: the combine differs")
                unaligned = K._sgd_card_plan(xu, lb, loss)
                assert unaligned.vec4 == 0 and unaligned.instance == "cluster"
                gu = K.sgd_batch_terms(xu, *call)
                assert torch.equal(gu, K.sgd_batch_terms(xu, *call))
                errs.append(within(gu, K.sgd_batch_terms_plain(xu, *call),
                                   f"d={d} {loss} unaligned"))
            if d == 16_000:
                for size in K.SGD_CLUSTER_SIZES:
                    ws = K._launch_sgd_terms(x, y, w, c, 5, 3, rows - 9, loss,
                                             plan=cluster_plan(K, x, rows - 9,
                                                               loss, size))
                    errs.append(within(ws[-1], K.sgd_batch_terms_plain(
                        x, y, w, c, 5, 3, rows - 9, loss), f"c={size}"))
        plan = K._sgd_card_plan(x, rows, "logistic")
        out[d] = {"plan": plan._asdict(), "max_abs_err": max(errs)}
        print(f"check d={d}: {json.dumps(out[d])}", file=sys.stderr,
              flush=True)
        del x, xu, flat
        torch.cuda.empty_cache()
    return out


def timed(K, g, LossFunc):
    """Step 3."""
    out = {}
    loss = "logistic"
    for d, lb in TIMED.items():
        n = 2 * lb
        x = torch.rand((n, d), generator=g, device="cuda")
        y = torch.floor(torch.rand(n, generator=g, device="cuda") * 2)
        w = torch.rand(n, generator=g, device="cuda")
        c = (torch.rand(d, generator=g, device="cuda") - 0.5) / d ** 0.5
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
               "device_ms": graph_ms(call()),
               "stage1_device_ms": graph_ms(call(combine=False)),
               "ms": time_ms(call()),
               "library_device_ms": graph_ms(library()),
               "library_ms": time_ms(library())}
        sweep = {}
        for size in K.SGD_CLUSTER_SIZES:
            if K._sgd_cluster_layout(K._sgd_cluster_slice(d, size)) is None:
                continue
            p = cluster_plan(K, x, lb, loss, size)
            sweep[size] = {"clusters": p.blocks, "resident": p.resident,
                           "rows": p.rows, "smem": p.smem,
                           "device_ms": graph_ms(call(p)),
                           "stage1_device_ms": graph_ms(call(p, False))}
        row["sweep"] = sweep
        if d == 16_000:
            row["plain_ms"] = time_ms(lambda s=rolling(n, lb): (
                K.sgd_batch_terms_plain(x, y, w, c, s(), 0, lb, loss)))
        row["share_of_bound"] = bound / row["device_ms"]
        out[d] = row
        print(f"timed d={d}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del x, y, w, mult
        torch.cuda.empty_cache()
    return out


def phases(K, _build, g):
    """Step 4: the clocked build at d = 16,000, lb = 20,000 and at d =
    100,000, lb = 3,200."""
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
    clocked.sgd_phase_cycles_read.argtypes = [ctypes.c_void_p]
    ptxas = sgd_ptxas(built.stdout + built.stderr)
    return {d: phase_split(K, clocked, g, d, lb, ptxas)
            for d, lb in ((16_000, 20_000), (100_000, 3_200))}


def phase_split(K, clocked, g, d, lb, ptxas):
    """One width's clocked run (step 4)."""
    loss = "logistic"
    n = 2 * lb
    x = torch.rand((n, d), generator=g, device="cuda")
    y = torch.floor(torch.rand(n, generator=g, device="cuda") * 2)
    w = torch.rand(n, generator=g, device="cuda")
    c = (torch.rand(d, generator=g, device="cuda") - 0.5) / d ** 0.5
    plan = K._sgd_card_plan(x, lb, loss)
    count = ctypes.c_int(0)
    assert clocked.sgd_clusters_on_card(
        K.SGD_LOSSES[loss], d, plan.dc, plan.cluster, plan.smem,
        ctypes.byref(count)) == 0  # sets the clocked build's smem limit

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
           "device_ms": {"real": graph_ms(launch(real)),
                         "clocked": graph_ms(launch(clocked))}}
    launch(clocked)()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (256 * len(PHASES)))()
    assert clocked.sgd_phase_cycles_read(buf) == 0
    runs = K.sgd_runs(plan, lb)
    stages = -(-(runs[0][1] - runs[0][0]) // plan.rows)
    mean = [statistics.mean(buf[t * len(PHASES) + q] for t in range(256))
            / stages for q in range(len(PHASES))]
    row.update({"stages": stages,
                "cycles_per_stage": dict(zip(PHASES, mean)),
                "cycles_per_stage_total": sum(mean), "ptxas": ptxas})
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
                        help="build and check only, no timing")
    parser.add_argument("--out", help="also append the JSON line to FILE")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_sgd_cluster: no CUDA device", file=sys.stderr)
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
    g = torch.Generator(device="cuda").manual_seed(26)
    result["check"] = check(K, g)
    if not args.quick:
        result["timed"] = timed(K, g, LossFunc)
        result["phases"] = phases(K, _build, g)
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
