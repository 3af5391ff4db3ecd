#!/usr/bin/env python3
"""The port's ``sgd_batch_terms`` at the linear main path's window and at the
widths around it, timed for one tree of the repository, so that two trees
can be held against each other on one card in one call.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/port_sgd_ab.py --tree DIR [--shapes A,B,...] [--out FILE]

Imports ``flink_ml_tpu_torch`` from DIR (the repository itself, or a
``git archive`` of another commit unpacked somewhere), builds its kernels
and, for each loss (logistic, hinge, least_square) at each shape below
(tables from one seed, so every tree gets the same inputs), holds the call
against ``sgd_batch_terms_plain`` (within SUM_RTOL/SUM_ATOL, and
bit-identical on a rerun; where the tree launches both stages from one C
entry, its output also equals ``reduce_partials_plain`` of the partials the
same call wrote, bit for bit). Then it times, with CUDA events:

- ``ms``: the whole call eagerly (batches of back-to-back calls, host
  enqueue included);
- ``device_ms`` and ``stage1_device_ms``: the device time of the whole call
  and of its first stage alone (the per-block partials), from calls
  captured in a CUDA graph and replayed;
- ``library_ms`` and ``library_device_ms``: ``torch.mv`` of the window's
  rows with the multipliers given, the yardstick that does less work;
- ``bound_ms``: the window's x, y and w, the coefficients and the output,
  each read or written once, at 3.35 TB/s.

The timed calls move their window on by lb at every call wherever the
table holds more than one window (each table but the last holds about 20),
so that no call finds its rows in L2, as in a fit over a table larger than
L2; where a table that fits L2 was timed on one window, the time depended
on where the allocator placed it. The shapes:

- ``main``: lb = 100,000 of a 10,000,000 x 100 table (the linear benchmark
  configs), clip 0;
- ``end-clipped``: the same table, start = n - lb, clip 41,234;
- ``ragged-lb``: lb = 100,003 from start 17;
- ``lb=1``: one row at 123,457;
- ``odd-d``: d = 7, lb = 9,998 from start 5, clip 3;
- ``d=512``: lb = 100,000 of 1,000,000 x 512 rows;
- ``chunked-d`` and ``chunked-odd-d``: d = 1,500 (lb = 4,991) and 6,001
  (lb = 2,991), start 5, clip 3, the windows of ``chip_smoke.py`` phase
  3 (the chunked instance's on a tree without the staged one, the staged
  instance's on a tree with it);
- ``d=2000``: all 100,000 rows of 100,000 x 2,000 (likewise);
- ``d=16000``: lb = 20,000 of 40,000 x 16,000 rows (the chunked
  instance's on a tree without the cluster one, the cluster instance's on
  a tree with it);
- ``d=262144``: lb = 1,220 of 2,440 x 262,144 rows (likewise the chunked
  instance's or the grid instance's);
- ``d=2097152``, ``d=2500000`` and ``d=4194304``: windows of 1.28 GB, lb =
  152 of 304, 128 of 256 and 76 of 152 rows (the chunked instance's on a
  tree without the two-pass set, the two-pass set's on a tree with it);
- ``fit-2097152``: lb = 1,250, all the rows of 1,250 x 2,097,152 (10.49 GB:
  phase 23's LR fit at 2^21 columns, every round all the rows).

``--shapes`` runs only the named shapes (all by default), ``--losses`` only
the named losses; ``--reps R`` captures R calls in each timed graph and
times R calls in each eager batch (20 and 10 by default: fewer keep a tree
whose call takes tens of milliseconds within a call's time limit).

It prints one JSON line: the tree, the card's name and power limit, ptxas'
registers and spills of each kernel of ``sgd_kernels.cu``, and each
shape's launch plan (the tile layout and grid, or the instance and grid,
with blocks per SM) and numbers. Run it for parent, change, change,
parent, each in a process of its own, and compare within the call.
"""

import argparse
import itertools
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

SUM_RTOL, SUM_ATOL = 1e-4, 1e-3
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory, at 700 W
LOSSES = ("logistic", "hinge", "least_square")

#: table name -> (rows, d)
TABLES = {"main": (10_000_000, 100), "d=7": (200_000, 7),
          "d=512": (1_000_000, 512), "d=1500": (100_000, 1_500),
          "d=6001": (60_000, 6_001), "d=2000": (100_000, 2_000),
          "d=16000": (40_000, 16_000), "d=262144": (2_440, 262_144),
          "d=2097152": (304, 2_097_152), "d=2500000": (256, 2_500_000),
          "d=4194304": (152, 4_194_304), "fit": (1_250, 2_097_152)}
#: shape -> (table, start, clip, lb)
SHAPES = {
    "main": ("main", 0, 0, 100_000),
    "end-clipped": ("main", 10_000_000 - 100_000, 41_234, 100_000),
    "ragged-lb": ("main", 17, 0, 100_003),
    "lb=1": ("main", 123_457, 0, 1),
    "odd-d": ("d=7", 5, 3, 9_998),
    "d=512": ("d=512", 0, 0, 100_000),
    "chunked-d": ("d=1500", 5, 3, 4_991),
    "chunked-odd-d": ("d=6001", 5, 3, 2_991),
    "d=2000": ("d=2000", 0, 0, 100_000),
    "d=16000": ("d=16000", 0, 0, 20_000),
    "d=262144": ("d=262144", 0, 0, 1_220),
    "d=2097152": ("d=2097152", 0, 0, 152),
    "d=2500000": ("d=2500000", 0, 0, 128),
    "d=4194304": ("d=4194304", 0, 0, 76),
    "fit-2097152": ("fit", 0, 0, 1_250),
}


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


def sgd_ptxas(log):
    """function -> ptxas' register and spill lines, for the sgd kernels."""
    out, current = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1] if "'" in line else line.strip()
        elif "registers" in line or "spill" in line:
            out.setdefault(current, []).append(line.strip())
    return out


def one_entry(K):
    """True where the tree launches both stages from one C entry (its
    ``_launch_sgd_terms`` returns a workspace of the partials, then the
    output row)."""
    return hasattr(K, "_sgd_plan")


def stage1(K, args):
    """The first stage alone: the per-block partials."""
    if one_entry(K):
        return K._launch_sgd_terms(*args, combine=False)
    return K._launch_sgd_terms(*args)


def plan_of(K, x, lb, loss):
    d = x.shape[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if one_entry(K):
        plan = K._sgd_card_plan(x, lb, loss)
        return dict(plan._asdict(), per_sm=plan.resident // sms)
    rows, dc, smem = K._sgd_layout(d)
    resident = K._sgd_resident_blocks(0, K.SGD_LOSSES[loss], smem)
    ntiles = -(-lb // rows)
    blocks = min(ntiles, resident)
    tiles_per_block = -(-ntiles // blocks)
    return {"instance": "tiles", "rows": rows, "dc": dc, "smem": smem,
            "blocks": -(-ntiles // tiles_per_block),
            "tiles_per_block": tiles_per_block, "per_sm": resident // sms}


def windows(table_rows, start, lb):
    """Window starts for the timed calls: the check's start, then on by lb
    (down from the end for a window that ends the table), or the start
    alone where the table holds one window."""
    if table_rows < 2 * lb:
        return itertools.repeat(start)
    if start + lb == table_rows:
        return itertools.cycle(range(start, -1, -lb))
    return itertools.cycle(range(start, table_rows - lb + 1, lb))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", required=True,
                        help="root of the repository tree to import")
    parser.add_argument("--shapes", default=",".join(SHAPES),
                        help="comma-separated shapes to run (default: all)")
    parser.add_argument("--losses", default=",".join(LOSSES),
                        help="comma-separated losses to run (default: all)")
    parser.add_argument("--reps", type=int, default=20,
                        help="calls in each timed graph (eager batches: "
                             "half as many, at least one)")
    parser.add_argument("--out", help="also append the JSON line to FILE")
    args = parser.parse_args()
    shapes = args.shapes.split(",")
    losses = args.losses.split(",")
    if sorted(set(losses) - set(LOSSES)):
        parser.error(f"unknown losses; known: {LOSSES}")
    reps, per_batch = args.reps, max(1, args.reps // 2)
    unknown = sorted(set(shapes) - set(SHAPES))
    if unknown:
        parser.error(f"unknown shapes {unknown}; known: {sorted(SHAPES)}")
    if not torch.cuda.is_available():
        print("port_sgd_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from flink_ml_tpu_torch.ops import _build
    from flink_ml_tpu_torch.ops import kernels as K
    from flink_ml_tpu_torch.ops.losses import LossFunc
    assert Path(K.__file__).resolve().is_relative_to(tree), K.__file__

    K.build_kernels()
    ptxas = sgd_ptxas(_build.BUILD_LOGS.get(K.SGD_SOURCE, ""))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(23)
    results = {}
    for table_name, (n, d) in TABLES.items():
        if not any(SHAPES[shape][0] == table_name for shape in shapes):
            continue
        x = torch.rand((n, d), generator=g, device="cuda")
        y = torch.floor(torch.rand(n, generator=g, device="cuda") * 2)
        w = torch.rand(n, generator=g, device="cuda")
        c = (torch.rand(d, generator=g, device="cuda") - 0.5) * (10 / d ** 0.5)
        for loss in losses:
            mult = LossFunc.by_name(loss).terms(x @ c, y, w)[1]
            for shape, (tname, start, clip, lb) in SHAPES.items():
                if tname != table_name or shape not in shapes:
                    continue
                call = (x, y, w, c, start, clip, lb, loss)
                got = K.sgd_batch_terms(*call)
                want = K.sgd_batch_terms_plain(*call)
                assert torch.equal(got, K.sgd_batch_terms(*call)), (
                    f"{shape} {loss}: rerun not bit-identical")
                assert torch.isfinite(got).all(), f"{shape} {loss}"
                excess = float(((got - want).abs() - SUM_RTOL * want.abs()
                                - SUM_ATOL).max())
                assert excess <= 0, (
                    f"{shape} {loss}: off by {excess} over tolerance")
                row = {"plan": plan_of(K, x, lb, loss),
                       "max_abs_err": float((got - want).abs().max())}
                if one_entry(K):
                    assert torch.equal(got, K.reduce_partials_plain(
                        stage1(K, call)[:-1])), f"{shape} {loss}: combine differs"
                    row["combine_bit_identical"] = True

                def at(fn):
                    """fn(s) on the next timed window."""
                    starts = windows(n, start, lb)
                    return lambda: fn(next(starts))

                def whole(s):
                    return K.sgd_batch_terms(x, y, w, c, s, clip, lb, loss)

                def first(s):
                    return stage1(K, (x, y, w, c, s, clip, lb, loss))

                def library(s):
                    return torch.mv(x[s:s + lb].T, mult[s:s + lb])

                row.update({
                    "ms": time_ms(at(whole), per_batch=per_batch),
                    "device_ms": graph_ms(at(whole), reps),
                    "stage1_ms": time_ms(at(first), per_batch=per_batch),
                    "stage1_device_ms": graph_ms(at(first), reps),
                    "bound_ms": 4 * (lb * d + 2 * lb + 2 * d + 2)
                                / PEAK_BYTES_PER_S * 1e3,
                    "library_ms": time_ms(at(library), per_batch=per_batch),
                    "library_device_ms": graph_ms(at(library), reps)})
                results.setdefault(shape, {})[loss] = row
                print(f"{shape} {loss}: {json.dumps(row)}", file=sys.stderr,
                      flush=True)
            del mult
        del x, y, w, c
        torch.cuda.empty_cache()
    line = json.dumps({"tree": str(args.tree), "card": card, "ptxas": ptxas,
                       "sgd_batch_terms": results})
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
