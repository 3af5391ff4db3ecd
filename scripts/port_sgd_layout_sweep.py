#!/usr/bin/env python3
"""Times the port's chunked ``sgd_batch_terms`` kernel over tile layouts and
widths, beside the staged instance the plan gives those widths.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/port_sgd_layout_sweep.py [--out F]

Rows of up to ``SGD_REG_COLS`` columns take the register instance, which
has no tile layout; for each wider feature width d it builds a table of two
400 MB windows on the card and times the logistic instance of the chunked
kernel (stage 1 and the fixed-order combine, launched by hand with
``_sgd_chunked_plan``) at every (rows, chunk columns) layout of the sweep,
and at the layout ``ops/kernels.py`` chooses for it, and the call as the
card plan launches it (``planned``: the staged instance up to about 13,200
columns), with CUDA events; the calls take the two windows in turn, so
none finds its rows in L2. Beside each time: the plain PyTorch version's
time and the byte bound (the window's x, y and w, the coefficients and the
output, read or written once, at 3.35 TB/s). Every result is held against
the plain version (rtol 1e-4 + atol 1e-3, sums over up to 1e6 rows). It
prints the card and one JSON line per width. Exits nonzero without a card
or on a wrong result.
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
sys.path.insert(0, str(REPO))

WIDTHS = (1000, 2000, 6001)
#: (rows, chunk columns); chunks are multiples of the kernel's 256 threads
LAYOUTS = ((64, 512), (32, 512), (16, 512), (64, 256), (32, 256), (16, 256),
           (8, 256))
WINDOW_FLOATS = 10 ** 8  # 400 MB of x per window
PEAK_BYTES_PER_S = 3.35e12


def time_ms(fn, batches=5, per_batch=10, warmup=3):
    """Median per-call device time over batches of back-to-back calls."""
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="port_sgd_layout_sweep")
    parser.add_argument("--out", default=None, help="also write the lines here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_sgd_layout_sweep: no CUDA device", file=sys.stderr)
        return 2

    from flink_ml_tpu_torch.ops import kernels as K

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    K.build_kernels()
    chosen_layout = K._sgd_layout
    g = torch.Generator(device="cuda").manual_seed(1)
    lines, ok = [], True
    for d in WIDTHS:
        lb = WINDOW_FLOATS // d
        x = torch.rand((2 * lb, d), generator=g, device="cuda")
        y = torch.floor(torch.rand(2 * lb, generator=g, device="cuda") * 2)
        w = torch.rand(2 * lb, generator=g, device="cuda")
        c = (torch.rand(d, generator=g, device="cuda") - 0.5) / d ** 0.5
        starts = itertools.cycle((0, lb))

        def plain():
            return K.sgd_batch_terms_plain(x, y, w, c, next(starts), 0, lb,
                                           "logistic")

        def kernel(plan):
            return K._launch_sgd_terms(x, y, w, c, next(starts), 0, lb,
                                       "logistic", plan=plan)[-1]

        want = K.sgd_batch_terms_plain(x, y, w, c, 0, 0, lb, "logistic")
        line = {"d": d, "lb": lb,
                "bound_ms": 4 * (lb * d + 2 * lb + 2 * d + 2)
                / PEAK_BYTES_PER_S * 1e3,
                "plain_ms": time_ms(plain), "chosen": None, "ms": {}}
        vec4 = int(d % 4 == 0 and x.data_ptr() % 16 == 0)
        for rows, chunk in LAYOUTS + ((None, None), ("planned", None)):
            if rows == "planned":
                plan, key = K._sgd_card_plan(x, lb, "logistic"), "planned"
            else:
                if rows is None:
                    rows, dc, smem = chosen_layout(d)
                    key = "chosen"
                else:
                    dc = min(d, chunk)
                    smem = 4 * (rows * dc + dc + 3 * rows)
                    key = f"{rows}x{chunk}"
                K._sgd_layout = lambda _d, r=(rows, dc, smem): r
                # the occupancy query, which lets the kernel use this
                # layout's shared memory, is cached by layout: ask anew
                K._sgd_resident_blocks.cache_clear()
                resident = K._sgd_resident_blocks(0, 0, 0, vec4, d, dc, smem)
                plan = K._sgd_chunked_plan(lb, d, resident, vec4)
                K._sgd_layout = chosen_layout
            got = K._launch_sgd_terms(x, y, w, c, 0, 0, lb, "logistic",
                                      plan=plan)[-1]
            if not bool(((got - want).abs()
                         <= 1e-4 * want.abs() + 1e-3).all()):
                ok = False
                key += " WRONG"
            ms = time_ms(lambda: kernel(plan))
            if key == "chosen":
                line["chosen"] = {"rows": rows, "dc": dc, "ms": ms}
            elif key.startswith("planned"):
                line[key] = {"instance": plan.instance, "ms": ms}
            else:
                line["ms"][key] = ms
        K._sgd_resident_blocks.cache_clear()
        text = json.dumps(line)
        print(text, flush=True)
        lines.append(text)
        del x, y, w
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(card + "\n" + "\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
