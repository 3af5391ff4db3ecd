#!/usr/bin/env python3
"""Times RobustScaler's rank selection on one CUDA card, at the
RobustScaler config's shape (``robustscaler-benchmark.json``: 10,000,000
x 100 float32 rows from its generator; ranks floor(q * (n - 1)) for q =
0.25, 0.5, 0.75, the scaler's defaults): the port's
``ops/quantile.rank_select_device`` (a sort of the order-preserving int32
keys, a group of columns at a time) against the JAX package's design, 32
bisection rounds per rank over the same keys (kept below), and against
selections by ``torch.kthvalue`` and by one ``torch.sort`` of all the keys.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/port_rank_select_ab.py [--rows N]

Every candidate selects the (rank + 1)-th smallest key per column and maps
it back, so each must give the bisection's result bit for bit (checked
with ``torch.equal`` on the int32 views). ``torch.kthvalue`` on the float32
rows themselves (the reference ``chip_smoke.py`` holds the scaler to) is
timed beside them. Times are host milliseconds around one call, ended by
``torch.cuda.synchronize()``, best of three; the peak of device memory
each call allocates is printed beside it. The last line is one JSON
object.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from flink_ml_tpu_torch.benchmark import runner  # noqa: E402
from flink_ml_tpu_torch.ops import quantile  # noqa: E402

CONFIG = (Path(__file__).resolve().parent.parent / "flink_ml_tpu"
          / "benchmark" / "configs" / "robustscaler-benchmark.json")
PROBS = (0.25, 0.5, 0.75)


def _ranks(n):
    return np.floor(np.asarray(PROBS, np.float64) * (n - 1)) \
        .astype(np.int64).tolist()


def kthvalue_rows(x):
    """kthvalue down the (n, d) keys' rows (a strided slice per column)."""
    keys = quantile._order_keys(x)
    out = torch.stack([torch.kthvalue(keys, r + 1, dim=0).values
                       for r in _ranks(x.shape[0])])
    return quantile._order_keys(out.view(torch.float32)).view(torch.float32)


def kthvalue_cols(x):
    """kthvalue along the transposed, contiguous (d, n) keys."""
    keys = quantile._order_keys(x).t().contiguous()
    out = torch.stack([torch.kthvalue(keys, r + 1, dim=1).values
                       for r in _ranks(x.shape[0])])
    return quantile._order_keys(out.view(torch.float32)).view(torch.float32)


def sort_cols(x):
    """One segmented sort of the transposed keys, then a gather."""
    keys = quantile._order_keys(x).t().contiguous()
    ranks = torch.tensor(_ranks(x.shape[0]), device=x.device)
    out = torch.sort(keys, dim=1).values[:, ranks].t().contiguous()
    return quantile._order_keys(out.view(torch.float32)).view(torch.float32)


def bisection(x):
    """32 rounds of bisection per rank: each round counts, per column, the
    keys at or below the bracket's midpoint (one pass over the keys)."""
    keys = quantile._order_keys(x)
    out = torch.empty((len(PROBS), x.shape[1]), dtype=torch.int32,
                      device=x.device)
    for r, rank in enumerate(_ranks(x.shape[0])):
        lo = torch.full((x.shape[1],), -(1 << 31), dtype=torch.int64,
                        device=x.device)
        hi = torch.full_like(lo, (1 << 31) - 1)
        for _ in range(32):
            mid = lo + torch.div(hi - lo, 2, rounding_mode="floor")
            ok = (keys <= mid.to(torch.int32)).sum(dim=0) >= rank + 1
            hi = torch.where(ok, mid, hi)
            lo = torch.where(ok, lo, mid + 1)
        out[r] = hi.to(torch.int32)
    return quantile._order_keys(out.view(torch.float32)).view(torch.float32)


def port(x):
    return quantile.rank_select_device(x, PROBS)


def library_kthvalue(x):
    """torch.kthvalue on the float32 rows (no order keys: NaN payloads and
    -0.0 are not told apart)."""
    return torch.stack([torch.kthvalue(x, r + 1, dim=0).values
                        for r in _ranks(x.shape[0])])


def _timed(fn, x, runs=3):
    best, out, peak = float("inf"), None, 0
    for _ in range(runs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start = time.perf_counter()
        out = fn(x)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - start) * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
    return out, best, peak


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=None,
                    help="cut the config's rows (default: the config's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("port_rank_select_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    ((_, spec),) = runner.load_config(str(CONFIG)).items()
    if args.rows:
        spec["inputData"]["paramMap"]["numValues"] = args.rows
    x = runner.build_generator(spec, "cuda").get_data().column("input")
    assert x.dtype == torch.float32 and x.is_cuda, (x.dtype, x.device)
    n, d = x.shape
    print(f"card: {card}; rows {n} x {d}; ranks {_ranks(n)}", flush=True)
    want, _, _ = _timed(bisection, x, runs=1)
    rows = {}
    for name, fn in (("bisection", bisection), ("port", port),
                     ("kthvalue_cols", kthvalue_cols),
                     ("kthvalue_rows", kthvalue_rows),
                     ("sort_cols", sort_cols),
                     ("library_kthvalue", library_kthvalue)):
        out, ms, peak = _timed(fn, x)
        same = torch.equal(out.view(torch.int32), want.view(torch.int32))
        rows[name] = {"ms": ms, "peak_bytes": peak, "bit_equal": same}
        print(f"{name}: {ms:.3f} ms, peak {peak / 2**30:.2f} GiB, "
              f"bit-equal to the bisection: {same}", flush=True)
        del out
        torch.cuda.empty_cache()
    # the bytes bound of one pass over the keys per rank at 3.35 TB/s
    bound_ms = len(PROBS) * x.numel() * 4 / 3.35e12 * 1e3
    print(json.dumps({"card": card, "rows": n, "width": d, "probs": PROBS,
                      "one_pass_per_rank_bound_ms": bound_ms,
                      "candidates": rows}, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
