#!/usr/bin/env python3
"""How far float32 SGD rounds on the card stray from the same rounds with
float64 terms: the LR config's fit at a wide dense width, its rounds run
with ``sgd_batch_terms`` (the kernels), ``sgd_batch_terms_plain`` (one
matrix-vector product each way), a second plain order (the gradient summed
over blocks of rows), terms taken in float64 and rounded once, and two ways
that tell the dots' part from the gradient's: float32 dots with a float64
gradient, and float64 dots with a float32 gradient added row by row in row
order.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/port_sgd_fit_precision.py [--shapes D:ROWS,...] [--out F]

For each shape (default: 2,097,152 columns over 1,250 rows and 262,144 over
10,000, ``chip_smoke.py`` phase 23's two widest fits) it builds the LR
config's table with only ``vectorDim`` and ``numValues`` changed (the
runner's generator, as phase 23 does, every round all the rows, weights 1)
and runs the config's rounds six ways (``--ways`` picks some) from zero
coefficients. It prints,
for each pair of ways, the largest coefficient difference, the largest
ratio of a difference to ``chip_smoke.py``'s COEFF_RTOL·|c| + COEFF_ATOL
(over 1: that check fails between the two), and the mean losses; and for
every way, its difference from the float64 rounds. One JSON line (also
appended to F with ``--out``).
"""

import argparse
import copy
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
COEFF_RTOL, COEFF_ATOL = 1e-4, 1e-6  # chip_smoke.py's fit tolerance
BLOCK_ROWS = 64  # rows of a block of the second plain order and of float64


def terms_blocked(xl, yl, wl, coeffs, start, clip, lb, loss_name, dtype,
                  grad_dtype=None, row_order=False):
    """The round's packed terms from blocks of BLOCK_ROWS rows: each
    block's dots in ``dtype``, its gradient in ``grad_dtype`` (default
    ``dtype``; with ``row_order``, float32 rows added one at a time in row
    order, as the two-pass set's owners add them), the blocks' gradients
    added in block order; the result rounded once to float32."""
    from flink_ml_tpu_torch.ops.losses import LossFunc

    loss_fn = LossFunc.by_name(loss_name)
    grad_dtype = grad_dtype or dtype
    c = coeffs.to(dtype)
    grad = torch.zeros(xl.shape[1], dtype=grad_dtype, device=xl.device)
    wsum = torch.zeros((), dtype=dtype, device=xl.device)
    lsum = torch.zeros((), dtype=dtype, device=xl.device)
    for r0 in range(0, lb, BLOCK_ROWS):
        r1 = min(lb, r0 + BLOCK_ROWS)
        xb = xl[start + r0:start + r1].to(dtype)
        wb = wl[start + r0:start + r1].to(dtype)
        keep = torch.arange(r0, r1, device=xl.device) >= clip
        wb = torch.where(keep, wb, torch.zeros_like(wb))
        loss, mult = loss_fn.terms(xb @ c, yl[start + r0:start + r1].to(dtype),
                                   wb)
        if row_order:
            for i in range(r1 - r0):
                grad.add_(xl[start + r0 + i], alpha=float(mult[i]))
        else:
            grad += xb.to(grad_dtype).T @ mult.to(grad_dtype)
        wsum += wb.sum()
        lsum += loss
    return torch.cat([grad.to(dtype), wsum[None], lsum[None]]).float()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shapes", default="2097152:1250,262144:10000",
                        help="comma-separated D:ROWS")
    parser.add_argument("--ways", default="",
                        help="comma-separated ways to run (default: all)")
    parser.add_argument("--out", help="also append the JSON line to FILE")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_sgd_fit_precision: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, str(REPO))
    from flink_ml_tpu_torch.benchmark import runner
    from flink_ml_tpu_torch.ops import kernels as K
    from flink_ml_tpu_torch.ops import optimizer

    K.build_kernels()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    config = REPO / "flink_ml_tpu" / "benchmark" / "configs" / \
        "logisticregression-benchmark.json"
    base = runner.load_config(str(config))["logisticregression"]
    ways = {
        "kernel": K.sgd_batch_terms,
        "plain": K.sgd_batch_terms_plain,
        "plain_blocked": lambda *a: terms_blocked(*a, torch.float32),
        "dots32_grad64": lambda *a: terms_blocked(*a, torch.float32,
                                                  torch.float64),
        "dots64_grad32_rows": lambda *a: terms_blocked(
            *a, torch.float64, torch.float32, row_order=True),
        "float64": lambda *a: terms_blocked(*a, torch.float64)}
    if args.ways:
        ways = {n: ways[n] for n in args.ways.split(",")}
    result = {"card": card, "shapes": {}}
    for shape in args.shapes.split(","):
        d, rows = (int(v) for v in shape.split(":"))
        spec = copy.deepcopy(base)
        spec["inputData"]["paramMap"].update(vectorDim=d, numValues=rows)
        table = runner.build_generator(spec).get_data()
        est = runner.build_stage(spec)
        x = table.vectors(est.features_col)
        y = table.column(est.label_col)
        w = torch.ones(rows, device="cuda")
        prm = optimizer.SGDParams(
            learning_rate=est.learning_rate,
            global_batch_size=est.global_batch_size,
            max_iter=spec["stage"]["paramMap"]["maxIter"], tol=est.tol,
            reg=est.reg, elastic_net=est.elastic_net)
        fits = {}
        for name, terms in ways.items():
            coeffs, loss, ran = optimizer.sgd_rounds(
                terms, "logistic", prm, x, y, w,
                torch.zeros(d, device="cuda"))
            fits[name] = (coeffs.double(), float(loss), int(ran))
        row = {"rows": rows, "d": d,
               "mean_loss": {n: f[1] for n, f in fits.items()},
               "rounds": {n: f[2] for n, f in fits.items()},
               "max_abs_coeff": float(fits["float64"][0].abs().max())}
        names = list(fits)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                diff = (fits[a][0] - fits[b][0]).abs()
                tol = COEFF_RTOL * fits[b][0].abs() + COEFF_ATOL
                row[f"{a} vs {b}"] = {
                    "max_abs_diff": float(diff.max()),
                    "mean_diff": float((fits[a][0] - fits[b][0]).mean()),
                    "max_over_tolerance": float((diff / tol).max())}
        result["shapes"][shape] = row
        print(f"{shape}: {json.dumps(row)}", file=sys.stderr, flush=True)
        del x, y, w, table, fits
        torch.cuda.empty_cache()
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
