#!/usr/bin/env python3
"""The port's KMeans kernels (Lloyd's stage 1, the whole
``lloyd_partial_sums`` and ``assign_nearest``) timed for one tree of the
repository, so that two trees can be held against each other on one card
in one call, and their outputs compared byte for byte.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/port_lloyd_ab.py --tree DIR [--out FILE] [--save FILE]
    python3 scripts/port_lloyd_ab.py --compare FILE FILE [FILE ...]

Imports ``flink_ml_tpu_torch`` from DIR (the repository itself, or a
``git archive`` of another commit unpacked somewhere), builds its kernels
and, at each shape below (from one seed, so every tree gets the same
inputs), prints one JSON line: the tree, the card's name and power limit,
and the eager time (CUDA events around batches of back-to-back calls, host
enqueue included) and device time (calls captured in a CUDA graph and
replayed) of stage 1 (the per-block partials), of the whole
``lloyd_partial_sums`` (stage 1 and ``reduce_partials``) and of
``assign_nearest``, with the byte bound of one pass over the inputs.
``--save`` writes each shape's stage-1 partials, sums and labels to FILE
(``torch.save``); ``--compare`` needs no card and exits 1 unless every
tensor of the files is the same, byte for byte, as the first file's.

The shapes are those of ``chip_smoke.py`` phase 2 (n, d, k and weights):
``main`` 1,000,000 x 100, k = 10, unit weights; ``ragged-n`` 100,003 x 100;
``zero-weights`` 200,000 x 100 with 30% of the weights 0; ``wide-k``
50,000 x 100, k = 300 (centroids scored in chunks); ``odd-d`` 10,007 x 7,
k = 5; and ``weighted``, 100,003 x 100 with weights uniform in [0, 1), whose
products weight x value are not exact in float32. n = 0 launches nothing
and is left out. Run it for parent, change, change, parent, each in a
process of its own, and compare within the call.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory, at 700 W

#: name -> (n, d, k, share of zero weights, or None for uniform weights)
SHAPES = {
    "main": (1_000_000, 100, 10, 0.0),
    "ragged-n": (100_003, 100, 10, 0.0),
    "zero-weights": (200_000, 100, 10, 0.3),
    "wide-k": (50_000, 100, 300, 0.0),
    "odd-d": (10_007, 7, 5, 0.0),
    "weighted": (100_003, 100, 10, None),
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
    return time_ms(graph.replay, batches=5, per_batch=5, warmup=1) / reps


def inputs(g, n, d, k, zero_share):
    """(x, v, centroids) on the card, from the generator g."""
    x = torch.rand((n, d), generator=g, device="cuda")
    c = torch.rand((k, d), generator=g, device="cuda")
    u = torch.rand(n, generator=g, device="cuda")
    v = u if zero_share is None else (u >= zero_share).float()
    return x, v, c


def compare(files) -> int:
    """0 when every tensor of every file equals the first file's, byte for
    byte; prints one line per shape and file."""
    first = torch.load(files[0])
    bad = 0
    for other_file in files[1:]:
        other = torch.load(other_file)
        for shape, tensors in first.items():
            same = {name: t.shape == other[shape][name].shape and bool(
                        (t.view(torch.uint8) == other[shape][name]
                         .view(torch.uint8)).all())
                    for name, t in tensors.items()}
            bad += not all(same.values())
            print(f"{other_file} {shape}: "
                  + ", ".join(f"{name} {'same bytes' if ok else 'DIFFER'}"
                              for name, ok in same.items()))
    return 1 if bad else 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", help="root of the repository tree to import")
    parser.add_argument("--out", help="also append the JSON line to FILE")
    parser.add_argument("--save", help="write the outputs to FILE")
    parser.add_argument("--compare", nargs="+", metavar="FILE",
                        help="compare saved outputs byte for byte")
    args = parser.parse_args()
    if args.compare:
        return compare(args.compare)
    if not args.tree:
        parser.error("--tree or --compare is required")
    if not torch.cuda.is_available():
        print("port_lloyd_ab: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from flink_ml_tpu_torch.ops import kernels as K
    assert Path(K.__file__).resolve().is_relative_to(tree), K.__file__

    for text in K.build_kernels().values():  # ptxas' report, to stderr
        for report in text.splitlines():
            if "registers" in report or "spill" in report:
                print("ptxas:", report.strip(), file=sys.stderr)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(7)
    results, saved = {}, {}
    for name, (n, d, k, zero_share) in SHAPES.items():
        x, v, c = inputs(g, n, d, k, zero_share)
        partials = K._launch_lloyd_partials(x, v, c)
        sums = K.lloyd_partial_sums(x, v, c)
        labels = K.assign_nearest(x, c)
        assert torch.equal(partials, K._launch_lloyd_partials(x, v, c)), (
            f"{name}: stage-1 rerun not bit-identical")
        saved[name] = {"stage1": partials.cpu(), "sums": sums.cpu(),
                       "labels": labels.cpu()}
        results[name] = {
            "n": n, "d": d, "k": k, "blocks": partials.shape[0],
            "stage1_ms": time_ms(lambda: K._launch_lloyd_partials(x, v, c)),
            "stage1_device_ms": graph_ms(
                lambda: K._launch_lloyd_partials(x, v, c)),
            "lloyd_ms": time_ms(lambda: K.lloyd_partial_sums(x, v, c)),
            "lloyd_device_ms": graph_ms(lambda: K.lloyd_partial_sums(x, v, c)),
            "assign_ms": time_ms(lambda: K.assign_nearest(x, c)),
            "assign_device_ms": graph_ms(lambda: K.assign_nearest(x, c)),
            "bound_ms": 4 * (n * d + n + k * d + k) / PEAK_BYTES_PER_S * 1e3}
        del x, v, c, partials
    line = json.dumps({"tree": str(args.tree), "card": card,
                       "shapes": results})
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    if args.save:
        Path(args.save).parent.mkdir(parents=True, exist_ok=True)
        torch.save(saved, args.save)
    return 0


if __name__ == "__main__":
    sys.exit(main())
