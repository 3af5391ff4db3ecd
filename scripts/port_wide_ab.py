#!/usr/bin/env python3
"""KNN's lists past 256 and the tiled KMeans labels at embedding widths,
timed for one tree of the repository, so that two trees can be held
against each other on one card in one call, and their outputs compared
byte for byte.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/port_wide_ab.py --tree DIR [--out FILE] [--save FILE]
    python3 scripts/port_wide_ab.py --compare FILE FILE [FILE ...]

Imports ``flink_ml_tpu_torch`` from DIR (the repository itself, or a
``git archive`` of another commit unpacked somewhere), builds its kernels
and prints one JSON line: the tree, the card's name and power limit, and,
from one seed (so every tree gets the same inputs):

- ``knn``: ``knn_topk_indices`` at k = 300 on the 16,384 x 50,000 x 32
  block of ``chip_smoke.py`` phase 6, eager time (CUDA events around
  back-to-back calls) and device time (calls captured in a CUDA graph and
  replayed), ``torch.topk(torch.addmm(...))`` beside it, and the operation
  bound; on a tree whose plan takes the first wide design there, also that
  instance at k = 1 (``wide_k1_ms``: its distance loop with a one-entry
  list, so the difference is the cost of its list insertions);
- ``labels``: ``assign_nearest`` and ``lloyd_partial_sums`` at 1,000,000 x
  768, k = 64 (the tiled route), with ``addmm`` + ``argmin`` and the
  operation bound.

``--save`` writes the outputs (the KNN lists of the block's first 4,096
rows, the labels at 768 x 64, and the main path's Lloyd sums and labels at
1,000,000 x 100, k = 10, which take the fused route) to FILE
(``torch.save``); ``--compare`` needs no card and exits 1 unless every
tensor of the files is the same, byte for byte, as the first file's. Run it
for parent, change, change, parent, each in a process of its own, and
compare within the call.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

PEAK_FP32_PER_S = 67e12  # H100 SXM, fp32 outside the tensor cores, 700 W
KNN_SHAPE, KNN_K = (16_384, 50_000, 32), 300
LABEL_SHAPE = (1_000_000, 768, 64)
MAIN_SHAPE = (1_000_000, 100, 10)
KNN_SAVED_ROWS = 4_096


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


def graph_ms(fn, reps, batches):
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
    return time_ms(graph.replay, batches=batches, per_batch=1,
                   warmup=1) / reps


def timed(fn):
    """(eager ms, device ms) of fn, with fewer calls where one takes over
    50 ms."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if (time.perf_counter() - start) * 1e3 < 50:
        return time_ms(fn), graph_ms(fn, reps=5, batches=5)
    return (time_ms(fn, batches=2, per_batch=1, warmup=0),
            graph_ms(fn, reps=1, batches=2))


def compare(files) -> int:
    """0 when every tensor of every file equals the first file's, byte for
    byte; prints one line per file."""
    first = torch.load(files[0])
    bad = 0
    for other_file in files[1:]:
        other = torch.load(other_file)
        same = {name: t.shape == other[name].shape and bool(
                    (t.view(torch.uint8) == other[name].view(torch.uint8))
                    .all())
                for name, t in first.items()}
        bad += not all(same.values())
        print(f"{other_file}: " + ", ".join(
            f"{name} {'same bytes' if ok else 'DIFFER'}"
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
        print("port_wide_ab: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from flink_ml_tpu_torch.ops import kernels as K
    assert Path(K.__file__).resolve().is_relative_to(tree), K.__file__

    K.build_kernels()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(25)
    saved, result = {}, {"tree": str(args.tree), "card": card}

    n, nt, d = KNN_SHAPE
    x = torch.rand((n, d), generator=g, device="cuda")
    train = torch.rand((nt, d), generator=g, device="cuda")
    tsq = torch.sum(train * train, dim=1)
    plan = K._knn_card_plan(x, nt, KNN_K)
    lists = K.knn_topk_indices(x, train, KNN_K)
    saved["knn_lists"] = lists[:KNN_SAVED_ROWS].cpu()
    ms, device_ms = timed(lambda: K.knn_topk_indices(x, train, KNN_K))
    lib_ms, lib_device_ms = timed(lambda: torch.topk(
        torch.addmm(tsq, x, train.T, alpha=-2), KNN_K, largest=False))
    knn = {"shape": [n, nt, d], "k": KNN_K, "route": plan.route,
           "ms": ms, "device_ms": device_ms, "library_ms": lib_ms,
           "library_device_ms": lib_device_ms,
           "bound_ms": 2 * n * nt * d / PEAK_FP32_PER_S * 1e3}
    if plan.route == "wide":
        knn["wide_k1_ms"] = time_ms(
            lambda: K._launch_knn(x, train, 1, wide=True), batches=2,
            per_batch=1, warmup=1)
    result["knn"] = knn
    print("knn:", json.dumps(knn), flush=True)
    del x, train, tsq, lists
    torch.cuda.empty_cache()

    n, d, k = LABEL_SHAPE
    x = torch.rand((n, d), generator=g, device="cuda")
    c = torch.rand((k, d), generator=g, device="cuda")
    v = torch.ones(n, device="cuda")
    csq = torch.sum(c * c, dim=1)
    saved["labels_768_64"] = K.assign_nearest(x, c).cpu()
    a_ms, a_device_ms = timed(lambda: K.assign_nearest(x, c))
    l_ms, l_device_ms = timed(lambda: K.lloyd_partial_sums(x, v, c))
    lib_ms, lib_device_ms = timed(
        lambda: torch.addmm(csq, x, c.T, alpha=-2).argmin(1))
    labels = {"shape": [n, d, k], "plan": K.kmeans_plan(n, k, d, False)._asdict(),
              "assign_ms": a_ms, "assign_device_ms": a_device_ms,
              "lloyd_ms": l_ms, "lloyd_device_ms": l_device_ms,
              "library_ms": lib_ms, "library_device_ms": lib_device_ms,
              "bound_ms": 2 * n * k * d / PEAK_FP32_PER_S * 1e3}
    result["labels"] = labels
    print("labels:", json.dumps(labels), flush=True)
    del x, c, v, csq
    torch.cuda.empty_cache()

    n, d, k = MAIN_SHAPE
    x = torch.rand((n, d), generator=g, device="cuda")
    c = torch.rand((k, d), generator=g, device="cuda")
    v = torch.ones(n, device="cuda")
    saved["main_lloyd"] = K.lloyd_partial_sums(x, v, c).cpu()
    saved["main_labels"] = K.assign_nearest(x, c).cpu()
    del x, c, v

    line = json.dumps(result)
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
