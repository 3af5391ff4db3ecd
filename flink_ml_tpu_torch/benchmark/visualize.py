"""Benchmark results visualization.

The port of ``flink_ml_tpu/benchmark/visualize.py`` (ref parity:
flink-ml-dist/src/main/flink-ml-bin/bin/benchmark-results-visualize.py):
reads one or more benchmark results JSON files — the output of
``flink_ml_tpu_torch.benchmark.runner``, which has the JAX runner's schema,
so either package's files can be drawn side by side — and renders a bar
chart of one metric per benchmark, one bar group per results file.

``matplotlib`` is optional (the ``viz`` extra) and imported only when a
chart is drawn; without it :func:`plot` raises an ``ImportError`` that
names it, before any file is written.

Usage:
    python -m flink_ml_tpu_torch.benchmark.visualize r1.json [r2.json ...] \\
        --metric inputThroughput --output-file chart.png
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

VALID_METRICS = ("inputThroughput", "outputThroughput", "totalTimeMs",
                 "inputRecordNum", "outputRecordNum",
                 # roofline provenance (runner.py): bytes the stage had to
                 # read at least once, and the resulting lower bound on
                 # achieved bandwidth over executeTime
                 "inputBytes", "achievedGBps")


def load_results(path: str) -> Dict[str, dict]:
    """name -> metric dict for every benchmark that produced results."""
    with open(path) as f:
        data = json.load(f)
    out = {}
    for name, entry in data.items():
        if isinstance(entry, dict) and "results" in entry:
            out[name] = entry["results"]
    return out


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "drawing benchmark charts needs matplotlib, which is not "
            "installed: install it, or the package's 'viz' extra "
            "(pip install 'flink-ml-tpu[viz]')") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot(files: List[str], metric: str, output_file: str,
         title: str = None) -> str:
    plt = _pyplot()
    labels = [os.path.basename(p) for p in files]
    if len(set(labels)) != len(labels):  # before/r.json vs after/r.json
        labels = files
    per_file = {lbl: load_results(p) for lbl, p in zip(labels, files)}
    names = sorted({n for r in per_file.values() for n in r})
    if not names:
        raise ValueError("no benchmark results found in input files")

    fig, ax = plt.subplots(figsize=(max(6, 1.2 * len(names)), 4.5))
    width = 0.8 / len(per_file)
    for i, (label, results) in enumerate(per_file.items()):
        xs = [j + i * width for j in range(len(names))]
        ys = [results.get(n, {}).get(metric, 0.0) for n in names]
        ax.bar(xs, ys, width=width, label=label)
    ax.set_xticks([j + 0.4 - width / 2 for j in range(len(names))])
    ax.set_xticklabels(names, rotation=30, ha="right")
    ax.set_ylabel(metric)
    ax.set_title(title or f"benchmark {metric}")
    if len(per_file) > 1:
        ax.legend()
    fig.tight_layout()
    fig.savefig(output_file, dpi=120)
    plt.close(fig)
    return output_file


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="flink-ml-tpu-torch-benchmark-visualize")
    parser.add_argument("results", nargs="+",
                        help="benchmark results JSON file(s)")
    parser.add_argument("--metric", default="inputThroughput",
                        choices=VALID_METRICS)
    parser.add_argument("--output-file", default="benchmark-results.png")
    parser.add_argument("--title", default=None)
    args = parser.parse_args(argv)
    path = plot(args.results, args.metric, args.output_file, args.title)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
