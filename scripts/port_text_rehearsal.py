#!/usr/bin/env python3
"""Rehearse phase 16 of ``chip_smoke.py`` on the CPU.

Runs the phase's logic with the port on the CPU (plain PyTorch, no launch
counts), to find faults before a chip call. Its times are the CPU's, never a
device metric.

    python3 scripts/port_text_rehearsal.py                  # whole phase, cut
    python3 scripts/port_text_rehearsal.py --part b --rows 10000000

``--part all`` cuts every config's ``numValues`` (numeric tables stay at 8 MiB
or more, so the generators still give tensor columns) and runs the phase
with the accuracy bar off (it holds only at full size). ``--part b`` runs
the HashingTF → IDF → FTRL stream alone on ``--rows`` rows of the
``hashingtf`` config, with the phase's accuracy bar when ``--rows`` is the
config's own.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402
from flink_ml_tpu_torch import Table  # noqa: E402
from flink_ml_tpu_torch.benchmark import runner  # noqa: E402
from flink_ml_tpu_torch.ops import kernels as K  # noqa: E402

#: rows of each generator in the cut rehearsal
CUT_ROWS = {"DoubleGenerator": 2_200_000, "RandomStringArrayGenerator": 300_000,
            "RandomStringGenerator": 500_000, "DenseVectorGenerator": 250_000}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--part", choices=("all", "b"), default="all")
    parser.add_argument("--rows", type=int, default=None,
                        help="rows of the hashingtf config for --part b")
    args = parser.parse_args(argv)
    real = runner.load_config

    def load(path):
        config = real(path)
        if "demo" in path:
            return config
        for spec in config.values():
            gen = spec["inputData"]["className"].rsplit(".", 1)[-1]
            params = spec["inputData"]["paramMap"]
            if args.part == "b" and args.rows:
                params["numValues"] = args.rows
            elif args.part == "all" and gen in CUT_ROWS:
                params["numValues"] = min(params["numValues"], CUT_ROWS[gen])
        return config

    runner.load_config = load
    if args.part == "all":
        c.TEXT_ACCURACY = 0.0
        c.phase_text(K, runner, Table, device="cpu")
        return 0
    ((_, spec),) = real(str(c.CONFIGS / "hashingtf-benchmark.json")).items()
    if args.rows and args.rows != spec["inputData"]["paramMap"]["numValues"]:
        c.TEXT_ACCURACY = 0.0
    c._hashed_stream(K, runner, Table, "cpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
