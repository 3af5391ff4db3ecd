#!/usr/bin/env python3
"""Rehearse phase 17 of ``chip_smoke.py`` on the CPU.

Runs the phase's logic (OnlineKMeans, OnlineStandardScaler, the CSR-fed
linear fits, AgglomerativeClustering and Swing) with the port on the CPU
(plain PyTorch, no launch counts), to find faults before a chip call. Its
times are the CPU's, never a device metric.

    python3 scripts/port_stream_rehearsal.py            # cut tables, ~30 s
    python3 scripts/port_stream_rehearsal.py --full     # the configs' own rows

The cut rehearsal runs the KMeans config on 100,000 rows (ten batches, the
float64 replay's count), the LR config on 500,000 (five windows) and the
hashingtf config on 500,000; each stays a tensor table (8 MiB or more).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402
from flink_ml_tpu_torch import Table  # noqa: E402
from flink_ml_tpu_torch.benchmark import runner  # noqa: E402
from flink_ml_tpu_torch.ops import kernels as K  # noqa: E402

#: rows of each config in the cut rehearsal
CUT_ROWS = {"KMeans": 100_000, "logisticregression": 500_000,
            "hashingtf": 500_000}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--full", action="store_true",
                        help="run the configs at their own size")
    args = parser.parse_args(argv)
    real = runner.load_config

    def load(path):
        config = real(path)
        for name, spec in config.items():
            if not args.full and name in CUT_ROWS:
                spec["inputData"]["paramMap"]["numValues"] = CUT_ROWS[name]
        return config

    runner.load_config = load
    c.phase_online(K, runner, Table, device="cpu")
    c.phase_sparse_linear(K, runner, Table, device="cpu")
    c.phase_host_algorithms(K, runner, Table, device="cpu")
    return 0


if __name__ == "__main__":
    sys.exit(main())
