#!/usr/bin/env python3
"""Phase 22 of ``chip_smoke.py`` alone on the card: build the kernels, print
the card's name and power limit, then run the feature mesh (the
StandardScaler config's column through StandardScaler → Normalizer →
KMeans, and StandardScaler → LogisticRegression on the LR config's table,
with no mesh and split over an 8-shard default mesh) with its gates:

    python3 scripts/port_phase22.py [--rows N]

``--rows`` cuts the configs' rows (a rehearsal; on the CPU pass
``--device cpu``).
"""

import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from flink_ml_tpu_torch.benchmark import runner
    from flink_ml_tpu_torch.ops import kernels as K

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("port_phase22: no CUDA device", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        chip_smoke.phase_build(K)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    else:
        card = args.device
    chip_smoke.log("card:", card)
    counts = chip_smoke.phase_feature_mesh(K, runner, card,
                                           device=args.device,
                                           rows=args.rows)
    print({k: v for k, v in counts.items() if v}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
