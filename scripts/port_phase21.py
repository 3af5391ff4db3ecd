#!/usr/bin/env python3
"""Phase 21 of ``chip_smoke.py`` alone on the card: build the kernels, print
the card's name and power limit, then run the meshes over processes (the
LR config's tensor-parallel fits and sequence attention over gloo ranks
that share the card) with its gates:

    python3 scripts/port_phase21.py
"""

import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("port_phase21: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from flink_ml_tpu_torch.benchmark import runner
    from flink_ml_tpu_torch.ops import kernels as K

    chip_smoke.phase_build(K)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    chip_smoke.log("card:", card)
    counts = chip_smoke.phase_meshes_over_processes(K, runner, card)
    print({k: v for k, v in counts.items() if v}, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
