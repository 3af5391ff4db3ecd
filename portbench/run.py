"""The benchmark of the PyTorch/CUDA port, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the numbers compared by the check
beside their limits as the last lines of standard error, and one JSON
object as the last line of standard output. Exits with another code than
0, and prints no result, without a CUDA card, when a JAX module was
loaded, or outside a checkout that holds the port.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", "out", "cache")
# kernel and build caches at fixed paths inside the checkout (the port's
# own CUDA builds go to flink_ml_tpu_torch/_build/)
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
# the port's default configuration: no trace dir, no health or drift
# telemetry, no mesh settings from the caller's environment
for _name in [n for n in os.environ if n.startswith("FLINK_ML_TPU_")]:
    del os.environ[_name]
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    import torch

    torch.set_num_threads(1)
    from portbench.harness import bench

    sys.exit(bench.main(sys.argv[1:], T0))
