"""flink_ml_tpu_torch — the PyTorch/CUDA port of flink_ml_tpu.

A second package beside the JAX one, ported slice by slice and held against
it by parity tests. Its entry points run on the CUDA card unless the caller
passes ``device="cpu"``; the Pallas kernels of the JAX package become CUDA
C++ kernels for Hopper, built from ``csrc/`` at first use. This slice holds
KMeans (fit, transform, save/load) and the benchmark runner for it.
"""

from flink_ml_tpu_torch.common.table import Table  # noqa: F401

__version__ = "0.1.0"
