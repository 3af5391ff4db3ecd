"""flink_ml_tpu_torch — the PyTorch/CUDA port of flink_ml_tpu.

A second package beside the JAX one, ported slice by slice and held against
it by parity tests. Its entry points run on the CUDA card unless the caller
passes ``device="cpu"``; the Pallas kernels of the JAX package become CUDA
C++ kernels for Hopper, built from ``csrc/`` at first use (the host C++ of
``csrc/host/`` with ``g++``). Every module of the JAX package has a twin:

  params, linalg, common — typed params, vectors and BLAS, the columnar
              Table, the host pool, windows and datasets
  api       — Stage/Estimator/Transformer/Model, Pipeline, Graph
  ops       — losses, the SGD and FTRL optimizers, the feature kernels,
              and the kernel wrappers (``ops/kernels.py``)
  parallel  — meshes of any axes in one process or over
              ``torch.distributed`` ranks, collectives, tensor-parallel SGD,
              sequence attention, the launcher and elastic fits
  iteration — bounded and unbounded iteration with checkpoints
  models    — the algorithm library
  servable, serving — engine-free inference and the serving runtime
  observability, resilience — tracing, metrics, health, the ops loop,
              supervised restarts and fault injection
  benchmark — the JSON-config benchmark runner and its plots
  analysis  — torchlint, the static analyzer of the port's contracts
"""

__version__ = "0.1.0"

from flink_ml_tpu_torch.api import (  # noqa: F401
    AlgoOperator,
    Estimator,
    Model,
    Stage,
    Transformer,
)
from flink_ml_tpu_torch.common.table import Table  # noqa: F401
from flink_ml_tpu_torch.common.functions import (  # noqa: F401
    array_to_vector,
    vector_to_array,
)
