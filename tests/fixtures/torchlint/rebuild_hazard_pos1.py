"""torchlint fixture: POSITIVE for rebuild-hazard.

A kernel library built and loaded inside the loop body, and a ctypes load
per item: nvcc/dlopen every iteration.
"""
import ctypes

from flink_ml_tpu_torch.ops import _build


def run(sources, xs):
    out = []
    for name in sources:
        lib = _build.load(name)  # a build/load per iteration
        out.append(lib)
    for path in xs:
        out.append(ctypes.CDLL(path))  # a dlopen per iteration
    return out
