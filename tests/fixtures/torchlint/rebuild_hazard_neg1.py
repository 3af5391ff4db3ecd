"""torchlint fixture: NEGATIVE for rebuild-hazard.

The port's idiom: the library is loaded once behind functools.lru_cache,
the graph is captured once and replayed in the loop, and one side stream
is made before the loop.
"""
import functools

import torch

from flink_ml_tpu_torch.ops import _build


@functools.lru_cache(maxsize=None)
def _lib(name):
    return _build.load(name)


def run(names, fn, x, reps):
    libs = [_lib(n) for n in names]  # cached: a dict lookup per name
    for name in names:
        libs.append(_lib(name))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(x)
    side = torch.cuda.Stream()
    for _ in range(reps):
        with torch.cuda.stream(side):
            graph.replay()
    return libs
