"""torchlint fixture: POSITIVE for capture-leak.

Host reads inside a CUDA-graph capture block: `.item()` on what a launch
in the block produced, and a branch on it, are both read once, at capture.
"""
import numpy as np
import torch


def capture(fn, x):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = fn(x)
        n = y.sum().item()  # a sync while the stream captures
        if y.max() > 1.0:  # resolved once, at capture
            y = y / 2
        host = np.asarray(y)  # pulls the captured value to the host
    return graph, n, host


def graphed(model, sample):
    def body(z):
        return z.cpu() + 1  # host copy inside a graphed callable

    return torch.cuda.make_graphed_callables(body, (sample,))
