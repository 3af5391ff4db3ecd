"""torchlint fixture: NEGATIVE for capture-leak.

Branches on static attributes (.ndim, .shape) and on a Python constant,
host reads after the capture block, re.compile (not a capture), and a
plain function that is never captured: none may be flagged.
"""
import re

import torch

PATTERN = re.compile(r"\d+")


@torch.compile
def scale(x, factor: float = 2.0):
    if x.ndim == 2:  # shape attributes are static under capture
        x = x.sum(dim=0)
    n = float(len(x))  # len() is the static leading dim
    return x * factor / n


def replay(fn, x, reps):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        count = 3
        for _ in range(reps):
            out = fn(x)
        if count > 2:  # a Python constant, not a device value
            pass
    graph.replay()
    return out.sum().item()  # after the capture: an ordinary read


def host_helper(x):
    if x.sum() > 0:  # never captured
        return float(x.sum())
    return 0.0
