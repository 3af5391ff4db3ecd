"""torchlint fixture: POSITIVE for rebuild-hazard.

A new CUDA graph captured, a torch.compile wrap and a new stream inside
loop bodies: each is paid every iteration.
"""
import torch


def replay_each(fn, batches):
    for x in batches:
        graph = torch.cuda.CUDAGraph()  # a capture per batch
        with torch.cuda.graph(graph):
            fn(x)
        graph.replay()


def compile_each(fn, batches):
    out = []
    while batches:
        out.append(torch.compile(fn)(batches.pop()))  # fresh compile cache
    return out


def side_streams(fn, batches):
    for x in batches:
        s = torch.cuda.Stream()  # a new stream per batch
        with torch.cuda.stream(s):
            fn(x)
