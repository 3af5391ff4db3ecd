"""torchlint fixture: POSITIVE for capture-leak (never imported, only parsed).

A Python branch on an input of a torch.compile'd step, and a host cast of
a value derived from an input of a function wrapped at the call site.
"""
import torch


@torch.compile
def step(x, lr):
    if x.sum() > 0:  # branch taken once, at compile
        return x * lr
    return x


def outer(x):
    def inner(v):
        s = v + 1.0
        return float(s)  # host read of a captured derivation

    return torch.compile(inner)(x)
