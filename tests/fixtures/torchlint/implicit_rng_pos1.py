"""torchlint fixture: POSITIVE for implicit-rng.

torch draws with no generator=: each takes from the process-wide
generator, so the result depends on every draw made before it.
"""
import torch
from torch import randperm


def init(n, d, device):
    w = torch.randn(d, device=device)  # global generator
    order = randperm(n, device=device)  # imported name, same hazard
    noise = torch.empty(n, device=device).normal_()  # in-place draw
    keep = torch.bernoulli(torch.full((n,), 0.5))
    return w, order, noise, keep
