"""torchlint fixture: NEGATIVE for implicit-rng.

Every draw names its generator: a seeded torch.Generator (the datagen
idiom) and numpy's default_rng; a seeded Generator object is not the
global state. Nothing may be flagged.
"""
import numpy as np
import torch


def init(n, d, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn(d, device=device, generator=g)
    order = torch.randperm(n, device=device, generator=g)
    noise = torch.empty(n, device=device).normal_(generator=g)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    legacy = np.random.RandomState(seed).rand(n)  # explicit state
    return w, order, noise, idx, legacy
