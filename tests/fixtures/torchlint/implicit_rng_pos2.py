"""torchlint fixture: POSITIVE for implicit-rng.

numpy's legacy global RandomState, and reseeding the process-wide state
for every other user in the process.
"""
import numpy as np
import torch


def sample(n):
    np.random.seed(0)  # reseeds numpy's global state
    torch.manual_seed(0)  # reseeds torch's global generator
    idx = np.random.permutation(n)  # module-level draw
    vals = np.random.rand(n)
    return idx, vals
