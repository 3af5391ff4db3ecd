"""torchlint fixture: NEGATIVE for alias-mutation.

Clones and copies break the alias chain; torch.take and np.take copy;
rebinding to a computed tensor owns fresh storage.
"""
import numpy as np
import torch


def safe_batch(table):
    batch = table.take(slice(0, 1024))
    col = batch.column("x").clone()  # owned storage
    col[0] = 0.0
    col.add_(1.0)
    host = batch.column("h").copy()
    host[0] = 1.0
    scaled = batch["y"] * 2  # a new tensor
    scaled.mul_(0.5)
    return col, host, scaled


def gathers(arr, t, idx):
    picked = np.take(arr, idx)  # numpy take copies
    picked[0] = 1.0
    rows = torch.take(t, idx)  # torch take copies
    rows.zero_()
    return picked, rows
