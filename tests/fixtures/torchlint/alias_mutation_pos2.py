"""torchlint fixture: POSITIVE for alias-mutation.

torch's own in-place spellings through view columns: an `_`-suffixed
method, one on a column expression, and an out= aimed at a view column.
"""
import torch


def shift(table, delta):
    batch = table.head(256)
    col = batch.column("features")
    col.add_(delta)  # in place on the source's storage
    batch["label"].fill_(0.0)  # directly on a column of the view
    torch.mul(col, 2.0, out=col)  # out= into the view
    return batch
