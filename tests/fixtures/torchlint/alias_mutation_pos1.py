"""torchlint fixture: POSITIVE for alias-mutation.

Writing through a column of a unit-step take batch: the write lands in the
source table's storage.
"""


def corrupt_batch(table):
    batch = table.take(slice(0, 1024))
    batch["x"][0] = 0.0  # aliases the source table
    return batch


def normalize_head(table):
    view = table.head(32)
    col = view.column("f")
    col[:] -= col.mean()  # augmented write into a view column
    return view
