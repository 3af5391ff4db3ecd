"""One LogisticRegression fit: ``maxIter`` SGD rounds, each the terms of one
window of ``min(globalBatchSize, n)`` rows. The cells' labels do not follow
the features, so the mean loss stays near log 2 and no fit stops at
``tol``."""

from __future__ import annotations

from portbench.cost import launch_cost


def fit_cost(params: dict, n: int, d: int):
    """``(bytes, operations)`` of one fit of ``n`` rows of ``d`` features."""
    lb = min(params["globalBatchSize"], n)
    nbytes, ops = launch_cost("sgd_batch_terms", lb=lb, d=d)
    return params["maxIter"] * nbytes, params["maxIter"] * ops
