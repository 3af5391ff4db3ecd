"""One KMeans fit: ``maxIter`` Lloyd rounds over every row, each the
partial sums of ``n`` rows against ``k`` centroids (the second stage's
partials are the kernel's own and are not counted)."""

from __future__ import annotations

from portbench.cost import launch_cost


def fit_cost(params: dict, n: int, d: int):
    """``(bytes, operations)`` of one fit of ``n`` rows of ``d`` columns."""
    nbytes, ops = launch_cost("lloyd_partial_sums", n=n, k=params["k"], d=d)
    return params["maxIter"] * nbytes, params["maxIter"] * ops
