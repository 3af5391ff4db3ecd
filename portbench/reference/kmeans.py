"""Lloyd's algorithm in float64, and the comparison of the KMeans cells.

A round assigns each row to its nearest centroid (the first of equal
distances), and each new centroid is the mean of its rows; an empty
cluster keeps its centroid; the counts are the model's weights. The init is
k distinct rows drawn by ``numpy.random.default_rng(seed).choice``.

Whole fits part from a float64 fit at their first tie flip (a row whose two
nearest centroids are equal to rounding), and from there on both are valid
Lloyd trajectories that differ; a lower precision parts sooner but ends as
far off. So the comparison follows the program round by round from its own
state: round r runs once in float64 from the program's centroids after
r - 1 rounds (after 0 rounds: the init rows, drawn here) and is held
against the program's centroids after r rounds. The state after r <
maxIter rounds is the output of a fit of r rounds of the same estimator on
the same table; after maxIter rounds, every fit of the window.

Numbers: ``step_gap``, the largest gap of any round between the
program's and the reference's cluster sums (count times centroid, each
coordinate) over the rows of an average cluster, n / k: a row that flips
between two tied centroids moves a sum by at most 1 whatever the cluster's
size, where it moves a small cluster's mean by 1 / its count;
``count_sum_gap``, the largest |sum of the weights - rows| of any output
(exact: every row is in one cluster). Readings: ``mean_gap``, the largest
centroid coordinate gap of any round, and ``step_count_gap``, the largest
count gap of any round.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import to_tf32


def init_indices(n: int, k: int, seed: int) -> np.ndarray:
    """The k distinct rows the fit starts from (fewer rows than k repeat)."""
    idx = np.random.default_rng(seed).choice(n, size=min(k, n),
                                             replace=False)
    return np.resize(idx, k) if len(idx) < k else idx


def lloyd_round(x: torch.Tensor, centroids: torch.Tensor,
                precision: str = "float64", block_rows: int = 1 << 17):
    """One round from ``centroids`` over the float32 rows ``x`` → (new
    centroids, counts), float64 (k, d) and (k,). ``precision`` "float64"
    computes in doubles; "tf32" in float32 on TF32-rounded operands (the
    control)."""
    k, d = centroids.shape
    if precision == "float64":
        dt = torch.float64
        c = centroids.to(x.device, dt)
    elif precision == "tf32":
        dt = torch.float32
        c = to_tf32(centroids.to(x.device))
    else:
        raise ValueError(f"unknown precision {precision!r}")
    norms = (c * c).sum(1)
    sums = torch.zeros(k, d, dtype=dt, device=x.device)
    counts = torch.zeros(k, dtype=dt, device=x.device)
    for start in range(0, x.shape[0], block_rows):
        xb = x[start:start + block_rows]
        xb = xb.to(dt) if precision == "float64" else to_tf32(xb)
        labels = torch.argmin(norms[None, :] - 2.0 * (xb @ c.T), dim=1)
        sums.index_add_(0, labels, xb)
        counts += torch.bincount(labels, minlength=k).to(dt)
    new = torch.where(counts[:, None] > 0,
                      sums / torch.clamp_min(counts[:, None], 1), c)
    return new.double(), counts.double()


def judge(run):
    """The cell's numbers (see the module's docstring) and the window's
    answers that failed → (numbers, failed)."""
    p = run.params
    x = run.inputs[p.get("featuresCol", "features")]
    n, k, rounds = x.shape[0], p["k"], p["maxIter"]
    state = x[torch.as_tensor(init_indices(n, k, p["seed"]),
                              device=x.device)].double()
    limits = run.limits
    gaps = {"step_gap": 0.0, "count_sum_gap": 0.0, "mean_gap": 0.0,
            "step_count_gap": 0.0}
    failed = 0
    for r in range(1, rounds + 1):
        ref_c, ref_n = lloyd_round(x, state)
        ref_c, ref_n = ref_c.cpu().numpy(), ref_n.cpu().numpy()
        ref_sums = ref_c * ref_n[:, None]
        outs = run.answers if r == rounds else [run.call(maxIter=r)]
        for out in outs:
            c, counts = out["centroid"], out["weight"]
            one = {"step_gap": float(np.abs(c * counts[:, None] - ref_sums)
                                     .max()) * k / n,
                   "count_sum_gap": float(abs(counts.sum() - n)),
                   "mean_gap": float(np.abs(c - ref_c).max()),
                   "step_count_gap": float(np.abs(counts - ref_n).max())}
            for name, value in one.items():
                gaps[name] = max(gaps[name], value)
            if r == rounds and not all(one[name] <= limit
                                       for name, limit in limits.items()):
                failed += 1
        state = torch.as_tensor(outs[-1]["centroid"], device=x.device)
    return gaps, failed


def control_fit(inputs: dict, params: dict) -> dict:
    """The control: this reference in the program's place, every round in
    TF32 (the next precision below float32) from the same init."""
    x = inputs[params.get("featuresCol", "features")]
    c = x[torch.as_tensor(init_indices(x.shape[0], params["k"],
                                       params["seed"]), device=x.device)]
    counts = torch.zeros(params["k"], dtype=torch.float64)
    for _ in range(params["maxIter"]):
        c, counts = lloyd_round(x, c, precision="tf32")
    return {"centroid": c.cpu().numpy(), "weight": counts.cpu().numpy()}
