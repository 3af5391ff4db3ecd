"""Binary logistic regression by SGD in float64, and the comparison of the
LogisticRegression cells (Flink ML's SGD with BinaryLogisticLoss).

From zero coefficients, each round takes the window of
``lb = min(globalBatchSize, n)`` rows from its offset (cut at the last row;
the offset wraps to 0 once a window reaches it), with labels y in {0, 1} as
s = 2y - 1 and weights w (the weight column, or ones):

- margins m = s * (x . coeffs); loss = sum w * log(1 + exp(-m));
  gradient = sum w * (-s / (exp(m) + 1)) * x;
- coeffs -= learningRate / sum(w) * gradient (no change where sum(w) = 0);
- the fit stops after the round whose mean loss falls below ``tol``, or
  after ``maxIter`` rounds.

A whole fit's coefficients part from a float64 fit by the program's own
rounding, compounded over the rounds, so the comparison follows the
program round by round from its own state: round r runs once in float64 from the program's coefficients
after r - 1 rounds (after 0 rounds: zeros) and is held against the
program's coefficients after r rounds, relative to the round's own step.
The state after r < maxIter rounds is the output of a fit of r rounds of
the same estimator on the same table, after the window; after maxIter
rounds, every fit of the window that the run kept. Round 1 starts from zero
margins, so it checks the gradient's sum alone; from round 2 on the margins
are the dots of the program's coefficients, so the dots are checked too.

Numbers: ``step_gap``, the largest ||coeffs_r - round(coeffs_{r-1})|| /
||round(coeffs_{r-1}) - coeffs_{r-1}|| (two-norms) of any round and any
answer (compared; a window's fit above the limit, or not finite, counts as
failed). Readings: ``first_step_gap``, round 1's; ``late_step_gap``, the
largest of rounds 2 and later; ``coef_gap``, the largest ||coeffs - fit||
/ ||fit|| of the window's fits against this module's own whole fit.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import to_tf32


def _columns(inputs: dict, params: dict):
    x = inputs[params.get("featuresCol", "features")]
    y = inputs[params.get("labelCol", "label")]
    weight_col = params.get("weightCol")
    w = (inputs[weight_col] if weight_col
         else torch.ones(x.shape[0], device=x.device))
    return x, y, w


def sgd_round(x, y, w, coeffs: torch.Tensor, offset: int, params: dict,
              precision: str = "float64", block_rows: int = 1024):
    """One round from ``coeffs`` at window ``offset`` → (new coeffs, mean
    loss, next offset). ``precision`` "float64" computes in doubles, a
    block of rows at a time; "tf32" in float32 on TF32-rounded operands
    (the control)."""
    if params.get("reg", 0.0) != 0.0:
        raise NotImplementedError("the reference fits reg = 0 only")
    n, d = x.shape
    dt = torch.float64 if precision == "float64" else torch.float32
    coeffs = coeffs.to(x.device, dt)
    lb = min(params["globalBatchSize"], n)
    end = min(offset + lb, n)
    grad = torch.zeros(d, dtype=dt, device=x.device)
    loss = torch.zeros((), dtype=dt, device=x.device)
    total_w = w[offset:end].to(dt).sum()
    c = coeffs if precision == "float64" else to_tf32(coeffs)
    for start in range(offset, end, block_rows):
        stop = min(start + block_rows, end)
        xb = x[start:stop]
        xb = xb.to(dt) if precision == "float64" else to_tf32(xb)
        s = 2.0 * y[start:stop].to(dt) - 1.0
        wb = w[start:stop].to(dt)
        m = s * (xb @ c)
        loss += (wb * torch.nn.functional.softplus(-m)).sum()
        mult = wb * (-s / (torch.exp(m) + 1.0))
        if precision != "float64":
            mult = to_tf32(mult)
        grad += xb.T @ mult
    if total_w > 0:
        coeffs = coeffs - (params["learningRate"] / total_w) * grad
    mean_loss = float(loss / total_w) if total_w > 0 else float("inf")
    return coeffs, mean_loss, 0 if offset + lb >= n else offset + lb


def fit(x, y, w, params: dict, precision: str = "float64",
        block_rows: int = 1024) -> np.ndarray:
    """The fitted (d,) coefficients, float64 on the host."""
    coeffs = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    offset = 0
    for _ in range(params["maxIter"]):
        coeffs, loss, offset = sgd_round(x, y, w, coeffs, offset, params,
                                         precision, block_rows)
        if loss < params["tol"]:
            break
    return coeffs.double().cpu().numpy()


def judge(run):
    """The cell's numbers (see the module's docstring) and the window's
    answers that failed → (numbers, failed)."""
    p = run.params
    x, y, w = _columns(run.inputs, p)
    rounds = p["maxIter"]
    limit = run.limits.get("step_gap", float("inf"))
    state = np.zeros(x.shape[1])
    offset, gaps, failed = 0, [], 0
    for r in range(1, rounds + 1):
        ref, _, offset = sgd_round(x, y, w, torch.as_tensor(state), offset,
                                   p)
        ref = ref.cpu().numpy()
        step = float(np.linalg.norm(ref - state))
        outs = run.answers if r == rounds else [run.call(maxIter=r)]
        gap = 0.0
        for out in outs:
            one = float(np.linalg.norm(out["coefficient"].ravel() - ref)) \
                / step
            one = one if np.isfinite(one) else float("inf")
            gap = max(gap, one)
            if r == rounds and not one <= limit:
                failed += 1
        gaps.append(gap)
        state = outs[-1]["coefficient"].ravel()
    whole = fit(x, y, w, p)
    scale = float(np.linalg.norm(whole))
    coef_gap = max(float(np.linalg.norm(a["coefficient"].ravel() - whole))
                   / scale for a in run.answers)
    return ({"step_gap": max(gaps), "first_step_gap": gaps[0],
             "late_step_gap": max(gaps[1:], default=0.0),
             "coef_gap": coef_gap, "step_gaps": gaps}, failed)


def control_fit(inputs: dict, params: dict) -> dict:
    """The control: this reference in the program's place, in TF32 (the
    next precision below float32)."""
    x, y, w = _columns(inputs, params)
    return {"coefficient": fit(x, y, w, params, precision="tf32")[None, :]}
