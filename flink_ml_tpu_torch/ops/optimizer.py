"""SGD: the training loop of the linear models.

The port of the dense, all-device fit of ``flink_ml_tpu/ops/optimizer.py``
(ref: flink-ml-lib/.../common/optimizer/SGD.java:67), with the same
semantics:

- the local batch is ``globalBatchSize`` rows, sliced in order from the data
  with clip-at-end and wrap-to-zero (SGD.java:206-213, 262-284): the window
  of the last round before a wrap is pulled back to end at the last row,
  and the rows it repeats weigh 0;
- per round: the minibatch's ``[Σ grad | Σ w | Σ loss]``, then the update
  rule (sgd, momentum or adam), then regularization (SGD.java:231-243); a
  round whose weights sum to 0 changes neither the coefficients nor the
  moments;
- termination: ``maxIter`` rounds, or the round whose data loss
  ``loss / Σ w`` falls below ``tol``.

The schedule depends only on (n, batch), so it is Python ints, and the fit
is a Python loop of rounds over device tensors: one ``sgd_batch_terms``
call (``ops/kernels.py``) and the shared update tail per round. The tol stop
is a mask, as in the JAX package's unrolled program: rounds after it run and
are discarded by ``torch.where``, so the fit never waits for the device
until it fetches the final coefficients and loss, once. The JAX package's
while program for more than 64 rounds gives the same results by
construction, so this one loop serves every ``maxIter``.

This slice runs one device and dense features: the per-shard batch shares,
the sharded update, tensor parallelism, the segment, host-round and CSR
paths and the health telemetry come with the parallel, iteration and
observability slices of the port, and asking for them raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.device import DeviceLike, resolve_device
from flink_ml_tpu_torch.observability.health import guard_final_state
from flink_ml_tpu_torch.ops import kernels
from flink_ml_tpu_torch.ops.losses import LossFunc
from flink_ml_tpu_torch.ops.regularization import regularize

#: ``batch_terms(xl, yl, wl, coeffs, start, clip, lb, loss_name) -> (d+2,)``
BatchTerms = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SGDParams:
    """Ref: the SGDParams POJO consumed by SGD (SGD.java:67), with the
    stateful update rules of the JAX package (``method``): the reference's
    stateless ``w -= lr/totalW · grad``, heavy-ball ``momentum``, ``adam``."""
    learning_rate: float = 0.1
    global_batch_size: int = 32
    max_iter: int = 20
    tol: float = 1e-6
    reg: float = 0.0
    elastic_net: float = 0.0
    #: update rule: "sgd" (stateless), "momentum", "adam"
    method: str = "sgd"
    momentum: float = 0.9
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8


#: moment vectors each rule carries (adam also carries its step counter)
_OPT_VECTORS = {"sgd": 0, "momentum": 1, "adam": 2}


def _check_method(prm: SGDParams) -> None:
    if prm.method not in _OPT_VECTORS:
        raise ValueError(
            f"SGDParams.method must be one of {sorted(_OPT_VECTORS)}, "
            f"got {prm.method!r}")


def _update_rule(prm: SGDParams):
    """The per-coordinate update rule ``rule(grad_sum, total_w, w, opt) ->
    (w_new, opt_new)``. ``opt`` is the rule's moment state: ``()`` for sgd,
    ``(m,)`` for momentum, ``(m, v, t)`` for adam (t, a 0-dim tensor, is the
    bias-correction step counter). Regularization is applied by the caller
    after the rule (SGD.java:231-243)."""
    _check_method(prm)
    lr = prm.learning_rate
    if prm.method == "sgd":
        def rule(grad, total_w, w, opt):
            return w - (lr / torch.clamp_min(total_w, 1e-30)) * grad, opt
    elif prm.method == "momentum":
        mu = prm.momentum

        def rule(grad, total_w, w, opt):
            g = grad / torch.clamp_min(total_w, 1e-30)
            m = mu * opt[0] + g
            return w - lr * m, (m,)
    else:  # adam
        b1, b2, eps = prm.beta1, prm.beta2, prm.eps

        def rule(grad, total_w, w, opt):
            g = grad / torch.clamp_min(total_w, 1e-30)
            m, v, t = opt
            t = t + 1.0
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * (g * g)
            m_hat = m / (1.0 - b1 ** t)
            v_hat = v / (1.0 - b2 ** t)
            return w - lr * m_hat / (torch.sqrt(v_hat) + eps), (m, v, t)
    return rule


def _init_opt(prm: SGDParams, d: int, device: torch.device) -> tuple:
    """The rule's zero moment state, float32 on ``device``."""
    opt = tuple(torch.zeros(d, dtype=torch.float32, device=device)
                for _ in range(_OPT_VECTORS[prm.method]))
    if prm.method == "adam":
        opt += (torch.zeros((), dtype=torch.float32, device=device),)
    return opt


def _apply_packed(prm: SGDParams, rule, coeffs: torch.Tensor, opt: tuple,
                  packed: torch.Tensor):
    """The update tail of one round, from its packed ``[Σ grad | Σ w |
    Σ loss]``: the update rule, regularization, and no change at all when
    the weights sum to 0 → ``(coeffs, opt, mean_loss)``. The JAX package's
    ``apply_packed`` on one device."""
    grad, total_w, total_loss = packed[:-2], packed[-2], packed[-1]
    # ref updateModel (SGD.java:231-243); skip when no weight
    updated, new_opt = rule(grad, total_w, coeffs, opt)
    updated, _ = regularize(updated, prm.reg, prm.elastic_net,
                            prm.learning_rate)
    has_weight = total_w > 0
    coeffs_out = torch.where(has_weight, updated, coeffs)
    # a zero-weight round must leave the moments untouched too
    opt_out = tuple(torch.where(has_weight, n, o) for n, o in zip(new_opt, opt))
    mean_loss = total_loss / torch.clamp_min(total_w, 1e-30)
    return coeffs_out, opt_out, mean_loss


def _static_batch_schedule(local_n: int, lb: int, max_iter: int):
    """The minibatch schedule as Python ints: round r slices [start,
    start+lb) with clip-at-end and wrap-to-zero (SGD.java:262-284). Returns
    [(start, first_valid)] per round; rows before ``first_valid`` (the clip
    overlap) weigh 0."""
    sched, offset = [], 0
    for _ in range(max_iter):
        start = min(offset, local_n - lb)
        sched.append((start, offset - start))  # 0 unless clipped
        offset = 0 if offset + lb >= local_n else offset + lb
    return sched


def sgd_rounds(batch_terms: BatchTerms, loss_name: str, prm: SGDParams,
               x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               coeffs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Every round of a fit on device tensors, with each round's terms from
    ``batch_terms`` (:func:`kernels.sgd_batch_terms` or its plain version)
    → (coeffs, mean_loss at the stopping round, rounds run), all tensors on
    the device; nothing here waits for the device."""
    n = x.shape[0]
    lb = min(prm.global_batch_size, n)
    rule = _update_rule(prm)
    opt = _init_opt(prm, coeffs.shape[0], coeffs.device)
    mean_loss = torch.full((), float("inf"), dtype=torch.float32,
                           device=coeffs.device)
    epoch = torch.zeros((), dtype=torch.int32, device=coeffs.device)
    stop = torch.zeros((), dtype=torch.bool, device=coeffs.device)
    for start, clip in _static_batch_schedule(n, lb, prm.max_iter):
        packed = batch_terms(x, y, w, coeffs, start, clip, lb, loss_name)
        updated, new_opt, new_loss = _apply_packed(prm, rule, coeffs, opt,
                                                   packed)
        # the tol stop as a mask: a round after it changes nothing
        active = torch.logical_not(stop)
        coeffs = torch.where(active, updated, coeffs)
        opt = tuple(torch.where(active, nw, old)
                    for nw, old in zip(new_opt, opt))
        mean_loss = torch.where(active, new_loss, mean_loss)
        epoch = epoch + active.to(torch.int32)
        stop = torch.logical_or(stop, torch.logical_and(active,
                                                        new_loss < prm.tol))
    return coeffs, mean_loss, epoch


def _on_device(values, device: torch.device) -> torch.Tensor:
    """A contiguous float32 tensor on ``device``: host arrays are placed
    once; a tensor already there is used as it is."""
    return torch.as_tensor(values, dtype=torch.float32,
                           device=device).contiguous()


class SGD:
    """Ref: Optimizer/SGD: optimize(initModel, trainData) → fitted coeffs."""

    def __init__(self, params: SGDParams):
        self.params = params
        self.last_execution_path = None

    def optimize(self, loss_func: LossFunc, init_coeffs,
                 features, labels, weights=None,
                 device: DeviceLike = None,
                 tag: Optional[str] = None) -> Tuple[np.ndarray, float]:
        """Returns (coeffs (d,) float64 np.ndarray, final mean loss float).

        ``features`` (n, d), ``labels`` and ``weights`` (n,) are numpy arrays
        or tensors; tensors already on ``device`` (default: the CUDA card)
        stay there, host arrays are placed once as float32, and
        ``weights=None`` means ones. Rounds run the ``sgd_batch_terms``
        kernel on the card (``cuda-sgd``), and its plain PyTorch version on
        the CPU (``torch-sgd``).
        ``tag`` names the fit in a :class:`NonFiniteState` error (the
        estimator's class name; ``SGD[<loss>]`` by default).
        """
        prm = self.params
        _check_method(prm)
        if not isinstance(features, (np.ndarray, torch.Tensor)):
            raise NotImplementedError(
                "sparse (CSR) features come with a later slice of the port; "
                "this slice fits dense features only")
        device = resolve_device(device)
        x = _on_device(features, device)
        n, d = x.shape
        y = _on_device(labels, device)
        w = (torch.ones(n, dtype=torch.float32, device=device)
             if weights is None else _on_device(weights, device))
        coeffs = _on_device(init_coeffs, device)
        if coeffs.shape != (d,):
            raise ValueError(f"features are {tuple(x.shape)}, so the "
                             f"coefficients must be ({d},), got "
                             f"{tuple(coeffs.shape)}")

        coeffs, mean_loss, _ = sgd_rounds(kernels.sgd_batch_terms,
                                          loss_func.NAME, prm, x, y, w, coeffs)
        # benchmark provenance (runner.py executionPath)
        self.last_execution_path = ("cuda-sgd" if device.type == "cuda"
                                    else "torch-sgd")

        # the one host synchronisation of the fit
        final = torch.cat([coeffs, mean_loss[None]]).cpu().numpy()
        out = final[:d].astype(np.float64)
        loss = float(final[d])
        guard_final_state(tag or f"SGD[{loss_func.NAME}]", out, loss=loss)
        return out, loss
