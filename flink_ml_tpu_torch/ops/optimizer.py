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

With an ``IterationConfig`` the same rounds run through the iteration
runtime (``iteration/iteration.py``): K-round segments between checkpoints,
each a masked loop like the plain fit's with one boundary fetch, or host
rounds of one round each with listeners, checkpoints and a stop fetch a
round. Every mode launches ``sgd_batch_terms`` with the same windows in the
same order, so each gives the plain fit's bits.

This slice runs one device and dense features: the per-shard batch shares,
the sharded update, tensor parallelism, the CSR path and the health
telemetry come with the parallel, sparse and observability slices of the
port, and asking for them raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from flink_ml_tpu_torch.device import DeviceLike, resolve_device
from flink_ml_tpu_torch.iteration import iteration
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


def _static_batch_schedule(local_n: int, lb: int, max_iter: int,
                           offset: int = 0):
    """The minibatch schedule as Python ints: round r slices [start,
    start+lb) with clip-at-end and wrap-to-zero (SGD.java:262-284), from the
    window offset ``offset``. Returns [(start, first_valid)] per round; rows
    before ``first_valid`` (the clip overlap) weigh 0."""
    sched = []
    for _ in range(max_iter):
        start = min(offset, local_n - lb)
        sched.append((start, offset - start))  # 0 unless clipped
        offset = _next_offset(local_n, lb, offset)
    return sched


def _next_offset(local_n: int, lb: int, offset: int) -> int:
    """The window offset after a round that started at ``offset``."""
    return 0 if offset + lb >= local_n else offset + lb


def _offset_after(local_n: int, lb: int, offset: int, rounds: int) -> int:
    for _ in range(rounds):
        offset = _next_offset(local_n, lb, offset)
    return offset


def _masked_rounds(batch_terms: BatchTerms, loss_name: str, prm: SGDParams,
                   x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                   coeffs: torch.Tensor, opt: tuple, offset: int,
                   rounds: int):
    """``rounds`` rounds from the window ``offset`` with the tol stop as a
    mask → (coeffs, opt, mean_loss at the stopping round, rounds run,
    stop), all tensors on the device; nothing here waits for the device. A
    round after the stop changes nothing."""
    n = x.shape[0]
    lb = min(prm.global_batch_size, n)
    rule = _update_rule(prm)
    mean_loss = torch.full((), float("inf"), dtype=torch.float32,
                           device=coeffs.device)
    ran = torch.zeros((), dtype=torch.int32, device=coeffs.device)
    stop = torch.zeros((), dtype=torch.bool, device=coeffs.device)
    for start, clip in _static_batch_schedule(n, lb, rounds, offset):
        packed = batch_terms(x, y, w, coeffs, start, clip, lb, loss_name)
        updated, new_opt, new_loss = _apply_packed(prm, rule, coeffs, opt,
                                                   packed)
        # the tol stop as a mask: a round after it changes nothing
        active = torch.logical_not(stop)
        coeffs = torch.where(active, updated, coeffs)
        opt = tuple(torch.where(active, nw, old)
                    for nw, old in zip(new_opt, opt))
        mean_loss = torch.where(active, new_loss, mean_loss)
        ran = ran + active.to(torch.int32)
        stop = torch.logical_or(stop, torch.logical_and(active,
                                                        new_loss < prm.tol))
    return coeffs, opt, mean_loss, ran, stop


def sgd_rounds(batch_terms: BatchTerms, loss_name: str, prm: SGDParams,
               x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               coeffs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Every round of a fit on device tensors, with each round's terms from
    ``batch_terms`` (:func:`kernels.sgd_batch_terms` or its plain version)
    → (coeffs, mean_loss at the stopping round, rounds run), all tensors on
    the device; nothing here waits for the device."""
    opt = _init_opt(prm, coeffs.shape[0], coeffs.device)
    coeffs, _, mean_loss, ran, _ = _masked_rounds(
        batch_terms, loss_name, prm, x, y, w, coeffs, opt, 0, prm.max_iter)
    return coeffs, mean_loss, ran


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

    def _iterate(self, loss_name: str, x: torch.Tensor, y: torch.Tensor,
                 w: torch.Tensor, coeffs0: torch.Tensor, seg_k: int, config,
                 listeners) -> Tuple[torch.Tensor, torch.Tensor]:
        """The rounds through the iteration runtime → (coeffs, mean_loss),
        device tensors. The carry is the JAX package's, leaf for leaf:
        ``(coeffs (d,) f32, offsets (1,) int32, mean_loss f32, opt)``, so
        the two packages' checkpoints hold the same leaves. ``offsets`` (the
        window offset) is a host numpy array: the schedule is Python ints,
        so a restored offset needs no device read. Each call builds a fresh
        carry, and no carry tensor is updated in place."""
        prm = self.params
        n, d = x.shape
        lb = min(prm.global_batch_size, n)
        batch_terms = kernels.sgd_batch_terms
        init = (coeffs0, np.zeros(1, np.int32),
                torch.full((), float("inf"), dtype=torch.float32,
                           device=coeffs0.device),
                _init_opt(prm, d, coeffs0.device))

        if seg_k:
            def run_segment(carry, epoch0, limit):
                coeffs, offsets, _, opt = carry
                offset = int(offsets[0])
                coeffs, opt, mean_loss, ran, stop = _masked_rounds(
                    batch_terms, loss_name, prm, x, y, w, coeffs, opt,
                    offset, limit - epoch0)
                # the boundary's one fetch: [epoch, stop]
                epoch, stop = iteration.read_boundary(
                    torch.stack([ran + epoch0, stop.to(torch.int32)]))
                epoch = int(epoch)
                offsets = np.asarray(
                    [_offset_after(n, lb, offset, epoch - epoch0)], np.int32)
                return (coeffs, offsets, mean_loss, opt), epoch, bool(stop)

            final = iteration.run_segmented(run_segment, init, prm.max_iter,
                                            seg_k, config.checkpoint_manager)
        else:
            def body(carry, epoch):
                # one round of the segments' own function, so every mode
                # runs the same update
                coeffs, offsets, _, opt = carry
                offset = int(offsets[0])
                coeffs, opt, mean_loss, _, _ = _masked_rounds(
                    batch_terms, loss_name, prm, x, y, w, coeffs, opt,
                    offset, 1)
                return (coeffs, np.asarray([_next_offset(n, lb, offset)],
                                           np.int32), mean_loss, opt)

            final = iteration.iterate_bounded(
                init, body, max_iter=prm.max_iter,
                terminate=lambda carry, epoch: carry[2] < prm.tol,
                config=config, listeners=listeners)
        coeffs, _, mean_loss, _ = final
        return coeffs, mean_loss

    def optimize(self, loss_func: LossFunc, init_coeffs,
                 features, labels, weights=None,
                 device: DeviceLike = None,
                 config=None, listeners=(),
                 tag: Optional[str] = None) -> Tuple[np.ndarray, float]:
        """Returns (coeffs (d,) float64 np.ndarray, final mean loss float).

        ``features`` (n, d), ``labels`` and ``weights`` (n,) are numpy arrays
        or tensors; tensors already on ``device`` (default: the CUDA card)
        stay there, host arrays are placed once as float32, and
        ``weights=None`` means ones. Rounds run the ``sgd_batch_terms``
        kernel on the card (``cuda-sgd``), and its plain PyTorch version on
        the CPU (``torch-sgd``).

        With ``config``/``listeners`` (an ``IterationConfig`` with host
        hooks) the rounds run through the iteration runtime, resumable from
        a checkpoint with the all-device fit's results: K-round segments
        when the only hook is a device-mode checkpoint interval
        (``-segments``), host rounds otherwise (``-rounds``).
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

        base = "cuda-sgd" if device.type == "cuda" else "torch-sgd"
        seg_k = iteration.device_checkpoint_segment(config, listeners)
        if not seg_k and not iteration.needs_host_loop(config, listeners):
            coeffs, mean_loss, _ = sgd_rounds(kernels.sgd_batch_terms,
                                              loss_func.NAME, prm, x, y, w,
                                              coeffs)
            path = base
        else:
            coeffs, mean_loss = self._iterate(loss_func.NAME, x, y, w, coeffs,
                                              seg_k, config, listeners)
            path = base + ("-segments" if seg_k else "-rounds")
        # benchmark provenance (runner.py executionPath)
        self.last_execution_path = path

        # the one host synchronisation of the fit
        final = torch.cat([coeffs, mean_loss[None]]).cpu().numpy()
        out = final[:d].astype(np.float64)
        loss = float(final[d])
        guard_final_state(tag or f"SGD[{loss_func.NAME}]", out, loss=loss)
        return out, loss
