"""Regularization.

The port of ``flink_ml_tpu/ops/regularization.py`` (ref: flink-ml-lib/.../
common/optimizer/RegularizationUtils.java:47): post-update shrink and
soft-threshold with the reference's exact formulas, idiosyncrasies included
(the pure-L2 "loss" term uses ||w||₂ rather than ||w||₂², and the L1 loss
term sums sign(w_i)), so loss curves and tol-based termination match.
``torch.sign`` is 0 at exact zeros, as ``jnp.sign`` is.
"""

from __future__ import annotations

import torch


def regularize(coeffs: torch.Tensor, reg: float, elastic_net: float,
               learning_rate: float):
    """Returns (new_coeffs, reg_loss). All branches are Python on the
    (static) params; the arithmetic stays in the dtype of ``coeffs``."""
    if reg == 0.0:
        return coeffs, torch.zeros((), dtype=coeffs.dtype, device=coeffs.device)
    if elastic_net == 0.0:
        # pure L2 (ref lines 55-59)
        loss = reg / 2.0 * torch.linalg.vector_norm(coeffs)
        return coeffs * (1.0 - learning_rate * reg), loss
    if elastic_net == 1.0:
        # pure L1 (ref lines 60-73): skip exact zeros
        sign = torch.sign(coeffs)
        loss = torch.sum(elastic_net * reg * sign)
        new = coeffs - learning_rate * elastic_net * reg * sign
        return new, loss
    # elastic net (ref lines 74-90)
    sign = torch.sign(coeffs)
    loss = torch.sum(elastic_net * reg * sign
                     + (1.0 - elastic_net) * (reg / 2.0) * coeffs * coeffs)
    new = coeffs - learning_rate * (elastic_net * reg * sign
                                    + (1.0 - elastic_net) * reg * coeffs)
    return new, loss
