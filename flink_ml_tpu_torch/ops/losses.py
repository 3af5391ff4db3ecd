"""Loss functions.

The port of ``flink_ml_tpu/ops/losses.py`` (ref: flink-ml-lib/.../common/
lossfunc/{LossFunc.java:40-49, BinaryLogisticLoss.java:29,
HingeLoss.java:33, LeastSquareLoss.java:29}). Each loss is a batched
function over the whole minibatch: ``dots = X @ w``, elementwise
``terms(dots) -> (loss_sum, multipliers)``, ``grad = X.T @ multipliers``.
Labels follow the reference convention (binary labels in {0, 1}, scaled to
±1 inside). The ``sgd_batch_terms`` kernel (``ops/kernels.py``) computes the
same per-row terms; these are its plain PyTorch form.
"""

from __future__ import annotations

import torch

__all__ = ["LossFunc", "BinaryLogisticLoss", "HingeLoss", "LeastSquareLoss"]


class LossFunc:
    """Batched loss: given coefficients and a weighted minibatch, return
    (loss_sum, grad_sum), the reference's computeLoss/computeGradient
    accumulated over the batch (LossFunc.java:40-49)."""

    NAME = None

    def terms(self, dots: torch.Tensor, labels: torch.Tensor,
              weights: torch.Tensor):
        """(b,) margins → (0-dim loss sum, (b,) gradient multipliers)."""
        raise NotImplementedError

    def loss_and_gradient(self, coeffs, features, labels, weights):
        """coeffs (d,), features (b, d), labels (b,), weights (b,) →
        (0-dim loss sum, (d,) gradient sum)."""
        loss, multipliers = self.terms(features @ coeffs, labels, weights)
        return loss, features.T @ multipliers

    @staticmethod
    def by_name(name: str) -> "LossFunc":
        for cls in (BinaryLogisticLoss, HingeLoss, LeastSquareLoss):
            if cls.NAME == name:
                return cls()
        raise ValueError(f"unknown loss {name!r}")


class BinaryLogisticLoss(LossFunc):
    """Ref: BinaryLogisticLoss.java:29: loss = w·log(1+e^{-dot·(2y-1)}),
    grad = w·(-(2y-1)/(e^{dot·(2y-1)}+1))·x."""

    NAME = "logistic"

    def terms(self, dots, labels, weights):
        label_scaled = 2.0 * labels - 1.0
        margins = dots * label_scaled
        # log1p(exp(-m)) with the standard overflow-safe rewrite
        loss = torch.sum(weights * torch.logaddexp(torch.zeros_like(margins),
                                                   -margins))
        multipliers = weights * (-label_scaled / (torch.exp(margins) + 1.0))
        return loss, multipliers


class HingeLoss(LossFunc):
    """Ref: HingeLoss.java:33: loss = w·max(0, 1-(2y-1)·dot); subgradient
    -(2y-1)·w·x where the hinge is active."""

    NAME = "hinge"

    def terms(self, dots, labels, weights):
        label_scaled = 2.0 * labels - 1.0
        hinge = 1.0 - label_scaled * dots
        loss = torch.sum(weights * torch.clamp_min(hinge, 0.0))
        active = (hinge > 0.0).to(dots.dtype)
        multipliers = -label_scaled * weights * active
        return loss, multipliers


class LeastSquareLoss(LossFunc):
    """Ref: LeastSquareLoss.java:29: loss = w·½(dot-y)², grad = w·(dot-y)·x."""

    NAME = "least_square"

    def terms(self, dots, labels, weights):
        err = dots - labels
        loss = torch.sum(weights * 0.5 * err * err)
        return loss, weights * err
