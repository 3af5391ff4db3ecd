"""torchlint fixture: POSITIVE for metric-in-capture.

Metric recording inside a torch.compile'd step: the counter increments
once, at compile, never per call of the compiled graph.
"""
import torch

from flink_ml_tpu_torch.common.metrics import metrics


@torch.compile
def train_step(w, g):
    metrics.group("ml").counter("steps")  # once, at compile
    return w - 0.1 * g


def loop(w, g):
    for _ in range(100):
        w = train_step(w, g)
    return w
