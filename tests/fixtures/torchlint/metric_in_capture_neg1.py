"""NEGATIVE: recording at the host boundary around the captured call (the
iteration-runtime pattern), and torch math lookalikes inside."""

import time

import torch

from flink_ml_tpu_torch.common.metrics import metrics


@torch.compile
def train_step(w, g):
    # torch.histc/histogram are math, not metric recording
    counts = torch.histc(g, bins=4)
    return w - 0.1 * g, counts


def fit(w, g, rounds):
    group = metrics.group("ml", "iteration")
    for _ in range(rounds):
        start = time.perf_counter()
        w, _ = train_step(w, g)
        # host boundary: records every epoch — must stay silent
        group.histogram("epochMs").observe(
            (time.perf_counter() - start) * 1000.0)
    group.counter("fits")
    return w
