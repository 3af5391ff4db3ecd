"""torchlint fixture: POSITIVE for metric-in-capture.

A tracer span and a histogram observe inside a CUDA-graph capture, and an
event inside a graphed callable: each records the capture, not a replay.
"""
import torch

from flink_ml_tpu_torch.common.metrics import metrics
from flink_ml_tpu_torch.observability import tracing

tracer = tracing.tracer
epoch_hist = metrics.group("ml", "iteration").histogram("epochMs")


def capture_round(fn, carry):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        with tracer.span("round"):  # measures the capture
            carry = fn(carry)
        epoch_hist.observe(1.0)  # recorded once
    return graph


def per_batch(x):
    tracing.event("batch")  # once, at capture
    return x.sum()


graphed = torch.cuda.make_graphed_callables(per_batch, (torch.zeros(4),))
