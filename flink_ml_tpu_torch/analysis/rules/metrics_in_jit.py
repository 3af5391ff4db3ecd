"""Rule TL107 ``metric-in-capture``: metric/tracer recording inside
captured code.

The port of ``flink_ml_tpu/analysis/rules/metrics_in_jit.py`` (JL107
``metric-in-jit``). ``metrics.group(...).counter(...)`` or
``tracer.span(...)`` inside a captured body — a ``with torch.cuda.graph``
block, a function handed to ``make_graphed_callables``, a
``torch.compile``/``torch.jit.script`` body (TL101's definition) — runs
once, when the body is captured, and never again: a replayed graph holds
no Python, so the counter records one increment for a million replays and
the span measures the capture, not the work. The observability layer is
host-side by design; recording belongs at the host boundaries around the
captured call (epoch/segment edges, stage wrappers).
"""

from __future__ import annotations

import ast
from typing import Iterator

from flink_ml_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    register,
)
from flink_ml_tpu_torch.analysis.rules._shared import captured_bodies

#: receiver roots that mark the observability layer (the module-level
#: registry/tracer singletons and their conventional local names)
_ROOTS = {"metrics", "tracer", "tracing"}

#: recording methods on registry groups / histograms / tracers — calling
#: any of these in captured code is the hazard regardless of receiver name
_RECORD_ATTRS = {"gauge", "counter", "histogram", "observe", "span",
                 "event", "add_event", "set_attribute"}

#: numeric namespaces whose same-named members are math, not metric
#: recording (``torch.histogram`` computes one)
_NUMERIC_ROOTS = {"torch", "np", "numpy", "scipy"}


def _chain_root(node: ast.AST):
    """The root Name of an attribute/call chain: ``metrics`` for
    ``metrics.group("ml").counter(...)`` (descends through both
    Attribute.value and Call.func)."""
    while True:
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Name):
            return node.id
        else:
            return None


@register
class MetricInCaptureRule(Rule):
    name = "metric-in-capture"
    code = "TL107"
    rationale = (
        "metrics.*/tracer span calls inside a CUDA-graph capture or a "
        "torch.compile/jit.script body run once, at capture, and record "
        "nothing per replay — record at host boundaries instead")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        seen = set()
        for body in captured_bodies(ctx):
            where = (f"`{body.name}`" if hasattr(body, "name")
                     else "a CUDA-graph capture")
            for node in ast.walk(body):
                if not isinstance(node, ast.Call) or \
                        not isinstance(node.func, ast.Attribute) or \
                        id(node) in seen:
                    continue
                attr = node.func.attr
                root = _chain_root(node.func)
                if root in _ROOTS or (
                        attr in _RECORD_ATTRS and root is not None
                        and root not in _NUMERIC_ROOTS):
                    seen.add(id(node))
                    yield self.finding(
                        ctx, node,
                        f"`{root}.…{attr}(...)` inside captured {where} "
                        "runs once, at capture, and records nothing per "
                        "replay (move the recording to the host boundary "
                        "around the captured call)")
