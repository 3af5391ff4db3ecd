"""Unified observability for the port: span tracing, metric export, model
health, build and device telemetry, and in-program device profiles.

The port of ``flink_ml_tpu/observability``, under the JAX package's env
switches and artifact names. Arm with ``FLINK_ML_TPU_TRACE_DIR=<dir>``:
every fit and transform opens a span, the iteration runtime, checkpoints,
the supervisor and the cross-shard collectives nest theirs inside, and the
spans and a metrics snapshot stream there as ``spans-<pid>.jsonl`` /
``metrics-<pid>.json`` — files either package's readers (``read_spans``,
``chrome_trace``, ``prometheus_text``) read. ``FLINK_ML_TPU_HEALTH=1`` (or
a trace dir) arms the convergence series (``health``);
``FLINK_ML_TPU_PROFILE_CAPTURE=1`` with a trace dir captures a
``torch.profiler`` window of the next fit and writes ``profile.json``: per
kernel device time and roofline share (``profiling``). Unarmed, each seam
costs one env or attribute check and records nothing.
"""

from flink_ml_tpu_torch.observability.compilestats import (
    capture_cost,
    compile_stats,
    compile_totals,
    sample_memory,
)
from flink_ml_tpu_torch.observability.exporters import (
    chrome_trace,
    dump_metrics,
    latest_trace_dir,
    prometheus_text,
    read_metrics,
    read_spans,
    resolve_trace_dir,
    write_chrome_trace,
)
from flink_ml_tpu_torch.observability.health import (
    CONVERGENCE_EVENT,
    HEALTH_EVENT,
    ConvergenceListener,
    check_fit,
    convergence_row,
    finite_sentinel,
    guard_final_state,
    observe_serving,
    summarize_values,
)
from flink_ml_tpu_torch.observability.profiling import (
    CAPTURE_ENV,
    boot_phase,
    boot_to_ready_ms,
    capture_now,
    efficiency_report,
    mark_ready,
    maybe_profile_fit,
    parse_profile_dir,
    profile_window,
)
from flink_ml_tpu_torch.observability.tracing import (
    TRACE_DIR_ENV,
    TRACE_PARENT_ENV,
    Span,
    TraceContext,
    Tracer,
    context_of,
    current_context,
    event,
    fresh_context,
    span,
    tracer,
)

__all__ = [
    "CAPTURE_ENV",
    "CONVERGENCE_EVENT",
    "ConvergenceListener",
    "HEALTH_EVENT",
    "Span",
    "TRACE_DIR_ENV",
    "TRACE_PARENT_ENV",
    "TraceContext",
    "Tracer",
    "boot_phase",
    "boot_to_ready_ms",
    "capture_cost",
    "capture_now",
    "check_fit",
    "chrome_trace",
    "compile_stats",
    "compile_totals",
    "context_of",
    "convergence_row",
    "current_context",
    "dump_metrics",
    "efficiency_report",
    "event",
    "finite_sentinel",
    "fresh_context",
    "guard_final_state",
    "latest_trace_dir",
    "mark_ready",
    "maybe_profile_fit",
    "observe_serving",
    "parse_profile_dir",
    "profile_window",
    "prometheus_text",
    "read_metrics",
    "read_spans",
    "resolve_trace_dir",
    "sample_memory",
    "span",
    "summarize_values",
    "tracer",
    "write_chrome_trace",
]
