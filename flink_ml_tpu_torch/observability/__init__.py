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
costs one env or attribute check and records nothing. The serving path's
halves: drift detection (``drift``: training-time baselines, mergeable
live sketches, PSI / JS / KS per model version), continuous evaluation
(``evaluation``: feedback-joined AUC and calibration) and the live
endpoint (``server``, ``FLINK_ML_TPU_METRICS_PORT``: ``/metrics``,
``/healthz``, ``/serving``, ``/drift``, ``/quality``, ``/slo``,
``/incidents``, ``/fleet``, ``/profilez`` ...). The ops halves: SLOs
with multi-window burn rates (``slo``), the flight recorder
(``flightrecorder``) that dumps ``incident-<seq>/`` evidence bundles on
SLO violations, drift, quality regressions, divergence and rollbacks,
and the fleet plane (``fleet``: per-process beacons folded into
membership and fleet-level windowed quantiles). The mesh dimension:
``meshstats`` records the topology (``mesh.json``), per-shard rows,
non-finite inputs and time-to-ready, and ``ml.skew`` stragglers. The
readers: ``flink-ml-tpu-torch-trace`` (``cli``) with its ``shards``,
``path``, ``locks`` and ``diff`` views and every other module's ``main``.
"""

from flink_ml_tpu_torch.observability.compilestats import (
    capture_cost,
    compile_stats,
    compile_totals,
    sample_memory,
)
from flink_ml_tpu_torch.observability.drift import (
    DRIFT_EVENT,
    DriftBaseline,
    SketchGroup,
    StreamingSketch,
    capture_fit_baseline,
    compare_sketches,
    drift_report,
    install_baseline,
    observe_transform,
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
from flink_ml_tpu_torch.observability.meshstats import (
    SKEW_EVENT,
    detect_skew,
    ensure_mesh_recorded,
    mesh_snapshot,
    observe_shard_ready,
    read_mesh,
    record_input_health,
    record_shard_rows,
)
from flink_ml_tpu_torch.observability.path import analyze_paths
from flink_ml_tpu_torch.observability.flightrecorder import (
    INCIDENT_EVENT,
    acknowledge,
    read_incidents,
    record_incident,
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
from flink_ml_tpu_torch.observability.slo import (
    SLO,
    SLO_EVENT,
    SLO_SPEC_ENV,
    default_slos,
    evaluate_slos,
    load_specs,
)
from flink_ml_tpu_torch.observability.server import (
    METRICS_PORT_ENV,
    TelemetryServer,
    maybe_start,
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
    "INCIDENT_EVENT",
    "SKEW_EVENT",
    "analyze_paths",
    "detect_skew",
    "ensure_mesh_recorded",
    "mesh_snapshot",
    "observe_shard_ready",
    "read_mesh",
    "record_input_health",
    "record_shard_rows",
    "SLO",
    "SLO_EVENT",
    "SLO_SPEC_ENV",
    "acknowledge",
    "default_slos",
    "evaluate_slos",
    "load_specs",
    "read_incidents",
    "record_incident",
    "CAPTURE_ENV",
    "CONVERGENCE_EVENT",
    "ConvergenceListener",
    "DRIFT_EVENT",
    "DriftBaseline",
    "HEALTH_EVENT",
    "METRICS_PORT_ENV",
    "SketchGroup",
    "StreamingSketch",
    "Span",
    "TRACE_DIR_ENV",
    "TelemetryServer",
    "TRACE_PARENT_ENV",
    "TraceContext",
    "Tracer",
    "boot_phase",
    "boot_to_ready_ms",
    "capture_cost",
    "capture_fit_baseline",
    "capture_now",
    "check_fit",
    "compare_sketches",
    "chrome_trace",
    "compile_stats",
    "compile_totals",
    "context_of",
    "convergence_row",
    "current_context",
    "drift_report",
    "dump_metrics",
    "efficiency_report",
    "event",
    "finite_sentinel",
    "fresh_context",
    "guard_final_state",
    "install_baseline",
    "latest_trace_dir",
    "mark_ready",
    "maybe_start",
    "maybe_profile_fit",
    "observe_serving",
    "observe_transform",
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
