"""``flink-ml-tpu-torch-trace``: inspect a trace directory from artifacts
alone.

The port of ``flink_ml_tpu/observability/cli.py``, with every subcommand of
the JAX package's ``flink-ml-tpu-trace`` and the same exit codes; it reads
either package's trace dirs. A failed or slow run leaves ``spans-*.jsonl``
+ ``metrics-*.json`` (and the views' own artifacts) under its
``FLINK_ML_TPU_TRACE_DIR``::

    flink-ml-tpu-torch-trace TRACE_DIR                 # summary (text)
    flink-ml-tpu-torch-trace summary TRACE_DIR --json  # summary (machine)
    flink-ml-tpu-torch-trace TRACE_DIR --chrome t.json # Perfetto trace
    flink-ml-tpu-torch-trace TRACE_DIR --prometheus    # metrics exposition
    flink-ml-tpu-torch-trace TRACE_DIR --check         # exit 2 on empty
    flink-ml-tpu-torch-trace diff A B --budget 20      # regression (exit 4)
    flink-ml-tpu-torch-trace health TRACE_DIR --check  # model health (3)
    flink-ml-tpu-torch-trace shards TRACE_DIR --check  # per-shard view (2)
    flink-ml-tpu-torch-trace slo TRACE_DIR --check     # SLO verdicts (4)
    flink-ml-tpu-torch-trace drift TRACE_DIR --check   # drift verdicts (4)
    flink-ml-tpu-torch-trace quality TRACE_DIR --check # quality verdicts (4)
    flink-ml-tpu-torch-trace controller TRACE_DIR --check  # ops loop (4)
    flink-ml-tpu-torch-trace path TRACE_DIR --check --budget 50  # (2/4)
    flink-ml-tpu-torch-trace incident TRACE_DIR --check  # incidents (4)
    flink-ml-tpu-torch-trace locks TRACE_DIR --check   # lock watchdog (4)
    flink-ml-tpu-torch-trace fleet DIR --check         # fleet members (4)
    flink-ml-tpu-torch-trace efficiency DIR --check --min-util 0.4  # (4)
    flink-ml-tpu-torch-trace ROOT --latest             # newest dir under ROOT

``python -m flink_ml_tpu_torch.observability.cli`` is the same program.
The summary holds the top spans by self time (time in a span minus its
children), the per-epoch breakdown (host/device split, checkpoints per
epoch) and the checkpoint/retry timeline (saves, restores, quarantines,
supervisor restarts, host-pool timeouts). Each subcommand is its module's
``main(argv)``: ``diff`` (``diff.py``), ``health`` (``health.py``),
``shards`` (``shards.py``), ``slo`` (``slo.py``), ``drift``
(``drift.py``), ``quality`` (``evaluation.py``), ``controller``
(``serving/controller.py``), ``path`` (``path.py``), ``incident``
(``flightrecorder.py``), ``locks`` (``lockstats.py``), ``fleet``
(``fleet.py``) and ``efficiency`` (``profiling.py``). Exit codes: 0 ok, 2
missing or broken artifacts, 3 a health event (``health --check``), 4 a
gate that fired. Every subcommand takes ``--latest`` (treat the dir as a
root and read its newest trace dir), and renders under
``exporters.pipe_guard``, so ``... | head`` closing the pipe is no error.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from flink_ml_tpu_torch.observability.diff import aggregate_self_time
from flink_ml_tpu_torch.observability.exporters import (
    pipe_guard,
    prometheus_text,
    read_metrics,
    read_spans,
    write_chrome_trace,
)

#: events that belong on the failure/recovery timeline
TIMELINE_EVENTS = ("supervisor.restart", "supervisor.recovered",
                   "checkpoint.quarantine", "hostpool.timeout",
                   "elastic.worker-lost", "elastic.relaunch",
                   "elastic.participation", "elastic.chaos")


def _ms(us) -> float:
    return round((us or 0) / 1000.0, 3)


def summarize(spans: List[dict]) -> dict:
    """Structured summary of a span list (the CLI's JSON output)."""
    by_id = {sp["id"]: sp for sp in spans if sp.get("id")}
    children: Dict[str, List[dict]] = {}
    for sp in spans:
        parent = sp.get("parent")
        if parent in by_id:
            children.setdefault(parent, []).append(sp)

    # -- top spans by aggregate self-time, grouped by name -------------------
    agg = aggregate_self_time(spans)
    top = [{"name": name, "count": row["count"],
            "total_ms": _ms(row["total_us"]),
            "self_ms": _ms(row["self_us"])}
           for name, row in agg.items()]
    top.sort(key=lambda r: -r["self_ms"])

    # -- per-epoch breakdown -------------------------------------------------
    epochs = []
    for sp in spans:
        if sp.get("name") not in ("epoch", "segment"):
            continue
        attrs = sp.get("attrs", {})
        ckpts = sum(1 for c in children.get(sp.get("id"), ())
                    if str(c.get("name", "")).startswith("checkpoint."))
        row = {"kind": sp["name"],
               "epoch": attrs.get("epoch", attrs.get("epoch_to")),
               "ms": _ms(sp.get("dur_us")),
               "checkpoints": ckpts}
        for key in ("host_ms", "device_ms", "rounds", "epoch_from",
                    "epoch_to"):
            if key in attrs:
                row[key] = attrs[key]
        epochs.append(row)
    epochs.sort(key=lambda r: (r["epoch"] is None, r["epoch"]))

    # -- checkpoint / retry timeline -----------------------------------------
    timeline = []
    for sp in spans:
        if str(sp.get("name", "")).startswith("checkpoint."):
            timeline.append({"ts_us": sp.get("ts_us", 0),
                             "what": sp["name"],
                             "ms": _ms(sp.get("dur_us")),
                             "attrs": sp.get("attrs", {})})
        for ev in sp.get("events", ()):
            if ev.get("name") in TIMELINE_EVENTS:
                timeline.append({"ts_us": ev.get("ts_us", 0),
                                 "what": ev["name"],
                                 "attrs": ev.get("attrs", {})})
    timeline.sort(key=lambda r: r["ts_us"])

    roots = [sp for sp in spans if sp.get("parent") not in by_id]
    # multi-process attribution: span records of a multi-process run
    # carry a ``process`` label (tracing.py) because pids alone collide
    # across hosts — count spans per process so a merged trace says who
    # ran what
    per_process: Dict[str, int] = {}
    for sp in spans:
        if "process" in sp:
            key = str(sp["process"])
            per_process[key] = per_process.get(key, 0) + 1
    return {"spans": len(spans),
            "traces": len({sp.get("trace") for sp in spans}),
            "roots": [{"name": sp.get("name"),
                       "ms": _ms(sp.get("dur_us"))} for sp in roots],
            "top_self_time": top,
            "epochs": epochs,
            "timeline": timeline,
            **({"processes": per_process} if per_process else {})}


def render_summary(summary: dict, top_n: int = 15) -> str:
    out = [f"{summary['spans']} span(s) across "
           f"{summary['traces']} trace(s)"]
    if summary.get("processes"):
        # numeric order: the keys are stringified process indices, and
        # p10 must not sort before p2
        parts = ", ".join(
            f"p{k}: {v}" for k, v in sorted(
                summary["processes"].items(),
                key=lambda kv: (not kv[0].isdigit(), int(kv[0])
                                if kv[0].isdigit() else 0, kv[0])))
        out.append(f"  processes: {parts} span(s)")
    for root in summary["roots"]:
        out.append(f"  root: {root['name']}  {root['ms']} ms")

    out.append("")
    out.append("top spans by self-time:")
    out.append(f"  {'name':<32} {'count':>6} {'total ms':>12} "
               f"{'self ms':>12}")
    for row in summary["top_self_time"][:top_n]:
        out.append(f"  {row['name']:<32} {row['count']:>6} "
                   f"{row['total_ms']:>12.3f} {row['self_ms']:>12.3f}")

    if summary["epochs"]:
        out.append("")
        out.append("per-epoch breakdown:")
        for row in summary["epochs"]:
            extra = "".join(
                f"  {k}={row[k]}" for k in
                ("host_ms", "device_ms", "rounds") if k in row)
            out.append(f"  {row['kind']} {row['epoch']}: "
                       f"{row['ms']} ms  checkpoints={row['checkpoints']}"
                       f"{extra}")

    if summary["timeline"]:
        out.append("")
        out.append("checkpoint/retry timeline:")
        t0 = summary["timeline"][0]["ts_us"]
        for row in summary["timeline"]:
            attrs = " ".join(f"{k}={v}"
                             for k, v in row.get("attrs", {}).items())
            ms = f" {row['ms']} ms" if "ms" in row else ""
            out.append(f"  +{_ms(row['ts_us'] - t0):>10.3f} ms  "
                       f"{row['what']}{ms}  {attrs}".rstrip())
    return "\n".join(out)


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "diff":
        # the regression gate lives in its own module; dispatch before
        # argparse so `diff` never collides with a dir named "diff"
        # (use ./diff to summarize such a directory)
        from flink_ml_tpu_torch.observability.diff import main as diff_main

        return diff_main(argv[1:])
    if argv and argv[0] == "health":
        # model-health view (observability/health.py); same dispatch
        # rule — use ./health to summarize a directory named "health"
        from flink_ml_tpu_torch.observability.health import main as health_main

        return health_main(argv[1:])
    if argv and argv[0] == "shards":
        # per-device mesh view (observability/shards.py); same dispatch
        # rule — use ./shards to summarize a directory named "shards"
        from flink_ml_tpu_torch.observability.shards import main as shards_main

        return shards_main(argv[1:])
    if argv and argv[0] == "slo":
        # SLO verdicts (observability/slo.py); same dispatch rule —
        # use ./slo to summarize a directory named "slo"
        from flink_ml_tpu_torch.observability.slo import main as slo_main

        return slo_main(argv[1:])
    if argv and argv[0] == "drift":
        # drift verdicts (observability/drift.py); same dispatch rule —
        # use ./drift to summarize a directory named "drift"
        from flink_ml_tpu_torch.observability.drift import main as drift_main

        return drift_main(argv[1:])
    if argv and argv[0] == "quality":
        # continuous-evaluation verdicts (observability/evaluation.py);
        # same dispatch rule — ./quality summarizes such a directory
        from flink_ml_tpu_torch.observability.evaluation import (
            main as quality_main,
        )

        return quality_main(argv[1:])
    if argv and argv[0] == "controller":
        # ops-controller timeline (serving/controller.py); same
        # dispatch rule — ./controller summarizes such a directory
        from flink_ml_tpu_torch.serving.controller import (
            main as controller_main,
        )

        return controller_main(argv[1:])
    if argv and argv[0] == "path":
        # critical-path view (observability/path.py); same dispatch
        # rule — use ./path to summarize a directory named "path"
        from flink_ml_tpu_torch.observability.path import main as path_main

        return path_main(argv[1:])
    if argv and argv[0] == "incident":
        # flight-recorder bundles (observability/flightrecorder.py);
        # same dispatch rule — ./incident summarizes such a directory
        from flink_ml_tpu_torch.observability.flightrecorder import (
            main as incident_main,
        )

        return incident_main(argv[1:])
    if argv and argv[0] == "locks":
        # lock-watchdog view (observability/lockstats.py); same
        # dispatch rule — use ./locks to summarize such a directory
        from flink_ml_tpu_torch.observability.lockstats import (
            main as locks_main,
        )

        return locks_main(argv[1:])
    if argv and argv[0] == "fleet":
        # live fleet membership + aggregates (observability/fleet.py);
        # same dispatch rule — use ./fleet to summarize such a directory
        from flink_ml_tpu_torch.observability.fleet import main as fleet_main

        return fleet_main(argv[1:])
    if argv and argv[0] == "efficiency":
        # measured device time against each launch's bytes and
        # operations (observability/profiling.py); same dispatch rule — use
        # ./efficiency to summarize a directory named "efficiency"
        from flink_ml_tpu_torch.observability.profiling import (
            main as efficiency_main,
        )

        return efficiency_main(argv[1:])
    if argv and argv[0] == "summary":
        # explicit subcommand spelling for the default view, so
        # unattended consumers can write `summary --json` without
        # knowing the bare-positional legacy form
        argv = argv[1:]
    parser = argparse.ArgumentParser(
        prog="flink-ml-tpu-torch-trace",
        description="Summarize a FLINK_ML_TPU_TRACE_DIR trace directory "
                    "(or `diff A B [--budget PCT]` two of them).")
    parser.add_argument("trace_dir")
    parser.add_argument("--chrome", metavar="OUT_JSON",
                        help="also export a Chrome/Perfetto trace")
    parser.add_argument("--prometheus", action="store_true",
                        help="print the merged metrics snapshot in "
                             "Prometheus text exposition format")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--json", action="store_true",
                        help="shorthand for --format json (machine-"
                             "readable summary for unattended sweeps)")
    parser.add_argument("--top", type=int, default=15,
                        help="rows in the self-time table")
    parser.add_argument("--check", action="store_true",
                        help="exit 2 when the trace has no spans (CI "
                             "smoke gate)")
    parser.add_argument("--latest", action="store_true",
                        help="treat TRACE_DIR as a root and pick the "
                             "newest trace dir under it")
    args = parser.parse_args(argv)

    try:
        from flink_ml_tpu_torch.observability.exporters import (
            resolve_trace_dir,
        )

        args.trace_dir = resolve_trace_dir(args.trace_dir, args.latest)
        spans = read_spans(args.trace_dir)
    except OSError as e:
        print(f"flink-ml-tpu-torch-trace: cannot read {args.trace_dir}: {e}",
              file=sys.stderr)
        return 2
    if args.check and not spans:
        print(f"flink-ml-tpu-torch-trace: no spans in {args.trace_dir}",
              file=sys.stderr)
        return 2

    if args.chrome:
        n = write_chrome_trace(args.trace_dir, args.chrome)
        print(f"wrote {n} span(s) to {args.chrome}", file=sys.stderr)

    if args.prometheus:
        snap = read_metrics(args.trace_dir)
        if not snap:
            print("flink-ml-tpu-torch-trace: no metric samples in "
                  f"{args.trace_dir} — either no metrics-*.json snapshot "
                  "was written (one lands when an outermost stage span "
                  "closes) or the traced run recorded no metrics",
                  file=sys.stderr)
        with pipe_guard():
            print(prometheus_text(snap), end="")
        return 0

    summary = summarize(spans)
    with pipe_guard():
        if args.json or args.format == "json":
            print(json.dumps(summary, indent=2, default=str))
        else:
            print(render_summary(summary, top_n=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
