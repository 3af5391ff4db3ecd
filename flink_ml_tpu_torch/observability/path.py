"""Critical-path analysis: where a request's (or an epoch's) wall time
went, reconstructed from the span DAG.

The port of ``flink_ml_tpu/observability/path.py``. The DAG comes from
two edge kinds (``observability/tracing.py``):

- **parent links**: same-thread nesting (``checkpoint.save`` inside
  ``epoch``);
- **follows_from links**: the cross-thread handoffs the micro-batcher
  records (``serving/batcher.py``): ``serving.pad`` follows the
  ``serving.submit`` spans it drained, ``serving.batch`` follows the pad
  that prepared it, and each ``serving.resolve`` is a child of its
  request's submit span with a follows_from edge to the batch that
  computed it.

Per request, the wall clock [submit start, resolve end] partitions into
named segments::

    submit   the admission/submit span itself
    queue    submit end -> serving.pad start   (waiting to be drained)
    pad      the serving.pad span              (host padding/vetting)
    handoff  pad end -> serving.batch start    (the pipeline queue)
    device   the serving.batch span            (dispatch + compute)
    resolve  batch end -> resolve end          (fetch + future fan-out)

``coverage`` is the attributed fraction of the wall clock (the acceptance
bar is 0.9). Epochs reuse the ``host_ms``/``device_ms`` attributes the
iteration runtime attaches to epoch spans. When a ``profile.json`` sits
beside the trace (``observability/profiling.py``),
:func:`attach_device_ops` names the top kernels of the device segment by
measured self time.

CLI: ``flink-ml-tpu-torch-trace path <dir> [--trace ID] [--json] [--check
[--budget PCT]]``: ``--check`` exits 2 when the trace holds no
reconstructable request, and with ``--budget`` 4 when the queue-wait
share (queue + handoff) of request wall time exceeds PCT percent.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

__all__ = [
    "EXIT_OK", "EXIT_INVALID", "EXIT_OVER_BUDGET",
    "REQUEST_SEGMENTS", "QUEUE_SEGMENTS",
    "analyze_paths", "attach_device_ops", "render_paths", "main",
]

EXIT_OK = 0
EXIT_INVALID = 2
#: --check --budget's violation exit — same class as diff/slo's 4
EXIT_OVER_BUDGET = 4

#: per-request segment names, timeline order
REQUEST_SEGMENTS = ("submit", "queue", "pad", "handoff", "device",
                    "resolve")
#: the segments the --budget gate counts as "queue wait": time the
#: request spent parked, not being worked on
QUEUE_SEGMENTS = ("queue", "handoff")


def _end_us(sp: dict) -> int:
    return int(sp.get("ts_us", 0)) + int(sp.get("dur_us") or 0)


def _link_ids(sp: dict) -> List[str]:
    return [ln.get("span") for ln in sp.get("links", ())
            if ln.get("span")]


def _index(spans: List[dict]) -> Dict[str, List[dict]]:
    by_name: Dict[str, List[dict]] = {}
    for sp in spans:
        by_name.setdefault(str(sp.get("name", "")), []).append(sp)
    return by_name


def _request_rows(spans: List[dict]) -> List[dict]:
    """One row per reconstructable request: a ``serving.resolve``
    span's ``parent`` IS its request's ``serving.submit`` span (the
    batcher opens it with ``parent=req.ctx``) — the primary join,
    collision-free across processes and across batcher instances in a
    merged trace. The shared ``req=`` attr is only the fallback for
    resolve spans whose submit parent record is missing (e.g. a ring
    that rotated it away), and then only when the ordinal is
    unambiguous. From the resolve, walk the follows_from edge to its
    ``serving.batch`` and that batch's edge to its ``serving.pad``."""
    by_name = _index(spans)
    by_id = {sp.get("id"): sp for sp in spans if sp.get("id")}
    submit_by_req: Dict[object, List[dict]] = {}
    for sp in by_name.get("serving.submit", ()):
        req = sp.get("attrs", {}).get("req")
        if req is not None:
            submit_by_req.setdefault(req, []).append(sp)
    rows: List[dict] = []
    for resolve in by_name.get("serving.resolve", ()):
        attrs = resolve.get("attrs", {})
        req = attrs.get("req")
        submit = by_id.get(resolve.get("parent"))
        if submit is not None and \
                submit.get("name") != "serving.submit":
            submit = None
        if submit is None:
            candidates = submit_by_req.get(req, [])
            # two batchers (or two processes) both mint req=0 — an
            # ambiguous ordinal must not cross-wire request paths
            submit = candidates[0] if len(candidates) == 1 else None
        if submit is None:
            continue
        batch = next((by_id[i] for i in _link_ids(resolve)
                      if i in by_id
                      and by_id[i].get("name") == "serving.batch"),
                     None)
        pad = None
        if batch is not None:
            pad = next((by_id[i] for i in _link_ids(batch)
                        if i in by_id
                        and by_id[i].get("name") == "serving.pad"),
                       None)
        t_submit0 = int(submit.get("ts_us", 0))
        wall_us = max(_end_us(resolve) - t_submit0, 1)
        seg = dict.fromkeys(REQUEST_SEGMENTS, 0)
        seg["submit"] = int(submit.get("dur_us") or 0)
        if pad is not None:
            seg["queue"] = max(
                int(pad.get("ts_us", 0)) - _end_us(submit), 0)
            seg["pad"] = int(pad.get("dur_us") or 0)
        if batch is not None:
            after_pad = _end_us(pad) if pad is not None \
                else _end_us(submit)
            seg["handoff"] = max(
                int(batch.get("ts_us", 0)) - after_pad, 0)
            seg["device"] = int(batch.get("dur_us") or 0)
            seg["resolve"] = max(_end_us(resolve) - _end_us(batch), 0)
        else:
            # no reconstructable tick: everything after the submit span
            # is unattributed — the coverage number says so
            seg["resolve"] = int(resolve.get("dur_us") or 0)
        covered = sum(seg.values())
        rows.append({
            "req": req,
            "trace": submit.get("trace"),
            "tick": attrs.get("tick"),
            "rows": attrs.get("rows"),
            "wall_us": wall_us,
            "segments_us": seg,
            "coverage": min(covered / wall_us, 1.0),
        })
    rows.sort(key=lambda r: -r["wall_us"])
    return rows


def _epoch_rows(spans: List[dict]) -> List[dict]:
    """Per-epoch wall-time attribution from the host/device split the
    iteration seams attach to epoch/segment spans."""
    rows: List[dict] = []
    for sp in spans:
        if sp.get("name") not in ("epoch", "segment"):
            continue
        attrs = sp.get("attrs", {})
        total_ms = (sp.get("dur_us") or 0) / 1000.0
        host = attrs.get("host_ms")
        device = attrs.get("device_ms")
        row = {"kind": sp["name"],
               "epoch": attrs.get("epoch", attrs.get("epoch_to")),
               "wall_ms": round(total_ms, 3),
               "follows": len(_link_ids(sp))}
        if host is not None or device is not None:
            h = float(host or 0.0)
            d = float(device or 0.0)
            row["host_ms"] = h
            row["device_ms"] = d
            row["other_ms"] = round(max(total_ms - h - d, 0.0), 3)
            row["coverage"] = (min((h + d) / total_ms, 1.0)
                               if total_ms > 0 else 0.0)
        rows.append(row)
    rows.sort(key=lambda r: (r["epoch"] is None, r["epoch"]))
    return rows


def analyze_paths(spans: List[dict],
                  trace: Optional[str] = None) -> dict:
    """The structured path report: per-request segment attribution
    (aggregate + the slowest requests), the queue-wait share the
    ``--budget`` gate reads, and the per-epoch host/device view.
    ``trace`` narrows the span set to one trace id first."""
    if trace:
        spans = [sp for sp in spans if sp.get("trace") == trace]
    requests = _request_rows(spans)
    agg = dict.fromkeys(REQUEST_SEGMENTS, 0)
    wall_total = 0
    covered = 0
    for row in requests:
        wall_total += row["wall_us"]
        # coverage is per-request (clamped at its own wall clock):
        # requests sharing one tick each legitimately attribute the
        # full pad/device time — summing those against summed wall
        # would read > 1
        covered += min(sum(row["segments_us"].values()),
                       row["wall_us"])
        for name, us in row["segments_us"].items():
            agg[name] += us
    queue_us = sum(agg[name] for name in QUEUE_SEGMENTS)
    report = {
        "spans": len(spans),
        "traces": len({sp.get("trace") for sp in spans}),
        "requests": {
            "count": len(requests),
            "wall_ms_total": round(wall_total / 1000.0, 3),
            "coverage": (round(covered / wall_total, 4)
                         if wall_total else None),
            "queue_share": (round(queue_us / wall_total, 4)
                            if wall_total else None),
            "segments_ms": {name: round(us / 1000.0, 3)
                            for name, us in agg.items()},
            # the attribution mix: each segment's share of ALL
            # attributed time (shared ticks count once per request they
            # served, so the mix reflects what a request experiences)
            "segment_share": {name: (round(us / max(sum(agg.values()),
                                                    1), 4))
                              for name, us in agg.items()},
        },
        "slowest": requests[:10],
        "epochs": _epoch_rows(spans),
    }
    return report


def attach_device_ops(report: dict, trace_dir: str,
                      top: int = 3) -> dict:
    """Sub-attribute the opaque device segment: when a ``profile.json``
    device-profile artifact sits beside the trace
    (observability/profiling.py), attach its top ops by measured
    self-time as ``report["device_ops"]`` — so a ``--budget`` verdict
    names the op that owns the device time instead of one black-box
    block. Best-effort: without an artifact the report is unchanged."""
    try:
        from flink_ml_tpu_torch.observability import profiling

        profile = profiling.read_profile(trace_dir)
    except Exception:  # noqa: BLE001 — most traces carry no profile
        return report
    ops = profile.get("ops") or []
    report["device_ops"] = {
        "source": profile.get("source"),
        "ops": [{"op": row["op"], "fn": row["fn"],
                 "selfMs": row["selfMs"], "count": row["count"]}
                for row in ops[:top]],
    }
    return report


def render_paths(report: dict, top_n: int = 5) -> str:
    req = report["requests"]
    out = [f"{report['spans']} span(s) across {report['traces']} "
           f"trace(s); {req['count']} reconstructed request path(s)"]
    if req["count"]:
        out.append(
            f"  wall {req['wall_ms_total']} ms total, attribution "
            f"coverage {req['coverage']:.1%}, queue-wait share "
            f"{req['queue_share']:.1%}")
        out.append("")
        out.append(f"  {'segment':<10} {'total ms':>12} {'share':>8}")
        for name in REQUEST_SEGMENTS:
            share = req["segment_share"][name]
            out.append(f"  {name:<10} {req['segments_ms'][name]:>12.3f}"
                       f" {share:>7.1%}")
        device_ops = report.get("device_ops")
        if device_ops and device_ops.get("ops"):
            src = device_ops.get("source")
            out.append("")
            out.append(f"  device segment, top op(s) by measured "
                       f"self-time (source: {src}):")
            for row in device_ops["ops"]:
                out.append(f"    {row['op']} (fn={row['fn']}): "
                           f"{row['selfMs']:.3f} ms x{row['count']}")
        if report["slowest"]:
            out.append("")
            out.append("  slowest request(s):")
            for row in report["slowest"][:top_n]:
                segs = " ".join(
                    f"{k}={v / 1000.0:.2f}ms"
                    for k, v in row["segments_us"].items() if v)
                out.append(f"    req {row['req']} tick {row['tick']}: "
                           f"{row['wall_us'] / 1000.0:.2f} ms  {segs}")
    if report["epochs"]:
        out.append("")
        out.append("per-epoch attribution:")
        for row in report["epochs"]:
            if "host_ms" in row:
                out.append(
                    f"  {row['kind']} {row['epoch']}: "
                    f"{row['wall_ms']} ms  host {row['host_ms']} + "
                    f"device {row['device_ms']} + other "
                    f"{row['other_ms']} ms "
                    f"({row['coverage']:.1%} attributed)")
            else:
                out.append(f"  {row['kind']} {row['epoch']}: "
                           f"{row['wall_ms']} ms")
    return "\n".join(out)


def main(argv=None) -> int:
    """``flink-ml-tpu-torch-trace path <dir>`` — critical-path view;
    ``--check`` exits 2 with no reconstructable requests, and with
    ``--budget PCT`` exits 4 when the queue-wait share exceeds PCT%."""
    import argparse
    import sys

    from flink_ml_tpu_torch.observability.exporters import (
        pipe_guard,
        read_spans,
        resolve_trace_dir,
    )

    parser = argparse.ArgumentParser(
        prog="flink-ml-tpu-torch-trace path",
        description="Per-request / per-epoch critical-path attribution "
                    "from a FLINK_ML_TPU_TRACE_DIR's span DAG "
                    "(parent + follows_from links).")
    parser.add_argument("trace_dir")
    parser.add_argument("--trace", default=None, metavar="ID",
                        help="narrow to one trace id")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    parser.add_argument("--check", action="store_true",
                        help="exit 2 when no request path can be "
                             "reconstructed (the smoke gate)")
    parser.add_argument("--budget", type=float, default=None,
                        metavar="PCT",
                        help="with --check: exit 4 when the queue-wait "
                             "share of request wall time exceeds PCT%%")
    parser.add_argument("--top", type=int, default=5,
                        help="slowest requests rendered")
    parser.add_argument("--latest", action="store_true",
                        help="treat TRACE_DIR as a root and pick the "
                             "newest trace dir under it")
    args = parser.parse_args(argv)

    try:
        trace_dir = resolve_trace_dir(args.trace_dir, args.latest)
        spans = read_spans(trace_dir)
    except OSError as e:
        print(f"flink-ml-tpu-torch-trace path: cannot read "
              f"{args.trace_dir}: {e}", file=sys.stderr)
        return EXIT_INVALID
    report = analyze_paths(spans, trace=args.trace)
    attach_device_ops(report, trace_dir)
    with pipe_guard():
        if args.json:
            print(json.dumps({"trace_dir": trace_dir,
                              "report": report}, indent=2,
                             default=str))
        else:
            print(render_paths(report, top_n=args.top))
    if args.check:
        if not report["requests"]["count"]:
            print(f"flink-ml-tpu-torch-trace path: no reconstructable "
                  f"request paths in {trace_dir} (no serving.submit/"
                  f"serving.resolve span pairs)", file=sys.stderr)
            return EXIT_INVALID
        if args.budget is not None:
            share = report["requests"]["queue_share"] or 0.0
            if share * 100.0 > args.budget:
                print(f"flink-ml-tpu-torch-trace path: queue-wait share "
                      f"{share:.1%} exceeds the {args.budget:g}% "
                      f"budget", file=sys.stderr)
                return EXIT_OVER_BUDGET
    return EXIT_OK


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
