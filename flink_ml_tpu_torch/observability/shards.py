"""``flink-ml-tpu-torch-trace shards``: the per-shard view of a trace dir.

The port of ``flink_ml_tpu/observability/shards.py``. Renders the mesh
telemetry (``observability/meshstats.py``) from the artifacts alone:

- the mesh topology (``mesh.json``): shard count, axis layout, platform;
- one row per shard: real rows held, non-finite input elements,
  time-to-ready quantiles (the straggler surface), bytes reduced per
  collective round, and whether an ``ml.skew`` event flagged the shard;
- the collective structure: the JAX package's traced-site counts (the
  port runs eagerly and records none) and the host-op timings;
- the skew event timeline.

``--check`` exits 2 when the dir holds no telemetry of a mesh of at least
:data:`MIN_DEVICES` shards: the gate that a multi-shard run really ran on
several shards.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from flink_ml_tpu_torch.common.metrics import histogram_quantile

#: gates --check: a multi-device trace must have recorded a mesh of at
#: least this many devices or per-shard series for them
MIN_DEVICES = 2


def _labeled(entries: Dict[str, object], name: str):
    """``(labels_dict, value)`` for every key of metric ``name``."""
    from flink_ml_tpu_torch.observability.health import _parse_labels

    for key, value in entries.items():
        base, _, rest = key.partition("{")
        if base == name:
            yield _parse_labels(rest[:-1] if rest else ""), value


def shards_summary(spans: List[dict], snapshot: Dict[str, dict],
                   mesh: Optional[dict]) -> dict:
    """Structured per-device summary (the CLI's JSON output)."""
    shard_group = snapshot.get("ml.shard", {}) or {}
    coll_group = snapshot.get("ml.collective", {}) or {}

    rows: Dict[str, dict] = {}

    def row(shard: str, device: str) -> dict:
        return rows.setdefault(shard, {"shard": int(shard),
                                       "device": device})

    for labels, value in _labeled(shard_group.get("gauges", {}), "rows"):
        if "shard" in labels:
            row(labels["shard"], labels.get("device", "?"))["rows"] = \
                int(value)
    for labels, value in _labeled(shard_group.get("gauges", {}),
                                  "nonFinite"):
        if "shard" in labels:
            r = row(labels["shard"], labels.get("device", "?"))
            r["nonFinite"] = r.get("nonFinite", 0) + int(value)
    for labels, hist in _labeled(shard_group.get("histograms", {}),
                                 "readyMs"):
        if "shard" not in labels or not hist.get("count"):
            continue
        r = row(labels["shard"], labels.get("device", "?"))
        r["readyCount"] = r.get("readyCount", 0) + int(hist["count"])
        p50 = histogram_quantile(hist, 0.5)
        mx = histogram_quantile(hist, 1.0)
        r["readyMs_p50"] = max(r.get("readyMs_p50", 0.0),
                               0.0 if math.isnan(p50) else round(p50, 3))
        r["readyMs_max"] = max(r.get("readyMs_max", 0.0),
                               0.0 if math.isnan(mx) else round(mx, 3))

    # skew: per-kind spread gauges + the event timeline; flag the shard
    # each event blamed
    skew = {}
    for labels, value in _labeled(shard_group.get("gauges", {}), "skew"):
        skew[labels.get("kind", "?")] = value
    events = []
    for sp in spans:
        for ev in sp.get("events", ()):
            if ev.get("name") == "ml.skew":
                events.append({"ts_us": ev.get("ts_us", 0),
                               "attrs": ev.get("attrs", {})})
    events.sort(key=lambda e: e["ts_us"])
    for ev in events:
        shard = str(ev["attrs"].get("shard", ""))
        if shard in rows:
            rows[shard]["skewFlagged"] = True

    # collective program structure: traced sites + host-boundary timing
    collectives = []
    payload = {key: hist for key, hist
               in coll_group.get("histograms", {}).items()}
    for labels, count in _labeled(coll_group.get("counters", {}),
                                  "tracedOps"):
        from flink_ml_tpu_torch.common.metrics import metric_key

        hist = payload.get(metric_key("payloadBytes", labels))
        entry = {"op": labels.get("op", "?"),
                 "axis": labels.get("axis", "?"),
                 "devices": labels.get("devices", "?"),
                 "tracedSites": int(count)}
        if hist and hist.get("count"):
            entry["payloadBytes_p50"] = round(
                histogram_quantile(hist, 0.5), 1)
            entry["payloadBytes_total"] = int(hist.get("sum", 0))
        collectives.append(entry)
    collectives.sort(key=lambda e: (e["op"], e["axis"]))

    host_ops = []
    for labels, hist in _labeled(coll_group.get("histograms", {}),
                                 "opMs"):
        if not hist.get("count"):
            continue
        host_ops.append({"op": labels.get("op", "?"),
                         "devices": labels.get("devices", "?"),
                         "count": int(hist["count"]),
                         "ms_p50": round(histogram_quantile(hist, 0.5), 3),
                         "ms_p99": round(histogram_quantile(hist, 0.99),
                                         3)})
    host_ops.sort(key=lambda e: e["op"])

    # bytes reduced per device: the sum of traced reduction-site
    # payloads (per-shard shapes). SPMD collectives move the same
    # per-shard volume through every device, so this column is identical
    # across rows BY CONSTRUCTION — it says how much each device
    # contributes to a reduction pass, not a per-device differential
    reduce_bytes = sum(
        e.get("payloadBytes_total", 0) for e in collectives
        if e["op"] in ("psum", "pmean", "pmax", "broadcast",
                       "termination_vote"))
    # process attribution: mesh.json records each shard's owning process
    # (meshstats.mesh_snapshot), so a merged multi-process trace resolves
    # every shard row to the process that ran it. A JAX package mesh
    # names a distinct device per shard and is looked up by device id;
    # the port's shards may share a device (virtual shards, or one CPU
    # device per rank), and its devices list is in shard order
    devices = (mesh or {}).get("devices", [])
    procs = [int(d.get("process", 0)) for d in devices]
    ids = [str(d.get("id")) for d in devices]
    by_id = len(set(ids)) == len(ids)
    dev_proc = dict(zip(ids, procs))
    n_procs = len(set(procs)) if procs else 1

    shard_rows = sorted(rows.values(), key=lambda r: r["shard"])
    for r in shard_rows:
        r.setdefault("rows", None)
        r.setdefault("nonFinite", 0)
        r["bytesReduced"] = reduce_bytes
        r.setdefault("skewFlagged", False)
        if by_id:
            r["process"] = dev_proc.get(str(r.get("device")), 0)
        else:
            r["process"] = (procs[r["shard"]] if r["shard"] < len(procs)
                            else 0)

    return {"mesh": mesh, "shards": shard_rows, "skew": skew,
            "skew_events": events, "collectives": collectives,
            "host_ops": host_ops, "process_count": n_procs}


def render_shards(summary: dict) -> str:
    out = []
    mesh = summary["mesh"]
    multiproc = summary.get("process_count", 1) > 1
    if mesh:
        axes = ",".join(f"{k}={v}" for k, v in mesh["shape"].items())
        procs = (f" processes={summary['process_count']}"
                 if multiproc else "")
        out.append(f"mesh: {mesh['device_count']} device(s) "
                   f"[{axes}] platform={mesh.get('platform')}{procs}")
    else:
        out.append("mesh: no mesh.json artifact (single-device run, or "
                   "trace predates mesh telemetry)")

    if summary["shards"]:
        out.append("")
        proc_hdr = f" {'proc':>5}" if multiproc else ""
        out.append(f"  {'shard':>5} {'device':>6}{proc_hdr} {'rows':>10} "
                   f"{'non-finite':>10} {'ready p50':>10} "
                   f"{'ready max':>10} {'bytes reduced':>13} {'skew':>5}")
        for r in summary["shards"]:
            proc_col = f" {r.get('process', 0):>5}" if multiproc else ""
            out.append(
                f"  {r['shard']:>5} {r['device']:>6}{proc_col} "
                f"{('-' if r['rows'] is None else r['rows']):>10} "
                f"{r['nonFinite']:>10} "
                f"{r.get('readyMs_p50', '-'):>10} "
                f"{r.get('readyMs_max', '-'):>10} "
                f"{r['bytesReduced']:>13} "
                f"{'!' if r['skewFlagged'] else '':>5}")

    if summary["skew"]:
        out.append("")
        out.append("skew (max/median per series):")
        for kind, value in sorted(summary["skew"].items()):
            out.append(f"  {kind}: "
                       f"{'inf' if value == -1.0 else round(value, 2)}")

    if summary["collectives"]:
        out.append("")
        out.append("collective sites (trace-time program structure):")
        for e in summary["collectives"]:
            extra = ""
            if "payloadBytes_p50" in e:
                extra = (f"  payload p50 {e['payloadBytes_p50']} B, "
                         f"total {e['payloadBytes_total']} B")
            out.append(f"  {e['op']} over {e['axis']} "
                       f"({e['devices']} devices): {e['tracedSites']} "
                       f"traced site(s){extra}")

    if summary["host_ops"]:
        out.append("")
        out.append("host-boundary collective ops:")
        for e in summary["host_ops"]:
            out.append(f"  {e['op']} ({e['devices']} devices): "
                       f"{e['count']}x  p50 {e['ms_p50']} ms  "
                       f"p99 {e['ms_p99']} ms")

    if summary["skew_events"]:
        out.append("")
        out.append("skew event timeline:")
        t0 = summary["skew_events"][0]["ts_us"]
        for ev in summary["skew_events"]:
            attrs = " ".join(f"{k}={v}" for k, v in ev["attrs"].items())
            out.append(f"  +{(ev['ts_us'] - t0) / 1000.0:>10.3f} ms  "
                       f"ml.skew  {attrs}")
    return "\n".join(out)


def main(argv=None) -> int:
    """``flink-ml-tpu-torch-trace shards <dir>`` — per-device table + mesh
    topology + collective structure. ``--check`` exits 2 when the trace
    recorded no multi-device telemetry (mesh of ≥2 devices or per-shard
    series)."""
    import argparse
    import json
    import sys

    from flink_ml_tpu_torch.observability.exporters import (
        pipe_guard,
        read_metrics,
        read_spans,
        resolve_trace_dir,
    )
    from flink_ml_tpu_torch.observability.meshstats import read_mesh

    parser = argparse.ArgumentParser(
        prog="flink-ml-tpu-torch-trace shards",
        description="Per-device/per-shard view of a FLINK_ML_TPU_TRACE_"
                    "DIR: mesh topology, row/ready/skew table, "
                    "collective structure.")
    parser.add_argument("trace_dir")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable output")
    parser.add_argument("--check", action="store_true",
                        help="exit 2 unless the trace recorded a "
                             "multi-device mesh or per-shard series")
    parser.add_argument("--latest", action="store_true",
                        help="treat TRACE_DIR as a root and pick the "
                             "newest trace dir under it")
    args = parser.parse_args(argv)

    try:
        args.trace_dir = resolve_trace_dir(args.trace_dir, args.latest)
        spans = read_spans(args.trace_dir)
    except OSError as e:
        print(f"flink-ml-tpu-torch-trace shards: cannot read "
              f"{args.trace_dir}: {e}", file=sys.stderr)
        return 2
    snapshot = read_metrics(args.trace_dir)
    mesh = read_mesh(args.trace_dir)
    summary = shards_summary(spans, snapshot, mesh)

    if args.check:
        # a 1-device fallback run still records shard=0 series, so the
        # per-shard row count must ALSO clear the multi-device bar
        multi = ((mesh or {}).get("device_count", 0) >= MIN_DEVICES
                 or len(summary["shards"]) >= MIN_DEVICES)
        if not multi:
            print(f"flink-ml-tpu-torch-trace shards: no multi-device telemetry "
                  f"in {args.trace_dir} (mesh: "
                  f"{(mesh or {}).get('device_count', 'absent')} "
                  f"device(s), {len(summary['shards'])} per-shard "
                  "series)", file=sys.stderr)
            return 2

    with pipe_guard():
        if args.json:
            print(json.dumps(summary, indent=2, default=str))
        else:
            print(render_shards(summary))
    return 0


if __name__ == "__main__":  # pragma: no cover
    import sys

    sys.exit(main())
