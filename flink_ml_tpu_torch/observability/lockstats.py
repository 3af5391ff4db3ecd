"""``flink-ml-tpu-torch-trace locks``: the lock watchdog's artifact view.

The port of ``flink_ml_tpu/observability/lockstats.py``. A lockcheck-armed
run (``FLINK_ML_TPU_LOCKCHECK=1``, ``common/locks.py``) dumps one
``locks-<suffix>.json`` per process beside its metrics snapshots: the
acquisition-order graph, detected cycles, per-lock hold times and long
holds. This view merges every dump in a trace dir:

- per-lock table: acquires, mean/max hold;
- the acquisition-order edges (outer -> inner, with counts);
- cycles: those each process detected live, plus any that appear only in
  the merged graph (two processes acquiring in opposite orders);
- the ``ml.lock`` / ``ml.thread`` event timeline from the spans.

With ``--check`` it exits 4 on any cycle or long hold and 2 when the dir
holds no lock telemetry at all; otherwise 0 (2 without telemetry).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

from flink_ml_tpu_torch.common.locks import LOCKS_GLOB
from flink_ml_tpu_torch.observability.exporters import (
    pipe_guard,
    read_spans,
    resolve_trace_dir,
)


def read_lock_dumps(trace_dir: str) -> List[dict]:
    """Every parseable ``locks-*.json`` in ``trace_dir`` (torn files
    are skipped — an armed run that crashed mid-dump must still
    report)."""
    out = []
    for path in sorted(glob.glob(os.path.join(trace_dir, LOCKS_GLOB))):
        try:
            with open(path, "r", encoding="utf-8") as f:
                out.append(json.load(f))
        except (OSError, json.JSONDecodeError):
            continue
    return out


def merge_dumps(dumps: List[dict]) -> dict:
    """One cross-process view: edges/acquires/long-holds sum, hold
    stats fold, cycles union (deduped by their edge set)."""
    edges: Dict[Tuple[str, str], int] = {}
    acquires: Dict[str, int] = {}
    holds: Dict[str, dict] = {}
    cycles: List[List[str]] = []
    cycle_keys = set()
    long_holds: List[dict] = []
    long_hold_total = 0
    threshold = None
    for dump in dumps:
        threshold = dump.get("threshold_ms", threshold)
        for a, b, n in dump.get("edges", ()):
            edges[(a, b)] = edges.get((a, b), 0) + int(n)
        for name, n in dump.get("acquires", {}).items():
            acquires[name] = acquires.get(name, 0) + int(n)
        for name, rec in dump.get("holds", {}).items():
            cur = holds.get(name)
            if cur is None:
                holds[name] = {"sum": float(rec.get("sum", 0.0)),
                               "count": int(rec.get("count", 0)),
                               "max_ms": float(rec.get("max_ms", 0.0))}
            else:
                cur["sum"] += float(rec.get("sum", 0.0))
                cur["count"] += int(rec.get("count", 0))
                cur["max_ms"] = max(cur["max_ms"],
                                    float(rec.get("max_ms", 0.0)))
        for path in dump.get("cycles", ()):
            sig = frozenset(zip(path, path[1:]))
            if sig not in cycle_keys:
                cycle_keys.add(sig)
                cycles.append(list(path))
        long_holds.extend(dump.get("long_holds", ()))
        long_hold_total += int(dump.get("long_hold_total", 0))
    # cycles visible only in the MERGED graph (cross-process hazard)
    for cycle in _graph_cycles(edges):
        sig = frozenset(zip(cycle, cycle[1:]))
        if sig not in cycle_keys:
            cycle_keys.add(sig)
            cycles.append(cycle)
    return {"threshold_ms": threshold, "edges": edges,
            "acquires": acquires, "holds": holds, "cycles": cycles,
            "long_holds": long_holds,
            "long_hold_total": long_hold_total}


def _graph_cycles(edges: Dict[Tuple[str, str], int]) -> List[List[str]]:
    """Simple cycles in the merged order graph (each reported once,
    from its lexicographically-smallest node)."""
    succ: Dict[str, List[str]] = {}
    for (a, b) in edges:
        succ.setdefault(a, []).append(b)
    out: List[List[str]] = []
    seen_sigs = set()
    for start in sorted(succ):
        stack: List[Tuple[str, List[str]]] = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(succ.get(node, ())):
                if nxt == start:
                    cycle = path + [start]
                    if min(cycle) != start:
                        continue  # reported from its smallest node
                    sig = frozenset(zip(cycle, cycle[1:]))
                    if sig not in seen_sigs:
                        seen_sigs.add(sig)
                        out.append(cycle)
                elif nxt not in path and nxt > start:
                    stack.append((nxt, path + [nxt]))
    return out


def lock_events(spans: List[dict]) -> List[dict]:
    """``ml.lock`` / ``ml.thread`` instants from the span records, in
    time order — the when/where of each cycle, long hold and thread
    crash."""
    out = []
    for sp in spans:
        for ev in sp.get("events", ()):
            if ev.get("name") in ("ml.lock", "ml.thread"):
                out.append({"ts_us": ev.get("ts_us", 0),
                            "name": ev["name"],
                            "attrs": ev.get("attrs", {})})
    out.sort(key=lambda r: r["ts_us"])
    return out


def report(trace_dir: str) -> Optional[dict]:
    """The merged lock report for ``trace_dir``; None when the dir holds
    no lock telemetry (no dumps and no ml.lock events)."""
    dumps = read_lock_dumps(trace_dir)
    try:
        spans = read_spans(trace_dir)
    except OSError:
        spans = []
    events = lock_events(spans)
    if not dumps and not events:
        return None
    merged = merge_dumps(dumps)
    return {
        "processes": len(dumps),
        "threshold_ms": merged["threshold_ms"],
        "locks": {
            name: {
                "acquires": merged["acquires"].get(name, 0),
                "mean_hold_ms": round(rec["sum"] / rec["count"], 3)
                if rec["count"] else 0.0,
                "max_hold_ms": round(rec["max_ms"], 3),
            }
            for name, rec in sorted(merged["holds"].items())
        },
        "edges": [{"outer": a, "inner": b, "count": n}
                  for (a, b), n in sorted(merged["edges"].items())],
        "cycles": merged["cycles"],
        "long_holds": merged["long_holds"],
        "long_hold_total": merged["long_hold_total"],
        "events": events,
    }


def render(rep: dict) -> str:
    out = [f"lock watchdog: {rep['processes']} process dump(s), "
           f"long-hold threshold "
           f"{rep['threshold_ms'] if rep['threshold_ms'] is not None else '?'} ms"]
    if rep["locks"]:
        out.append("")
        out.append(f"  {'lock':<36} {'acquires':>9} {'mean ms':>9} "
                   f"{'max ms':>9}")
        for name, row in rep["locks"].items():
            out.append(f"  {name:<36} {row['acquires']:>9} "
                       f"{row['mean_hold_ms']:>9.3f} "
                       f"{row['max_hold_ms']:>9.3f}")
    if rep["edges"]:
        out.append("")
        out.append("acquisition order (outer -> inner):")
        for e in rep["edges"]:
            out.append(f"  {e['outer']} -> {e['inner']}  x{e['count']}")
    if rep["cycles"]:
        out.append("")
        out.append("CYCLES (potential deadlocks):")
        for cycle in rep["cycles"]:
            out.append("  " + " -> ".join(cycle))
    if rep["long_hold_total"]:
        out.append("")
        out.append(f"long holds: {rep['long_hold_total']} over threshold")
        for rec in rep["long_holds"][:10]:
            out.append(f"  {rec.get('lock')}: {rec.get('hold_ms')} ms")
    if rep["events"]:
        out.append("")
        out.append("event timeline:")
        t0 = rep["events"][0]["ts_us"]
        for ev in rep["events"]:
            attrs = " ".join(f"{k}={v}"
                             for k, v in ev.get("attrs", {}).items())
            out.append(f"  +{(ev['ts_us'] - t0) / 1000.0:>10.3f} ms  "
                       f"{ev['name']}  {attrs}".rstrip())
    if not rep["cycles"] and not rep["long_hold_total"]:
        out.append("")
        out.append("no cycles, no long holds — lock discipline held")
    return "\n".join(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="flink-ml-tpu-torch-trace locks",
        description="Merged lock-watchdog view of a trace dir "
                    "(FLINK_ML_TPU_LOCKCHECK-armed run).")
    parser.add_argument("trace_dir")
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--check", action="store_true",
                        help="exit 4 on any recorded cycle or long "
                             "hold, 2 when the dir has no lock "
                             "telemetry at all")
    parser.add_argument("--latest", action="store_true",
                        help="treat TRACE_DIR as a root and pick the "
                             "newest trace dir under it")
    args = parser.parse_args(argv)

    try:
        trace_dir = resolve_trace_dir(args.trace_dir, args.latest)
    except OSError as e:
        print(f"locks: {e}", file=sys.stderr)
        return 2
    rep = report(trace_dir)
    if rep is None:
        print(f"locks: no lock telemetry in {trace_dir} — was the run "
              f"armed with FLINK_ML_TPU_LOCKCHECK=1?", file=sys.stderr)
        return 2
    with pipe_guard():
        if args.json:
            print(json.dumps(rep, indent=2, default=str))
        else:
            print(render(rep))
    if args.check and (rep["cycles"] or rep["long_hold_total"]):
        print(f"locks: {len(rep['cycles'])} cycle(s), "
              f"{rep['long_hold_total']} long hold(s) — failing the "
              f"gate", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
