"""``flink-ml-tpu-torch-trace diff``: compare two trace dirs (or metrics
snapshots) and gate perf regressions from artifacts alone.

The port of ``flink_ml_tpu/observability/diff.py``. A trace dir is the
``FLINK_ML_TPU_TRACE_DIR`` artifact set (``spans-*.jsonl`` +
``metrics-*.json``, either package's); a side may also be one
registry-snapshot JSON file. The diff reports:

- **per-span-name self-time deltas** (span duration minus direct
  children, aggregated by name: where work actually happened),
- **histogram-quantile deltas** (q50/q90/q99 of every registry
  histogram, labeled series kept apart),
- **compile-count deltas**: the ``ml.compile`` counters and the totals
  ``compilestats.compile_totals_from_snapshot`` reads. In the port these
  count ``nvcc`` builds of the CUDA sources; a library found already built
  counts 0 (``cached``). So a cold build dir against a warm one differs by
  one build a source, which trips the +2 floor below: diff two warm runs,
- **per-phase compile-time deltas** (the ``ml.compile
  phaseMs{phase=...}`` histograms a JAX package snapshot carries),
- **per-kernel efficiency rows** when a ``profile.json`` sits beside a
  side's artifacts (``observability/profiling.py``): measured device ms
  and roofline share, reported and never gated (the floor is
  ``flink-ml-tpu-torch-trace efficiency --check``'s).

``--budget <pct>`` turns the report into a regression gate: exit
:data:`EXIT_BUDGET` (4) when side B regresses side A beyond the budget.
Gated: per-span-name self-time (with a ``--min-ms`` absolute noise
floor, default 5 ms) and the total compile count (floor: +2 compiles).
Histogram quantiles are reported but not gated. Exit codes: 0 within
budget or no budget given, 2 unreadable or empty side, 4 budget exceeded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
from typing import Dict, List, Optional

from flink_ml_tpu_torch.common.metrics import histogram_quantile
from flink_ml_tpu_torch.observability.compilestats import (
    compile_totals_from_snapshot,
)
from flink_ml_tpu_torch.observability.exporters import read_metrics, read_spans

EXIT_OK = 0
EXIT_INVALID = 2
#: the budget exit code (the class of slo/drift/quality gates)
EXIT_BUDGET = 4

QUANTILES = (0.5, 0.9, 0.99)

#: default absolute self-time noise floor (ms) under which no span-level
#: delta can gate, whatever its percentage
DEFAULT_MIN_MS = 5.0

#: compile-count gate floor: B must add at least this many compiles over
#: A before the percentage budget can fire (one stray compile is noise)
COMPILE_COUNT_FLOOR = 2


# -- span aggregation (shared with cli.summarize) -----------------------------
def aggregate_self_time(spans: List[dict]) -> Dict[str, dict]:
    """``name → {count, total_us, self_us}`` where self-time is a span's
    duration minus its direct children's — the quantity worth diffing
    (total time double-counts every level of nesting)."""
    by_id = {sp["id"]: sp for sp in spans if sp.get("id")}
    child_dur: Dict[str, int] = {}
    for sp in spans:
        parent = sp.get("parent")
        if parent in by_id:
            child_dur[parent] = (child_dur.get(parent, 0)
                                 + (sp.get("dur_us") or 0))
    agg: Dict[str, dict] = {}
    for sp in spans:
        dur = sp.get("dur_us") or 0
        row = agg.setdefault(sp.get("name", "?"),
                             {"count": 0, "total_us": 0, "self_us": 0})
        row["count"] += 1
        row["total_us"] += dur
        row["self_us"] += max(0, dur - child_dur.get(sp.get("id"), 0))
    return agg


# -- side loading -------------------------------------------------------------
def load_side(path: str) -> dict:
    """One diff side: a trace directory, or a metrics-snapshot JSON
    file. Raises ValueError when the side holds no readable artifact —
    an empty side must be EXIT_INVALID, never a vacuous 'no regression'."""
    if os.path.isdir(path):
        spans = read_spans(path)
        snap = read_metrics(path)
        if not spans and not snap:
            raise ValueError(
                f"{path}: no spans-*.jsonl or metrics-*.json artifacts")
        # per-fn efficiency rides along when a profile.json sits beside
        # the artifacts (observability/profiling.py) — so the diff can
        # tell "slower because lower utilization" from "slower because
        # more work". Best-effort: most sides have no profile
        eff: Dict[str, dict] = {}
        try:
            from flink_ml_tpu_torch.observability import profiling

            report = profiling.efficiency_report(path, snapshot=snap)
            eff = {row["fn"]: row for row in report["fns"]}
        except Exception:  # noqa: BLE001 — optional evidence
            pass
        return {"spans": aggregate_self_time(spans), "metrics": snap,
                "efficiency": eff}
    with open(path, "r", encoding="utf-8") as f:
        snap = json.load(f)
    if not isinstance(snap, dict) or not snap:
        raise ValueError(f"{path}: not a metrics snapshot")
    return {"spans": {}, "metrics": snap, "efficiency": {}}


# -- delta computation --------------------------------------------------------
_PHASE_KEY = re.compile(r'^phaseMs\{phase="((?:[^"\\]|\\.)*)"\}$')


def _phase_totals(snap: Optional[dict]) -> Dict[str, dict]:
    """``phase → {count, ms}`` from a snapshot's ``ml.compile``
    ``phaseMs{phase="..."}`` histograms (count + summed ms — the
    per-phase channels of a JAX package snapshot; the port writes none)."""
    out: Dict[str, dict] = {}
    hists = ((snap or {}).get("ml.compile") or {}).get("histograms", {})
    for key, hist in hists.items():
        m = _PHASE_KEY.match(key)
        if not m:
            continue
        out[m.group(1)] = {"count": int(hist.get("count", 0)),
                           "ms": float(hist.get("sum", 0.0))}
    return out


def _pct(a: float, b: float) -> Optional[float]:
    if a <= 0:
        return None if b <= 0 else math.inf
    return (b - a) / a * 100.0


def diff_profiles(a: dict, b: dict) -> dict:
    """Structured deltas between two loaded sides (B relative to A)."""
    span_rows = []
    for name in sorted(set(a["spans"]) | set(b["spans"])):
        empty = {"count": 0, "total_us": 0, "self_us": 0}
        ra = a["spans"].get(name, empty)
        rb = b["spans"].get(name, empty)
        a_ms = ra["self_us"] / 1000.0
        b_ms = rb["self_us"] / 1000.0
        span_rows.append({"name": name,
                          "a_count": ra["count"], "b_count": rb["count"],
                          "a_self_ms": round(a_ms, 3),
                          "b_self_ms": round(b_ms, 3),
                          "delta_ms": round(b_ms - a_ms, 3),
                          "delta_pct": _pct(a_ms, b_ms)})
    span_rows.sort(key=lambda r: -abs(r["delta_ms"]))

    hist_rows = []
    ma, mb = a["metrics"] or {}, b["metrics"] or {}
    for group in sorted(set(ma) | set(mb)):
        ha = (ma.get(group) or {}).get("histograms", {})
        hb = (mb.get(group) or {}).get("histograms", {})
        for key in sorted(set(ha) | set(hb)):
            sa, sb = ha.get(key), hb.get(key)
            row = {"group": group, "key": key,
                   "a_count": int((sa or {}).get("count", 0)),
                   "b_count": int((sb or {}).get("count", 0)),
                   "quantiles": {}}
            for q in QUANTILES:
                qa = histogram_quantile(sa, q) if sa else float("nan")
                qb = histogram_quantile(sb, q) if sb else float("nan")
                row["quantiles"][f"q{int(q * 100)}"] = {
                    "a": None if math.isnan(qa) else round(qa, 3),
                    "b": None if math.isnan(qb) else round(qb, 3),
                    "delta_pct": (None if math.isnan(qa) or math.isnan(qb)
                                  else _pct(qa, qb))}
            hist_rows.append(row)

    compile_rows = []
    ca = (ma.get("ml.compile") or {}).get("counters", {})
    cb = (mb.get("ml.compile") or {}).get("counters", {})
    for key in sorted(set(ca) | set(cb)):
        va, vb = int(ca.get(key, 0)), int(cb.get(key, 0))
        compile_rows.append({"key": key, "a": va, "b": vb,
                             "delta": vb - va})
    totals_a = compile_totals_from_snapshot(ma)
    totals_b = compile_totals_from_snapshot(mb)

    # per-phase compile-time deltas (ml.compile phaseMs{phase=...}):
    # count AND summed ms per monitoring phase, so "more compiles" and
    # "slower compiles" read as distinct findings
    pa, pb = _phase_totals(ma), _phase_totals(mb)
    phase_rows = []
    for phase in sorted(set(pa) | set(pb)):
        ra = pa.get(phase, {"count": 0, "ms": 0.0})
        rb = pb.get(phase, {"count": 0, "ms": 0.0})
        phase_rows.append({
            "phase": phase,
            "a_count": ra["count"], "b_count": rb["count"],
            "a_ms": round(ra["ms"], 3), "b_ms": round(rb["ms"], 3),
            "delta_ms": round(rb["ms"] - ra["ms"], 3),
            "delta_pct": _pct(ra["ms"], rb["ms"])})
    phase_rows.sort(key=lambda r: -abs(r["delta_ms"]))

    # per-fn efficiency deltas (profile.json sides only): measured
    # device ms + roofline utilization — reported, never gated (the
    # efficiency gate is `flink-ml-tpu-torch-trace efficiency --check`, with real floors)
    ea, eb = a.get("efficiency") or {}, b.get("efficiency") or {}
    eff_rows = []
    for fn in sorted(set(ea) | set(eb)):
        ra, rb = ea.get(fn) or {}, eb.get(fn) or {}
        eff_rows.append({
            "fn": fn,
            "a_device_ms": ra.get("deviceMs"),
            "b_device_ms": rb.get("deviceMs"),
            "a_utilization": ra.get("utilization"),
            "b_utilization": rb.get("utilization"),
            "a_achieved_flops": ra.get("achievedFlops"),
            "b_achieved_flops": rb.get("achievedFlops"),
            "bound": rb.get("bound") or ra.get("bound")})

    return {"spans": span_rows, "histograms": hist_rows,
            "compile": compile_rows,
            "compile_phases": phase_rows,
            "efficiency": eff_rows,
            "compile_totals": {"a": totals_a, "b": totals_b},
            # span gating needs span data on BOTH sides: against a
            # metrics-only side (a snapshot file, or a dir that captured
            # no spans) every B span would read as an infinite-percent
            # regression and the budget would always fire
            "spans_comparable": bool(a["spans"]) and bool(b["spans"])}


def violations(diff: dict, budget_pct: float,
               min_ms: float = DEFAULT_MIN_MS) -> List[dict]:
    """The gated regressions in ``diff`` exceeding ``budget_pct``."""
    out = []
    for row in diff["spans"] if diff.get("spans_comparable") else ():
        regress_ms = row["b_self_ms"] - row["a_self_ms"]
        if regress_ms < min_ms:
            continue
        pct = row["delta_pct"]
        if pct is not None and pct > budget_pct:
            out.append({"kind": "span-self-time", "name": row["name"],
                        "a_ms": row["a_self_ms"], "b_ms": row["b_self_ms"],
                        "delta_pct": (None if math.isinf(pct)
                                      else round(pct, 1))})
    ta = diff["compile_totals"]["a"]["count"]
    tb = diff["compile_totals"]["b"]["count"]
    if tb - ta >= COMPILE_COUNT_FLOOR:
        pct = _pct(float(ta), float(tb))
        if pct is not None and pct > budget_pct:
            out.append({"kind": "compile-count", "name": "backend compiles",
                        "a": ta, "b": tb,
                        "delta_pct": (None if math.isinf(pct)
                                      else round(pct, 1))})
    return out


# -- rendering ----------------------------------------------------------------
def _fmt_pct(pct: Optional[float]) -> str:
    if pct is None:
        return "  —   "
    if math.isinf(pct):
        return "  new "
    return f"{pct:+7.1f}%"


def render_diff(diff: dict, viol: List[dict], top_n: int = 15) -> str:
    out = ["span self-time deltas (B vs A):",
           f"  {'name':<32} {'A ms':>10} {'B ms':>10} {'delta':>10} "
           f"{'pct':>8}"]
    for row in diff["spans"][:top_n]:
        out.append(f"  {row['name']:<32} {row['a_self_ms']:>10.3f} "
                   f"{row['b_self_ms']:>10.3f} {row['delta_ms']:>+10.3f} "
                   f"{_fmt_pct(row['delta_pct'])}")
    if not diff["spans"]:
        out.append("  (no spans on either side)")
    elif not diff.get("spans_comparable"):
        out.append("  (one side has no span data — self-time deltas "
                   "reported but not gated)")

    hists = [r for r in diff["histograms"]
             if r["a_count"] or r["b_count"]]
    if hists:
        out.append("")
        out.append("histogram quantile deltas (reported, not gated):")
        for row in hists[:top_n]:
            qs = "  ".join(
                f"{q}: {v['a']}→{v['b']}"
                for q, v in row["quantiles"].items()
                if v["a"] is not None or v["b"] is not None)
            out.append(f"  {row['group']}:{row['key']}  "
                       f"count {row['a_count']}→{row['b_count']}  {qs}")

    ct = diff["compile_totals"]
    out.append("")
    out.append(f"compile totals: count {ct['a']['count']}→"
               f"{ct['b']['count']}, time "
               f"{ct['a']['timeMs']:.1f}→{ct['b']['timeMs']:.1f} ms")
    for row in diff["compile"][:top_n]:
        if row["delta"]:
            out.append(f"  {row['key']}: {row['a']}→{row['b']} "
                       f"({row['delta']:+d})")
    phases = [r for r in diff.get("compile_phases", ())
              if r["a_count"] or r["b_count"]]
    if phases:
        out.append("per-phase compile time (count / ms — 'more compiles'"
                   " vs 'slower compiles'):")
        for row in phases[:top_n]:
            out.append(
                f"  {row['phase']}: {row['a_count']}→{row['b_count']} "
                f"compiles, {row['a_ms']:.1f}→{row['b_ms']:.1f} ms "
                f"({row['delta_ms']:+.1f} ms, "
                f"{_fmt_pct(row['delta_pct']).strip()})")

    effs = diff.get("efficiency") or ()
    if effs:
        out.append("")
        out.append("per-fn efficiency (measured device ms / roofline "
                   "utilization — reported, not gated):")
        for row in effs[:top_n]:
            ua, ub = row["a_utilization"], row["b_utilization"]
            out.append(
                "  {}: deviceMs {}→{}  util {}→{}  bound={}".format(
                    row["fn"],
                    "—" if row["a_device_ms"] is None
                    else f"{row['a_device_ms']:.3f}",
                    "—" if row["b_device_ms"] is None
                    else f"{row['b_device_ms']:.3f}",
                    "—" if ua is None else f"{ua * 100.0:.1f}%",
                    "—" if ub is None else f"{ub * 100.0:.1f}%",
                    row["bound"] or "—"))

    if viol:
        out.append("")
        out.append("BUDGET EXCEEDED:")
        for v in viol:
            out.append(f"  {v['kind']}: {v['name']}  "
                       + " ".join(f"{k}={val}" for k, val in v.items()
                                  if k not in ("kind", "name")))
    return "\n".join(out)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="flink-ml-tpu-torch-trace diff",
        description="Diff two trace dirs / metrics snapshots; with "
                    "--budget, gate regressions (exit 4).")
    parser.add_argument("a", help="baseline: trace dir or metrics JSON")
    parser.add_argument("b", help="candidate: trace dir or metrics JSON")
    parser.add_argument("--budget", type=float, default=None, metavar="PCT",
                        help="fail (exit 4) when B regresses A beyond "
                             "PCT%% on a gated quantity")
    parser.add_argument("--min-ms", type=float, default=DEFAULT_MIN_MS,
                        help="absolute span self-time delta (ms) below "
                             "which the budget never fires "
                             f"(default {DEFAULT_MIN_MS})")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--top", type=int, default=15,
                        help="rows per section in text output")
    parser.add_argument("--latest", action="store_true",
                        help="treat each directory side as a root and "
                             "pick the newest trace dir under it "
                             "(snapshot-file sides pass through)")
    args = parser.parse_args(argv)

    try:
        from flink_ml_tpu_torch.observability.exporters import (
            resolve_trace_dir,
        )

        if args.latest:
            if os.path.isdir(args.a):
                args.a = resolve_trace_dir(args.a, True)
            if os.path.isdir(args.b):
                args.b = resolve_trace_dir(args.b, True)
        side_a = load_side(args.a)
        side_b = load_side(args.b)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"flink-ml-tpu-torch-trace diff: {e}", file=sys.stderr)
        return EXIT_INVALID

    diff = diff_profiles(side_a, side_b)
    viol = (violations(diff, args.budget, args.min_ms)
            if args.budget is not None else [])

    from flink_ml_tpu_torch.observability.exporters import pipe_guard

    with pipe_guard():  # a closed `| head` pipe must not mask the gate
        if args.format == "json":
            print(json.dumps({"diff": diff, "violations": viol,
                              "budget_pct": args.budget}, indent=2,
                             default=str))
        else:
            print(render_diff(diff, viol, top_n=args.top))
    return EXIT_BUDGET if viol else EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
