"""torchlint command line (also installed as ``flink-ml-tpu-torch-lint``).

The port of ``flink_ml_tpu/analysis/cli.py``: the same flags and exit
codes. Exit codes: 0 = clean (every finding suppressed with a
justification), 1 = unsuppressed findings, 2 = usage error. The rule
catalogue and suppression syntax live in docs/torchlint.md.

Usage:
    python -m flink_ml_tpu_torch.analysis.cli flink_ml_tpu_torch/ \\
        chip_smoke.py scripts/port_*.py
        [--format text|json] [--output FILE] [--rules r1,r2]
        [--show-suppressed] [--list-rules] [--suppressions]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from flink_ml_tpu_torch.analysis.core import TOOL


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog=TOOL)
    parser.add_argument("paths", nargs="*",
                        help="files or directories to analyze")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--output", default=None,
                        help="also write the report (in --format) here")
    parser.add_argument("--rules", default=None,
                        help="comma-separated subset of rule names")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="include suppressed findings in text output")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--suppressions", action="store_true",
                        help="audit mode: list every suppression with "
                             "its justification, flag stale ones "
                             "(GitHub ::warning annotations), exit 0 "
                             "always — a report, not a gate")
    args = parser.parse_args(argv)

    from flink_ml_tpu_torch.analysis import Report, all_rules, analyze_paths

    if args.list_rules:
        for name, rule in sorted(all_rules().items()):
            print(f"{rule.code}  {name}: {rule.rationale}")
        return 0
    if not args.paths:
        parser.error("no paths given (or use --list-rules)")

    if args.suppressions:
        return _suppressions_report(args)

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    try:
        report = Report(analyze_paths(args.paths, rules))
    except ValueError as e:  # unknown rule name
        parser.error(str(e))

    rendered = report.render_json() if args.format == "json" \
        else report.render_text(show_suppressed=args.show_suppressed)
    print(rendered)
    if args.output:
        with open(args.output, "w") as f:
            f.write(rendered + "\n")
    return report.exit_code


def _suppressions_report(args) -> int:
    """The ``--suppressions`` audit: every justified silence in one
    place, stale ones flagged. Always exits 0 — a report, not a gate
    (the gate is the plain lint run, where ``unused-suppression`` is a
    blocking finding)."""
    from flink_ml_tpu_torch.analysis.core import collect_suppressions

    pairs = collect_suppressions(args.paths)
    stale = [(p, s) for p, s in pairs if not s.used]
    if args.format == "json":
        rendered = json.dumps({
            "suppressions": [
                {"path": p, "line": s.line, "rules": list(s.rules),
                 "justification": s.justification, "used": s.used}
                for p, s in pairs],
            "counts": {"total": len(pairs), "stale": len(stale)},
        }, indent=2)
    else:
        lines = []
        for p, s in pairs:
            mark = "     " if s.used else "STALE"
            lines.append(f"{mark} {p}:{s.line}: "
                         f"disable={','.join(s.rules)} -- "
                         f"{s.justification or '(no justification)'}")
        lines.append(f"{TOOL}: {len(pairs)} suppression(s), "
                     f"{len(stale)} stale")
        rendered = "\n".join(lines)
    print(rendered)
    if args.output:
        with open(args.output, "w") as f:
            f.write(rendered + "\n")
    # GitHub annotations for stale entries: visible on the PR without
    # failing the job (the blocking copy is unused-suppression)
    if os.environ.get("GITHUB_ACTIONS") == "true":
        for p, s in stale:
            print(f"::warning file={p},line={s.line}::stale {TOOL} "
                  f"suppression for {','.join(s.rules)} — no finding "
                  f"matches this line; delete it")
    return 0


if __name__ == "__main__":
    sys.exit(main())
