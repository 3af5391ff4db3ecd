"""torchlint core: rule registry, suppressions, findings, reports.

The port of ``flink_ml_tpu/analysis/core.py``. The analyzer is a plain-``ast``
pass: it never imports the code it analyzes. The hazards it looks for are
the ones a run hides: a host read inside a captured CUDA graph bakes one
value into every replay, a draw from torch's global generator makes a fit
depend on whoever drew before it, a dropped status code from a ctypes call
turns a failed launch into garbage output, and a ``try`` around a kernel
that goes on to the plain version turns a broken kernel into a slow path
nobody notices. Rules are registered classes; each receives a parsed
``FileContext`` and yields ``Finding``s. Suppression is per-line::

    risky_call(x)  # torchlint: disable=host-sync -- one fetch a segment

The justification after ``--`` is MANDATORY: a bare ``disable`` is itself
reported (rule ``bare-suppression``), so every silenced hazard carries an
auditable reason. Unknown rule names in a disable are reported too
(``unknown-rule``) — a typo must not silently disable nothing — and so
is a suppression that no longer matches any finding on its line
(``unused-suppression``): stale disables must not linger to mask future
findings.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

#: the tool's name, as reports and the suppression comment spell it
TOOL = "torchlint"

#: trailing ``torchlint: disable=<rules> -- <why>`` comments
_SUPPRESS_RE = re.compile(
    r"#\s*torchlint:\s*disable=([A-Za-z0-9_,\s-]+?)\s*(?:--\s*(\S.*))?$")

#: meta-rules emitted by the framework itself (not registered Rule classes)
META_RULES = ("bare-suppression", "unknown-rule", "unused-suppression",
              "parse-error")


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False
    justification: Optional[str] = None

    def render(self) -> str:
        tag = " [suppressed]" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule}: {self.message}{tag}")


@dataclass
class Suppression:
    line: int
    rules: Tuple[str, ...]
    justification: Optional[str]
    used: bool = False


class FileContext:
    """One parsed source file plus the shared per-file indexes rules need:
    a parent map (ast has no uplinks) and the suppression table."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        # real COMMENT tokens only (a disable=... example inside a
        # docstring is documentation, not a suppression)
        self.suppressions: List[Suppression] = []
        try:
            tokens = tokenize.generate_tokens(io.StringIO(source).readline)
            comments = [(t.start[0], t.string) for t in tokens
                        if t.type == tokenize.COMMENT]
        except (tokenize.TokenError, IndentationError):  # pragma: no cover
            comments = []  # ast.parse succeeded; tokenize rarely disagrees
        for lineno, text in comments:
            m = _SUPPRESS_RE.search(text)
            if m:
                rules = tuple(r.strip() for r in m.group(1).split(",")
                              if r.strip())
                self.suppressions.append(
                    Suppression(lineno, rules, m.group(2)))

    # -- navigation helpers shared by rules ---------------------------------
    def enclosing_function(self, node: ast.AST):
        """Nearest enclosing FunctionDef/AsyncFunctionDef, or None."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parents.get(cur)
        return None

    def enclosing_loop(self, node: ast.AST):
        """Nearest enclosing For/While WITHIN the same function scope
        (the search stops at a def boundary: a nested function's body does
        not execute per-iteration just because the def sits in a loop)."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return None
            if isinstance(cur, (ast.For, ast.While)):
                return cur
            cur = self.parents.get(cur)
        return None


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    return dotted_name(node.func)


class Rule:
    """Base class. Subclasses set ``name`` (the suppression id), ``code``,
    ``rationale`` (one line, surfaced by ``--list-rules`` and docs), and
    implement ``check``."""

    name: str = ""
    code: str = ""
    rationale: str = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(self.name, ctx.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)


_REGISTRY: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and index by rule name."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"{cls.__name__} has no rule name")
    if inst.name in _REGISTRY:
        raise ValueError(f"duplicate rule {inst.name!r}")
    _REGISTRY[inst.name] = inst
    return cls


def all_rules() -> Dict[str, Rule]:
    # rule modules self-register on import; import here so callers that
    # reach core directly (tests) still see the full set
    from flink_ml_tpu_torch.analysis import rules  # noqa: F401

    return dict(_REGISTRY)


def _apply_suppressions(ctx: FileContext, findings: List[Finding],
                        report_unused: bool = True) -> List[Finding]:
    """Mark findings whose line carries a matching disable; then report
    framework findings for bare, unknown, and unused suppressions.
    ``report_unused`` is off for subset runs (--rules): a suppression
    for a rule that simply didn't run is not stale."""
    by_line: Dict[int, List[Suppression]] = {}
    for sup in ctx.suppressions:
        by_line.setdefault(sup.line, []).append(sup)
    known = set(all_rules()) | set(META_RULES)
    for f in findings:
        for sup in by_line.get(f.line, ()):
            if f.rule in sup.rules:
                f.suppressed = True
                f.justification = sup.justification
                sup.used = True
    for sup in ctx.suppressions:
        if sup.justification is None:
            findings.append(Finding(
                "bare-suppression", ctx.path, sup.line, 0,
                "suppression without a justification (write "
                f"'# {TOOL}: disable=<rule> -- <why this is safe>')"))
        for r in sup.rules:
            if r not in known:
                findings.append(Finding(
                    "unknown-rule", ctx.path, sup.line, 0,
                    f"disable names unknown rule {r!r}; known: "
                    f"{', '.join(sorted(known))}"))
        if report_unused and not sup.used \
                and all(r in known for r in sup.rules):
            findings.append(Finding(
                "unused-suppression", ctx.path, sup.line, 0,
                f"suppression for {', '.join(sup.rules)} matches no "
                "finding on this line — the hazard it silenced is gone "
                "(or moved); delete it so it cannot mask a future one"))
    return findings


def analyze_source(source: str, path: str = "<string>",
                   rules: Optional[Iterable[str]] = None) -> List[Finding]:
    """All findings (suppressed ones included, marked) for one source
    blob. ``rules`` optionally restricts to a subset of rule names."""
    registry = all_rules()
    if rules is not None:
        unknown = set(rules) - set(registry)
        if unknown:
            raise ValueError(f"unknown rules: {sorted(unknown)}; "
                             f"known: {sorted(registry)}")
        registry = {k: v for k, v in registry.items() if k in set(rules)}
    try:
        ctx = FileContext(path, source)
    except SyntaxError as e:
        return [Finding("parse-error", path, e.lineno or 1, e.offset or 0,
                        f"could not parse: {e.msg}")]
    findings: List[Finding] = []
    for rule in registry.values():
        findings.extend(rule.check(ctx))
    findings = _apply_suppressions(ctx, findings,
                                   report_unused=rules is None)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def analyze_file(path: str,
                 rules: Optional[Iterable[str]] = None) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        return analyze_source(f.read(), path, rules)


def iter_python_files(paths: Iterable[str]) -> Iterator[str]:
    """Expand files/directories into .py files, sorted for stable output."""
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)
        else:
            yield p


def analyze_paths(paths: Iterable[str],
                  rules: Optional[Iterable[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for path in iter_python_files(paths):
        findings.extend(analyze_file(path, rules))
    return findings


def collect_suppressions(
        paths: Iterable[str]) -> List[Tuple[str, Suppression]]:
    """Every suppression in ``paths`` with its ``used`` flag settled by
    a full analysis pass — the ``--suppressions`` audit (analysis/cli.py):
    the justification inventory reviewers read, plus staleness (a
    suppression no finding matched is dead weight that could mask a
    future hazard). Unparseable files simply contribute none."""
    registry = all_rules()
    out: List[Tuple[str, Suppression]] = []
    for path in iter_python_files(paths):
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
        try:
            ctx = FileContext(path, source)
        except SyntaxError:
            continue
        findings: List[Finding] = []
        for rule in registry.values():
            findings.extend(rule.check(ctx))
        _apply_suppressions(ctx, findings, report_unused=False)
        for sup in ctx.suppressions:
            out.append((path, sup))
    return out


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def exit_code(self) -> int:
        return 1 if self.unsuppressed else 0

    def render_text(self, show_suppressed: bool = False) -> str:
        shown = self.findings if show_suppressed else self.unsuppressed
        lines = [f.render() for f in shown]
        n_sup = len(self.findings) - len(self.unsuppressed)
        lines.append(f"{TOOL}: {len(self.unsuppressed)} finding(s), "
                     f"{n_sup} suppressed")
        return "\n".join(lines)

    def render_json(self) -> str:
        return json.dumps({
            "findings": [asdict(f) for f in self.findings],
            "counts": {"unsuppressed": len(self.unsuppressed),
                       "suppressed": (len(self.findings)
                                      - len(self.unsuppressed))},
        }, indent=2)
