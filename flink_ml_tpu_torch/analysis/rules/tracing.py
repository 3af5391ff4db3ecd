"""Rule TL101 ``capture-leak``: host reads of captured values.

The port of ``flink_ml_tpu/analysis/rules/tracing.py`` (JL101
``tracer-leak``). Torch captures code three ways: a ``with
torch.cuda.graph(...)`` block records its launches once and replays them, a
function handed to ``torch.cuda.make_graphed_callables`` becomes such a
graph, and a function under ``torch.compile`` or ``torch.jit.script`` is
compiled. Inside any of them, ``.item()``/``.tolist()``/``.cpu()``/
``.numpy()``, ``float(x)``/``int(x)``/``bool(x)`` and ``np.*`` on a device
value either fail at capture time (a sync while a stream captures), break
the compiled graph, or — worst — bake the value seen once into every
replay. A Python ``if``/``while`` on such a value is the same hazard: the
branch is taken once, when the body is captured. The rule runs the JAX
rule's forward taint pass: a captured def's parameters, and every name a
capture block binds from a call, taint the assignments that mention them;
``.shape``/``.dtype``/``len()``/``isinstance()`` stay static.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Set

from flink_ml_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    call_name,
    register,
)
from flink_ml_tpu_torch.analysis.rules._shared import (
    captured_functions,
    captured_params,
    capture_blocks,
)

#: attribute accesses that are concrete (static) under capture
STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "itemsize", "sharding",
                "aval", "weak_type", "device", "is_cuda", "layout"}

#: host builtins whose call concretizes its operand
HOST_CASTS = {"float", "int", "bool", "complex"}

#: builtins that stay static even on captured values
STATIC_CALLS = {"len", "isinstance", "type", "hasattr", "getattr", "repr",
                "str"}

#: tensor methods that copy the value to the host
HOST_READS = {"item", "tolist", "cpu", "numpy"}


def _mentions_traced(node: ast.AST, tainted: Set[str]) -> bool:
    """Does ``node`` reference a tainted name in a way that reads its
    value (i.e. not through a static attribute or static builtin)?"""
    if isinstance(node, ast.Attribute) and node.attr in STATIC_ATTRS:
        return False
    if isinstance(node, ast.Call):
        name = call_name(node)
        if name in STATIC_CALLS:
            return False
        if name is not None and name.rsplit(".", 1)[-1] in STATIC_ATTRS:
            return False
    if isinstance(node, ast.Name):
        return node.id in tainted
    return any(_mentions_traced(c, tainted)
               for c in ast.iter_child_nodes(node))


def _produced(value: ast.AST, tainted: Set[str], block: bool) -> bool:
    """Does binding ``value`` taint its target: it mentions a captured
    value, or (in a capture block) a call produced it on the device."""
    if _mentions_traced(value, tainted):
        return True
    return block and any(isinstance(n, ast.Call) for n in ast.walk(value))


@register
class CaptureLeakRule(Rule):
    name = "capture-leak"
    code = "TL101"
    rationale = (
        ".item()/.cpu()/float()/np.* or a Python branch on a device value "
        "inside a CUDA-graph capture or a torch.compile/jit.script body "
        "fails at capture, breaks the graph, or bakes the value seen once "
        "into every replay")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        findings: List[Finding] = []
        for fn in captured_functions(ctx):
            self._walk_body(ctx, fn.body, captured_params(fn, ctx),
                            findings, block=False)
        for block in capture_blocks(ctx):
            # a capture block has no parameters: what its calls return is
            # what its launches produce, and any host read inside it syncs
            self._walk_body(ctx, block.body, set(), findings, block=True)
        seen = set()
        for f in findings:
            key = (f.line, f.col, f.message)
            if key not in seen:
                seen.add(key)
                yield f

    # -- statement-ordered taint walk ---------------------------------------
    def _walk_body(self, ctx, stmts, tainted: Set[str], findings, block):
        for stmt in stmts:
            self._walk_stmt(ctx, stmt, tainted, findings, block)

    def _walk_stmt(self, ctx, stmt, tainted: Set[str], findings, block):
        if isinstance(stmt, ast.Assign):
            self._scan_expr(ctx, stmt.value, tainted, findings, block)
            is_tainted = _produced(stmt.value, tainted, block)
            for tgt in stmt.targets:
                self._bind(tgt, is_tainted, tainted)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            self._scan_expr(ctx, stmt.value, tainted, findings, block)
            self._bind(stmt.target,
                       _produced(stmt.value, tainted, block), tainted)
        elif isinstance(stmt, ast.AugAssign):
            self._scan_expr(ctx, stmt.value, tainted, findings, block)
            if _produced(stmt.value, tainted, block):
                self._bind(stmt.target, True, tainted)
        elif isinstance(stmt, (ast.If, ast.While)):
            self._scan_expr(ctx, stmt.test, tainted, findings, block)
            if _mentions_traced(stmt.test, tainted):
                kind = "if" if isinstance(stmt, ast.If) else "while"
                findings.append(self.finding(
                    ctx, stmt,
                    f"Python `{kind}` on a captured value: the branch is "
                    "taken once, at capture (use torch.where, or branch "
                    "outside the captured body)"))
            self._walk_body(ctx, stmt.body, tainted, findings, block)
            self._walk_body(ctx, stmt.orelse, tainted, findings, block)
        elif isinstance(stmt, ast.For):
            self._scan_expr(ctx, stmt.iter, tainted, findings, block)
            self._bind(stmt.target,
                       _mentions_traced(stmt.iter, tainted), tainted)
            self._walk_body(ctx, stmt.body, tainted, findings, block)
            self._walk_body(ctx, stmt.orelse, tainted, findings, block)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def closes over the captured environment
            self._walk_body(ctx, stmt.body, set(tainted), findings, block)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan_expr(ctx, item.context_expr, tainted, findings,
                                block)
                if block and item.optional_vars is not None:
                    self._bind(item.optional_vars, True, tainted)
            self._walk_body(ctx, stmt.body, tainted, findings, block)
        elif isinstance(stmt, ast.Try):
            self._walk_body(ctx, stmt.body, tainted, findings, block)
            for h in stmt.handlers:
                self._walk_body(ctx, h.body, tainted, findings, block)
            self._walk_body(ctx, stmt.orelse, tainted, findings, block)
            self._walk_body(ctx, stmt.finalbody, tainted, findings, block)
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self._scan_expr(ctx, child, tainted, findings, block)

    def _bind(self, target, is_tainted: bool, tainted: Set[str]):
        if isinstance(target, ast.Name):
            if is_tainted:
                tainted.add(target.id)
            else:
                tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, is_tainted, tainted)

    def _scan_expr(self, ctx, expr, tainted: Set[str], findings, block):
        """Flag host reads / casts / np.* calls on captured operands and
        captured ternary tests anywhere inside ``expr``; in a capture
        block, every host read (any receiver) and device sync."""
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                name = call_name(node)
                attr = (node.func.attr
                        if isinstance(node.func, ast.Attribute) else None)
                if attr in HOST_READS and not node.args and (
                        block or _mentions_traced(node.func.value,
                                                  tainted)):
                    findings.append(self.finding(
                        ctx, node,
                        f"`.{attr}()` inside a captured body copies a "
                        "device value to the host: a sync that fails "
                        "under graph capture or breaks the compiled "
                        "graph"))
                elif block and name in ("torch.cuda.synchronize",
                                        "cuda.synchronize"):
                    findings.append(self.finding(
                        ctx, node,
                        "a device synchronize inside a CUDA-graph capture "
                        "is not allowed while the stream captures"))
                elif name in HOST_CASTS and any(
                        _mentions_traced(a, tainted) for a in node.args):
                    findings.append(self.finding(
                        ctx, node,
                        f"host cast `{name}()` on a captured value reads "
                        "it once, at capture"))
                elif name and (name.startswith("np.")
                               or name.startswith("numpy.")) and any(
                        _mentions_traced(a, tainted) for a in node.args):
                    findings.append(self.finding(
                        ctx, node,
                        f"`{name}` on a captured value pulls it to the "
                        "host at capture (use torch ops)"))
            elif isinstance(node, ast.IfExp) and _mentions_traced(
                    node.test, tainted):
                findings.append(self.finding(
                    ctx, node,
                    "conditional expression on a captured value is "
                    "resolved once, at capture (use torch.where)"))
