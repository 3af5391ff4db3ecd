"""Rule TL105 ``native-contract``: the port's native and kernel contract,
held at every call site.

The port of ``flink_ml_tpu/analysis/rules/native_contract.py`` (JL105),
with the two halves of the port's own contract
(``flink_ml_tpu_torch/native/__init__.py``) added:

(a) the fallible host wrappers (``factorize_i64``, ``doc_freq_i64``,
    ``rowwise_counts``, ``csv_parse_numeric``) return ``None`` past their
    caps — a caller that uses the result without a ``None`` check crashes
    exactly on the inputs the cap exists for;
(b) ``np.take(..., mode='clip')`` silently clamps out-of-range indices
    where fancy indexing would raise, so it must sit behind an earlier
    bounds ``assert`` on the indices (``benchmark/datagen.py`` is the
    reference pattern);
(c) a C entry called through a ctypes library handle returns its status
    as an integer: a status that is dropped, or bound and never compared,
    turns a failed launch into whatever the output buffer held. The
    reference patterns are ``ops/kernels.py``'s ``_raise_on_error(source,
    rc, what)`` and ``native/__init__.py``'s ``if n < 0: return None``;
(d) kernel or raise: an ``except`` handler around a kernel launch or a
    native call that goes on to the plain version (a ``*_plain`` /
    ``*_reference`` call or a ``torch-*`` route) or sets a fallback flag
    turns a broken kernel into a slow path nobody notices. The port
    raises instead (``KernelBuildError``/``KernelLaunchError``).
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Set

from flink_ml_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    call_name,
    dotted_name,
    register,
)
from flink_ml_tpu_torch.analysis.rules._shared import origins_of

#: native wrappers whose None return is the over-cap signal
FALLIBLE = {"factorize_i64", "doc_freq_i64", "rowwise_counts",
            "csv_parse_numeric"}

#: calls whose result is a ctypes library handle: the port's cached
#: loaders, its build module's loaders, and ctypes itself
_HANDLE_MAKERS = {"_lib", "CDLL", "LoadLibrary"}
_BUILD_LOADERS = {"load", "load_host"}

#: modules whose functions launch kernels or call native code
_KERNEL_MODULES = ("ops.kernels", "native")

#: handler-side markers of a fallback to the plain version
_PLAIN_SUFFIXES = ("_plain", "_reference")
_FLAG_WORDS = ("fallback", "broken")


def _fallible_native_call(node: ast.Call) -> Optional[str]:
    name = call_name(node)
    if name is None:
        return None
    parts = name.split(".")
    if len(parts) >= 2 and parts[-2] == "native" and parts[-1] in FALLIBLE:
        return name
    return None


def _scope_of(ctx: FileContext, node: ast.AST) -> ast.AST:
    return ctx.enclosing_function(node) or ctx.tree


def _none_checked(scope: ast.AST, varname: str) -> bool:
    """Is ``varname`` compared against None anywhere in ``scope``?"""
    for node in ast.walk(scope):
        if isinstance(node, ast.Compare) and len(node.ops) == 1 \
                and isinstance(node.ops[0], (ast.Is, ast.IsNot)):
            sides = [node.left, node.comparators[0]]
            names = [dotted_name(s) for s in sides]
            consts = [isinstance(s, ast.Constant) and s.value is None
                      for s in sides]
            if varname in names and any(consts):
                return True
    return False


def _names_in(node: ast.AST):
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _take_indices(node: ast.Call) -> Optional[ast.AST]:
    """The indices operand of a ``take`` call: second positional for the
    module form ``np.take(a, idx, ...)``, first for the method form
    ``a.take(idx, ...)``."""
    name = call_name(node) or ""
    if name in ("np.take", "numpy.take"):
        return node.args[1] if len(node.args) > 1 else None
    return node.args[0] if node.args else None


def _bounds_assert_before(scope: ast.AST, call: ast.Call) -> bool:
    """An assert EARLIER in the scope that mentions (a name from) the
    indices operand — an unrelated precondition assert must not satisfy
    the bounds-check requirement (the whole point is that clip's clamp
    is silent)."""
    idx = _take_indices(call)
    idx_names = _names_in(idx) if idx is not None else set()
    for n in ast.walk(scope):
        if isinstance(n, ast.Assert) and n.lineno < call.lineno:
            if not idx_names or idx_names & _names_in(n.test):
                return True
    return False


# -- (c) ctypes handles ------------------------------------------------------
def _makes_handle(value: ast.AST) -> bool:
    """``_lib(...)``, ``_build.load(...)``, ``ctypes.CDLL(...)``..."""
    if not isinstance(value, ast.Call):
        return False
    name = call_name(value)
    if name is None:
        return False
    module, _, last = name.rpartition(".")
    return last in _HANDLE_MAKERS or (
        last in _BUILD_LOADERS and module.rsplit(".", 1)[-1] == "_build")


def _handle_names(ctx: FileContext) -> Dict[int, Set[str]]:
    """id(scope) -> names bound (in the scope's own statements) to a
    library handle, or to a function looked up on one (``fn =
    getattr(lib, name)``, kept as ``fn:<name>``)."""
    assigns = [(node, _scope_of(ctx, node)) for node in ast.walk(ctx.tree)
               if isinstance(node, ast.Assign)]
    out: Dict[int, Set[str]] = {}
    for node, scope in assigns:
        if _makes_handle(node.value):
            out.setdefault(id(scope), set()).update(
                t.id for t in node.targets if isinstance(t, ast.Name))
    for node, scope in assigns:
        value = node.value
        handles = out.get(id(scope), set())
        if isinstance(value, ast.Call) and call_name(value) == "getattr" \
                and value.args and (
                    _makes_handle(value.args[0])
                    or (isinstance(value.args[0], ast.Name)
                        and value.args[0].id in handles)):
            out.setdefault(id(scope), set()).update(
                f"fn:{t.id}" for t in node.targets
                if isinstance(t, ast.Name))
    return out


def _is_handle_call(node: ast.Call, handles: Set[str]) -> bool:
    """``lib.entry(...)`` / ``_lib(src).entry(...)`` / ``fn(...)`` for a
    function looked up on a handle."""
    func = node.func
    if isinstance(func, ast.Name):
        return f"fn:{func.id}" in handles
    if isinstance(func, ast.Attribute):
        recv = func.value
        if isinstance(recv, ast.Name):
            return recv.id in handles
        return _makes_handle(recv)
    return False


def _status_checked(scope: ast.AST, var: str, after: int) -> bool:
    """Is ``var`` compared, tested, passed on, or returned after line
    ``after`` — anything that lets a non-zero status be seen?"""
    for node in ast.walk(scope):
        if getattr(node, "lineno", 0) < after:
            continue
        if isinstance(node, (ast.Compare, ast.If, ast.While, ast.Assert,
                             ast.IfExp, ast.BoolOp)):
            test = getattr(node, "test", node)
            if var in _names_in(test):
                return True
        elif isinstance(node, ast.Call):
            if any(var in _names_in(a) for a in node.args) or any(
                    var in _names_in(k.value) for k in node.keywords):
                return True
        elif isinstance(node, ast.Return) and node.value is not None:
            if var in _names_in(node.value):
                return True
    return False


# -- (d) kernel or raise -----------------------------------------------------
def _kernel_aliases(ctx: FileContext) -> Dict[str, str]:
    """Local names that stand for a kernel module or a kernel wrapper."""
    out: Dict[str, str] = {}
    for alias, origin in origins_of(ctx).items():
        if any(origin.endswith(m) or f"{m}." in origin
               for m in _KERNEL_MODULES) and "flink_ml_tpu_torch" in origin:
            out[alias] = origin
    return out


def _is_kernel_call(node: ast.Call, aliases: Dict[str, str],
                    handles: Set[str]) -> bool:
    name = call_name(node)
    if name is None:
        return _is_handle_call(node, handles)
    head = name.split(".", 1)[0]
    last = name.rsplit(".", 1)[-1]
    if last.endswith(_PLAIN_SUFFIXES):
        return False
    if head in aliases:
        return True
    if last.startswith("_launch") or _fallible_native_call(node):
        return True
    return _is_handle_call(node, handles)


def _fallback_in(handler: ast.ExceptHandler) -> Optional[str]:
    """What in ``handler`` goes on to the plain version, or None."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Call):
            name = call_name(node) or ""
            if name.rsplit(".", 1)[-1].endswith(_PLAIN_SUFFIXES):
                return f"calls `{name}`"
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith("torch-"):
            return f"takes the {node.value!r} route"
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                name = dotted_name(t) or ""
                if any(w in name.lower() for w in _FLAG_WORDS):
                    return f"sets `{name}`"
    return None


@register
class NativeContractRule(Rule):
    name = "native-contract"
    code = "TL105"
    rationale = (
        "a fallible native wrapper's None, np.take(mode='clip')'s silent "
        "clamp and a ctypes entry's status code each need their check at "
        "the call site; a kernel that fails raises, it never falls back "
        "to the plain version")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        handles_of = _handle_names(ctx)
        aliases = _kernel_aliases(ctx)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Try):
                yield from self._check_try(ctx, node, handles_of, aliases)
                continue
            if not isinstance(node, ast.Call):
                continue
            native_name = _fallible_native_call(node)
            if native_name is not None:
                yield from self._check_native(ctx, node, native_name)
                continue
            name = call_name(node) or ""
            if name.rsplit(".", 1)[-1] == "take" and any(
                    kw.arg == "mode"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value == "clip"
                    for kw in node.keywords):
                scope = _scope_of(ctx, node)
                if not _bounds_assert_before(scope, node):
                    yield self.finding(
                        ctx, node,
                        "np.take(mode='clip') without a preceding bounds "
                        "assert in this scope: clip silently clamps "
                        "out-of-range indices where fancy indexing "
                        "raised (assert indices.max() < len(table) "
                        "first — see benchmark/datagen.py)")
                continue
            scope = _scope_of(ctx, node)
            if _is_handle_call(node, handles_of.get(id(scope), set())):
                yield from self._check_status(ctx, node, scope)

    def _check_native(self, ctx, node: ast.Call,
                      name: str) -> Iterator[Finding]:
        # climb to the statement consuming the call result; the only
        # accepted shape is `x = native.f(...)` (possibly via a
        # conditional expression) followed by a None check on x in scope
        cur, parent = node, ctx.parents.get(node)
        while isinstance(parent, (ast.IfExp, ast.BoolOp)):
            cur, parent = parent, ctx.parents.get(parent)
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1 \
                and isinstance(parent.targets[0], ast.Name):
            var = parent.targets[0].id
            if not _none_checked(_scope_of(ctx, node), var):
                yield self.finding(
                    ctx, node,
                    f"result of fallible `{name}` is never None-checked: "
                    "the wrapper returns None past its caps "
                    "(native/__init__.py contract) — handle that case")
        elif isinstance(parent, ast.Compare):
            pass  # direct `native.f(...) is None` probe is fine
        else:
            yield self.finding(
                ctx, node,
                f"result of fallible `{name}` used inline: assign it "
                "and None-check before use (returns None past its caps "
                "— native/__init__.py contract)")

    def _check_status(self, ctx, node: ast.Call,
                      scope: ast.AST) -> Iterator[Finding]:
        parent = ctx.parents.get(node)
        entry = (node.func.attr if isinstance(node.func, ast.Attribute)
                 else dotted_name(node.func))
        if isinstance(parent, ast.Expr):
            yield self.finding(
                ctx, node,
                f"status of ctypes entry `{entry}` is dropped: a failed "
                "launch goes unseen and the output holds garbage — check "
                "it (`_raise_on_error(source, rc, what)` in "
                "ops/kernels.py)")
        elif isinstance(parent, ast.Assign) and len(parent.targets) == 1 \
                and isinstance(parent.targets[0], ast.Name):
            var = parent.targets[0].id
            if not _status_checked(scope, var, node.lineno):
                yield self.finding(
                    ctx, node,
                    f"status `{var}` of ctypes entry `{entry}` is never "
                    "compared: a failed launch goes unseen — compare it "
                    "or pass it to the error check")

    def _check_try(self, ctx, node: ast.Try, handles_of,
                   aliases) -> Iterator[Finding]:
        handles = handles_of.get(id(_scope_of(ctx, node)), set())
        launches = [n for stmt in node.body for n in ast.walk(stmt)
                    if isinstance(n, ast.Call)
                    and _is_kernel_call(n, aliases, handles)]
        if not launches:
            return
        for handler in node.handlers:
            what = _fallback_in(handler)
            if what is None:
                continue
            yield self.finding(
                ctx, handler,
                f"this handler around `{call_name(launches[0]) or 'a kernel'}"
                f"(...)` {what}: a kernel that fails must raise, not fall "
                "back to the plain version (the port's kernel-or-raise "
                "rule)")
