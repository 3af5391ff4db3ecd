"""Helpers shared by rules: the file's import table, and recognizing the
code torch CAPTURES — a ``with torch.cuda.graph(...)`` block, a function
handed to ``torch.cuda.make_graphed_callables``, and a function under
``torch.compile`` or ``torch.jit.script`` in decorator or wrap form.

The port of ``flink_ml_tpu/analysis/rules/_shared.py``. Where the JAX
module matches ``jit``-like callees on their final name component, this one
resolves every callee through the file's imports first and matches the
whole dotted name: ``compile`` alone is far too common a name
(``re.compile``) to mark code as captured. Torch's capture wrappers take no
static-argument declarations, so there is no statics parsing here.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Union

from flink_ml_tpu_torch.analysis.core import FileContext, dotted_name

#: wrappers whose FUNCTION operand (positional arg 0, or the decorated def)
#: is captured: compiled into a graph that runs without its Python
FUNCTION_CAPTURES = {"torch.compile", "torch.jit.script",
                     "torch.cuda.make_graphed_callables"}

#: context managers whose block is recorded once and replayed
BLOCK_CAPTURES = {"torch.cuda.graph"}

Captured = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.With]


def import_origins(tree: ast.AST) -> Dict[str, str]:
    """Alias → fully-dotted origin for every import in the file, so a
    bare ``all_reduce`` from ``from torch.distributed import all_reduce``
    (or an ``as`` alias) resolves to ``torch.distributed.all_reduce``."""
    origins: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                origins[alias.asname or alias.name.split(".")[0]] = \
                    alias.name if alias.asname else alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                origins[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
    return origins


def resolve(name: str, origins: Dict[str, str]) -> str:
    """``dist.all_reduce`` → ``torch.distributed.all_reduce`` given
    ``import torch.distributed as dist``."""
    head, _, rest = name.partition(".")
    origin = origins.get(head, head)
    return f"{origin}.{rest}" if rest else origin


def resolved_call(node: ast.AST, origins: Dict[str, str]) -> Optional[str]:
    """The import-resolved dotted name of a call's callee (or of a bare
    expression), or None when it is not a Name/Attribute chain."""
    if isinstance(node, ast.Call):
        node = node.func
    name = dotted_name(node)
    return resolve(name, origins) if name is not None else None


def origins_of(ctx: FileContext) -> Dict[str, str]:
    """The file's import table, cached on the context."""
    cached = getattr(ctx, "_import_origins", None)
    if cached is None:
        cached = ctx._import_origins = import_origins(ctx.tree)
    return cached


def _is_capture_callee(node: ast.AST, origins: Dict[str, str]) -> bool:
    return resolved_call(node, origins) in FUNCTION_CAPTURES


def capture_decorator(dec: ast.AST, origins: Dict[str, str]) -> bool:
    """True when ``dec`` captures the def it decorates: bare
    (``@torch.compile``), called (``@torch.compile(mode=...)``), or via
    ``functools.partial(torch.compile, ...)``."""
    if _is_capture_callee(dec, origins):
        return True
    if isinstance(dec, ast.Call):
        if _is_capture_callee(dec.func, origins):
            return True
        fname = resolved_call(dec, origins)
        if fname in ("functools.partial", "partial") and dec.args \
                and _is_capture_callee(dec.args[0], origins):
            return True
    return False


def _function_operands(call: ast.Call) -> List[str]:
    """Names of the functions a capture call takes: positional arg 0, a
    Name or a tuple/list of Names (``make_graphed_callables((f, g), ...)``)."""
    if not call.args:
        return []
    arg = call.args[0]
    if isinstance(arg, ast.Name):
        return [arg.id]
    if isinstance(arg, (ast.Tuple, ast.List)):
        return [e.id for e in arg.elts if isinstance(e, ast.Name)]
    return []


def captured_functions(ctx: FileContext) -> List[ast.FunctionDef]:
    """Every def torch captures — via decorator, or via a call-site wrap
    ``torch.compile(fn)`` / ``make_graphed_callables(fn, args)`` resolving
    to a def of that name anywhere in the file (cached on the context:
    three rules share one pass)."""
    cached = getattr(ctx, "_captured_functions", None)
    if cached is None:
        cached = ctx._captured_functions = list(_captured_functions(ctx))
    return cached


def _captured_functions(ctx: FileContext) -> Iterator[ast.FunctionDef]:
    origins = origins_of(ctx)
    defs_by_name: Dict[str, List[ast.FunctionDef]] = {}
    seen: Set[int] = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(node.name, []).append(node)
            if any(capture_decorator(d, origins)
                   for d in node.decorator_list):
                seen.add(id(node))
                yield node
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call) \
                or not _is_capture_callee(node.func, origins):
            continue
        for name in _function_operands(node):
            for fn in defs_by_name.get(name, ()):
                if id(fn) not in seen:
                    seen.add(id(fn))
                    yield fn


def capture_blocks(ctx: FileContext) -> List[ast.With]:
    """Every ``with torch.cuda.graph(...)`` block (any item of the
    ``with`` may be the capture), cached on the context."""
    cached = getattr(ctx, "_capture_blocks", None)
    if cached is None:
        origins = origins_of(ctx)
        cached = ctx._capture_blocks = [
            node for node in ast.walk(ctx.tree)
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                isinstance(item.context_expr, ast.Call)
                and resolved_call(item.context_expr, origins)
                in BLOCK_CAPTURES
                for item in node.items)]
    return cached


def captured_bodies(ctx: FileContext) -> List[Captured]:
    """Captured defs, then capture blocks, each once."""
    return [*captured_functions(ctx), *capture_blocks(ctx)]


def captured_params(fn: ast.FunctionDef, ctx: FileContext) -> Set[str]:
    """Parameter names that carry the captured call's inputs: all of them,
    less the receiver of a method (``self``/``cls`` of a def in a class
    body), which is the Python object the capture closes over."""
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args]
    if names and isinstance(ctx.parents.get(fn), ast.ClassDef) \
            and names[0] in ("self", "cls"):
        names = names[1:]
    names += [a.arg for a in args.kwonlyargs]
    if args.vararg is not None:
        names.append(args.vararg.arg)
    if args.kwarg is not None:
        names.append(args.kwarg.arg)
    return set(names)
