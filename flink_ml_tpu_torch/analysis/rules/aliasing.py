"""Rule TL106 ``alias-mutation``: in-place writes through Table views.

The port of ``flink_ml_tpu/analysis/rules/aliasing.py`` (JL106). The
port's ``Table.take(slice)`` with a unit step, and ``head(n)``, return
columns that are VIEWS of the source table's storage: tensor and numpy
columns share it (``common/table.py`` ``take`` docstring). An in-place
write through a view column therefore silently corrupts the source table
and every sibling batch. Torch writes in place more ways than numpy: the
rule tracks names bound to ``.take(...)``/``.head(...)`` results (and
columns pulled out of them) within a scope and flags

- subscript assignment and augmented assignment through them (the JAX
  rule's writes);
- torch's in-place methods on them (``add_``, ``copy_``, ``fill_``,
  ``index_add_``, ``scatter_add_``, ... — any ``<name>_`` method);
- ``out=`` aimed at one of them.

``.clone()`` and ``.copy()`` — and any rebinding to an owned value —
break the alias chain.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from flink_ml_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    call_name,
    register,
)

_MESSAGE = ("in-place write through a Table.take()/head() view column: "
            "unit-step slices alias the source table's storage "
            "(common/table.py take() docstring) — .clone()/.copy() the "
            "column before mutating")


def _is_view_producer(value: ast.AST) -> bool:
    """A ``<expr>.take(...)`` / ``<expr>.head(...)`` method call that is
    not an explicit numpy or torch call (np.take and torch.take copy)."""
    if not isinstance(value, ast.Call) \
            or not isinstance(value.func, ast.Attribute) \
            or value.func.attr not in ("take", "head"):
        return False
    name = call_name(value) or ""
    return not name.startswith(("np.", "numpy.", "torch."))


def _is_column_of(value: ast.AST, views: Set[str]) -> bool:
    """``view["col"]`` or ``view.column("col")`` for a tracked view."""
    if isinstance(value, ast.Subscript) \
            and isinstance(value.value, ast.Name):
        return value.value.id in views
    if isinstance(value, ast.Call) \
            and isinstance(value.func, ast.Attribute) \
            and value.func.attr in ("column", "scalars", "vectors") \
            and isinstance(value.func.value, ast.Name):
        return value.func.value.id in views
    return False


def _is_inplace_method(attr: str) -> bool:
    """torch's in-place spelling: ``add_``, ``index_add_``... (not a
    dunder, not a private ``_name``)."""
    return attr.endswith("_") and not attr.startswith("_") \
        and len(attr) > 1


@register
class AliasMutationRule(Rule):
    name = "alias-mutation"
    code = "TL106"
    rationale = (
        "columns of a unit-step Table.take()/head() are views of the "
        "source storage; a subscript, augmented, in-place-method or out= "
        "write through one corrupts the source and all sibling batches — "
        "clone first (common/table.py contract)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        scopes = [n for n in ast.walk(ctx.tree)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        scopes.append(ctx.tree)
        for scope in scopes:
            yield from self._check_scope(ctx, scope)

    def _own_nodes(self, scope):
        """Nodes of this scope in SOURCE ORDER (alias tracking is a
        forward pass: `view = t.head(n)` must register before
        `col = view.column(...)`), not descending into nested defs."""
        for child in ast.iter_child_nodes(scope):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            yield child
            yield from self._own_nodes(child)

    def _aliased(self, node: ast.AST, views: Set[str],
                 cols: Set[str]) -> bool:
        """Is ``node`` a tracked view column, or a slice/column of one?"""
        if isinstance(node, ast.Name):
            return node.id in cols
        if _is_column_of(node, views):
            return True
        if isinstance(node, ast.Subscript):
            return self._aliased(node.value, views, cols)
        return False

    def _check_scope(self, ctx, scope) -> Iterator[Finding]:
        # ONE forward pass: a write is judged against the alias state AT
        # THAT POINT, so `c[0] = 1` before `c = view["a"]` is clean, and
        # rebinding a name to ANYTHING that is not itself a view/column
        # (not just `.clone()`) clears its alias status — `col = col * 2`
        # owns a fresh tensor.
        views: Set[str] = set()
        cols: Set[str] = set()
        for node in self._own_nodes(scope):
            if isinstance(node, ast.Call):
                # torch's in-place writes: col.add_(1), view["x"].fill_(0),
                # torch.add(a, b, out=col)
                func = node.func
                if isinstance(func, ast.Attribute) \
                        and _is_inplace_method(func.attr) \
                        and self._aliased(func.value, views, cols):
                    yield self.finding(ctx, node, _MESSAGE)
                    continue
                for kw in node.keywords:
                    if kw.arg == "out" and self._aliased(kw.value, views,
                                                         cols):
                        yield self.finding(ctx, kw.value, _MESSAGE)
                continue
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.AnnAssign):
                value, targets = node.value, [node.target]
            elif isinstance(node, ast.AugAssign):
                value, targets = None, [node.target]
            else:
                continue
            for tgt in targets:  # writes through the CURRENT aliases
                if isinstance(tgt, ast.Subscript):
                    base = tgt.value
                    hit = (isinstance(base, ast.Name) and base.id in cols) \
                        or _is_column_of(base, views)
                elif isinstance(node, ast.AugAssign):
                    # col += 1 on a tensor or ndarray mutates in place too
                    hit = isinstance(tgt, ast.Name) and tgt.id in cols
                else:
                    hit = False
                if hit:
                    yield self.finding(ctx, tgt, _MESSAGE)
            if isinstance(node, ast.AugAssign) or value is None:
                continue  # augmented assign never rebinds to a new object
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            if not names:
                continue
            if _is_view_producer(value):
                views.update(names)
                for n in names:
                    cols.discard(n)
            elif _is_column_of(value, views) or (
                    isinstance(value, ast.Name) and value.id in cols):
                cols.update(names)
                for n in names:
                    views.discard(n)
            elif isinstance(value, ast.Name) and value.id in views:
                views.update(names)
            else:  # rebound to an owned value: alias chain broken
                for n in names:
                    views.discard(n)
                    cols.discard(n)
