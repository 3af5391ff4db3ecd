"""Lock-discipline inference shared by the concurrency rules
(TL109–TL112, analysis/rules/concurrency.py).

The port of ``flink_ml_tpu/analysis/concurrency.py``, unchanged in what it
infers; the lock factories are the port's ``common/locks.py`` names, and
the fork machinery also finds torch in child-reachable code.

Everything here is plain-``ast``, per-file, and heuristic on purpose —
the same stance as the rest of torchlint: catch the hazard shapes this
codebase actually produces (``self._lock = threading.Lock()`` in
``__init__``, ``with self._lock:`` guards, the ``common/locks.py``
``make_lock``/``make_condition`` seam) with near-zero false positives,
and let a justified suppression carry anything deliberately lock-free
(the registry's "one atomic read" properties).

Inference per class:

- **lock attributes** — ``self.X`` bound (anywhere in the class) to a
  call whose final name is a known lock factory;
- **thread attributes** — same, for ``Thread``/``Timer``;
- **guarded attributes** — a non-lock ``self.X`` with at least one
  *write* (an assignment, or an in-place mutator call like
  ``self.X.append(v)``) under a ``with self.<lock>:`` guard outside
  ``__init__``;
  those writes define the discipline TL109 holds the rest of the class
  to;
- **accesses** — every ``self.X`` load/store outside ``__init__`` /
  ``__del__``, with the set of lock names held at that node (enclosing
  ``with`` items up to the nearest function boundary — a nested def's
  body does not run under its lexical ``with``).

Methods named ``*_locked`` are callee-side guard contracts (the
convention common/metrics.py already uses): their accesses count as
guarded, and TL111 treats their bodies as lock-holding.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

from flink_ml_tpu_torch.analysis.core import FileContext, dotted_name

#: call targets (final name component) that mint a lock-like object
LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                  "BoundedSemaphore", "make_lock", "make_condition"}

#: call targets that mint a thread of execution
THREAD_FACTORIES = {"Thread", "Timer"}

#: method names that mutate their receiver in place: ``self.X.append(v)``
#: is a WRITE to the shared container, not a read, for discipline
#: inference (list/set/dict/deque mutators the codebase actually calls)
MUTATOR_METHODS = {"append", "appendleft", "extend", "insert", "pop",
                   "popleft", "remove", "clear", "update", "add",
                   "discard", "setdefault"}


def factory_kind(value: ast.AST) -> Optional[str]:
    """``"lock"`` / ``"thread"`` when ``value`` is a call to a known
    factory (matched on the final dotted component), else None."""
    if not isinstance(value, ast.Call):
        return None
    name = dotted_name(value.func)
    if name is None:
        return None
    last = name.rsplit(".", 1)[-1]
    if last in LOCK_FACTORIES:
        return "lock"
    if last in THREAD_FACTORIES:
        return "thread"
    return None


def self_attr(node: ast.AST) -> Optional[str]:
    """``"X"`` when ``node`` is exactly ``self.X``."""
    if isinstance(node, ast.Attribute) \
            and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def module_fork_sensitive(ctx: FileContext) -> Dict[str, str]:
    """Module-level ``NAME = <lock/thread factory>()`` bindings:
    name -> kind. These are exactly the objects a fork snapshots in
    whatever state a sibling thread left them (TL112)."""
    out: Dict[str, str] = {}
    for node in ctx.tree.body:
        targets: List[ast.AST] = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        if value is None:
            continue
        kind = factory_kind(value)
        if kind is None:
            continue
        for t in targets:
            if isinstance(t, ast.Name):
                out[t.id] = kind
    return out


def module_lock_names(ctx: FileContext) -> Set[str]:
    return {n for n, k in module_fork_sensitive(ctx).items()
            if k == "lock"}


def enclosing_class(ctx: FileContext,
                    node: ast.AST) -> Optional[ast.ClassDef]:
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = ctx.parents.get(cur)
    return None


def _lock_expr_name(expr: ast.AST, class_locks: Set[str],
                    module_locks: Set[str]) -> Optional[str]:
    """The lock name a ``with``-item context expression acquires:
    ``self.X`` (X a known class lock) -> ``"self.X"``, a module-level
    lock Name -> its name; anything else (an unknown expression, a
    ``lock.acquire()`` call) -> None — unresolvable guards are simply
    not credited, keeping the rules conservative."""
    attr = self_attr(expr)
    if attr is not None and attr in class_locks:
        return f"self.{attr}"
    if isinstance(expr, ast.Name) and expr.id in module_locks:
        return expr.id
    return None


def guards_at(ctx: FileContext, node: ast.AST, class_locks: Set[str],
              module_locks: Set[str]) -> Set[str]:
    """Names of known locks held at ``node`` via enclosing ``with``
    statements, stopping at the nearest def/lambda boundary (a closure
    body does not execute under its lexically-enclosing guard)."""
    held: Set[str] = set()
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            break
        if isinstance(cur, ast.With):
            for item in cur.items:
                name = _lock_expr_name(item.context_expr, class_locks,
                                       module_locks)
                if name is not None:
                    held.add(name)
        cur = ctx.parents.get(cur)
    return held


@dataclass
class Access:
    attr: str
    node: ast.AST
    is_write: bool
    guards: Set[str]
    method: str
    in_locked_helper: bool  # method named *_locked: guarded by contract


@dataclass
class ClassInfo:
    node: ast.ClassDef
    name: str
    methods: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    lock_attrs: Set[str] = field(default_factory=set)
    thread_attrs: Set[str] = field(default_factory=set)
    #: attr -> lock name of its first guarded write (the discipline)
    guarded_attrs: Dict[str, str] = field(default_factory=dict)
    accesses: List[Access] = field(default_factory=list)


def _is_mutator_receiver(ctx: FileContext, node: ast.AST) -> bool:
    """True when ``node`` is the receiver of an in-place mutator call —
    ``self.X`` inside ``self.X.append(...)``: a write for discipline
    purposes even though the ast ctx is Load."""
    parent = ctx.parents.get(node)
    if not (isinstance(parent, ast.Attribute)
            and parent.value is node
            and parent.attr in MUTATOR_METHODS):
        return False
    call = ctx.parents.get(parent)
    return isinstance(call, ast.Call) and call.func is parent


def class_infos(ctx: FileContext) -> List[ClassInfo]:
    """Per-class discipline inference, cached on the context (all four
    rules share one pass)."""
    cached = getattr(ctx, "_concurrency_classes", None)
    if cached is not None:
        return cached
    module_locks = module_lock_names(ctx)
    infos: List[ClassInfo] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        info = ClassInfo(node, node.name)
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info.methods[stmt.name] = stmt
        # pass 1: lock/thread attributes, from any self.X = factory()
        for method in info.methods.values():
            for sub in ast.walk(method):
                if not isinstance(sub, ast.Assign):
                    continue
                kind = factory_kind(sub.value)
                if kind is None:
                    continue
                for t in sub.targets:
                    attr = self_attr(t)
                    if attr is None:
                        continue
                    if kind == "lock":
                        info.lock_attrs.add(attr)
                    else:
                        info.thread_attrs.add(attr)
        # pass 2: attribute accesses + the guards they run under
        for mname, method in info.methods.items():
            if mname in ("__init__", "__del__"):
                continue
            locked_helper = mname.endswith("_locked")
            for sub in ast.walk(method):
                attr = self_attr(sub)
                if attr is None or attr in info.lock_attrs:
                    continue
                if attr in info.methods:
                    continue  # self.method(...) is a call, not state
                is_write = (isinstance(sub.ctx, (ast.Store, ast.Del))
                            or _is_mutator_receiver(ctx, sub))
                guards = guards_at(ctx, sub, info.lock_attrs,
                                   module_locks)
                info.accesses.append(Access(
                    attr, sub, is_write, guards, mname, locked_helper))
        # pass 3: discipline — attrs with a guarded write (self locks)
        for acc in info.accesses:
            if not acc.is_write or acc.attr in info.guarded_attrs:
                continue
            for g in sorted(acc.guards):
                if g.startswith("self."):
                    info.guarded_attrs[acc.attr] = g
                    break
        infos.append(info)
    ctx._concurrency_classes = infos
    return infos


# -- lock-order analysis (TL110 machinery) -----------------------------------
def iter_self_accesses(info: ClassInfo) -> Iterator[Access]:
    """The ``self.<attr>`` reads and writes :func:`class_infos` recorded
    for one class, in source order."""
    yield from info.accesses


def _qualify(lock_name: str, ctx: FileContext,
             node: ast.AST) -> Optional[str]:
    """File-scope identity for a lock name: ``self.X`` becomes
    ``ClassName.X`` (two classes' ``_lock`` attrs are different locks);
    module-level names pass through."""
    if lock_name.startswith("self."):
        cls = enclosing_class(ctx, node)
        if cls is None:
            return None
        return f"{cls.name}.{lock_name[len('self.'):]}"
    return lock_name


def _locks_acquired_in(fn: ast.FunctionDef, ctx: FileContext,
                       class_locks: Set[str],
                       module_locks: Set[str]) -> Set[str]:
    """Qualified lock names acquired anywhere in ``fn``'s own body
    (intraprocedural; nested defs excluded — they run later)."""
    out: Set[str] = set()
    for sub in ast.walk(fn):
        if not isinstance(sub, ast.With):
            continue
        if ctx.enclosing_function(sub) is not fn:
            continue
        for item in sub.items:
            name = _lock_expr_name(item.context_expr, class_locks,
                                   module_locks)
            if name is not None:
                qualified = _qualify(name, ctx, sub)
                if qualified is not None:
                    out.add(qualified)
    return out


def lock_order_edges(ctx: FileContext
                     ) -> Dict[Tuple[str, str], List[ast.AST]]:
    """(outer, inner) -> acquisition sites, per file. Direct nesting
    (``with A: ... with B:``) plus one level of call expansion: a call
    under a guard to a same-file def (bare name) or same-class method
    (``self.m()``) contributes edges to every lock that callee acquires
    — the same local-resolution stance as ``_shared.captured_functions``.
    Longer chains are the runtime watchdog's job (common/locks.py)."""
    cached = getattr(ctx, "_concurrency_edges", None)
    if cached is not None:
        return cached
    module_locks = module_lock_names(ctx)
    by_class = {info.node: info for info in class_infos(ctx)}
    module_defs: Dict[str, ast.FunctionDef] = {}
    for stmt in ctx.tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            module_defs[stmt.name] = stmt

    def class_locks_for(node: ast.AST) -> Set[str]:
        cls = enclosing_class(ctx, node)
        info = by_class.get(cls) if cls is not None else None
        return info.lock_attrs if info is not None else set()

    edges: Dict[Tuple[str, str], List[ast.AST]] = {}

    def add_edge(outer: str, inner: str, site: ast.AST) -> None:
        if outer != inner:
            edges.setdefault((outer, inner), []).append(site)

    for node in ast.walk(ctx.tree):
        # direct nesting: an acquisition under an already-held guard
        if isinstance(node, ast.With):
            inner_names = set()
            for item in node.items:
                name = _lock_expr_name(item.context_expr,
                                       class_locks_for(node),
                                       module_locks)
                if name is not None:
                    qualified = _qualify(name, ctx, node)
                    if qualified is not None:
                        inner_names.add(qualified)
            if not inner_names:
                continue
            held = guards_at(ctx, node, class_locks_for(node),
                             module_locks)
            for h in held:
                outer = _qualify(h, ctx, node)
                if outer is None:
                    continue
                for inner in inner_names:
                    add_edge(outer, inner, node)
        # one-level call expansion: callee's locks acquired under the
        # caller's held guard
        elif isinstance(node, ast.Call):
            held = guards_at(ctx, node, class_locks_for(node),
                             module_locks)
            if not held:
                continue
            callee: Optional[ast.FunctionDef] = None
            callee_locks: Set[str] = set()
            if isinstance(node.func, ast.Name):
                callee = module_defs.get(node.func.id)
                if callee is not None:
                    callee_locks = _locks_acquired_in(
                        callee, ctx, set(), module_locks)
            else:
                mname = self_attr(node.func)
                cls = enclosing_class(ctx, node)
                info = by_class.get(cls) if cls is not None else None
                if mname is not None and info is not None:
                    callee = info.methods.get(mname)
                    if callee is not None:
                        callee_locks = _locks_acquired_in(
                            callee, ctx, info.lock_attrs, module_locks)
            if not callee_locks:
                continue
            for h in held:
                outer = _qualify(h, ctx, node)
                if outer is None:
                    continue
                for inner in callee_locks:
                    add_edge(outer, inner, node)
    ctx._concurrency_edges = edges
    return edges


# -- fork-reachability (TL112 machinery) -------------------------------------
def fork_calls(ctx: FileContext) -> List[ast.Call]:
    """Calls to ``os.fork`` (dotted, or ``fork`` imported from ``os``)."""
    from_os = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.ImportFrom) and node.module == "os":
            for alias in node.names:
                if alias.name == "fork":
                    from_os.add(alias.asname or alias.name)
    out = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name == "os.fork" or (name in from_os):
            out.append(node)
    return out


def child_reachable_functions(ctx: FileContext
                              ) -> List[ast.FunctionDef]:
    """Defs that run in the forked CHILD: any def named ``_child_main``,
    defs called from a ``pid == 0`` branch (``pid`` assigned from
    ``os.fork()``), plus one level of bare-name call expansion."""
    forks = {id(c) for c in fork_calls(ctx)}
    if not forks:
        return []
    module_defs: Dict[str, ast.FunctionDef] = {}
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            module_defs.setdefault(node.name, node)
    roots: List[ast.FunctionDef] = []
    if "_child_main" in module_defs:
        roots.append(module_defs["_child_main"])
    # pid = os.fork(); if pid == 0: <child branch>
    fork_vars = set()
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign) and id(node.value) in forks:
            for t in node.targets:
                if isinstance(t, ast.Name):
                    fork_vars.add(t.id)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.If):
            continue
        test = node.test
        if not (isinstance(test, ast.Compare)
                and isinstance(test.left, ast.Name)
                and test.left.id in fork_vars
                and len(test.ops) == 1
                and isinstance(test.ops[0], ast.Eq)
                and len(test.comparators) == 1
                and isinstance(test.comparators[0], ast.Constant)
                and test.comparators[0].value == 0):
            continue
        for sub in node.body:
            for call in ast.walk(sub):
                if isinstance(call, ast.Call) \
                        and isinstance(call.func, ast.Name) \
                        and call.func.id in module_defs:
                    roots.append(module_defs[call.func.id])
    # one-level expansion through bare-name calls
    seen = {id(f) for f in roots}
    expanded = list(roots)
    for f in roots:
        for call in ast.walk(f):
            if isinstance(call, ast.Call) \
                    and isinstance(call.func, ast.Name) \
                    and call.func.id in module_defs:
                callee = module_defs[call.func.id]
                if id(callee) not in seen:
                    seen.add(id(callee))
                    expanded.append(callee)
    return expanded


def torch_uses(ctx: FileContext, fn: ast.AST) -> Iterator[ast.AST]:
    """``import torch`` / ``from torch... import`` statements and calls
    that resolve to ``torch.*`` inside ``fn`` — in child-reachable code,
    each is a forked worker touching torch after the parent may have
    brought CUDA up (the port's fork rule: workers stay numpy-only)."""
    from flink_ml_tpu_torch.analysis.rules._shared import (
        import_origins,
        resolved_call,
    )

    origins = import_origins(ctx.tree)
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Import):
            if any(a.name == "torch" or a.name.startswith("torch.")
                   for a in sub.names):
                yield sub
        elif isinstance(sub, ast.ImportFrom):
            if sub.module and (sub.module == "torch"
                               or sub.module.startswith("torch.")):
                yield sub
        elif isinstance(sub, ast.Call):
            name = resolved_call(sub, origins)
            if name is not None and (name == "torch"
                                     or name.startswith("torch.")):
                yield sub
