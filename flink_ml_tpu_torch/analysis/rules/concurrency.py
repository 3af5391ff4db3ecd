"""Concurrency rules TL109–TL112: lock discipline over the serving &
training threading surface, and the fork rule of the host pool.

The port of ``flink_ml_tpu/analysis/rules/concurrency.py``, the same four
rules under the same names. The races a threaded server ships are found by
review, not by a run, and replica fleets and elastic training multiply
threads and locks; these rules encode the discipline the code already
follows so the next violation is a lint finding, not a production
incident. One addition: TL112 also flags torch in code a forked host-pool
worker runs, since a child that touches torch after the parent brought
CUDA up inherits a CUDA context it cannot use. The shared inference
machinery lives in analysis/concurrency.py; the matching RUNTIME watchdog
(acquisition-order graph, hold-time histograms) is common/locks.py.
"""

from __future__ import annotations

import ast
from typing import Iterator

from flink_ml_tpu_torch.analysis.concurrency import (
    child_reachable_functions,
    class_infos,
    enclosing_class,
    fork_calls,
    guards_at,
    lock_order_edges,
    module_fork_sensitive,
    module_lock_names,
    self_attr,
    torch_uses,
)
from flink_ml_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    dotted_name,
    register,
)


@register
class UnguardedSharedState(Rule):
    name = "unguarded-shared-state"
    code = "TL109"
    rationale = (
        "an attribute written under `with self._lock:` elsewhere in the "
        "class is shared state; touching it without the lock is a race")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for info in class_infos(ctx):
            if not info.lock_attrs:
                continue
            for acc in info.accesses:
                lock = info.guarded_attrs.get(acc.attr)
                if lock is None:
                    continue
                if acc.in_locked_helper:
                    continue  # *_locked: caller holds the lock by contract
                if any(g.startswith("self.") for g in acc.guards):
                    continue
                verb = "write to" if acc.is_write else "read of"
                yield self.finding(
                    ctx, acc.node,
                    f"{verb} self.{acc.attr} in "
                    f"{info.name}.{acc.method}() outside `with "
                    f"{lock}:` — the attribute is guarded by that lock "
                    f"everywhere it is written; take the lock, rename "
                    f"the method *_locked if the caller holds it, or "
                    f"suppress with why the lock-free access is safe")


@register
class LockOrder(Rule):
    name = "lock-order"
    code = "TL110"
    rationale = (
        "two locks acquired in both orders across the file can deadlock "
        "the moment the two paths run concurrently")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        edges = lock_order_edges(ctx)
        for (a, b), sites in sorted(
                edges.items(), key=lambda kv: (kv[0][0], kv[0][1])):
            if a >= b:  # report each conflicting pair once, from one side
                continue
            reverse = edges.get((b, a))
            if not reverse:
                continue
            rev_lines = ", ".join(
                str(getattr(s, "lineno", "?")) for s in reverse[:3])
            for site in sites:
                yield self.finding(
                    ctx, site,
                    f"lock order conflict: {a} is held while acquiring "
                    f"{b} here, but {b} is held while acquiring {a} "
                    f"(line {rev_lines}) — pick one acquisition order "
                    f"or drop one lock before taking the other")


#: blocking receivers whose final attribute name alone is decisive
_BLOCKING_ATTRS = {"result": "Future.result()",
                   "block_until_ready": "block_until_ready()"}


def _blocking_call(ctx: FileContext, node: ast.Call,
                   held: set) -> str:
    """A short description when ``node`` is a call that can block
    indefinitely, else ''. Heuristics tuned against this package:
    string ``sep.join(parts)`` and ``dict.get(key)`` shapes are
    excluded; ``cond.wait()`` on a HELD condition is the sanctioned
    release-and-sleep pattern, not a block-under-lock."""
    name = dotted_name(node.func)
    if name == "time.sleep":
        return "time.sleep()"
    if name == "sleep":
        for imp in ast.walk(ctx.tree):
            if isinstance(imp, ast.ImportFrom) and imp.module == "time" \
                    and any(a.name == "sleep" and a.asname is None
                            for a in imp.names):
                return "time.sleep()"
        return ""
    if not isinstance(node.func, ast.Attribute):
        return ""
    attr = node.func.attr
    if attr in _BLOCKING_ATTRS:
        return _BLOCKING_ATTRS[attr]
    receiver = dotted_name(node.func.value)
    if attr == "join":
        # thread/process join: zero args, a numeric timeout, or a
        # timeout= keyword. `sep.join(iterable)` has one non-numeric
        # positional arg and no timeout — excluded.
        if any(kw.arg == "timeout" for kw in node.keywords):
            return ".join(timeout=...)"
        if not node.args and not node.keywords:
            return ".join()"
        if len(node.args) == 1 and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, (int, float)):
            return ".join(timeout)"
        return ""
    if attr == "wait":
        if receiver is not None and receiver in held:
            return ""  # cond.wait() under `with cond:` releases the lock
        return ".wait()"
    if attr in ("get", "put"):
        # queue-shaped receivers only: dict.get(key)/np arrays etc. must
        # not fire. A zero-positional-arg .get() is queue-like too.
        queueish = receiver is not None and any(
            tok in receiver.lower() for tok in ("queue", "handoff"))
        if attr == "get" and not node.args \
                and all(kw.arg in ("block", "timeout")
                        for kw in node.keywords):
            return ".get()"
        if queueish:
            return f".{attr}() on a queue"
        return ""
    return ""


@register
class BlockingUnderLock(Rule):
    name = "blocking-under-lock"
    code = "TL111"
    rationale = (
        "an indefinite block (Future.result, join, sleep, queue wait) "
        "while holding a lock stalls every thread contending for it")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        module_locks = module_lock_names(ctx)
        by_class = {info.node: info for info in class_infos(ctx)}
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            cls = enclosing_class(ctx, node)
            info = by_class.get(cls) if cls is not None else None
            class_locks = info.lock_attrs if info is not None else set()
            held = guards_at(ctx, node, class_locks, module_locks)
            fn = ctx.enclosing_function(node)
            in_locked_helper = (fn is not None
                                and fn.name.endswith("_locked"))
            if not held and not in_locked_helper:
                continue
            # raw receiver names too, for the cond.wait(self-held) check
            held_exprs = set(held)
            desc = _blocking_call(ctx, node, held_exprs)
            if not desc:
                continue
            where = ", ".join(sorted(held)) if held else \
                f"the lock {fn.name}() holds by contract"
            yield self.finding(
                ctx, node,
                f"{desc} while holding {where} — this can block "
                f"indefinitely with the lock held; move the blocking "
                f"call outside the guard (snapshot state under the "
                f"lock, block after releasing it)")


@register
class ForkUnsafeState(Rule):
    name = "fork-unsafe-state"
    code = "TL112"
    rationale = (
        "a fork snapshots locks/threads mid-state: a mutex a sibling "
        "thread held at fork time is locked forever in the child; torch "
        "in a forked child meets a CUDA state it cannot use")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        forks = fork_calls(ctx)
        if not forks:
            return
        module_locks = module_lock_names(ctx)
        sensitive = module_fork_sensitive(ctx)
        by_class = {info.node: info for info in class_infos(ctx)}
        # (a) fork while holding a lock: the child is born with it held
        for call in forks:
            cls = enclosing_class(ctx, call)
            info = by_class.get(cls) if cls is not None else None
            class_locks = info.lock_attrs if info is not None else set()
            held = guards_at(ctx, call, class_locks, module_locks)
            if held:
                yield self.finding(
                    ctx, call,
                    f"os.fork() while holding {', '.join(sorted(held))} "
                    f"— the child inherits the locked mutex and every "
                    f"child-side acquire deadlocks; fork outside the "
                    f"guard")
        # (b) pre-fork locks/threads, and torch, in child-reachable code
        for fn in child_reachable_functions(ctx):
            for use in torch_uses(ctx, fn):
                what = ("imports torch" if isinstance(
                    use, (ast.Import, ast.ImportFrom)) else "calls torch")
                yield self.finding(
                    ctx, use,
                    f"child-reachable `{fn.name}` {what} — a forked "
                    f"worker inherits the parent's CUDA state but cannot "
                    f"use it; keep the child numpy-only (the host pool's "
                    f"fork rule) and move the torch work to the parent")
            for sub in ast.walk(fn):
                if not isinstance(sub, ast.Name) \
                        or not isinstance(sub.ctx, ast.Load):
                    continue
                kind = sensitive.get(sub.id)
                if kind is None:
                    continue
                yield self.finding(
                    ctx, sub,
                    f"module-level {kind} {sub.id!r} was created before "
                    f"the fork and is used in child-reachable code — a "
                    f"sibling thread may have held/started it at fork "
                    f"time; re-create it in the child (the reseed_child "
                    f"seam) or suppress with why the pre-fork state is "
                    f"safe")
