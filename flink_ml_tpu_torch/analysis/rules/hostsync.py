"""Rule TL104 ``host-sync``: device→host syncs inside hot loops.

The port of ``flink_ml_tpu/analysis/rules/hostsync.py`` (JL104). The
port's round and batch loops are host-bound: each round enqueues a few
short kernels, and the card idles while Python decides what to launch
next. A ``.item()``/``.cpu()``/``.tolist()``/``.numpy()``/
``np.asarray``/``torch.cuda.synchronize()``/``Event.synchronize()``/
``print`` of a device value there blocks until the card drains its queue,
every round, so the next round's launches cannot be queued behind this
one's. Static analysis cannot see residency, so the rule is scoped by PATH
(the iteration runtime, ``ops/optimizer.py``'s rounds and
``models/online.py``'s batches) and by POSITION (inside a For/While body,
same function scope) — exactly where a sync is a per-round cost. A
``.tolist()``/``.item()`` of an array a numpy call made in the same
function reads the host, not the device, and is not flagged.
Deliberate syncs (a termination check that must see the loss, one
boundary fetch a segment) get a justified suppression, which makes the
``--suppressions`` audit the inventory of the per-round syncs these loops
pay.
"""

from __future__ import annotations

import ast
from typing import Iterator

from flink_ml_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    call_name,
    register,
)

#: path fragments that mark hot-loop modules: the iteration runtime and
#: its streaming driver, the SGD rounds, the online estimators' batches
PATH_MARKERS = ("iteration",)
PATH_SUFFIXES = ("ops/optimizer.py", "models/online.py")

_SYNC_CALLS = {"np.asarray", "numpy.asarray", "np.array", "numpy.array",
               "torch.cuda.synchronize"}

#: tensor methods that copy to the host (and so wait for the device)
_HOST_READS = {"item", "cpu", "tolist", "numpy"}


def _numpy_valued(value: ast.AST) -> bool:
    """An expression a numpy call produced: ``np.nonzero(d)[0] + 1``, a
    method or index of one; a torch call around a numpy one is not."""
    if isinstance(value, ast.Call):
        if (call_name(value) or "").startswith(("np.", "numpy.")):
            return True
        return isinstance(value.func, ast.Attribute) \
            and _numpy_valued(value.func.value)
    if isinstance(value, (ast.Subscript, ast.Attribute)):
        return _numpy_valued(value.value)
    if isinstance(value, ast.UnaryOp):
        return _numpy_valued(value.operand)
    if isinstance(value, ast.BinOp):
        sides = [value.left, value.right]
        return any(_numpy_valued(x) for x in sides) and all(
            _numpy_valued(x) or isinstance(x, ast.Constant) for x in sides)
    return False


def _host_array(ctx: FileContext, receiver: ast.AST) -> bool:
    """Is ``receiver`` a host numpy array: a numpy call's result, or a name
    every binding of which in the function is one? ``.tolist()`` of such
    an array reads no device value."""
    if not isinstance(receiver, ast.Name):
        return _numpy_valued(receiver)
    scope = ctx.enclosing_function(receiver) or ctx.tree
    values = [node.value for node in ast.walk(scope)
              if isinstance(node, ast.Assign) and any(
                  isinstance(t, ast.Name) and t.id == receiver.id
                  for t in node.targets)]
    return bool(values) and all(_numpy_valued(v) for v in values)


def hot_loop_module(path: str) -> bool:
    path = path.replace("\\", "/")
    return any(m in path for m in PATH_MARKERS) \
        or path.endswith(PATH_SUFFIXES)


@register
class HostSyncRule(Rule):
    name = "host-sync"
    code = "TL104"
    rationale = (
        ".item()/.cpu()/.tolist()/np.asarray/synchronize/print inside a "
        "round or batch loop body blocks on the device queue every round, "
        "so the next round cannot be queued behind this one")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not hot_loop_module(ctx.path):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            if ctx.enclosing_loop(node) is None:
                continue
            name = call_name(node)
            attr = (node.func.attr if isinstance(node.func, ast.Attribute)
                    else None)
            if name in _SYNC_CALLS:
                yield self.finding(
                    ctx, node,
                    f"`{name}` in a loop body waits for the device every "
                    "round (hoist it out of the loop, or keep the value "
                    "on the device)")
            elif attr in _HOST_READS and not node.args \
                    and not node.keywords \
                    and not _host_array(ctx, node.func.value):
                yield self.finding(
                    ctx, node,
                    f"`.{attr}()` in a loop body is a blocking device "
                    "sync every round (batch the readback, or carry the "
                    "value on the device)")
            elif attr == "synchronize" and not node.args:
                yield self.finding(
                    ctx, node,
                    "`.synchronize()` in a loop body drains the device "
                    "queue every round")
            elif name == "print":
                yield self.finding(
                    ctx, node,
                    "`print` in a loop body forces device-to-host "
                    "materialization of its arguments every round (log "
                    "outside the loop)")
