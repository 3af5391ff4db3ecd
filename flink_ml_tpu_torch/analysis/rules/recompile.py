"""Rule TL102 ``rebuild-hazard``: kernel builds, captures, compiles and
streams made anew inside a loop body.

The port of ``flink_ml_tpu/analysis/rules/recompile.py`` (JL102
``recompile-hazard``). What a JAX loop pays for a fresh ``jax.jit`` a
torch loop pays for four things made per iteration:

- a kernel build or load (``_build.build``/``load``/``build_all``/
  ``build_host``/``load_host``, ``ctypes.CDLL``, ``cpp_extension.load``):
  nvcc or g++ and a ``dlopen`` every round, where the port's idiom is the
  cached lazy build behind ``functools.lru_cache`` (``ops/kernels.py``
  ``_lib``);
- a ``torch.cuda.CUDAGraph()`` or ``make_graphed_callables`` capture:
  a capture costs far more than the launches it saves, so it pays only
  when it is replayed;
- a ``torch.compile`` / ``torch.jit.script`` wrap: a fresh compile cache
  per wrap;
- a ``torch.cuda.Stream()``: a new stream per round, and work that no
  longer orders against the previous round's.

The JAX rule's second half, an unhashable value for a declared static
argument, has no torch spelling: torch's capture wrappers declare no
statics, so it has no counterpart here.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from flink_ml_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    register,
)
from flink_ml_tpu_torch.analysis.rules._shared import (
    origins_of,
    resolved_call,
)

#: the port's build module's entry points (ops/_build.py)
_BUILD_FNS = {"build", "load", "build_all", "build_host", "load_host"}

#: other calls that build or load a library
_LOADERS = {"ctypes.CDLL", "ctypes.cdll.LoadLibrary", "ctypes.PyDLL",
            "torch.utils.cpp_extension.load",
            "torch.utils.cpp_extension.load_inline"}

_CAPTURES = {"torch.cuda.CUDAGraph", "torch.cuda.make_graphed_callables"}
_COMPILES = {"torch.compile", "torch.jit.script"}
_STREAMS = {"torch.cuda.Stream"}


def _hazard(name: Optional[str]) -> Optional[str]:
    """What a call made in a loop body costs every iteration, or None."""
    if name is None:
        return None
    module, _, last = name.rpartition(".")
    if last in _BUILD_FNS and module.rsplit(".", 1)[-1] == "_build":
        return (f"`{name}` builds or loads a kernel library every "
                "iteration — build once, behind a cached loader (the "
                "lru_cache'd `_lib` of ops/kernels.py)")
    if name in _LOADERS:
        return (f"`{name}` loads a library every iteration — load once "
                "and keep the handle (functools.lru_cache)")
    if name in _CAPTURES:
        return (f"`{name}` captures a new CUDA graph every iteration — "
                "capture once outside the loop and replay it inside")
    if name in _COMPILES:
        return (f"`{name}` wraps anew every iteration, with a fresh "
                "compile cache — hoist the wrap out of the loop")
    if name in _STREAMS:
        return ("`torch.cuda.Stream()` makes a new stream every iteration "
                "— make it once and reuse it")
    return None


@register
class RebuildHazardRule(Rule):
    name = "rebuild-hazard"
    code = "TL102"
    rationale = (
        "a kernel build/load, a CUDA-graph capture, a torch.compile wrap "
        "or a new CUDA stream inside a loop body is paid every iteration "
        "— build, capture, compile and make streams once")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        origins = origins_of(ctx)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) \
                    or ctx.enclosing_loop(node) is None:
                continue
            message = _hazard(resolved_call(node, origins))
            if message is not None:
                yield self.finding(ctx, node, message)
