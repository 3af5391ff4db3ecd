"""Rule TL103 ``implicit-rng``: draws from global random state.

The port of ``flink_ml_tpu/analysis/rules/rng.py`` (JL103 ``rng-reuse``).
A ``jax.random`` key is a value, so the JAX hazard is drawing twice from
one key. A ``torch.Generator`` carries its own state, so reusing one is
how it is meant to be used; the torch hazard is the draw that names NO
generator and takes from the process-wide one. Such a fit's result depends
on every draw any other code made before it — a test run in another order,
a second model in the same server, a library that draws at import — and
two seeds that should be independent are not. The port's idiom is an
explicit generator per column (``benchmark/datagen.py``
``_torch_generator``) and ``np.random.default_rng(seed)`` on the host.

The rule flags:

- ``torch.rand``/``randn``/``randint``/``randperm``/``normal``/
  ``bernoulli``/``multinomial`` with no ``generator=``;
- the in-place draws ``uniform_``/``normal_``/``random_``/``bernoulli_``/
  ``exponential_`` with no ``generator=``;
- the module-level ``np.random.<draw>`` functions (the legacy global
  ``RandomState``) — constructors such as ``default_rng`` and
  ``Generator`` are the fix, not the hazard;
- seeding the global state: ``torch.manual_seed``, ``torch.cuda.
  manual_seed[_all]`` and ``np.random.seed``, which reset it for every
  other user in the process.
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

#: torch functions that draw, and take ``generator=``
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal",
                "bernoulli", "multinomial"}

#: tensor methods that draw in place, and take ``generator=``
_INPLACE_DRAWS = {"uniform_", "normal_", "random_", "bernoulli_",
                  "exponential_"}

#: members of np.random that make explicit state rather than draw from
#: the global one
_NP_CONSTRUCTORS = {"default_rng", "Generator", "RandomState",
                    "SeedSequence", "BitGenerator", "PCG64", "PCG64DXSM",
                    "MT19937", "Philox", "SFC64"}

#: calls that reseed the process-wide state
_GLOBAL_SEEDS = {"torch.manual_seed", "torch.cuda.manual_seed",
                 "torch.cuda.manual_seed_all", "numpy.random.seed",
                 "torch.random.manual_seed"}


def _canonical(name: Optional[str]) -> Optional[str]:
    """``np.random.x`` → ``numpy.random.x`` so both spellings match."""
    if name is not None and (name == "np" or name.startswith("np.")):
        return "numpy" + name[2:]
    return name


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" or kw.arg is None
               for kw in node.keywords)


@register
class ImplicitRngRule(Rule):
    name = "implicit-rng"
    code = "TL103"
    rationale = (
        "a torch draw without generator=, a module-level np.random draw, "
        "or a global reseed ties a result to every other draw in the "
        "process — pass an explicit torch.Generator / np.random.Generator")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        origins = origins_of(ctx)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _canonical(resolved_call(node, origins))
            if name in _GLOBAL_SEEDS:
                yield self.finding(
                    ctx, node,
                    f"`{name}` reseeds the process-wide generator for "
                    "every other user in the process — seed an explicit "
                    "torch.Generator / np.random.default_rng instead")
                continue
            if name is not None and name.startswith("torch."):
                last = name.rsplit(".", 1)[-1]
                if name.count(".") == 1 and last in _TORCH_DRAWS \
                        and not _has_generator(node):
                    yield self.finding(
                        ctx, node,
                        f"`{name}` without generator= draws from torch's "
                        "global generator — pass an explicit "
                        "torch.Generator")
                continue
            if name is not None and name.startswith("numpy.random."):
                member = name[len("numpy.random."):]
                if "." not in member and member not in _NP_CONSTRUCTORS:
                    yield self.finding(
                        ctx, node,
                        f"`{name}` draws from numpy's global RandomState "
                        "— draw from np.random.default_rng(seed)")
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _INPLACE_DRAWS \
                    and not _has_generator(node):
                yield self.finding(
                    ctx, node,
                    f"in-place `.{node.func.attr}()` without generator= "
                    "draws from torch's global generator — pass an "
                    "explicit torch.Generator")
