"""torchlint — static analysis for the port's PyTorch/CUDA hazards.

The port of ``flink_ml_tpu/analysis/`` (``jaxlint``). The port keeps
contracts a run cannot check: a kernel that fails raises instead of
falling back to the plain version, a forked host-pool worker stays
numpy-only, every draw names its generator, collectives go through the
parallel layer's seams, and the serving and ops loops hold one lock
discipline. This package checks them in the source: an AST rule registry
(``flink_ml_tpu_torch.analysis.rules``, one ``TL1xx`` rule per ``JL1xx``
rule of the JAX package), per-line suppressions with mandatory
justifications, and text/JSON reports. It never imports the code it
analyzes. CLI: ``python -m flink_ml_tpu_torch.analysis.cli`` (installed as
``flink-ml-tpu-torch-lint``); rule catalogue: ``docs/torchlint.md``.
"""

from flink_ml_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    Report,
    Rule,
    all_rules,
    analyze_file,
    analyze_paths,
    analyze_source,
    iter_python_files,
    register,
)
