"""Rule modules self-register on import (flink_ml_tpu_torch.analysis.core
``register``); importing this package loads the full rule set."""

from flink_ml_tpu_torch.analysis.rules import (  # noqa: F401
    aliasing,
    concurrency,
    hostsync,
    metrics_in_jit,
    native_contract,
    raw_collective,
    recompile,
    rng,
    tracing,
)
