"""The port's iteration runtime (``flink_ml_tpu/iteration``): the bounded
driver with its device, segment and host modes (:mod:`iteration`),
checkpoint/resume (:mod:`checkpoint`), termination predicates
(:mod:`termination`) and the unbounded stream plumbing (:mod:`streaming`).
"""

from flink_ml_tpu_torch.iteration.checkpoint import CheckpointManager  # noqa: F401
from flink_ml_tpu_torch.iteration.iteration import (  # noqa: F401
    IterationConfig,
    IterationListener,
    Iterations,
    iterate_bounded,
)
from flink_ml_tpu_torch.iteration.streaming import (  # noqa: F401
    StreamTable,
    generate_batches,
)
