"""Production serving runtime over the engine-free servables.

The port of ``flink_ml_tpu/serving``. The servable tier
(flink_ml_tpu_torch/servable/) answers ONE caller's ``transform``; this
package turns it into a server:

- :mod:`batcher` — async micro-batching: admission-controlled queueing
  with deadlines, padding/bucketing to a fixed batch-shape table, one
  device dispatch per tick — pipelined (a pad stage overlapping a device
  stage);
- :mod:`warmup` — run every bucket shape on the thread that will serve
  it at start and gate ``/healthz`` readiness on completion;
- :mod:`registry` — versioned model hot-swap from checkpointed model
  data: manifest-validated, health-probed, atomic, rolled back on any
  failure — the online-learning (FTRL) → serving handoff — plus canary
  fraction routing and first-class rollback to v(N-1);
- :mod:`controller` — the self-healing ops loop: drift/SLO/quality
  violation → warm-start retrain → publish with a fresh baseline →
  canary → staged ramp → swap, with automatic rollback when the canary's
  error/drift/latency gauges regress;
- :mod:`loadgen` — closed/open-loop load generation with exact latency
  percentiles, the one request-driving path for benchmarks, smokes and
  tests.

Ref parity: the reference stops at the synchronous servable interface
(TransformerServable.transform); the runtime around it — Flink's job
graph there — is this package here.
"""

from flink_ml_tpu_torch.serving.batcher import (  # noqa: F401
    BUCKETS_ENV,
    DEADLINE_ENV,
    DEFAULT_BUCKET_ROWS,
    PIPELINE_ENV,
    QUEUE_ENV,
    WINDOW_ENV,
    BatcherConfig,
    MicroBatcher,
)
from flink_ml_tpu_torch.serving.controller import (  # noqa: F401
    ControllerConfig,
    OpsController,
)
from flink_ml_tpu_torch.serving.loadgen import (  # noqa: F401
    LoadGenConfig,
    percentiles,
    run_loadgen,
)
from flink_ml_tpu_torch.serving.registry import (  # noqa: F401
    ModelRegistry,
    publish_model,
)
from flink_ml_tpu_torch.serving.warmup import (  # noqa: F401
    WARMUP_GATE,
    compile_count,
    warm,
)

__all__ = [
    "BUCKETS_ENV",
    "DEADLINE_ENV",
    "DEFAULT_BUCKET_ROWS",
    "PIPELINE_ENV",
    "QUEUE_ENV",
    "WINDOW_ENV",
    "BatcherConfig",
    "MicroBatcher",
    "ControllerConfig",
    "OpsController",
    "LoadGenConfig",
    "percentiles",
    "run_loadgen",
    "ModelRegistry",
    "publish_model",
    "WARMUP_GATE",
    "compile_count",
    "warm",
]
