"""torchlint fixture: POSITIVE for fork-unsafe-state.

A module-level lock created before the fork is used in the child's
entrypoint — a sibling thread may have held it at fork time — and the
child imports torch and calls it after the parent brought CUDA up.
"""
import os

from flink_ml_tpu_torch.common.locks import make_lock

_cache_lock = make_lock("cache")


def _child_main(payload):
    import torch  # a forked worker must stay numpy-only

    with _cache_lock:
        return torch.as_tensor(payload).sum()


def spawn(payload):
    pid = os.fork()
    if pid == 0:
        _child_main(payload)
        os._exit(0)
    return pid
