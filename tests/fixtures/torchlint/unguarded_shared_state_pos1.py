"""torchlint fixture: POSITIVE for unguarded-shared-state.

The batcher's pending queue is written under ``self._lock`` in submit(),
then read and cleared without it in drain() — a race with submit().
"""
from flink_ml_tpu_torch.common.locks import make_lock


class Batcher:
    def __init__(self):
        self._lock = make_lock("batcher")
        self._pending = []

    def submit(self, req):
        with self._lock:
            self._pending.append(req)

    def drain(self):
        out = list(self._pending)  # read outside the lock
        self._pending.clear()  # write outside the lock
        return out
