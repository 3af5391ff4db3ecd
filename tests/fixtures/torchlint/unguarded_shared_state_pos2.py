"""torchlint fixture: POSITIVE for unguarded-shared-state.

A served model swapped under the condition in swap(), read bare on the
device thread's path in predict().
"""
from flink_ml_tpu_torch.common.locks import make_condition


class Server:
    def __init__(self):
        self._cond = make_condition("server")
        self._model = None
        self._version = 0

    def swap(self, model):
        with self._cond:
            self._model = model
            self._version += 1
            self._cond.notify_all()

    def predict(self, x):
        return self._model(x), self._version  # both unguarded
