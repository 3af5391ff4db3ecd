"""torchlint fixture: POSITIVE for lock-order.

The conflict hides one call deep: flush() holds ``self._buf_lock`` and
calls ``self._commit()``, which takes ``self._meta_lock`` — while
reload() nests the same pair the other way round.
"""
import threading


class Checkpointer:
    def __init__(self):
        self._buf_lock = threading.RLock()
        self._meta_lock = threading.Lock()

    def _commit(self):
        with self._meta_lock:
            return None

    def flush(self):
        with self._buf_lock:
            self._commit()

    def reload(self):
        with self._meta_lock:
            with self._buf_lock:
                return None
