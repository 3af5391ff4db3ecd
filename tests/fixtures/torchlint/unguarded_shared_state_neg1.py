"""torchlint fixture: NEGATIVE for unguarded-shared-state.

Every access of the guarded state takes the lock, a *_locked helper is
guarded by contract, and a justified lock-free read is suppressed.
"""
import threading


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._active = None
        self._history = []

    def publish(self, model):
        with self._lock:
            self._active = model
            self._record_locked(model)

    def _record_locked(self, model):
        self._history.append(model)

    def snapshot(self):
        with self._lock:
            return list(self._history)

    @property
    def active(self):
        return self._active  # torchlint: disable=unguarded-shared-state -- one atomic reference read; publish replaces the object under the lock
