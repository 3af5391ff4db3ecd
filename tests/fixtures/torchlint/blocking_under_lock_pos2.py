"""torchlint fixture: POSITIVE for blocking-under-lock.

A device-thread join and a queue get inside ``with self._lock:``, plus a
``*_locked`` helper (lock held by contract) that joins.
"""
import queue
import threading


class DeviceStage:
    def __init__(self):
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=lambda: None)
        self.queue = queue.Queue()

    def stop(self):
        with self._lock:
            self._thread.join()

    def take(self):
        with self._lock:
            return self.queue.get()

    def _stop_locked(self):
        self._thread.join(5.0)
