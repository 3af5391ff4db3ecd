"""torchlint fixture: POSITIVE for blocking-under-lock.

A Future.result() and a time.sleep() with the lock held — every thread
contending for ``_lock`` stalls behind the block.
"""
import time

from flink_ml_tpu_torch.common.locks import make_lock

_lock = make_lock("refit")


def wait_for(future):
    with _lock:
        return future.result()


def throttle():
    with _lock:
        time.sleep(0.5)
