"""torchlint fixture: NEGATIVE for blocking-under-lock.

Blocking calls outside any guard, ``cond.wait()`` under its own condition
(it releases the lock while waiting), string ``sep.join(parts)`` and
``dict.get(key)`` under a lock.
"""
import time

from flink_ml_tpu_torch.common.locks import make_condition, make_lock

_cond = make_condition("ticks")
_lock = make_lock("labels")


def blocking_outside(future, worker):
    time.sleep(0.1)
    future.result()
    worker.join()


def sanctioned_wait():
    with _cond:
        _cond.wait()


def lookups(labels, table):
    with _lock:
        rendered = ", ".join(labels)
        return table.get(rendered)
