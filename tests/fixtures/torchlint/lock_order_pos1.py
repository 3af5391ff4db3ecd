"""torchlint fixture: POSITIVE for lock-order.

Two module-level locks nested in opposite orders across two paths — run
concurrently (the controller's tick and a metrics dump), they deadlock.
"""
from flink_ml_tpu_torch.common.locks import make_lock

_stats_lock = make_lock("stats")
_state_lock = make_lock("state")


def record(value):
    with _stats_lock:
        with _state_lock:
            return value


def rollover():
    with _state_lock:
        with _stats_lock:
            return None
