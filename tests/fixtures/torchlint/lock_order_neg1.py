"""torchlint fixture: NEGATIVE for lock-order.

Both paths nest the same pair in the same order (outer before inner) — a
consistent hierarchy never deadlocks, and a single-lock path has no order
to violate.
"""
from flink_ml_tpu_torch.common.locks import make_lock

_outer = make_lock("outer")
_inner = make_lock("inner")
_solo = make_lock("solo")


def path_one():
    with _outer:
        with _inner:
            return 1


def path_two():
    with _outer:
        with _inner:
            return 2


def lone():
    with _solo:
        return 3
