"""torchlint fixture: POSITIVE for fork-unsafe-state.

Forking while the guard is held (the child is born with the mutex
locked), and a torch call in a function the ``pid == 0`` branch calls.
"""
import os
import threading

import torch

_state_lock = threading.Lock()


def fork_under_guard():
    with _state_lock:
        return os.fork()


def _shard(rows):
    return torch.from_numpy(rows).sum()  # torch in the child


def launch(rows):
    pid = os.fork()
    if pid == 0:
        _shard(rows)
        os._exit(0)
    return pid
