"""torchlint fixture: NEGATIVE for fork-unsafe-state.

The host pool's pattern: the child re-creates its lock instead of
touching the inherited one and stays numpy-only, the fork happens outside
any guard, and the parent branch may use torch and pre-fork state freely.
"""
import os
import threading

import numpy as np
import torch

_log_lock = threading.Lock()


def _child_main(rows):
    fresh = threading.Lock()
    with fresh:
        return np.asarray(rows).sum()


def spawn(rows):
    pid = os.fork()
    if pid == 0:
        _child_main(rows)
        os._exit(0)
    with _log_lock:  # parent-side use of pre-fork state is fine
        return pid, torch.as_tensor(rows).sum()
