"""A closed loop of one caller: each call starts when the one before has
answered, back to back, until the window's time is up. A call's latency is
from its start to its answer on the host."""

from __future__ import annotations

import random
import time


def window(call, seconds: float, seed: int, sample: int):
    """Runs ``call()`` back to back for ``seconds`` → (latencies in seconds,
    one per call; the answers kept: a reservoir of ``sample`` drawn from
    ``seed``, then the last; the window's length in seconds). Keeping every
    answer would grow the heap through the window."""
    latencies, kept = [], []
    draw = random.Random(seed)
    started = time.perf_counter()
    while True:
        begun = time.perf_counter()
        answer = call()
        done = time.perf_counter()
        latencies.append(done - begun)
        if len(kept) < sample:
            kept.append(answer)
        else:
            slot = draw.randrange(len(latencies))
            if slot < sample:
                kept[slot] = answer
        if done - started >= seconds:
            break
    return latencies, kept + [answer], done - started
