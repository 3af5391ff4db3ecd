"""torchlint fixture: NEGATIVE for host-sync.

Losses stay on the device through the loop and come back in one stacked
fetch after it; a `.tolist()` of an array a numpy call made reads the
host, not the device; a justified per-segment fetch is suppressed.
"""
import numpy as np
import torch


def rounds(step, w, n, ts, gap):
    pending = []
    for _ in range(n):
        w, loss = step(w)
        pending.append(loss)  # stays on the device
    losses = torch.stack(pending).cpu().numpy()  # one fetch, after
    for _chunk in range(3):
        starts = np.nonzero(np.diff(ts) > gap)[0] + 1
        bounds = [0, *starts.tolist(), len(ts)]  # host numpy array
    for _seg in range(2):
        stop = w.sum().item()  # torchlint: disable=host-sync -- one boundary fetch a segment decides whether the fit stops
        if stop:
            break
    return w, losses, bounds
