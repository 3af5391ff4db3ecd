"""torchlint fixture: POSITIVE for host-sync (path has the iteration
marker).

A per-round `.item()` and `.cpu()` of device values in a round loop: the
host waits for the card every round.
"""
import torch


def rounds(step, w, n):
    losses = []
    for _ in range(n):
        w, loss = step(w)
        losses.append(loss.item())  # a sync per round
        if bool(torch.isnan(w).any().cpu()):  # another
            break
    return w, losses
