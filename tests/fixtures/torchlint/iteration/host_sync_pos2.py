"""torchlint fixture: POSITIVE for host-sync.

A synchronize, an np.asarray of a device value and a print inside a
while loop of the iteration runtime.
"""
import numpy as np
import torch


def drive(step, state):
    epoch = 0
    while epoch < 10:
        state = step(state)
        torch.cuda.synchronize()  # drains the queue every round
        snapshot = np.asarray(state.tolist())  # host copy per round
        print("epoch", epoch, snapshot)
        epoch += 1
    return state
