"""The 95th percentile of the window's fit times, each from the call to its
model data on the host (numpy's linear interpolation)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 95)) * 1e3
