"""The 95th percentile (linear interpolation) of every step's time in the
window, from its start to its loss on the host, in ms."""

import numpy as np


def read(run: dict):
    steps = run["steps_s"]
    return float(np.percentile(steps, 95)) * 1e3 if steps else None
