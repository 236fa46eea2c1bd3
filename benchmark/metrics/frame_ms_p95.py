"""The 95th percentile of the window's frames, each timed on the host
from its camera change to its being complete on the device."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.window.unit_s) * 1e3, 95))
