"""The 90th percentile of the window's batch wall times, host clock, ms."""

import numpy as np


def read(rec):
    return float(np.percentile([1e3 * (e - s) for s, e in rec["units"]], 90))
