"""The 95th percentile of every flush time of the window (host clock,
submit to acknowledgement), linear between order statistics."""
import numpy as np


def read(rec):
    fs = rec["window"]["flush_s"]
    return float(np.percentile(fs, 95)) * 1e3 if fs else None
