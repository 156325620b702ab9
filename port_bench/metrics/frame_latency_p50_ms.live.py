"""Median of the window's frame latencies (each from its tick's due time
to the stream yielding its result), the same latencies as the end-to-end
95th percentile, read in the traced run."""

import numpy as np


def read(run):
    if run.latencies_ms is None or len(run.latencies_ms) == 0:
        return None
    return float(np.median(run.latencies_ms))
