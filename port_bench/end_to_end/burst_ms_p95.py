"""The 95th percentile (linear between order statistics) of the latency
of every burst completed in the window: the host's call to the output
complete on the card."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.latencies_s, dtype=np.float64), 95.0)) * 1e3
