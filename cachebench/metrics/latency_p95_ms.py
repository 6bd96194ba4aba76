"""latency_p95_ms (ms): the 95th percentile of every query latency of the
window, each the host clock from submit to answer, synchronised."""
import numpy as np


def read(run):
    return float(np.percentile(run.latencies_s, 95)) * 1e3
