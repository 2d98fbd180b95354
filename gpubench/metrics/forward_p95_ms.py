"""forward_p95_ms: the 95th percentile (nearest rank) of every inference's
latency in the window, from its call to the end of its last kernel as two
CUDA events read it."""

import math


def read(record):
    lat = sorted(record["window"]["latencies_s"])
    return lat[max(math.ceil(0.95 * len(lat)) - 1, 0)] * 1e3
