"""ell_spmm_roofline: the unfused aggregations' least time over the device
time of the aggregation kernels (B1/B2) in the traced window, in percent.

The least time of one inference is the bytes of each layer's aggregation
over the card's HBM bandwidth: ``A_hat`` read once (8 bytes a nonzero),
the N x F_out operand read once and the N x F_out output written once
(``gpubench/counts.py``), whatever the kernels read again or pad.
"""

import re

from gpubench import counts

#: Profiler names of the kernels this share covers.
KERNELS = re.compile(r"\bell_aggregate_kernel\b")


def read(record):
    t, peaks = record["trace"], record["peaks"]
    if t is None or peaks is None:
        return None
    device_s = sum(d for name, _, d in t["ops"] if KERNELS.search(name)) / 1e6
    if device_s <= 0:
        return None
    c = record["counts"]
    least = counts.aggregation_least_seconds(c["nodes"], c["nnz"], c["dims"],
                                             peaks["hbm_bytes_s"])
    return least * t["forwards"] / device_s * 100.0
