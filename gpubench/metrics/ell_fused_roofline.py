"""ell_fused_roofline: the fused layers' least time over the device time of
the fused kernels (B3/B4) in the traced window, in percent.

The least time of one layer is the larger of its FLOPs (the 2 N F_in
F_out combination and the 2 nnz(A_hat) F_out aggregation) over the
card's peak at the cell's precision and its bytes over the HBM
bandwidth: ``X`` read once, ``W``, ``A_hat`` read once (8 bytes a
nonzero) and the N x F_out output written once (``gpubench/counts.py``).
"""

import re

from gpubench import counts

#: Profiler names of the kernels this share covers.
KERNELS = re.compile(r"\bell_fused_xw_kernel\b")


def read(record):
    t, peaks = record["trace"], record["peaks"]
    if t is None or peaks is None:
        return None
    device_s = sum(d for name, _, d in t["ops"] if KERNELS.search(name)) / 1e6
    if device_s <= 0:
        return None
    c = record["counts"]
    least = counts.fused_least_seconds(c["nodes"], c["nnz"], c["dims"],
                                       peaks[c["precision"]],
                                       peaks["hbm_bytes_s"])
    return least * t["forwards"] / device_s * 100.0
