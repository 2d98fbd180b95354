"""forward_mfu: the model FLOPs of one inference (each layer's 2 N F_in
F_out combination and 2 nnz(A_hat) F_out aggregation) over the traced
window's time per inference times the card's peak at the cell's
precision (f32: outside the tensor cores, no TF32), in percent."""

from gpubench import counts


def read(record):
    t, peaks = record["trace"], record["peaks"]
    if t is None or peaks is None or t["busy_s"] <= 0:
        return None
    c = record["counts"]
    flops = counts.model_flops(c["nodes"], c["nnz"], c["dims"])
    per_forward = t["window_s"] / t["forwards"]
    return flops / per_forward / peaks[c["precision"]] * 100.0
