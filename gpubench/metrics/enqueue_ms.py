"""enqueue_ms: host milliseconds from the call into the step to its
return, before the wait for the device: the sum over the window's
inferences (many steps together) over their count."""


def read(record):
    w = record["window"]
    return w["enqueue_s"] / w["forwards"] * 1e3
