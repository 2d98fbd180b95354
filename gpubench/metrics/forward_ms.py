"""forward_ms: the window's seconds over the inferences completed in it."""


def read(record):
    w = record["window"]
    return w["seconds"] / w["forwards"] * 1e3
