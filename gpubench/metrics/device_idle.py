"""device_idle: the share of the traced window in which no kernel, copy
or memset ran on the card (1 - the union of their intervals over the
window), in percent."""


def read(record):
    t = record["trace"]
    if t is None or t["busy_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
