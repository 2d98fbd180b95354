"""A closed loop with one inference in flight.

Each inference is one ``system.call(i)``; it ends when the device has
finished it (``synchronize``), and the next starts then.  The window
closes with the first inference that ends past ``seconds``.  Its length
is the host clock's from the first call to the last end.  Each
inference's latency is read from two CUDA events around its call, from
the call to the end of its last kernel (the host clock on the CPU);
its enqueue time is the host clock's from the call to its return.
"""

from __future__ import annotations

import time

import torch


def run(system, seconds: float, device: torch.device) -> dict:
    cuda = device.type == "cuda"
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    latencies, enqueue_s = [], 0.0
    begin = time.perf_counter()
    deadline = begin + seconds
    i = 0
    while True:
        if cuda:
            start.record()
        t0 = time.perf_counter()
        out = system.call(i)
        t1 = time.perf_counter()
        if cuda:
            end.record()
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        system.keep(i, out)
        latencies.append(start.elapsed_time(end) / 1e3 if cuda else t2 - t0)
        enqueue_s += t1 - t0
        i += 1
        if t2 >= deadline:
            break
    return {"seconds": t2 - begin, "forwards": i, "latencies_s": latencies,
            "enqueue_s": enqueue_s}
