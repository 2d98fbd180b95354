"""A profiled window and what its trace says.

:func:`profile` runs a fixed number of inferences of the closed loop
under ``torch.profiler`` (CUPTI on the card), inside the benchmark's own
host spans: ``bench.window`` around all of them, ``bench.enqueue``
around each call and ``bench.sync`` around each wait.  The trace is
read from the profiler's Chrome trace export: every kernel, copy and
memset on the device with its start and length, and the host spans and
operators that were running when the device went idle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("bench.enqueue", "bench.sync")


def profile(system, forwards: int, device: torch.device) -> dict:
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        with record_function("bench.window"):
            for i in range(forwards):
                with record_function("bench.enqueue"):
                    out = system.call(i)
                with record_function("bench.sync"):
                    if cuda:
                        torch.cuda.synchronize(device)
                del out
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return read(events, forwards)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


class _Spans:
    """Nested host spans, sorted by start: the innermost one holding a
    time is the latest-starting one that has not yet ended."""

    def __init__(self, spans: List[Tuple[float, float, str]], reach: int = 256):
        self.spans = sorted(spans)
        self.starts = [a for a, _, _ in self.spans]
        self.reach = reach

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t)
        for a, b, name in reversed(self.spans[max(0, i - self.reach):i]):
            if t < b:
                return name
        return ""


def read(events: List[dict], forwards: int) -> dict:
    """The window's length, the device's busy time inside it, the device
    operations (name, start, length; microseconds) and the idle gaps
    summed by what the host was doing when each began."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = [e for e in complete if e.get("cat") == "user_annotation"
              and e.get("name") == "bench.window"]
    if not window:
        raise RuntimeError("the trace holds no bench.window span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    ops = [(e["name"], float(e["ts"]), float(e["dur"])) for e in complete
           if e.get("cat") in DEVICE_CATS and float(e["ts"]) < w1
           and float(e["ts"]) + float(e["dur"]) > w0]
    busy = _union([(max(s, w0), min(s + d, w1)) for _, s, d in ops])
    busy_us = sum(b - a for a, b in busy)
    bench = _Spans([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in complete
                    if e.get("cat") == "user_annotation"
                    and e.get("name") in SPANS])
    host_ops = _Spans([(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e["name"]) for e in complete
                       if e.get("cat") in ("cpu_op", "cuda_runtime",
                                           "cuda_driver")])
    gaps: Dict[str, List[float]] = defaultdict(list)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            label = bench.at(a) or "bench.loop"
            op = host_ops.at(a)
            gaps[f"{label}:{op}" if op else label].append((b - a) / 1e6)
    by_name: Dict[str, float] = defaultdict(float)
    for name, _, d in ops:
        by_name[name] += d / 1e6
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "forwards": forwards,
        "ops": ops,
        "by_name": dict(by_name),
        "gaps": {k: (sum(v), len(v)) for k, v in gaps.items()},
    }


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle gaps, summed
    by what the host was doing, in seconds over the traced window."""
    ops = sorted(trace["by_name"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace["gaps"].items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_ops": [[name, s] for name, s in ops],
            "idle_gaps": [[f"{name} x{n}", s] for name, (s, n) in gaps]}
