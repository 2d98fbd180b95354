"""A profiled window's device time put down to the program's phases.

The program marks where its work happens with ``torch.profiler``
ranges named ``gcn.*`` (``repro_torch.obs.trace.phase``): ``gcn.forward``
around one inference and, inside it, ``gcn.permute``, one ``gcn.layer``
a layer (holding ``gcn.combine``, ``gcn.aggregate`` and ``gcn.fold``),
``gcn.activation`` and ``gcn.unpermute``.  The profiler's Chrome trace
holds them as host ``user_annotation`` events.  Every device operation
(kernel, copy, memset) carries ``args.correlation``, the id of the
runtime or driver call that launched it; the operation belongs to the
innermost ``gcn.*`` range open on the launching thread at that call, and
to the layer whose ``gcn.layer`` range holds the call, counted from 0
within its ``gcn.forward``.

:func:`read` takes the events and ``devtrace.read``'s result of them,
and gives, for each phase and layer, the device seconds (the union of
its operations' intervals in the window), its launches, its host self
time (its ranges less the ``gcn.*`` ranges inside them) and the idle
seconds its operations ended.  ``devtrace.read`` labels each idle gap by
the host span it began in; :func:`read` adds the phase of the operation
that ended it.  Device time launched outside every ``gcn.*`` range is
``unattributed``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from gpubench.devtrace import DEVICE_CATS, _union

PREFIX = "gcn."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: The label of the gap that the window's end, not an operation, ends.
WINDOW_END = "(window end)"


class _Range:
    __slots__ = ("name", "start", "end", "parent", "layer", "children_us")

    def __init__(self, name: str, start: float, end: float,
                 parent: Optional["_Range"]):
        self.name, self.start, self.end, self.parent = name, start, end, parent
        self.layer: Optional[int] = parent.layer if parent else None
        self.children_us = 0.0


class _Thread:
    """One host thread's ``gcn.*`` ranges as a forest, sorted by start."""

    def __init__(self, ranges: List[Tuple[float, float, str]]):
        self.nodes: List[_Range] = []
        stack: List[_Range] = []
        layers: Dict[int, int] = {}      # id of a gcn.forward -> layers seen
        for start, neg_dur, name in sorted((a, a - b, n) for a, b, n in ranges):
            end = start - neg_dur
            while stack and start >= stack[-1].end:
                stack.pop()
            node = _Range(name, start, end, stack[-1] if stack else None)
            if name == "gcn.layer":
                forward = node.parent
                while forward is not None and forward.name != "gcn.forward":
                    forward = forward.parent
                k = id(forward)
                node.layer = layers.get(k, 0)
                layers[k] = node.layer + 1
            if node.parent is not None:
                node.parent.children_us += end - start
            stack.append(node)
            self.nodes.append(node)
        self.starts = [n.start for n in self.nodes]

    def at(self, t: float) -> Optional[_Range]:
        """The innermost range holding ``t``: of the last range to start
        by ``t``, the nearest ancestor (or itself) still open."""
        i = bisect.bisect_right(self.starts, t)
        node = self.nodes[i - 1] if i else None
        while node is not None and t >= node.end:
            node = node.parent
        return node


def _key(name: str, layer: Optional[int]) -> Tuple[str, str]:
    """The ``(phase, layer)`` pair a phase's numbers are kept under; the
    layer is ``"-"`` outside every ``gcn.layer``."""
    return name, "-" if layer is None else str(layer)


def read(events: List[dict], trace: dict) -> dict:
    """The window's device time, host time and idle gaps by phase and
    layer (seconds), from ``events`` and ``trace = devtrace.read(events,
    forwards)``: its window, busy time and gaps by the host span each
    began in (``began_in``), and here each gap by the phase whose
    operation ended it (``ended_by``)."""
    complete = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = [e for e in complete if e.get("cat") == "user_annotation"
              and e.get("name") == "bench.window"]
    if not window:
        raise RuntimeError("the trace holds no bench.window span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])

    by_thread: Dict[tuple, list] = defaultdict(list)
    for e in complete:
        if (e.get("cat") == "user_annotation"
                and e.get("name", "").startswith(PREFIX)):
            ts = float(e["ts"])
            by_thread[(e.get("pid"), e.get("tid"))].append(
                (ts, ts + float(e["dur"]), e["name"]))
    threads = {k: _Thread(v) for k, v in by_thread.items()}
    launches = {e["args"]["correlation"]: (e.get("pid"), e.get("tid"),
                                           float(e["ts"]))
                for e in complete if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}

    def phase_of(op: dict) -> Optional[Tuple[str, str]]:
        launch = launches.get(op.get("args", {}).get("correlation"))
        if launch is None or launch[:2] not in threads:
            return None
        node = threads[launch[:2]].at(launch[2])
        return None if node is None else _key(node.name, node.layer)

    phases: Dict[Tuple[str, str], dict] = {}

    def entry(k: Tuple[str, str]) -> dict:
        if k not in phases:
            phases[k] = {"device_s": 0.0, "launches": 0, "host_self_s": 0.0,
                         "idle_before_s": 0.0, "_intervals": []}
        return phases[k]

    ops, unattributed = [], defaultdict(list)
    for e in complete:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if not (a < w1 and b > w0):
            continue
        a, b = max(a, w0), min(b, w1)
        k = phase_of(e)
        ops.append((a, b, k))
        if k is None:
            unattributed[e["name"]].append((a, b))
        else:
            p = entry(k)
            p["launches"] += 1
            p["_intervals"].append((a, b))

    for thread in threads.values():
        for node in thread.nodes:
            if w0 <= node.start < w1:
                entry(_key(node.name, node.layer))["host_self_s"] += (
                    node.end - node.start - node.children_us) / 1e6

    # The gaps are devtrace.read's: the same busy intervals' complement.
    first: Dict[float, Optional[Tuple[str, str]]] = {}
    for a, _, k in sorted(ops, key=lambda o: o[0]):
        first.setdefault(a, k)
    busy = _union([(a, b) for a, b, _ in ops])
    ended_by: Dict[str, List[float]] = defaultdict(list)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        if b >= w1:
            ended = WINDOW_END
        else:
            k = first.get(b)
            ended = "unattributed" if k is None else "/".join(k)
            if k is not None:
                entry(k)["idle_before_s"] += (b - a) / 1e6
        ended_by[ended].append((b - a) / 1e6)

    out: Dict[str, Dict[str, dict]] = defaultdict(dict)
    for (name, layer), p in phases.items():
        p["device_s"] = sum(b - a for a, b in _union(p.pop("_intervals"))) / 1e6
        out[name][layer] = p
    un_s = sum(b - a for a, b in _union(
        [iv for ivs in unattributed.values() for iv in ivs])) / 1e6
    return {
        "forwards": trace["forwards"],
        "busy_s": trace["busy_s"],
        "phases": dict(out),
        "unattributed_s": un_s,
        "unattributed_ops": {n: sum(b - a for a, b in _union(ivs)) / 1e6
                             for n, ivs in unattributed.items()},
        "began_in": trace["gaps"],
        "ended_by": {k: (sum(v), len(v)) for k, v in ended_by.items()},
    }


def device_ms(trace: dict, *names: str) -> Optional[float]:
    """Device ms per inference under the phases ``names``, summed over
    layers; ``None`` where none of them ran."""
    found = [p["device_s"] for n in names
             for p in trace["phases"].get(n, {}).values()]
    if not found:
        return None
    return sum(found) / trace["forwards"] * 1e3


def table(trace: dict) -> str:
    """The per-phase, per-layer table of :func:`read`, in ms and launches
    per inference, phases in the order of their device time."""
    n = trace["forwards"]
    rows = sorted(((name, layer, p) for name, layers in trace["phases"].items()
                   for layer, p in layers.items()),
                  key=lambda r: -r[2]["device_s"])
    lines = [f"{'phase':<16} {'layer':>5} {'device_ms':>10} {'launches':>9} "
             f"{'host_self_ms':>12} {'idle_before_ms':>14}"]
    for name, layer, p in rows:
        lines.append(
            f"{name:<16} {layer:>5} {p['device_s'] / n * 1e3:>10.4f} "
            f"{p['launches'] / n:>9.2f} {p['host_self_s'] / n * 1e3:>12.4f} "
            f"{p['idle_before_s'] / n * 1e3:>14.4f}")
    busy = trace["busy_s"]
    share = 1.0 - trace["unattributed_s"] / busy if busy > 0 else 0.0
    lines.append(f"busy_ms {busy / n * 1e3:.4f} unattributed_ms "
                 f"{trace['unattributed_s'] / n * 1e3:.4f} attributed "
                 f"{share * 100:.3f}% of busy")
    for name, s in sorted(trace["unattributed_ops"].items(),
                          key=lambda kv: -kv[1])[:5]:
        lines.append(f"unattributed {name[:90]} {s / n * 1e3:.4f} ms")
    for side in ("began_in", "ended_by"):
        for label, (s, count) in sorted(trace[side].items(),
                                        key=lambda kv: -kv[1][0]):
            lines.append(f"idle {side.replace('_', ' ')} {label} "
                         f"x{count / n:.2f} {s / n * 1e3:.4f} ms")
    return "\n".join(lines)
