"""SLO telemetry for the serving runtime.

One :class:`MetricsRegistry` per runtime instance, fed by the queue
(admission verdicts, depth), the scheduler (close reasons, sheds) and the
worker loop (per-request wait/exec/e2e, SLO attainment).  Everything is
lock-guarded — submissions land from caller threads while the worker loop
records completions — and :meth:`MetricsRegistry.snapshot` renders the
whole state as one JSON-able dict (the schema documented in the README),
so dashboards and benchmarks consume the same object the tests assert on.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

import numpy as np


class Histogram:
    """Latency histogram: bounded reservoir + percentile summaries.

    Samples are kept raw (seconds) up to ``max_samples``; past that,
    Vitter's algorithm R keeps a uniform reservoir so memory stays bounded
    for a long-lived runtime while percentiles stay statistically honest.
    Short runs (every test, every bounded benchmark) never overflow the
    reservoir, so their percentiles remain assertion-exact.  The
    replacement draw comes from an internal 64-bit LCG, not the global
    RNG: deterministic across runs and isolated from user seeding.
    ``count``/``mean``/``max`` track *all* observations, reservoir or not,
    and the summary schema is unchanged.
    """

    #: Default reservoir bound; ~16 KiB of floats per histogram.
    MAX_SAMPLES = 2048

    def __init__(self, max_samples: int = MAX_SAMPLES) -> None:
        if max_samples < 1:
            raise ValueError(f"max_samples must be >= 1, got {max_samples}")
        self.max_samples = int(max_samples)
        self._values: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lcg = 0x9E3779B97F4A7C15    # fixed seed: deterministic runs

    def _rand_below(self, bound: int) -> int:
        self._lcg = (
            self._lcg * 6364136223846793005 + 1442695040888963407
        ) & 0xFFFFFFFFFFFFFFFF
        return (self._lcg >> 33) % bound

    def observe(self, value_s: float) -> None:
        v = float(value_s)
        self._count += 1
        self._sum += v
        if self._count == 1 or v > self._max:
            self._max = v
        if len(self._values) < self.max_samples:
            self._values.append(v)
        else:
            j = self._rand_below(self._count)
            if j < self.max_samples:
                self._values[j] = v

    @property
    def count(self) -> int:
        return self._count

    def percentile(self, q: float) -> float:
        if not self._values:
            return 0.0
        return float(np.percentile(np.asarray(self._values, np.float64), q))

    def summary_ms(self) -> Dict[str, float]:
        if not self._values:
            return {"count": 0, "p50": 0.0, "p99": 0.0, "mean": 0.0,
                    "max": 0.0}
        v = np.asarray(self._values, np.float64) * 1e3
        return {
            "count": int(self._count),
            "p50": float(np.percentile(v, 50)),
            "p99": float(np.percentile(v, 99)),
            "mean": float(self._sum / self._count * 1e3),
            "max": float(self._max * 1e3),
        }


#: Counter names every registry starts with (snapshots always carry the
#: full set, so consumers never need ``.get`` fallbacks).
COUNTERS = (
    "submitted",            # offered to admission control
    "admitted",             # entered the queue
    "rejected_queue_full",  # admission: bounded queue at capacity
    "rejected_infeasible",  # admission: deadline < estimated exec time
    "rejected_closed",      # admission: queue closed (graceful shutdown)
    "rejected_unknown_servable",  # admission: graph_key routes nowhere
    "rejected_quota",       # admission: tenant token-bucket quota exhausted
    "rejected_inflight",    # admission: tenant concurrent-inflight cap hit
    "rejected_acl",         # admission: tenant not allowed this method
    "shed_expired",         # queued, then deadline became unmeetable
    "cancelled",            # caller-cancelled while queued
    "completed",            # future resolved with a result
    "failed",               # future resolved with an exception
    "batches_full",         # close reason: bucket filled
    "batches_deadline",     # close reason: earliest deadline - est reached
    "batches_flush",        # close reason: explicit flush/drain
    "slo_met",              # completed with deadline, on time
    "slo_missed",           # completed with deadline, late
)


#: Characters with structural meaning inside a labeled key; escaped in
#: label values so distinct (name, labels) never collide on one key.
_LABEL_ESCAPES = {"\\": "\\\\", ",": "\\,", "=": "\\=",
                  "{": "\\{", "}": "\\}"}


def _escape_label(value: object) -> str:
    return "".join(_LABEL_ESCAPES.get(ch, ch) for ch in str(value))


def labeled(name: str, **labels: str) -> str:
    """Metric key with attached labels, Prometheus-style.

    ``labeled("completed", tenant="cold", servable="cora")`` ->
    ``completed{servable=cora,tenant=cold}``.  Labels are sorted so the
    same (name, labels) always maps to the same key regardless of call
    site; labeled keys live beside the plain counters/histograms in the
    same registry and snapshot, so per-tenant/per-servable series need no
    second schema.  ``None``-valued labels are dropped, which lets call
    sites pass optional dimensions unconditionally.

    Label values are backslash-escaped (``\\ , = { }``) so values
    containing the separator characters can't collide on one key —
    ``tenant="a,b=c"`` and ``tenant="a", extra="c"`` stay distinct —
    and :func:`parse_labeled` can recover the exact (name, labels)
    pair for exporters.
    """
    kept = {k: v for k, v in labels.items() if v is not None}
    if not kept:
        return name
    inner = ",".join(f"{k}={_escape_label(kept[k])}" for k in sorted(kept))
    return f"{name}{{{inner}}}"


def parse_labeled(key: str) -> tuple:
    """Inverse of :func:`labeled`: ``key`` -> ``(name, labels_dict)``.

    Plain (unlabeled) keys come back as ``(key, {})``.  Escaped
    separator characters in label values are unescaped, so
    ``parse_labeled(labeled(n, **ls)) == (n, ls)`` for any string
    labels.
    """
    if not key.endswith("}"):
        return key, {}
    brace = key.find("{")
    if brace < 0:
        return key, {}
    name, inner = key[:brace], key[brace + 1:-1]
    labels: Dict[str, str] = {}
    parts: List[str] = []
    label_key = ""
    in_value = False
    escaped = False
    for ch in inner:
        if escaped:
            parts.append(ch)
            escaped = False
        elif ch == "\\":
            escaped = True
        elif not in_value and ch == "=":
            label_key = "".join(parts)
            parts = []
            in_value = True
        elif in_value and ch == ",":
            labels[label_key] = "".join(parts)
            parts = []
            in_value = False
        else:
            parts.append(ch)
    if in_value:
        labels[label_key] = "".join(parts)
    return name, labels


#: The counters that mean "offered but never produced a result" — the
#: numerator of ``shed_rate`` in both the property and the snapshot.
_SHED_COUNTERS = (
    "rejected_queue_full",
    "rejected_infeasible",
    "rejected_unknown_servable",
    "rejected_quota",
    "rejected_inflight",
    "rejected_acl",
    "shed_expired",
)


class MetricsRegistry:
    """Counters + gauges + latency histograms, snapshotted to JSON."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {name: 0 for name in COUNTERS}
        self._gauges: Dict[str, float] = {"queue_depth": 0}
        self._hists: Dict[str, Histogram] = {
            "wait_s": Histogram(),   # admission -> batch close
            "exec_s": Histogram(),   # batch close -> result ready
            "e2e_s": Histogram(),    # admission -> result ready
        }

    # ------------------------------------------------------------------

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def count(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def observe(self, hist: str, value_s: float) -> None:
        with self._lock:
            self._hists.setdefault(hist, Histogram()).observe(value_s)

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self._hists.setdefault(name, Histogram())

    # ------------------------------------------------------------------

    @property
    def shed_rate(self) -> float:
        """Fraction of offered requests that never produced a result:
        admission rejections plus queued-then-expired sheds."""
        with self._lock:
            c = self._counters
            shed = sum(c[k] for k in _SHED_COUNTERS)
            return shed / max(c["submitted"], 1)

    @property
    def slo_attainment(self) -> float:
        """On-time fraction of completed deadline-carrying requests."""
        with self._lock:
            c = self._counters
            judged = c["slo_met"] + c["slo_missed"]
            return c["slo_met"] / max(judged, 1)

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: h.summary_ms() for k, h in self._hists.items()}
        shed = sum(counters[k] for k in _SHED_COUNTERS)
        judged = counters["slo_met"] + counters["slo_missed"]
        return {
            "counters": counters,
            "gauges": gauges,
            "latency_ms": hists,
            "derived": {
                "shed_rate": shed / max(counters["submitted"], 1),
                "slo_attainment": counters["slo_met"] / max(judged, 1),
            },
        }

    def write_json(self, path: str, indent: Optional[int] = 2) -> dict:
        snap = self.snapshot()
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(snap, f, indent=indent)
        return snap
