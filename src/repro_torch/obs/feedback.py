"""Measured-latency feedback into the planner.

The port of ``repro.obs.feedback``.  ``PlanFeedback`` accumulates
per-(bucket, plan) execute-latency EWMAs — from ``RuntimeLoop`` directly
while serving, or offline via :meth:`PlanFeedback.ingest` over drained
traces — and persists them as JSON (by default under ``REPRO_BENCH_DIR``,
where the reference keeps its store). ``plan.autoplan.choose_plan`` consults
measured entries *before* the modeled ``DeviceModel`` costs: a
candidate with a measurement is priced by its measurement, one without
falls back to the model (cold start). The static-default never-worse
invariant is kept against measured cost when a measurement exists —
an injected measurement that says the static plan is fastest makes
``choose_plan`` keep the static plan, whatever the model claims.

Caveat, stated rather than hidden: when only some candidates have
measurements, measured seconds and modeled comparison-seconds mix in
one argmin. Modeled costs are calibrated arbitrary units, so a
measured candidate competes on real seconds while unmeasured ones
compete on model units. That is the standard cold-start compromise
(same shape as ``BucketEstimator``): it converges as coverage grows,
and the static default is always re-priced by *its* measurement first,
so "never worse than static" holds in measured terms.

Keys are strings so the store survives JSON round-trips:

* ``bucket_key(bucket, feature_dim)`` → ``"b{nodes}x{rows}/f{fdim}"``
* ``plan_key(impl, br, bk, bf, width, precision, fused)`` →
  ``"reference/r128.k128.f128/w1/f32/unfused"``

``impl`` is the port's name (``exec.plan.IMPL_NAMES``), so a key equals
the reference's after mapping its impl through that table
(``"cuda/..."`` for ``"pallas/..."``).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterable, Optional

__all__ = [
    "PlanFeedback",
    "bucket_key",
    "plan_key",
    "plan_key_from_plan",
    "default_path",
]

DEFAULT_BASENAME = "PLAN_FEEDBACK.json"


def default_path() -> str:
    """Feedback store location: ``$REPRO_BENCH_DIR`` (default
    ``results/bench``) / ``PLAN_FEEDBACK.json``."""
    return os.path.join(os.environ.get("REPRO_BENCH_DIR", "results/bench"),
                        DEFAULT_BASENAME)


def bucket_key(bucket, feature_dim: int) -> str:
    """Stable string identity for a (bucket, feature_dim) pair."""
    nodes = getattr(bucket, "nodes", None)
    rows = getattr(bucket, "rows", None)
    if nodes is None:
        return f"{bucket}/f{int(feature_dim)}"
    return f"b{int(nodes)}x{int(rows)}/f{int(feature_dim)}"


def plan_key(impl: str, block_rows: int, block_k: int, block_f: int,
             width: int = 1, precision: str = "f32",
             fused: bool = False) -> str:
    """Canonical identity of one plan candidate in the autoplan search."""
    return (f"{impl}/r{int(block_rows)}.k{int(block_k)}.f{int(block_f)}"
            f"/w{int(width)}/{precision}/"
            f"{'fused' if fused else 'unfused'}")


def plan_key_from_plan(plan) -> str:
    """`plan_key` of a concrete ``SpmmPlan`` (pre-resolve ``impl``)."""
    return plan_key(plan.impl, plan.block_rows, plan.block_k, plan.block_f,
                    int(getattr(plan, "n_shards", 1) or 1),
                    plan.precision, bool(plan.fused))


class PlanFeedback:
    """Per-(bucket, plan) execute-latency EWMAs, JSON-persistable.

    ``record`` folds one batch execution into the EWMA, normalised to
    per-operand seconds (``seconds / batch``) so measurements taken at
    different padded batch widths are comparable. ``measured`` returns
    the current EWMA or ``None`` — the planner's cue to fall back to
    the model.
    """

    def __init__(self, ewma: float = 0.3):
        if not 0.0 < ewma <= 1.0:
            raise ValueError(f"ewma must be in (0, 1], got {ewma}")
        self.ewma = float(ewma)
        self._lock = threading.Lock()
        # bucket_key -> plan_key -> {"seconds": ewma, "count": n}
        self._entries: Dict[str, Dict[str, dict]] = {}

    def record(self, bucket: str, plan: str, seconds: float,
               batch: int = 1) -> float:
        """Fold one measurement; returns the updated EWMA."""
        per_op = float(seconds) / max(int(batch), 1)
        with self._lock:
            plans = self._entries.setdefault(str(bucket), {})
            entry = plans.get(str(plan))
            if entry is None:
                entry = {"seconds": per_op, "count": 1}
                plans[str(plan)] = entry
            else:
                entry["seconds"] = ((1.0 - self.ewma) * entry["seconds"]
                                    + self.ewma * per_op)
                entry["count"] = int(entry["count"]) + 1
            return entry["seconds"]

    def measured(self, bucket: str, plan: str) -> Optional[float]:
        with self._lock:
            entry = self._entries.get(str(bucket), {}).get(str(plan))
            return None if entry is None else float(entry["seconds"])

    def has_bucket(self, bucket: str) -> bool:
        with self._lock:
            return bool(self._entries.get(str(bucket)))

    def __len__(self) -> int:
        with self._lock:
            return sum(len(p) for p in self._entries.values())

    def entries(self) -> Dict[str, Dict[str, dict]]:
        """Deep-ish copy of the store (safe to mutate/serialise)."""
        with self._lock:
            return {b: {p: dict(e) for p, e in plans.items()}
                    for b, plans in self._entries.items()}

    def ingest(self, traces: Iterable) -> int:
        """Fold the ``execute`` spans of drained traces; returns count.

        Only spans that carry both identity attributes and a pinned
        ``end`` are folded — incomplete or non-serving spans are
        skipped, not guessed at.
        """
        n = 0
        for trace in traces:
            for span in getattr(trace, "spans", ()):
                if span.name != "execute" or span.end is None:
                    continue
                attrs = span.attributes
                bkey = attrs.get("bucket_key")
                pkey = attrs.get("plan_key")
                if not bkey or not pkey:
                    continue
                self.record(bkey, pkey, span.end - span.start,
                            batch=int(attrs.get("padded_batch", 1) or 1))
                n += 1
        return n

    # -- persistence -----------------------------------------------------

    def save(self, path: Optional[str] = None) -> str:
        path = path or default_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = {"version": 1, "ewma": self.ewma,
                   "entries": self.entries()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: Optional[str] = None,
             ewma: float = 0.3) -> "PlanFeedback":
        """Load a store; missing file → empty, corrupt file → moved to
        a ``.corrupt`` sibling (same contract as ``BENCH_summary``)."""
        path = path or default_path()
        fb = cls(ewma=ewma)
        if not os.path.exists(path):
            return fb
        try:
            with open(path) as f:
                payload = json.load(f)
            entries = payload["entries"]
            if not isinstance(entries, dict):
                raise ValueError("entries is not a dict")
            for bkey, plans in entries.items():
                for pkey, entry in plans.items():
                    fb._entries.setdefault(str(bkey), {})[str(pkey)] = {
                        "seconds": float(entry["seconds"]),
                        "count": int(entry.get("count", 1)),
                    }
            fb.ewma = float(payload.get("ewma", ewma))
        except (ValueError, KeyError, TypeError, OSError):
            os.replace(path, path + ".corrupt")
            return cls(ewma=ewma)
        return fb
