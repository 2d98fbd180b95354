"""Telemetry export: traces + registry snapshots as JSON / Prometheus.

Two formats, one source of truth:

* **JSON** — ``write_traces_json`` dumps drained traces (the exact
  span tree, ``Trace.to_dict`` schema) and ``write_metrics_json``
  dumps a ``MetricsRegistry`` snapshot (same schema as
  ``MetricsRegistry.write_json``, kept as the single snapshot shape).
* **Prometheus text exposition** — ``render_prometheus`` flattens a
  snapshot into ``repro_<name>{label="value"} <num>`` lines. Labeled
  series produced by ``runtime.metrics.labeled()`` are parsed back
  into real Prometheus labels via ``parse_labeled`` (the escaping
  inverse), histograms become summary-style series (``quantile="0.5"``
  / ``"0.99"`` plus ``_count`` and ``_sum``), and the derived gauges
  (shed rate, SLO attainment) ride along.

Everything here is pure rendering — no locks held, no registries
mutated — so exporters are safe to call from CLI teardown paths.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple, Union

from repro_torch.runtime.metrics import MetricsRegistry, parse_labeled

__all__ = [
    "traces_to_dicts",
    "render_traces_json",
    "write_traces_json",
    "snapshot_of",
    "write_metrics_json",
    "render_prometheus",
    "write_prometheus",
]

# The reference's metric names: both packages' exports read alike.
PREFIX = "repro"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def traces_to_dicts(traces: Iterable) -> List[dict]:
    return [t.to_dict() for t in traces]


def render_traces_json(traces: Iterable, indent: int = 2) -> str:
    return json.dumps({"traces": traces_to_dicts(traces)}, indent=indent,
                      default=str)


def write_traces_json(path: str, traces: Iterable) -> int:
    """Write drained traces; returns the number written."""
    dicts = traces_to_dicts(traces)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traces": dicts}, f, indent=2, default=str)
    return len(dicts)


def snapshot_of(registry_or_snapshot: Union[MetricsRegistry, dict]) -> dict:
    """Accept either a live registry or an already-taken snapshot."""
    if isinstance(registry_or_snapshot, dict):
        return registry_or_snapshot
    return registry_or_snapshot.snapshot()


def write_metrics_json(path: str,
                       registry_or_snapshot: Union[MetricsRegistry, dict],
                       ) -> dict:
    snap = snapshot_of(registry_or_snapshot)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
    return snap


# --------------------------------------------------------------------------
# Prometheus text exposition


def _metric_name(name: str) -> str:
    return f"{PREFIX}_{_NAME_RE.sub('_', name)}"


def _label_value(value: object) -> str:
    # Prometheus text format: escape backslash, double-quote, newline.
    s = str(value)
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{_NAME_RE.sub("_", k)}="{_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_value(value: float) -> str:
    f = float(value)
    return repr(int(f)) if f == int(f) else repr(f)


def _series(section: Dict[str, float], kind: str,
            lines: List[str]) -> None:
    typed: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for key, value in section.items():
        base, labels = parse_labeled(key)
        typed.setdefault(base, []).append((labels, value))
    for base in sorted(typed):
        name = _metric_name(base)
        lines.append(f"# TYPE {name} {kind}")
        for labels, value in sorted(typed[base],
                                    key=lambda kv: sorted(kv[0].items())):
            lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(value)}")


def render_prometheus(registry_or_snapshot: Union[MetricsRegistry, dict],
                      ) -> str:
    """A registry snapshot as Prometheus text exposition (format 0.0.4)."""
    snap = snapshot_of(registry_or_snapshot)
    lines: List[str] = []
    _series(snap.get("counters", {}), "counter", lines)
    _series(snap.get("gauges", {}), "gauge", lines)

    hists = snap.get("latency_ms", {})
    grouped: Dict[str, List[Tuple[Dict[str, str], dict]]] = {}
    for key, summary in hists.items():
        base, labels = parse_labeled(key)
        grouped.setdefault(base, []).append((labels, summary))
    for base in sorted(grouped):
        name = _metric_name(base) + "_ms"
        lines.append(f"# TYPE {name} summary")
        for labels, summary in sorted(grouped[base],
                                      key=lambda kv: sorted(kv[0].items())):
            count = int(summary.get("count", 0))
            for q_label, q_key in (("0.5", "p50"), ("0.99", "p99")):
                q_labels = dict(labels)
                q_labels["quantile"] = q_label
                lines.append(f"{name}{_fmt_labels(q_labels)} "
                             f"{_fmt_value(summary.get(q_key, 0.0))}")
            lines.append(f"{name}_count{_fmt_labels(labels)} {count}")
            lines.append(f"{name}_sum{_fmt_labels(labels)} "
                         f"{_fmt_value(summary.get('mean', 0.0) * count)}")

    derived = snap.get("derived", {})
    for key in sorted(derived):
        value = derived[key]
        if value is None:
            continue
        name = _metric_name(key)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt_value(value)}")
    return "\n".join(lines) + "\n"


def write_prometheus(path: str,
                     registry_or_snapshot: Union[MetricsRegistry, dict],
                     ) -> str:
    text = render_prometheus(registry_or_snapshot)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return text
