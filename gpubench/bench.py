"""Run one cell of ``BENCHMARK.json`` and build its result line.

Everything a cell needs is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<config>.json``)
and traffic mix (``traffic/<traffic>.json``); the mix names the system
adapter (``systems/<system>.py``) and the loop (``loops/<loop>.py``);
the cell's own file (``workloads/<cell>.json``) holds the limits its
check is held to; each metric is read by ``metrics/<metric>.py`` from
the run's record.  Adding a configuration, mix, cell or metric adds
files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import time
from typing import Callable, Dict, List, Optional

import torch

from gpubench import devtrace, peaks

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CACHE = ".cache"
#: A compared number that is infinite or NaN, as the result line gives it.
NOT_FINITE = 1.7976931348623157e308


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    """A module of the benchmark loaded from its file (names may hold dots)."""
    name = "gpubench_part_" + "".join(
        c if c.isalnum() else "_" for c in os.path.relpath(path, BENCH_DIR))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One cell and the files it is made of, under ``bench_dir``."""

    def __init__(self, bench_dir: str, spec: dict, name: str):
        cells = {c["name"]: c for c in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.bench_dir, self.spec, self.name = bench_dir, spec, name
        self.entry = cells[name]
        self.config = load_json(self.path("configs", self.entry["config"]))
        self.traffic = load_json(self.path("traffic", self.entry["traffic"]))
        self.own = load_json(self.path("workloads", name))

    def path(self, kind: str, name: str, ext: str = ".json") -> str:
        return os.path.join(self.bench_dir, kind, name + ext)

    def module(self, kind: str, name: str):
        return load_module(self.path(kind, name, ".py"))

    def metrics(self, trace: bool) -> List[dict]:
        """The cell's end-to-end metrics (``trace`` off) or per-layer ones
        (on): each with a ``workloads`` list that names the cell, or
        without one, where it reports the end-to-end metric it moves."""
        def listed(m: dict) -> bool:
            return self.name in m.get("workloads", [self.name])

        e2e = [m for m in self.spec["end_to_end"] if listed(m)]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]


def card_info(device: torch.device) -> dict:
    """The card's name and power limit (``nvidia-smi``), or the CPU."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "power_limit": None}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=60)
        info["power_limit"] = out.stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        pass
    return info


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: torch.device, bench_dir: str = BENCH_DIR,
        spec: Optional[dict] = None, t_start: Optional[float] = None,
        log: Callable[[str], None] = print) -> Dict:
    """Set up, warm, measure and check one cell; its result line's dict
    (``check`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    if spec is None:
        spec = load_json(os.path.join(os.path.dirname(bench_dir),
                                      "BENCHMARK.json"))
    cell = Cell(bench_dir, spec, workload)
    traffic = cell.traffic
    system = cell.module("systems", traffic["system"]).System(
        cell.config, traffic, seed, device,
        os.path.join(bench_dir, CACHE), log)
    system.warm()
    setup_s = time.perf_counter() - t_start

    window = cell.module("loops", traffic["loop"]).run(system, seconds, device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    traced = (devtrace.profile(system, traffic["trace_forwards"], device)
              if trace else None)
    card = card_info(device)
    log(f"card: {card['kind']} power.limit {card['power_limit']}")

    system.release()
    numbers = system.check()
    limits = cell.own["limits"]
    if set(numbers) != set(limits):
        raise KeyError(f"the check gives {sorted(numbers)}, the cell's "
                       f"limits are for {sorted(limits)}")
    correct = all(numbers[k] <= limits[k] for k in numbers)

    record = {
        "cell": cell.name, "config": cell.config, "traffic": traffic,
        "setup": dict(system.setup, setup_s=setup_s),
        "window": window, "memory": {"peak_bytes": peak}, "trace": traced,
        "counts": system.counts(), "peaks": peaks.peaks_of(card["kind"]),
    }
    metrics = {}
    for m in cell.metrics(trace):
        value = cell.module("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": card["platform"], "kind": card["kind"],
           "count": cell.entry["chips"], "memory_peak_bytes": peak,
           "power_limit": card["power_limit"]}
    result = {"correct": correct, "attempted": window["forwards"],
              "failed": 0 if correct else system.checked,
              "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = devtrace.breakdown(traced)
    result["check"] = {k: {"value": v if math.isfinite(v) else NOT_FINITE,
                           "limit": limits[k]} for k, v in numbers.items()}
    return result


def check_lines(result: dict) -> List[str]:
    """Each compared number beside its limit, one line each."""
    return [f"check {k} {v['value']!r} limit {v['limit']!r}"
            + ("" if v["value"] <= v["limit"] else " FAILED")
            for k, v in result["check"].items()]
