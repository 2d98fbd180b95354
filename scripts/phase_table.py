#!/usr/bin/env python3
"""One benchmark cell's inferences, their device time put down to the
program's phases, and what the phases cost.

    python3 scripts/phase_table.py --workload reddit-full --seed 7 [--forwards 32] [--rounds 3]

from the root of a checkout, with a card.  Sets the cell up as
``gpubench/run.py`` does (its configuration, traffic, system and cache),
then prints:

* ``registry``: the set-up's ``RegistryStats`` (hash, read, unpickle,
  build and store seconds, bytes read) beside the benchmark's own
  ``graph_load_s``;
* ``memo``: the operand's memo builds after warm-up and after the
  profiled windows (a forward past warm-up builds nothing);
* ``phase_off_ns``: host nanoseconds of one ``phase()`` call with
  tracing off, the cost every inference pays;
* ``rounds``: profiled windows of ``--forwards`` inferences each, the
  phases on and forced off in turns (on, off, off, on, ...), each with
  its traced ms per inference and its busy ms;
* the per-phase, per-layer table of the first window with the phases on
  (``gpubench/phases.py``) and its ``fold_ms``, ``aggregate_ms`` and
  ``permute_ms``;
* last, all of it as one JSON line.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profiled_events(system, forwards: int, device) -> list:
    """The Chrome trace events of ``forwards`` inferences under the
    profiler, inside the spans ``gpubench/devtrace.py`` puts around them."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            for i in range(forwards):
                with record_function("bench.enqueue"):
                    out = system.call(i)
                with record_function("bench.sync"):
                    torch.cuda.synchronize(device)
                del out
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def phase_off_ns(calls: int = 200_000) -> float:
    """Host ns of one ``phase(name, **counts)`` enter and exit, untraced."""
    from repro_torch.obs.trace import phase

    t0 = time.perf_counter()
    for _ in range(calls):
        with phase("gcn.fold", sub_rows=1, out_rows=1, width=1):
            pass
    return (time.perf_counter() - t0) / calls * 1e9


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--forwards", type=int, default=32)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    for path in (CHECKOUT, os.path.join(CHECKOUT, "src")):
        if path not in sys.path:
            sys.path.insert(0, path)

    import torch

    import repro_torch.obs.trace as trace_mod
    from gpubench import bench, devtrace, phases

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    spec = bench.load_json(os.path.join(CHECKOUT, "BENCHMARK.json"))
    cell = bench.Cell(bench.BENCH_DIR, spec, args.workload)
    system = cell.module("systems", cell.traffic["system"]).System(
        cell.config, cell.traffic, args.seed, device,
        os.path.join(bench.BENCH_DIR, bench.CACHE),
        lambda m: print(m, file=sys.stderr, flush=True))
    stats = system.registry.stats
    registry = dict(vars(stats), graph_load_s=system.setup["graph_load_s"])
    print("registry " + " ".join(f"{k} {v!r}" for k, v in registry.items()),
          flush=True)
    system.warm()
    setup_s = time.perf_counter() - T_START
    graph = next(iter(system.registry._graphs.values()))
    operands = graph.on_device(device)[0]
    memo_warm = {repr(k): v for k, v in operands.memo_builds.items()}
    off_ns = phase_off_ns()
    print(f"setup_s {setup_s:.3f} phase_off_ns {off_ns:.1f}", flush=True)

    # The phases forced off: they see no profiler (none is current in
    # this process's obs spans either), while the profiler runs on.
    profiling = trace_mod._profiler_enabled
    rounds, first = [], None
    order = ["on", "off", "off", "on"] * args.rounds
    for i, mode in enumerate(order[:2 * args.rounds]):
        if mode == "off":
            trace_mod._profiler_enabled = lambda: False
        try:
            events = profiled_events(system, args.forwards, device)
        finally:
            trace_mod._profiler_enabled = profiling
        dt = devtrace.read(events, args.forwards)
        row = {"mode": mode,
               "traced_ms": dt["window_s"] / args.forwards * 1e3,
               "busy_ms": dt["busy_s"] / args.forwards * 1e3}
        rounds.append(row)
        print(f"round {i} {mode} traced_ms {row['traced_ms']:.4f} busy_ms "
              f"{row['busy_ms']:.4f}", flush=True)
        if mode == "on" and first is None:
            first = (phases.read(events, dt),
                     devtrace.breakdown(dt))
    memo_after = {repr(k): v for k, v in operands.memo_builds.items()}
    ph, breakdown = first
    print(phases.table(ph), flush=True)
    metrics = {
        "fold_ms": phases.device_ms(ph, "gcn.fold"),
        "aggregate_ms": phases.device_ms(ph, "gcn.aggregate"),
        "permute_ms": phases.device_ms(ph, "gcn.permute", "gcn.unpermute"),
    }
    print(" ".join(f"{k} {v!r}" for k, v in metrics.items()), flush=True)
    on = [r["traced_ms"] for r in rounds if r["mode"] == "on"]
    off = [r["traced_ms"] for r in rounds if r["mode"] == "off"]
    card = bench.card_info(device)
    result = {
        "cell": args.workload, "seed": args.seed, "card": card,
        "setup_s": setup_s, "registry": registry,
        "memo_builds_warm": memo_warm, "memo_builds_after": memo_after,
        "memo_built_again": memo_after != memo_warm,
        "phase_off_ns": off_ns, "rounds": rounds,
        "traced_ms_on_median": statistics.median(on),
        "traced_ms_off_median": statistics.median(off),
        "metrics": metrics, "phases": ph, "breakdown": breakdown,
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
