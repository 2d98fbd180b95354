"""Readings that a cell's check limits are set from, on the card.

    python3 gpubench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 --seconds 2

In one process: the cell is set up once; for each of ``--seeds`` the
inputs are drawn anew, a short closed-loop window runs as in a run of
the benchmark, and the check's numbers are read (the program's
readings); for each of ``--control-seeds`` the reference computed with
TF32 in the program's place is held to the reference (the control,
which has to fail).  One JSON line a reading, then a summary.  The
benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH_DIR)


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path[:0] = [CHECKOUT, os.path.join(CHECKOUT, "src")]

    import torch
    from gpubench import bench

    if not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    spec = bench.load_json(os.path.join(CHECKOUT, "BENCHMARK.json"))
    cell = bench.Cell(BENCH_DIR, spec, args.workload)
    loop = cell.module("loops", cell.traffic["loop"])

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    system = cell.module("systems", cell.traffic["system"]).System(
        cell.config, cell.traffic, args.seeds[0], device,
        os.path.join(BENCH_DIR, bench.CACHE), log)
    log(f"set-up {time.perf_counter() - t0:.1f} s")
    program, control = [], []
    for seed in args.seeds:
        system.draw(seed)
        system.warm()
        window = loop.run(system, args.seconds, device)
        reading = dict(system.check(), seed=seed, kind="program",
                       forwards=window["forwards"])
        program.append(reading)
        print(json.dumps(reading), flush=True)
    for seed in args.control_seeds:
        system.draw(seed)
        reading = dict(system.control(), seed=seed, kind="control")
        control.append(reading)
        print(json.dumps(reading), flush=True)
    summary = {"workload": args.workload, "kind": "summary",
               "program_max": {k: max(r[k] for r in program)
                               for k in cell.own["limits"]},
               "control_min": {k: min(r[k] for r in control)
                               for k in cell.own["limits"]} if control else None,
               "limits": cell.own["limits"],
               "card": torch.cuda.get_device_name(device)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or ".") != BENCH_DIR]
    sys.exit(main())
