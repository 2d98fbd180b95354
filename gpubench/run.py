"""Run one cell of the benchmark on the card and print its result line.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The program under test is ``repro_torch``
from the checkout's ``src/``.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: each
compared number beside its limit); the last lines of standard error
repeat the check.  Without a card, or with fewer than the cell asks for,
without the program, or with ``jax``, ``jaxlib``, ``flax`` or ``repro``
loaded once the window has closed, it prints no result and exits
non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that must not be there, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if CHECKOUT not in sys.path:
        sys.path.insert(0, CHECKOUT)
    src = os.path.join(CHECKOUT, "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    try:
        import repro_torch
    except ImportError as e:
        log(f"error: the program repro_torch is not importable from {src}: {e}")
        return 3
    if not os.path.abspath(repro_torch.__file__).startswith(src + os.sep):
        log(f"error: repro_torch was loaded from {repro_torch.__file__}, "
            f"not from the checkout's {src}")
        return 3

    import torch
    from gpubench import bench

    spec = bench.load_json(os.path.join(CHECKOUT, "BENCHMARK.json"))
    chips = next((c["chips"] for c in spec["workloads"]
                  if c["name"] == args.workload), None)
    if chips is None:
        log(f"error: no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"error: the cell needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    result = bench.run(args.workload, args.seed, args.seconds,
                       bool(args.trace), torch.device("cuda", 0), spec=spec,
                       t_start=T_START, log=log)
    found = forbidden_modules()
    if found:
        log(f"error: loaded in this process: {', '.join(found)}")
        return 4
    for line in bench.check_lines(result):
        log(line)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    # The script's own directory would put the benchmark's modules at the
    # top level, where they could shadow others of the same name.
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or ".") != BENCH_DIR]
    sys.exit(main())
