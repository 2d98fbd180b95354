#!/usr/bin/env python3
"""The simulator's five-dataset geomean, assembled from chip_smoke runs.

    python3 scripts/sim_geomean.py pubmed.out reddit.out yelp.out

Reads the ``{"sim": ...}`` line of each ``chip_smoke.py`` output: the
default run's phase 13 (a) gives Cora, CiteSeer and PubMed, a
``--dataset reddit`` or ``--dataset yelp`` run's phase 13 (b) gives that
dataset.  Prints each dataset's modeled GROW / FlexVector cycle ratio and
FlexVector / GROW energy ratio, then their geomeans over the datasets
read beside the survey's 3.78x / -40.5% (a five-dataset figure).  The
ratios are the simulator's modeled ASIC figures, not card times.  Host
only: it reads text files.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics

SURVEY_SPEEDUP, SURVEY_ENERGY_SAVING = 3.78, 0.405
KEYS = ("cycles_grow_over_flexvector", "energy_flexvector_over_grow")


def sim_record(path: str) -> dict:
    with open(path) as f:
        for line in f:
            if line.startswith('{"sim": '):
                return json.loads(line)["sim"]
    raise SystemExit(f"{path}: no {{\"sim\": ...}} line")


def ratios(sim: dict) -> dict:
    """Dataset -> its two ratios, from one run's record."""
    out = {name: {k: r[k] for k in KEYS}
           for name, r in (sim.get("datasets") or {}).items()}
    if sim.get("run_dataset"):
        out[sim["dataset"]] = {k: sim["run_dataset"][k] for k in KEYS}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("outputs", nargs="+", help="chip_smoke.py outputs")
    args = ap.parse_args()
    per = {}
    for path in args.outputs:
        per.update(ratios(sim_record(path)))
    for name, r in per.items():
        print(f"{name}: GROW / FlexVector cycles "
              f"{r['cycles_grow_over_flexvector']!r}x, FlexVector / GROW "
              f"energy {r['energy_flexvector_over_grow']!r}")
    geo = {k: math.exp(statistics.fmean(math.log(r[k]) for r in per.values()))
           for k in KEYS}
    print(f"geomean over {len(per)} ({', '.join(per)}): modeled speedup "
          f"{geo[KEYS[0]]!r}x, energy -{(1 - geo[KEYS[1]]) * 100!r}% (the "
          f"survey: {SURVEY_SPEEDUP}x, -{SURVEY_ENERGY_SAVING * 100:.1f}% "
          f"over five datasets)")
    print(json.dumps({"datasets": per, "geomean": geo}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
