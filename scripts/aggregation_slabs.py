#!/usr/bin/env python3
"""Time the aggregation kernel B1 at each count of column slabs.

    python3 scripts/aggregation_slabs.py                    # PubMed
    python3 scripts/aggregation_slabs.py --dataset reddit   # ~2 min setup

The aggregation kernels walk the dense operand's columns in slabs sized
to a share of the L2 (``L2_SLAB_BYTES`` in
``repro_torch/kernels/flexvector_spmm.py``).  This script chooses that
share by measurement: on the ELL table ``GCNGraph.build`` gives the
forward pass, with a random dense operand of each layer's width as the
dispatcher pads it (``aggregation_args``), it times ``spmm_ell_dense_grid``
at f32 and bf16 with the budget set to give 1, 2, 3 and 4 slabs, twice
each.  Each setting's output is held against the plain version.  Prints
the card's name and power limit, then one JSON line per setting: its
slabs, the CUDA-event times (each the median of 20 launches,
``chip_smoke.device_ms``) and the gather rate.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
HIDDEN = 64
SLAB_COUNTS = (1, 2, 3, 4)
REPS = 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="pubmed", choices=("pubmed", "reddit"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("aggregation_slabs: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch.exec.dispatch import aggregation_args, prepare_precision
    from repro_torch.exec.plan import SpmmPlan
    from repro_torch.graphs.datasets import DATASETS, load_dataset
    from repro_torch.kernels import flexvector_spmm as fv
    from repro_torch.models.gcn import GCNConfig, GCNGraph

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    spec = DATASETS[args.dataset]
    cfg = GCNConfig(in_dim=spec.feature_dim, hidden_dim=HIDDEN,
                    out_dim=spec.classes, n_layers=2)
    graph = GCNGraph.build(load_dataset(args.dataset, seed=SEED).adj_norm, cfg)
    operands, _, _ = graph.on_device(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    budget = fv.L2_SLAB_BYTES
    try:
        for precision in ("f32", "bf16"):
            plan = SpmmPlan(impl="cuda", block_rows=cfg.block_rows,
                            block_k=cfg.block_k, block_f=cfg.block_f,
                            precision=precision).resolve(schedulable=True)
            for width in (HIDDEN, spec.classes):
                xw = torch.randn(graph.n_nodes, width, generator=gen,
                                 device=dev)
                vals, scales, dense = prepare_precision(plan, operands, xw)
                name, call, kw, _ = aggregation_args(plan, operands, vals,
                                                     dense, scales)
                kernel, plain = fv.KERNELS[name], fv.PLAIN[name]
                ref = plain(*call, **kw)
                k, fa = call[2].shape
                pieces = fa * call[2].element_size() // 16
                gathered = smoke.gather_bytes(fv, call[0], call[2])
                seen = set()
                for n in SLAB_COUNTS:
                    fit = -(-pieces // n)        # pieces per slab
                    fv.L2_SLAB_BYTES = fit * k * 16
                    slab_cols, n_slabs = smoke.slabs(fv, call[2])
                    if n_slabs in seen:
                        continue
                    seen.add(n_slabs)
                    got = smoke.agreement(torch, kernel(*call, **kw), ref)
                    smoke.check(smoke.agrees(got, 1e-5),
                                f"{name}: {smoke.describe(got)}")
                    ms = [smoke.device_ms(torch, lambda: kernel(*call, **kw),
                                          REPS) for _ in range(2)]
                    mean = sum(ms) / len(ms)
                    print(json.dumps({
                        "dataset": args.dataset, "precision": precision,
                        "width": width, "columns": fa, "K": k,
                        "slabs": n_slabs, "slab_cols": slab_cols,
                        "slab_bytes": k * slab_cols * call[2].element_size(),
                        "ms": ms, "mean_ms": mean, "gathered_bytes": gathered,
                        "gather_tb_per_s": gathered / mean / 1e9}))
    finally:
        fv.L2_SLAB_BYTES = budget
    return 0


if __name__ == "__main__":
    sys.exit(main())
