#!/usr/bin/env python3
"""Would the fused kernels gain from processing their output in L2-sized
bands?  Counts, on the host, the bands of output rows each column group's
slots reach.

    python3 scripts/fused_band_share.py                    # PubMed
    python3 scripts/fused_band_share.py --dataset reddit   # ~2 min

The fused kernels (B3/B4) form one 64-row column group's tile of
``X W + b`` per CTA and scatter it into the (R, F_out) sub-row output
through ``column_slots``.  Processing the output in bands of rows that fit
the card's L2 would form each group's tile once per band its slots reach.
For each band height this prints, as one JSON line, the bands, the share
of (non-empty group, band) pairs that hold a slot, and the mean bands a
group reaches: the tile work a banded kernel would repeat.  Host numpy
only, on the ELL table ``GCNGraph.build`` gives the forward pass.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 65,536 rows of 128 f32 columns are 32 MB, what the H100's 50 MB L2 could
# hold of the output; 262,144 rows, four times that.
BAND_ROWS = (65_536, 262_144)
HIDDEN = 64
SEED = 0


def band_reach(cols: np.ndarray, n_dense_rows: int, band_rows: int) -> dict:
    from repro_torch.kernels.flexvector_spmm import XW_TILE_ROWS, column_slots

    group, start, ids = column_slots(cols, n_dense_rows)
    slot_group = np.repeat(group, np.diff(start)).astype(np.int64)
    band = ids.astype(np.int64) // cols.shape[1] // band_rows
    n_bands = -(-cols.shape[0] // band_rows)
    pairs = np.unique(slot_group * n_bands + band).size
    groups = np.unique(slot_group).size
    return {"band_rows": band_rows, "bands": n_bands,
            "group_rows": XW_TILE_ROWS, "groups": groups,
            "pair_share": pairs / max(groups * n_bands, 1),
            "mean_bands_per_group": pairs / max(groups, 1)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="pubmed", choices=("pubmed", "reddit"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.graphs.datasets import DATASETS, load_dataset
    from repro_torch.models.gcn import GCNConfig, GCNGraph

    spec = DATASETS[args.dataset]
    data = load_dataset(args.dataset, seed=SEED)
    cfg = GCNConfig(in_dim=spec.feature_dim, hidden_dim=HIDDEN,
                    out_dim=spec.classes, n_layers=2)
    ell = GCNGraph.build(data.adj_norm, cfg).pre.ell
    cols = np.asarray(ell.cols)
    print(json.dumps({"dataset": args.dataset, "sub_rows": cols.shape[0],
                      "tau": cols.shape[1], "bands": [
                          band_reach(cols, spec.nodes, b) for b in BAND_ROWS]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
