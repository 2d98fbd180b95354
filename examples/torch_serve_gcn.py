"""Serve GCN inference with batched requests (PyTorch + CUDA port).

The port's counterpart of ``examples/serve_gcn.py``.  A request asks for
the logits of a set of seed nodes; the port's serving engine samples each
request's 2-hop neighbourhood (the receptive field of a 2-layer GCN,
fanout-capped), batches the requests per shape bucket and replays the
bucket's captured forward through the CUDA kernels (CUDA graphs on the
card; on the CPU, closures over the kernels' plain versions).
Reports per-request latency and throughput, and the simulator's modeled
cycles for the same aggregation on the FlexVector ASIC.

Run:  PYTHONPATH=src python examples/torch_serve_gcn.py --requests 64 --batch 8
      PYTHONPATH=src python examples/torch_serve_gcn.py --device cpu
"""

import argparse
import time
from typing import List

import numpy as np
import torch

from repro_torch.core import apply_symmetric_permutation
from repro_torch.device import resolve_device
from repro_torch.graphs import load_dataset
from repro_torch.models.gcn import GCNConfig, init_params
from repro_torch.serve import ServeEngine
from repro_torch.sim import HWConfig, simulate_flexvector


def two_hop(adj_scipy, seeds: np.ndarray) -> np.ndarray:
    """Receptive field of a 2-layer GCN for the seed set."""
    hop1 = adj_scipy[seeds].nonzero()[1]
    frontier = np.unique(np.concatenate([seeds, hop1]))
    hop2 = adj_scipy[frontier].nonzero()[1]
    return np.unique(np.concatenate([frontier, hop2]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seeds-per-request", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch path)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    ds = load_dataset(args.dataset)
    cfg = GCNConfig(in_dim=ds.spec.feature_dim, hidden_dim=64,
                    out_dim=ds.spec.classes, spmm_impl="cuda")
    params = init_params(cfg, torch.Generator().manual_seed(0), dev)
    engine = ServeEngine(ds.adj_norm, ds.features, cfg, params=params,
                         device=dev, max_batch=args.batch,
                         max_seeds=args.seeds_per_request)
    engine.warmup()                          # capture every (rung, batch)

    rng = np.random.default_rng(0)
    requests: List[np.ndarray] = [
        rng.choice(ds.spec.nodes, args.seeds_per_request, replace=False)
        for _ in range(args.requests)
    ]
    adj_sp = ds.adj_norm.to_scipy()

    lat: List[float] = []
    t_all = time.perf_counter()
    for i in range(0, len(requests), args.batch):
        batch = requests[i : i + args.batch]
        t0 = time.perf_counter()
        out = engine.query_batch(batch)      # bucketed, replayed
        dt = time.perf_counter() - t0
        lat.extend([dt / len(batch)] * len(batch))
        fields = [len(two_hop(adj_sp, seeds)) for seeds in batch]
        if i == 0:
            print(f"batch 0: {len(batch)} requests, receptive fields "
                  f"{fields}, first logits {out[0][0][:3]}")
    wall = time.perf_counter() - t_all

    lat_ms = np.asarray(lat) * 1e3
    print(f"\n{args.requests} requests in {wall:.2f}s "
          f"({args.requests / wall:.1f} req/s)")
    print(f"latency per request: p50={np.percentile(lat_ms, 50):.2f} ms "
          f"p95={np.percentile(lat_ms, 95):.2f} ms")

    # what the FlexVector ASIC would do with this aggregation workload
    padj = apply_symmetric_permutation(ds.adj_norm, engine.graph.pre.perm)
    fv = simulate_flexvector(padj, ds.spec.feature_dim, HWConfig(), device=dev)
    per_layer_ms = fv.time_s * 1e3
    print(f"FlexVector ASIC estimate: {per_layer_ms:.2f} ms per aggregation "
          f"layer at 1 GHz ({fv.cycles:.2e} cycles)")


if __name__ == "__main__":
    main()
