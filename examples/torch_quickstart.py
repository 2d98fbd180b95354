"""Quickstart (PyTorch + CUDA port): FlexVector SpMM for one GCN
aggregation on a Cora-scale graph.

The port's counterpart of ``examples/quickstart.py``:
  dataset -> hybrid preprocessing (edge-cut + vertex-cut) -> bounded-row
  ELL -> SpMM (reference, or the CUDA kernels) -> PPA estimate from the
  instruction-driven simulator (its tile statistics grouped on the card).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--impl cuda_sparse]
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core import apply_symmetric_permutation, preprocess, spmm_ell
from repro_torch.device import resolve_device
from repro_torch.graphs import label_propagation_permutation, load_dataset
from repro_torch.sim import GROWConfig, HWConfig, simulate_flexvector, simulate_grow


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="cora")
    ap.add_argument("--impl", default="reference",
                    choices=["reference", "cuda", "cuda_sparse"])
    ap.add_argument("--tau", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch path)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    ds = load_dataset(args.dataset)
    print(f"{ds.spec.name}: {ds.spec.nodes} nodes, {ds.adj.nnz // 2} edges, "
          f"F={ds.spec.feature_dim}")

    # 1. hybrid preprocessing (Section IV): edge-cut + vertex-cut -> ELL
    t0 = time.perf_counter()
    pre = preprocess(ds.adj_norm, tau=args.tau, tile_rows=16,
                     edge_cut="rcm", pad_rows_to=128)
    print(f"preprocess: {time.perf_counter() - t0:.2f}s -> "
          f"{pre.ell.padded_rows} sub-rows, tau={pre.ell.tau}, "
          f"{len(pre.tiles)} tiles")

    # 2. aggregation SpMM: A_hat @ X
    x = torch.as_tensor(ds.features[pre.perm], device=dev)
    t0 = time.perf_counter()
    out = spmm_ell(pre.ell, x, impl=args.impl, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"spmm[{args.impl}]: {time.perf_counter() - t0:.2f}s, "
          f"out shape {tuple(out.shape)}")

    # 3. validate against the scipy oracle
    want = (ds.adj_norm.to_scipy() @ np.asarray(ds.features))[pre.perm]
    err = np.abs(out.cpu().numpy().astype(np.float64) - want).max()
    print(f"max |err| vs scipy oracle: {err:.2e}")

    # 4. PPA estimate (paper's evaluation vehicle) under the METIS-like
    #    label-propagation edge-cut
    lp = label_propagation_permutation(ds.adj_norm, device=dev)
    padj = apply_symmetric_permutation(ds.adj_norm, lp)
    fv = simulate_flexvector(padj, ds.spec.feature_dim, HWConfig(), device=dev)
    gl = simulate_grow(padj, ds.spec.feature_dim, GROWConfig(), device=dev)
    print(f"FlexVector : {fv.cycles:.3e} cycles, {fv.energy_j * 1e6:.1f} uJ, "
          f"{fv.area_um2 / 1e3:.1f} K um^2")
    print(f"GROW-like  : {gl.cycles:.3e} cycles, {gl.energy_j * 1e6:.1f} uJ, "
          f"{gl.area_um2 / 1e3:.1f} K um^2")
    print(f"speedup {gl.cycles / fv.cycles:.2f}x, "
          f"energy -{(1 - fv.energy_pj / gl.energy_pj) * 100:.1f}%")


if __name__ == "__main__":
    main()
