"""Setup and phases 2-4 of ``chip_smoke.py`` at one dataset, on the card.

    python3 scripts/chip_phases.py reddit

A quicker run than the whole script for work on the kernels: the kernels
against their plain versions at the main path's shapes (with their
times, bounds and library calls), the public path's dtype check, and the
f32, bf16 and int8 forwards.  No serving, planning or later phase.  The
last line is one ``{"dev_kernels": ...}`` object, each phase 2 entry
summed over the forward's two layers (``scripts/kernel_rows.py`` reads
it)."""
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

def main(dataset: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch.exec as rt
    from repro_torch.graphs.datasets import DATASETS, load_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels import flexvector_spmm as fv
    from repro_torch.models.gcn import GCNConfig, init_params
    from repro_torch.serve import ArtifactRegistry
    dev = torch.device("cuda")
    device, card = cs.phase_device(torch, _build)
    t0 = time.perf_counter()
    spec = DATASETS[dataset]
    data = load_dataset(dataset, seed=cs.SEED)
    cfg = GCNConfig(in_dim=spec.feature_dim, hidden_dim=cs.HIDDEN, out_dim=spec.classes, n_layers=2)
    with tempfile.TemporaryDirectory() as d:
        registry = ArtifactRegistry(cache_dir=d, mem_capacity=16)
        graph = registry.get_or_build(data.adj_norm, cfg, persist=False)
    print(f"setup {dataset}: {time.perf_counter() - t0:.1f} s")
    params = init_params(cfg, torch.Generator().manual_seed(cs.SEED), dev)
    feats = torch.as_tensor(data.features, device=dev)
    t2 = time.perf_counter()
    cases = cs.main_path_cases(torch, rt, graph, cfg, params, feats, dev)
    kernels = cs.phase_kernels(torch, np, fv, cases, dev)
    public = cs.public_dtype_check(torch, np, rt, graph, cfg, dev)
    t3 = time.perf_counter()
    main = cs.phase_main_path(torch, rt, fv, graph, cfg, params, feats, dev, ("f32",), 3)
    quant = cs.phase_main_path(torch, rt, fv, graph, cfg, params, feats, dev, ("bf16", "int8"), 4)
    print(f"phase 2: {t3 - t2:.1f} s, phases 3-4: {time.perf_counter() - t3:.1f} s")
    rows = {k: {f: sum(c[f] for c in v["per_layer"]) for f in ("ms", "bound_ms", "plain_ms", "library_ms")}
            for k, v in kernels.items()}
    for k, v in kernels.items():
        rows[k]["library_call"] = v["per_layer"][0]["library_call"]
        rows[k]["max_abs_err"] = v["max_abs_err"]
        rows[k]["bound_by"] = v["per_layer"][0]["bound_by"]
    print(json.dumps({"dev_kernels": rows, "dataset": dataset, "card": card,
                      "public": public, "forward_ms": {**main["forward_ms"], **quant["forward_ms"]}}))

if __name__ == "__main__":
    main(sys.argv[1])
