#!/usr/bin/env python3
"""Fit the H100 cost model's kernel rates on the card.

    python3 scripts/fit_device_model.py                      # PubMed, Reddit
    python3 scripts/fit_device_model.py --datasets pubmed

``repro_torch.plan.cost.H100`` prices what the port's kernels move (its
module docstring): each step's work is counted from the shapes by
``cost.cuda_spmm_work`` / ``cuda_fused_work`` / ``cuda_combination_work``
and turned into time at the rates of ``cost.CudaRates``.  This script
measures those steps on the card and fits the rates from the same work
counts.  For each dataset at chip_smoke's configuration (published
widths, 2 layers, hidden 64, seed 0), each storage precision and both
layers of the static forward, it times with CUDA events
(``chip_smoke.device_ms``):

* the combination (``quant.affine``),
* the unfused SpMM as the dispatch runs it (``exec.dispatch.execute``:
  the cast, B1 or B2, the fold) and the fold alone,
* the fused kernel B3 split into zero fill, tile product and scatter
  (``chip_smoke.fused_split``),

and on the host clock the static forwards, unfused and fused
(``chip_smoke.timed_forwards``).  The fits, each a ratio of summed work
to summed time over the cells named:

* ``fold_bw``: Reddit folds, sub-row bytes over their time less the
  output's write at 3.35 TB/s;
* ``gather_bw``: Reddit B1 SpMMs, gathered bytes over their time less
  the HBM bytes at 3.35 TB/s and the fold at ``fold_bw``;
* ``bitmap_s``: Reddit B2 less B1 SpMM time, over the bitmap tests;
* ``scatter_bw``: Reddit fused scatters, read-modify-write bytes over
  the split's scatter time less the slot decode at 3.35 TB/s;
* ``tile_flops_f32`` / ``tile_flops_bf16``: Reddit tile FLOPs over the
  split's product time, at f32 and at bf16/int8;
* ``gemm_flops``: Reddit f32 combinations, FLOPs over their time less
  the bias pass at 3.35 TB/s;
* ``launch_s``: PubMed forwards (host-bound), host time over the
  model's launches.

Prints the card's name and power limit, one JSON line per measured cell,
the fitted rates as one ``{"fitted": ...}`` line and, under them, each
forward's measured ms beside the model's (``exec.pipeline.layer_seconds``
summed over the layers) as ``{"forwards": ...}``.  Needs one CUDA card;
Reddit adds ~1.5 min of host preprocessing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
HIDDEN = 64
PRECISIONS = ("f32", "bf16", "int8")


def measure(torch, smoke, name: str, dev) -> dict:
    """The dataset's cells on ``dev``: per precision and layer, the step
    times (ms) and the model's work counts of each step."""
    from repro_torch.core.spmm import segment_accumulate
    from repro_torch.exec import quant
    from repro_torch.exec.dispatch import (aggregation_args, execute,
                                           execute_layer, prepare_precision)
    from repro_torch.exec.fused import fused_args
    from repro_torch.exec.plan import SpmmPlan
    from repro_torch.graphs.datasets import DATASETS, load_dataset
    from repro_torch.kernels import flexvector_spmm as fv
    from repro_torch.models.gcn import GCNConfig, GCNGraph, gcn_forward, init_params
    from repro_torch.plan import cost

    spec = DATASETS[name]
    data = load_dataset(name, seed=SEED)
    cfg = GCNConfig(in_dim=spec.feature_dim, hidden_dim=HIDDEN,
                    out_dim=spec.classes, n_layers=2, spmm_impl="cuda")
    graph = GCNGraph.build(data.adj_norm, cfg)
    stats = cost.graph_stats_from_ell(graph.pre.ell)
    operands, perm, _ = graph.on_device(dev)
    params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    feats = torch.as_tensor(data.features, device=dev)
    blocks = dict(block_rows=cfg.block_rows, block_k=cfg.block_k,
                  block_f=cfg.block_f)
    br = cfg.block_rows
    cells, forwards = [], []
    for precision in PRECISIONS:
        qparams = quant.quantize_params(params, precision, br)
        ref_plan = SpmmPlan(impl="reference", precision=precision, **blocks)
        x = feats[perm]
        for i in range(cfg.n_layers):
            layer = qparams[f"layer_{i}"]
            f_in, f_out = x.shape[1], layer["b"].shape[0]
            cell = {"dataset": name, "precision": precision, "layer": i,
                    "f_in": f_in, "f_out": f_out,
                    "n_out_rows": stats.n_out_rows}
            cell["comb_ms"] = smoke.device_ms(
                torch, lambda: quant.affine(x, layer, precision, br), smoke.REPS)
            cell["comb_work"] = cost.cuda_combination_work(
                stats.n_dense_rows, f_in, f_out, precision)
            xw = quant.affine(x, layer, precision, br)
            for impl in ("cuda", "cuda_sparse"):
                plan = SpmmPlan(impl=impl, precision=precision,
                                **blocks).resolve(schedulable=True)
                cell[f"{impl}_spmm_ms"] = smoke.device_ms(
                    torch, lambda: execute(plan, operands, xw), smoke.REPS)
                cell[f"{impl}_spmm_work"] = cost.cuda_spmm_work(
                    stats, f_out, impl=impl, block_rows=br,
                    block_k=cfg.block_k, precision=precision)
            plan = SpmmPlan(impl="cuda", precision=precision,
                            **blocks).resolve(schedulable=True)
            vals, scales, dense = prepare_precision(plan, operands, xw)
            kname, args, kw, (r, f) = aggregation_args(plan, operands, vals,
                                                       dense, scales)
            sub = fv.KERNELS[kname](*args, **kw)[:r, :f]
            cell["fold_ms"] = smoke.device_ms(
                torch, lambda: segment_accumulate(sub, operands.row_map,
                                                  operands.n_out_rows),
                smoke.REPS)
            plan = SpmmPlan(impl="cuda", precision=precision, fused=True,
                            **blocks).resolve(schedulable=True)
            kname, args, kw, real = fused_args(plan, operands, x, layer, br)
            kernel = fv.KERNELS[kname]
            full = smoke.device_ms(torch, lambda: kernel(*args, **kw),
                                   smoke.REPS)
            cell["fused_split"] = smoke.fused_split(
                torch, kernel, args, kw, real + (f_in,), full)
            cell["fused_work"] = cost.cuda_fused_work(
                stats, f_in, f_out, impl="cuda", block_rows=br,
                block_k=cfg.block_k, block_f=cfg.block_f,
                precision=precision)
            cells.append(cell)
            print(json.dumps({"cell": cell}))
            x = execute_layer(ref_plan, operands, x, layer, w_block_rows=br)
            if i < cfg.n_layers - 1:
                x = torch.relu(x)
        for fused in (False, True):
            plan = SpmmPlan(impl="cuda", fused=fused, **blocks)
            ms, _ = smoke.timed_forwards(
                torch, lambda: gcn_forward(params, graph, feats, cfg,
                                           plan=plan, precision=precision,
                                           device=dev))
            fwd = {"dataset": name, "precision": precision, "fused": fused,
                   "forward_ms": ms}
            forwards.append(fwd)
            print(json.dumps({"forward": fwd}))
    return {"cells": cells, "forwards": forwards, "stats": stats, "cfg": cfg}


def fit(results: dict) -> dict:
    """The rates, from the cells of ``results`` (dataset -> measure())."""
    from repro_torch.plan import cost

    hbm = cost.H100.hbm_bw
    big = results.get("reddit", results.get("pubmed"))["cells"]

    def ratio(num, den):
        return sum(num) / sum(den)

    # the fold's output rows written at the HBM rate
    fold_bw = ratio(
        [c["cuda_spmm_work"]["fold"] for c in big],
        [c["fold_ms"] * 1e-3 - c["n_out_rows"] * c["f_out"] * 4 / hbm
         for c in big])
    gather_bw = ratio(
        [c["cuda_spmm_work"]["gather"] for c in big],
        [c["cuda_spmm_ms"] * 1e-3 - c["cuda_spmm_work"]["hbm"] / hbm
         - c["cuda_spmm_work"]["fold"] / fold_bw for c in big])
    bitmap_s = ratio(
        [c["cuda_sparse_spmm_ms"] * 1e-3 - c["cuda_spmm_ms"] * 1e-3
         for c in big],
        [c["cuda_sparse_spmm_work"]["bitmap"] for c in big])
    scatter_bw = ratio(
        [c["fused_work"]["scatter"] for c in big],
        [c["fused_split"]["scatter_ms"] * 1e-3
         - c["fused_split"]["decode_floor_ms"] * 1e-3 for c in big])
    tile = {}
    for key, precs in (("f32", ("f32",)), ("bf16", ("bf16", "int8"))):
        sel = [c for c in big if c["precision"] in precs]
        tile[key] = ratio([c["fused_work"]["tile_flops"] for c in sel],
                          [c["fused_split"]["product_ms"] * 1e-3 for c in sel])
    f32 = [c for c in big if c["precision"] == "f32"]
    gemm_flops = ratio(
        [c["comb_work"]["flops"] for c in f32],
        [c["comb_ms"] * 1e-3 - c["comb_work"]["hbm"] / hbm for c in f32])
    small = results.get("pubmed", results.get("reddit"))
    launches = []
    for fwd in small["forwards"]:
        n = 0
        for c in small["cells"]:
            if c["precision"] != fwd["precision"]:
                continue
            if fwd["fused"]:
                n += c["fused_work"]["launches"]
            else:
                n += (c["cuda_spmm_work"]["launches"]
                      + c["comb_work"]["launches"])
        launches.append(n)
    launch_s = ratio([f["forward_ms"] * 1e-3 for f in small["forwards"]],
                     launches)
    return {"gather_bw": gather_bw, "bitmap_s": bitmap_s, "fold_bw": fold_bw,
            "scatter_bw": scatter_bw, "gemm_flops": gemm_flops,
            "tile_flops_f32": tile["f32"], "tile_flops_bf16": tile["bf16"],
            "launch_s": launch_s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--datasets", nargs="+", default=["pubmed", "reddit"],
                    choices=("pubmed", "reddit"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("fit_device_model: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch.exec.pipeline import layer_seconds
    from repro_torch.exec.plan import SpmmPlan
    from repro_torch.plan import cost

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    results = {}
    for name in args.datasets:
        results[name] = measure(torch, smoke, name, torch.device("cuda"))
    rates = fit(results)
    print(json.dumps({"fitted": rates}))
    device = dataclasses.replace(cost.H100, cuda=cost.CudaRates(**rates))
    out = []
    for name, res in results.items():
        cfg, stats = res["cfg"], res["stats"]
        dims = ((cfg.in_dim, cfg.hidden_dim), (cfg.hidden_dim, cfg.out_dim))
        for fwd in res["forwards"]:
            plan = SpmmPlan(impl="cuda", block_rows=cfg.block_rows,
                            block_k=cfg.block_k, block_f=cfg.block_f,
                            precision=fwd["precision"], fused=fwd["fused"])
            modeled = 1e3 * sum(layer_seconds(stats, plan, fi, fo,
                                              device=device)
                                for fi, fo in dims)
            out.append(dict(fwd, modeled_ms=modeled,
                            measured_over_modeled=fwd["forward_ms"] / modeled))
    print(json.dumps({"forwards": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
