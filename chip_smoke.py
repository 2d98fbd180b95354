#!/usr/bin/env python3
"""Drive the repro_torch port on one CUDA card and check it end to end.

    python3 chip_smoke.py                    # PubMed, the default
    python3 chip_smoke.py --dataset reddit   # ~2 min of host preprocessing

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit (``nvidia-smi``), then the
   kernel library built from ``src/repro_torch/csrc`` and its build time.
2. Kernels: each of the four CUDA kernels against its plain PyTorch
   version on the card, at the shapes the main path gives it (both GCN
   layers) and on a small ragged case; timed with CUDA events beside the
   plain version, a library call computing the same function
   (``torch.sparse.mm``, never used by the port) and the least time the
   card could take for the layer's real widths (and, beside it, for the
   block-padded operands the kernel is given).  A small graph's forward
   pass on the card is held against the reference impl on the CPU.
3. Main path: the dataset at its published widths through
   ``GCNGraph.build`` and a 2-layer ``gcn_forward`` under the four kernel
   configs (dense/sparse grid x unfused/fused), each held against the
   reference impl on the card and timed over a few full-graph requests.
   The launch counts are reset just before and must all be > 0 after.

Prints one ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository's ``src/repro_torch`` beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "src/repro_torch/csrc/flexvector_spmm.cu"
REPLACES = {
    "spmm_ell_dense_grid": "src/repro/kernels/flexvector_spmm.py:156",
    "spmm_ell_sparse_grid": "src/repro/kernels/flexvector_spmm.py:271",
    "spmm_ell_fused_dense_grid": "src/repro/kernels/flexvector_spmm.py:426",
    "spmm_ell_fused_sparse_grid": "src/repro/kernels/flexvector_spmm.py:551",
}
KERNELS = tuple(REPLACES)
AGGREGATION = ("spmm_ell_dense_grid", "spmm_ell_sparse_grid")
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# on the CUDA cores (the kernels do f32 FMA, no TF32).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# Kernel vs plain version, as a fraction of max|plain|.  Aggregation: the
# same tau products summed in the same order, only FMA contraction
# differs.  Fused: the kernel re-associates to (sum_t v X[c]) W +
# (sum_t v) b, so each output is an F_in-long f32 dot product taken in
# another order (error ~ sqrt(F_in) * 2^-24 of its magnitude).
REL_TOL = {
    "spmm_ell_dense_grid": 1e-5,
    "spmm_ell_sparse_grid": 1e-5,
    "spmm_ell_fused_dense_grid": 1e-4,
    "spmm_ell_fused_sparse_grid": 1e-4,
}
# Forward vs the reference impl, as a fraction of max|reference|: two
# layers of the above, plus index_add_'s atomics summing vertex-cut
# partials in run-dependent order.
FORWARD_REL_TOL = 1e-4
CONFIGS = (("cuda", False), ("cuda_sparse", False), ("cuda", True),
           ("cuda_sparse", True))
SLEEP_CYCLES = 2_000_000  # ~1 ms of device time that hides host enqueue
HIDDEN = 64      # PubMed's and Reddit's published hidden width
SEED = 0         # graph, features and weights
REPS = 20        # timed launches per kernel and shape
REQUESTS = 10    # timed full-graph requests per config


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# -- measurement helpers -------------------------------------------------------


def device_ms(torch, fn, reps: int, warm: int = 3) -> float:
    """Median device time of ``fn()`` from CUDA events.

    A ~1 ms device-side sleep is queued before each timed call, so the
    host has enqueued the whole call before the start event fires and
    the events bracket device work only.  Data stays warm in L2, as it is
    in the forward pass that produces it.
    """
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(torch, out, ref) -> tuple:
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    return err, err / max(scale, 1e-30)


def ell_csr(torch, cols, vals, n_cols: int, k_limit: int):
    """The ELL table as a (R, n_cols) CSR tensor, slots >= k_limit dropped."""
    r, tau = cols.shape
    keep = (cols >= 0) & (cols < k_limit)
    rows = torch.arange(r, device=cols.device)[:, None].expand(r, tau)[keep]
    coo = torch.sparse_coo_tensor(
        torch.stack([rows, cols[keep].long()]), vals[keep], (r, n_cols),
        check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def work(torch, name: str, args, kw, real=None) -> dict:
    """Least bytes and FLOPs the call needs on these inputs.

    ``real`` is the unpadded ``(rows, output width)`` of the layer; the
    padding rows and columns the kernel is also given are left out of the
    count (``real=None`` counts the operands as given).  Bytes: each input
    read once (only the rows of the dense operand or of X that the ELL
    table references), the output written once.  FLOPs: aggregation 2 per
    counted slot and column; fused, the cheaper of X W on the referenced
    rows then aggregation, or aggregation of X then the product.
    """
    if real is None:
        real = (args[0].shape[0],
                args[2 if name in AGGREGATION else 3].shape[1])
    r, f = real
    cols = args[0][:r]
    tau = cols.shape[1]
    ell_bytes = 8 * r * tau
    if name in AGGREGATION:
        k = args[2].shape[0]
        keep = (cols >= 0) & (cols < k)
        nnz = int(keep.sum())
        uniq = int(torch.unique(cols[keep]).numel())
        sched = sum(4 * a.numel() for a in args[3:])
        nbytes = ell_bytes + sched + 4 * uniq * f + 4 * r * f
        flops = 2 * nnz * f
    else:
        f_in = args[2].shape[1]
        keep = (cols >= 0) & (cols < kw["k_real"])
        nnz = int(keep.sum())
        uniq = int(torch.unique(cols[keep]).numel())
        rows = int(keep.any(dim=1).sum())
        sched = sum(4 * a.numel() for a in args[5:])
        nbytes = (ell_bytes + sched + 4 * uniq * f_in + 4 * f_in * f
                  + 4 * f + 4 * r * f)
        flops = min(2 * uniq * f_in * f + 2 * nnz * f,
                    2 * nnz * f_in + 2 * rows * f_in * f)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def device_busy(torch, fn) -> dict:
    """Device time of one ``fn()`` by kernel name, from ``torch.profiler``
    (kernels, copies and memsets on the card), in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def library_call(torch, name: str, args, kw):
    """One PyTorch call computing the kernel's function (a yardstick)."""
    cols, vals = args[0], args[1]
    if name in AGGREGATION:
        dense = args[2]
        a = ell_csr(torch, cols, vals, dense.shape[0], dense.shape[0])
        return lambda: torch.sparse.mm(a, dense)
    x, w, b = args[2], args[3], args[4]
    a = ell_csr(torch, cols, vals, x.shape[0], kw["k_real"])
    return lambda: torch.sparse.mm(a, torch.addmm(b, x, w))


# -- phases ------------------------------------------------------------------------


def phase_device(torch, build) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    build.load_library()
    print(f"phase 1: kernel library {build.library_path().name} ready in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {build.BUILD_SECONDS:.1f} s)")
    log = build.build_log_path()
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def main_path_cases(torch, rt, graph, cfg, params, feats, dev) -> dict:
    """Each kernel's (args, kwargs, (rows, width)) for both layers of one
    forward pass, built by the same functions the dispatch uses; (rows,
    width) is the unpadded output shape."""
    from repro_torch.exec import quant
    from repro_torch.exec.dispatch import aggregation_args, execute_layer
    from repro_torch.exec.fused import fused_args

    operands, perm, _ = graph.on_device(dev)
    ref_plan = rt.SpmmPlan(impl="reference", block_rows=cfg.block_rows,
                           block_k=cfg.block_k, block_f=cfg.block_f)
    x = feats[perm]
    cases = {name: [] for name in KERNELS}
    for i in range(len(params)):
        layer = params[f"layer_{i}"]
        xw = quant.affine(x, layer, "f32")
        for impl in ("cuda", "cuda_sparse"):
            plan = rt.SpmmPlan(impl=impl, block_rows=cfg.block_rows,
                               block_k=cfg.block_k, block_f=cfg.block_f
                               ).resolve(schedulable=True)
            name, args, kw, real = aggregation_args(plan, operands,
                                                    operands.vals, xw)
            cases[name].append((args, kw, real))
            name, args, kw, real = fused_args(plan, operands, x, layer)
            cases[name].append((args, kw, real))
        x = execute_layer(ref_plan, operands, x, layer)
        if i < len(params) - 1:
            x = torch.relu(x)
    return cases


def ragged_cases(torch, np, dev, seed: int) -> dict:
    """Small case off the main path's grid: F not a multiple of 128, a row
    block with no entries, k_real < K, a schedule that omits an occupied
    tile and a kb_ids list with -1 padding."""
    from repro_torch.core.dataflow import plan_fused_k_schedule, plan_kernel_grid
    from repro_torch.core.sparse_formats import TiledELL
    from repro_torch.kernels.flexvector_spmm import schedule_tile_bitmaps

    rng = np.random.default_rng(seed)
    r, tau, k, f, f_in, br, bk, bf = 64, 5, 48, 40, 37, 16, 16, 8
    cols = rng.integers(0, k, (r, tau)).astype(np.int32)
    cols[rng.random((r, tau)) < 0.3] = -1
    cols[2 * br:3 * br] = -1                       # an empty row block
    vals = rng.standard_normal((r, tau)).astype(np.float32)
    vals[cols < 0] = 0.0
    ell = TiledELL(cols=cols, vals=vals, row_map=np.arange(r, dtype=np.int32),
                   n_dense_rows=k, n_orig_rows=r)
    grid = plan_kernel_grid(ell, f, br, bk, bf)
    drop = int(np.flatnonzero(~grid.first_k)[0])   # an occupied, non-first step
    pairs = np.delete(grid.pairs, drop, axis=0)
    first = np.delete(grid.first_k, drop)
    bitmaps = schedule_tile_bitmaps(pairs[:, 0], pairs[:, 1], first,
                                    r // br, k // bk)
    kb_f = plan_fused_k_schedule(ell, br, bk)
    kb_f = np.concatenate([kb_f[1:], [-1, -1]]).astype(np.int32)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    c, v = t(cols, torch.int32), t(vals)
    dense = t(rng.standard_normal((k, f)))
    x = t(rng.standard_normal((k, f_in)))
    w = t(rng.standard_normal((f_in, f)))
    b = t(rng.standard_normal((1, f)))
    kw = dict(block_rows=br, block_k=bk, block_f=bf)
    fkw = dict(kw, k_real=k - 5)
    return {
        "spmm_ell_dense_grid": ((c, v, dense), kw),
        "spmm_ell_sparse_grid": ((c, v, dense, t(bitmaps, torch.int32)), kw),
        "spmm_ell_fused_dense_grid": ((c, v, x, w, b), fkw),
        "spmm_ell_fused_sparse_grid": ((c, v, x, w, b,
                                        t(kb_f, torch.int32)), fkw),
    }


def phase_kernels(torch, np, fv, cases, dev) -> dict:
    results = {}
    ragged = ragged_cases(torch, np, dev, SEED)
    for name in KERNELS:
        kernel, plain = getattr(fv, name), fv.PLAIN[name]
        args, kw = ragged[name]
        err, rel = rel_err(torch, kernel(*args, **kw), plain(*args, **kw))
        torch.cuda.synchronize()
        print(f"phase 2: {name} ragged max_abs_err={err:.3e} rel={rel:.3e} "
              f"(tol {REL_TOL[name]:.0e})")
        check(rel <= REL_TOL[name], f"{name} disagrees with its plain version "
              f"on the ragged case: rel err {rel:.3e}")
        entry = {"max_abs_err": err, "max_rel_err": rel, "per_layer": []}
        for layer, (args, kw, real) in enumerate(cases[name]):
            out, ref = kernel(*args, **kw), plain(*args, **kw)
            err, rel = rel_err(torch, out, ref)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"{name} non-finite output")
            check(rel <= REL_TOL[name], f"{name} layer {layer} disagrees with "
                  f"its plain version: rel err {rel:.3e}")
            cell = work(torch, name, args, kw, real)
            padded = work(torch, name, args, kw)
            cell.update(
                shape=[list(a.shape) for a in args],
                real_shape=list(real),
                padded_bound_ms=padded["bound_ms"],
                padding_byte_share=1.0 - cell["bytes"] / padded["bytes"],
                max_abs_err=err,
                ms=device_ms(torch, lambda: kernel(*args, **kw), REPS),
                plain_ms=device_ms(torch, lambda: plain(*args, **kw), REPS),
                library_ms=device_ms(torch, library_call(torch, name, args, kw),
                                     REPS),
            )
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            entry["max_rel_err"] = max(entry["max_rel_err"], rel)
            entry["per_layer"].append(cell)
            print(f"phase 2: {name} layer {layer} {cell['shape']} real "
                  f"{cell['real_shape']} max_abs_err={err:.3e} rel={rel:.3e} "
                  f"ms={cell['ms']:.4f} plain_ms={cell['plain_ms']:.4f} "
                  f"library_ms={cell['library_ms']:.4f} "
                  f"bound_ms={cell['bound_ms']:.4f} ({cell['bound_by']}) "
                  f"padded_bound_ms={cell['padded_bound_ms']:.4f} "
                  f"padding_byte_share={cell['padding_byte_share']:.3f}")
        results[name] = entry
    return results


def small_forward_check(torch, np, rt, dev) -> None:
    """A small graph's forward on the card against the reference impl on
    the CPU, under the four kernel configs."""
    from repro_torch.core.sparse_formats import random_power_law_csr
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.gcn import GCNConfig, GCNGraph, gcn_forward

    adj = random_power_law_csr(96, 96, 700, seed=0)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((96, 12)).astype(np.float32)
    raw = {f"layer_{i}": {"w": rng.standard_normal(s).astype(np.float32),
                          "b": rng.standard_normal(s[1]).astype(np.float32)}
           for i, s in enumerate([(12, 64), (64, 8)])}
    base = dict(in_dim=12, hidden_dim=64, out_dim=8, block_rows=16,
                block_k=16, block_f=16)
    cfg = GCNConfig(**base)
    graph = GCNGraph.build(adj, cfg)
    ref = gcn_forward(params_from_numpy(raw, "cpu"), graph, feats, cfg,
                      device="cpu")
    params = params_from_numpy(raw, dev)
    for impl, fused in CONFIGS:
        plan = rt.SpmmPlan(impl=impl, block_rows=16, block_k=16, block_f=16,
                           fused=fused)
        out = gcn_forward(params, graph, feats, cfg, plan=plan, device=dev)
        err, rel = rel_err(torch, out.cpu(), ref)
        print(f"phase 2: small forward {impl} fused={fused} vs CPU reference "
              f"rel={rel:.3e}")
        check(rel <= FORWARD_REL_TOL, f"small forward {impl} fused={fused} "
              f"rel err {rel:.3e}")


def phase_main_path(torch, rt, fv, graph, cfg, params, feats, dev) -> dict:
    from repro_torch.models.gcn import gcn_forward

    ref_plan = rt.SpmmPlan(impl="reference", block_rows=cfg.block_rows,
                           block_k=cfg.block_k, block_f=cfg.block_f)
    ref = gcn_forward(params, graph, feats, cfg, plan=ref_plan, device=dev)
    torch.cuda.synchronize()
    timings, busy = {}, {}
    fv.reset_launches()
    for impl, fused in CONFIGS:
        plan = rt.SpmmPlan(impl=impl, block_rows=cfg.block_rows,
                           block_k=cfg.block_k, block_f=cfg.block_f,
                           fused=fused)
        times = []
        for i in range(3 + REQUESTS):
            t0 = time.perf_counter()
            out = gcn_forward(params, graph, feats, cfg, plan=plan, device=dev)
            torch.cuda.synchronize()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        check(tuple(out.shape) == (graph.n_nodes, cfg.out_dim),
              f"{impl} fused={fused}: output shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{impl} fused={fused}: "
              "non-finite logits")
        err, rel = rel_err(torch, out, ref)
        check(rel <= FORWARD_REL_TOL, f"{impl} fused={fused} disagrees with "
              f"the reference impl: rel err {rel:.3e}")
        key = f"{impl}{'+fused' if fused else ''}"
        timings[key] = statistics.median(times)
        print(f"phase 3: {key} forward median {timings[key]:.3f} ms over "
              f"{REQUESTS} requests, vs reference max_abs_err={err:.3e} "
              f"rel={rel:.3e}")
        busy[key] = device_busy(torch, lambda: gcn_forward(
            params, graph, feats, cfg, plan=plan, device=dev))
    launches = dict(fv.LAUNCHES)
    print(f"phase 3: launches {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    ref_times = []
    for _ in range(3 + REQUESTS):
        t0 = time.perf_counter()
        gcn_forward(params, graph, feats, cfg, plan=ref_plan, device=dev)
        torch.cuda.synchronize()
        ref_times.append((time.perf_counter() - t0) * 1e3)
    timings["reference"] = statistics.median(ref_times[3:])
    print(f"phase 3: reference forward median {timings['reference']:.3f} ms")
    busy["reference"] = device_busy(torch, lambda: gcn_forward(
        params, graph, feats, cfg, plan=ref_plan, device=dev))
    idle = {}
    for key, kernels in busy.items():
        total = sum(kernels.values())
        if total == 0.0:
            print(f"phase 3: {key} device time not measured (no device "
                  "events in the profile)")
            continue
        idle[key] = max(0.0, 1.0 - total / timings[key])
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
        print(f"phase 3: {key} device busy {total:.3f} ms of "
              f"{timings[key]:.3f} ms (idle share {idle[key]:.2f}); top: "
              + "; ".join(f"{name[:60]} {ms:.3f}" for name, ms in top))
    return {"launches": launches, "forward_ms": timings,
            "device_busy_ms": {k: sum(v.values()) for k, v in busy.items()},
            "device_idle_share": idle}


def run(args) -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    sys.path.insert(0, src)
    try:
        import numpy as np
        import repro_torch
        import repro_torch.exec as rt
        from repro_torch.graphs.datasets import DATASETS, load_dataset
        from repro_torch.kernels import _build
        from repro_torch.kernels import flexvector_spmm as fv
        from repro_torch.models.gcn import GCNConfig, GCNGraph, init_params
    except ImportError as e:
        print(f"chip_smoke: the repository's port is not here ({e})",
              file=sys.stderr)
        return 1
    if not os.path.abspath(repro_torch.__file__).startswith(src + os.sep):
        print("chip_smoke: repro_torch does not come from this checkout",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    device = phase_device(torch, _build)

    t0 = time.perf_counter()
    spec = DATASETS[args.dataset]
    data = load_dataset(args.dataset, seed=SEED)
    cfg = GCNConfig(in_dim=spec.feature_dim, hidden_dim=HIDDEN,
                    out_dim=spec.classes, n_layers=2)
    graph = GCNGraph.build(data.adj_norm, cfg)
    ell = graph.pre.ell
    print(f"setup: {args.dataset} {spec.nodes} nodes, ELL {ell.padded_rows}x"
          f"{ell.tau} ({ell.nnz} nnz), built in "
          f"{time.perf_counter() - t0:.1f} s")
    params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    feats = torch.as_tensor(data.features, device=dev)

    cases = main_path_cases(torch, rt, graph, cfg, params, feats, dev)
    kernels = phase_kernels(torch, np, fv, cases, dev)
    small_forward_check(torch, np, rt, dev)
    main = phase_main_path(torch, rt, fv, graph, cfg, params, feats, dev)

    lines = []
    for name in KERNELS:
        k = kernels[name]
        cells = k["per_layer"]
        top = max(cells, key=lambda c: c["bound_ms"])
        lines.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": main["launches"][name],
            "max_abs_err": k["max_abs_err"],
            "max_rel_err": k["max_rel_err"],
            "rel_tol": REL_TOL[name],
            # per forward pass: the sum over its two layer launches
            "ms": sum(c["ms"] for c in cells),
            "us": 1e3 * sum(c["ms"] for c in cells),
            "plain_ms": sum(c["plain_ms"] for c in cells),
            "bound_ms": sum(c["bound_ms"] for c in cells),
            "bound_by": top["bound_by"],
            "padded_bound_ms": sum(c["padded_bound_ms"] for c in cells),
            "library_ms": sum(c["library_ms"] for c in cells),
            "per_layer": cells,
        })
    print(json.dumps({"kernels": lines, "dataset": args.dataset,
                      "forward_ms": main["forward_ms"],
                      "device_busy_ms": main["device_busy_ms"],
                      "device_idle_share": main["device_idle_share"]}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="pubmed", choices=("pubmed", "reddit"))
    args = ap.parse_args()
    try:
        return run(args)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
