#!/usr/bin/env python3
"""Drive the repro_torch port on one CUDA card and check it end to end.

    python3 chip_smoke.py                    # PubMed, the default
    python3 chip_smoke.py --dataset reddit   # ~2 min of host preprocessing

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit (``nvidia-smi``), then the
   kernel library built from ``src/repro_torch/csrc`` and its build time.
2. Kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it (both GCN layers) and on a
   small ragged case: the four f32 kernels, their bf16 instantiations
   (``name@bf16``) and their int8 ``_scaled`` variants.  Each is timed with
   CUDA events beside the plain version, a library call computing the same
   function (``torch.sparse.mm``, never used by the port) and the least
   time the card could take for the layer's real widths at its storage
   widths (and, beside it, for the block-padded operands the kernel is
   given).  Each aggregation launch prints its column slabs and its
   gather rate (the slots' dense rows at their 16-byte-rounded width over
   its time; above the HBM rate, the gathers hit L2), and a case whose
   dense operand needs two or more slabs (300,032 x 64 f32, 77 MB) is held
   against the plain version at every precision.  Each fused kernel's time
   is split into the zero fill of its output, the product (its tiles of
   ``X W + b`` alone) and the scatter, beside the scatter's and the fill's
   floor in device memory.
   As a control, the fused bf16/int8 plain version without its bf16
   rounding of ``X W + b`` must fail the agreement check.  A small graph's
   forward pass on the card, at each precision, is held against the same
   precision on the CPU.
3. Main path, f32: the dataset at its published widths through
   ``GCNGraph.build`` and a 2-layer ``gcn_forward`` under the four kernel
   configs (dense/sparse grid x unfused/fused), each held against the
   reference impl on the card and timed over a few full-graph requests.
   The launch counts are reset just before; each of the four kernels must
   have launched on f32 values after, and none on other values.
4. Main path, bf16 and int8: the same four configs at
   ``precision="bf16"``, then at ``"int8"``, each held against the
   reference impl at the same precision and against the f32 reference's
   logits within the reference's budgets (bf16 0.02, int8 0.05).  The
   launch counts are reset before each precision and read after it: every
   kernel of that precision (the four at bf16, the four ``_scaled`` ones at
   int8) must have launched on values of that precision, and no kernel on
   values of another.  As a control, the f32 forward in the place of each
   must fail the agreement check.

5. Serving: ``ServeEngine`` (the port's registry, sampler, bucketed
   micro-batcher and CUDA graphs) at the serving CLI's defaults, sharing
   phase 3's ``ArtifactRegistry`` (so the dataset is preprocessed once:
   its ``builds`` count does not move when an engine is built).  Engines:
   ``cuda`` at f32, bf16 and int8, fused at f32 and int8, and
   ``cuda_sparse``, which must record its degradation to the dense grid
   in the batcher (at Reddit only f32 unfused and int8 fused).  For each:
   warmup captures one CUDA graph per (rung, batch); then, timed, a slice
   of the CLI's request draw that no engine has served (so each request
   pays its subgraph's preprocessing; the registry's builds and memory
   hits in the window are printed), some through ``query`` and the rest
   in one ``query_batch``, and 100 full-graph forwards, with no capture
   after warmup.  Every answer is held against an ``impl="reference"``
   engine on the card at the same precision, a sample against an eager
   ``gcn_forward`` over each request's own subgraph (no batcher, no
   replay), and requests found for every warmed rung run through
   ``batcher.run`` at batches of 1, 2, 3, 4 and 8 against eager forwards.
   One ``query_batch`` is profiled: its device kernels must include the
   port's aggregation kernel (the fused kernel for fused engines) and no
   library sparse kernel.  The wrappers' counts in the timed window are
   the full-graph steps' launches; each captured graph keeps one
   forward's launches, and replays x those are the replays' launches.
   Uncapped queries on the small graph of phase 2 are held against
   full-graph rows.  Prints n, p50 and (from 100 requests up) p99 per
   scenario, requests/s and the batch's device idle share.

6. Planning: the cost model on the H100 model (``plan.cost.H100``) over
   the same graph with the ``cuda`` config.  At f32, bf16 and int8 it
   plans the pipeline (``exec.pipeline.plan_pipeline``: each layer's
   impl, blocks, fusion and k-order, the candidates priced and the host
   seconds it took) and runs ``gcn_forward(plan="auto")`` once with the
   launch counts reset just before and read just after: the chosen
   kernels, and no other, must have launched; the logits are held against
   the reference impl at phase 4's limits.  Then it times the chosen
   pipeline, the static unfused and the static fused plan in interleaved
   rounds (300 at PubMed, 20 at Reddit), each median beside the model's
   ms and the measured-to-modeled ratio: each chosen forward must be
   within 10% of the static unfused one.  At Reddit the f32 choice must
   be unfused and the model within 0.5x-2x of the chosen and static
   unfused forwards.  At PubMed one engine with ``autoplan=True``,
   ``precision="auto"`` and ``ladder_growth="auto"`` (the registry of
   phase 3, the serving CLI's other defaults) prints each warmed rung's
   plans and precision and the full-graph step's modeled ms per
   precision; its full-graph step, timed against its f32 step over 300
   interleaved rounds, must be within 10% of it.  It serves 100 queries
   and 100 batched requests that phase 5 did not, captures nothing after
   warmup and answers as an ``impl="reference"`` engine at the same
   precisions does, within phase 5's limits.

Prints one ``{"fused_split": ...}`` line, one ``{"kernels": [...]}`` line,
one ``{"serving": ...}`` line and one ``{"planning": ...}`` line, then as
the last line ``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository's ``src/repro_torch`` beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "src/repro_torch/csrc/flexvector_spmm.cu"
_TPU = "src/repro/kernels/flexvector_spmm.py"
REPLACES = {
    "spmm_ell_dense_grid": f"{_TPU}:156",
    "spmm_ell_sparse_grid": f"{_TPU}:271",
    "spmm_ell_fused_dense_grid": f"{_TPU}:426",
    "spmm_ell_fused_sparse_grid": f"{_TPU}:551",
    "spmm_ell_dense_grid_scaled": f"{_TPU}:164",
    "spmm_ell_sparse_grid_scaled": f"{_TPU}:288",
    "spmm_ell_fused_dense_grid_scaled": f"{_TPU}:437",
    "spmm_ell_fused_sparse_grid_scaled": f"{_TPU}:570",
}
KERNELS = tuple(REPLACES)   # the eight pallas_call sites
BASE = KERNELS[:4]
PRECISIONS = ("f32", "bf16", "int8")
# Phase 2's entries: a kernel name, "@bf16" for its bf16 instantiation.
KEYS = BASE + tuple(f"{n}@bf16" for n in BASE) + KERNELS[4:]
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 on
# the CUDA cores (the f32 kernels do f32 FMA, no TF32) and dense bf16 on
# the tensor cores, the least time for products of bf16 and int8 inputs.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
# Agreement of an output with its reference takes two limits: its
# largest error, as a fraction of max|reference| (REL_TOL,
# FORWARD_REL_TOL), and the share of its elements off by more than
# FLIP_REL of max|reference|, which must stay <= FLIP_SHARE (kernels) or
# FORWARD_FLIP_SHARE (forwards).
#
# Kernel vs plain version.  Aggregation: the same tau products summed in
# the same slot order, only FMA contraction differs.  Fused f32: each
# element of X W + b is an F_in-long f32 dot product taken in another order
# than the plain version's matmul (error ~ sqrt(F_in) * 2^-24 of its
# magnitude),
# and the kernel's atomics add the tau terms of an output row in an order
# that changes from run to run.  Fused bf16/int8: X W + b is summed in
# another f32 order before its bf16 rounding, so an element near a rounding
# boundary can land one bf16 ulp (2^-8 of itself) away.  Such flips are
# rare, so the largest error may reach 8e-3 while few elements differ; a
# kernel that skipped the rounding would differ in most of them (the
# phase 2 control).
REL_TOL = {
    "spmm_ell_dense_grid": 1e-5,
    "spmm_ell_sparse_grid": 1e-5,
    "spmm_ell_fused_dense_grid": 1e-4,
    "spmm_ell_fused_sparse_grid": 1e-4,
}
for _n in BASE:
    REL_TOL[f"{_n}@bf16"] = REL_TOL[f"{_n}_scaled"] = (
        8e-3 if "fused" in _n else 1e-5)
FLIP_REL = 1e-5
FLIP_SHARE = 1e-2
# Forward vs the reference impl: two layers of the above, plus
# index_add_'s atomics summing vertex-cut partials in run-dependent order.
# bf16/int8: a rounding flip in a layer's X W + b moves the logits of the
# rows that aggregate it by far less than the 2e-3 limit.  int8 values
# times their scale are not exact in f32, so their products summed in
# another order move layer 1's output by an ulp and flip some of layer
# 2's roundings: a few per mille of the logits move.  The f32 forward in
# bf16's or int8's place moves most of them by about 2e-3 or more (the
# phase 4 control).
FORWARD_REL_TOL = {"f32": 1e-4, "bf16": 2e-3, "int8": 2e-3}
FORWARD_FLIP_SHARE = 5e-2
# Served answers are their seeds' logits, and a seed aggregates the hidden
# rows of its whole neighbourhood (hundreds at Reddit, a hub's in the
# larger rungs), so one bf16 rounding flip among them moves all of its
# logits: the share that moves is the share of seeds with a flip in their
# field, not the few per mille of phase 4's whole graph (up to 0.15 of a
# handful of hub seeds on the card).  The f32 forward in bf16's or int8's
# place moves 0.8-0.98 of the elements (the phase 2 and 4 controls, and
# phase 5's own on the eager sample), so the limit still tells them apart.
SERVE_FLIP_SHARE = {"f32": FORWARD_FLIP_SHARE, "bf16": 0.25, "int8": 0.25}
# Logits vs the f32 reference: the reference's budgets
# (tests/test_quant.py).
LOGIT_BUDGET = {"bf16": 0.02, "int8": 0.05}
CONFIGS = (("cuda", False), ("cuda_sparse", False), ("cuda", True),
           ("cuda_sparse", True))
SLEEP_CYCLES = 2_000_000  # ~1 ms of device time that hides host enqueue
HIDDEN = 64      # PubMed's and Reddit's published hidden width
SEED = 0         # graph, features and weights
REPS = 20        # timed launches per kernel and shape
REQUESTS = 10    # timed full-graph requests per config
MULTI_SLAB_K = 300_032   # phase 2's multi-slab case: 2,344 k-tiles of 128
# Phase 5: the serving CLI's defaults (repro_torch.launch.serve_gcn) and
# its request draw, 1-4 seeds per request from numpy seed 0.  Each engine
# serves its own slice of one draw in which no seed set repeats, so no
# timed request has been served before (the registry keeps every subgraph
# it preprocessed).  Per engine: ``queries`` requests through query, the
# ``batch`` after them in one query_batch, ``full`` full-graph forwards.
SERVE = dict(fanout=16, max_batch=8, max_seeds=4, base_bucket_nodes=256)
SERVE_LOAD = {"pubmed": dict(queries=300, batch=400, full=100),
              "reddit": dict(queries=200, batch=300, full=100)}
P99_MIN_REQUESTS = 100    # a scenario timed over fewer reports no p99
SERVE_EAGER_CHECKED = 16  # answers per engine held against eager forwards
SERVE_PER_RUNG = 2        # requests found for each warmed rung
# (impl, precision, fused) of each phase 5 engine, grouped by precision so
# that each precision's reference engine is built once.  Reddit's requests
# cost more host time: it runs f32 unfused and int8 fused.
SERVE_ENGINES = {
    "pubmed": (("cuda", "f32", False), ("cuda", "f32", True),
               ("cuda_sparse", "f32", False), ("cuda", "bf16", False),
               ("cuda", "int8", False), ("cuda", "int8", True)),
    "reddit": (("cuda", "f32", False), ("cuda", "int8", True)),
}
# Phase 6: planning.  The requests of the autoplanned PubMed engine, the
# limits of the H100 model's modeled ms against the measured ms of the
# Reddit forwards, and how much slower than the static unfused forward
# the chosen one may be (at PubMed and Reddit), and the autoplanned
# engine's full-graph step than its f32 step.
PLAN_LOAD = dict(queries=100, batch=100)
MODEL_RATIO = (0.5, 2.0)
PLAN_SLOWER = 1.10
# Phase 6 times the forwards it compares in interleaved rounds, one of
# each per round, and holds their medians: PubMed's forwards take ~0.5-2
# ms of mostly host time, so it takes hundreds of rounds to rise above
# the host's noise; Reddit's take 8-16 ms of device time.
PLAN_ROUNDS = {"pubmed": 300, "reddit": 20}
# Kernel names in the profile of a replayed batch (csrc/flexvector_spmm.cu),
# and names of library sparse kernels that must not appear there.
AGGREGATION_KERNEL = "ell_aggregate_kernel"
FUSED_KERNEL = "ell_fused_xw_kernel"
LIBRARY_SPARSE = ("sparse", "csrmm", "coomm", "spmm")


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


def agreement(torch, out, ref, real=None) -> dict:
    """``out`` vs ``ref`` over their first ``real = (rows, cols)`` (all
    of them by default): the largest error ``err``, ``rel`` = ``err`` /
    max|ref| and ``flip_share``, the share of elements off by more than
    FLIP_REL of max|ref|."""
    if real is not None:
        out, ref = out[:real[0], :real[1]], ref[:real[0], :real[1]]
    if not out.numel():
        return {"err": 0.0, "rel": 0.0, "flip_share": 0.0}
    diff = (out.float() - ref.float()).abs()
    scale = max(float(ref.abs().max()), 1e-30)
    err = float(diff.max())
    return {"err": err, "rel": err / scale,
            "flip_share": float((diff > FLIP_REL * scale).float().mean())}


def agrees(reading: dict, rel_tol: float,
           flip_share: float = FLIP_SHARE) -> bool:
    return reading["rel"] <= rel_tol and reading["flip_share"] <= flip_share


def describe(reading: dict) -> str:
    return (f"max_abs_err={reading['err']:.3e} rel={reading['rel']:.3e} "
            f"flip_share={reading['flip_share']:.2e}")


def ell_csr(torch, cols, vals, n_cols: int, k_limit: int):
    """The ELL table as a (R, n_cols) CSR tensor, slots >= k_limit dropped."""
    r, tau = cols.shape
    keep = (cols >= 0) & (cols < k_limit)
    rows = torch.arange(r, device=cols.device)[:, None].expand(r, tau)[keep]
    coo = torch.sparse_coo_tensor(
        torch.stack([rows, cols[keep].long()]), vals[keep], (r, n_cols),
        check_invariants=False)
    return coo.coalesce().to_sparse_csr()


def split_key(key: str) -> tuple:
    """``(kernel name, precision)`` of a phase 2 entry."""
    if key.endswith("@bf16"):
        return key[:-len("@bf16")], "bf16"
    return key, "int8" if key.endswith("_scaled") else "f32"


def is_aggregation(name: str) -> bool:
    return "fused" not in name


def work(torch, name: str, args, kw, real=None) -> dict:
    """Least bytes and FLOPs the call needs on these inputs.

    ``real`` is the unpadded ``(rows, output width)`` of the layer, and
    for a fused kernel its unpadded input width third; the padding rows
    and columns the kernel is also given are left out of the count
    (``real=None`` counts the operands as given).  Bytes: each input
    read once at its storage width (only the rows of the dense operand or
    of X that the ELL table references; the int8 scale vector; the
    schedule), the f32 output written once; not the fused kernels' slot
    lists, which the kernel's design adds (``fused_split`` prints their
    cost).  FLOPs:
    aggregation 2 per counted slot and column; fused f32, the cheaper of
    X W on the referenced rows then aggregation, or aggregation of X then
    the product; fused bf16/int8 only the former, since X W + b is rounded
    before it is aggregated.  f32 FLOPs count at the CUDA-core f32 peak,
    bf16/int8 ones at the bf16 tensor-core peak.
    """
    if real is None:
        real = (args[0].shape[0],
                args[2 if is_aggregation(name) else 3].shape[1])
    r, f = real[:2]
    cols, vals = args[0][:r], args[1]
    tau = cols.shape[1]
    ell_bytes = (4 + vals.element_size()) * r * tau
    if kw.get("scales") is not None:
        ell_bytes += 4 * -(-r // kw["block_rows"])
    quant = vals.dtype != torch.float32
    if is_aggregation(name):
        dense = args[2]
        k = dense.shape[0]
        keep = (cols >= 0) & (cols < k)
        nnz = int(keep.sum())
        uniq = int(torch.unique(cols[keep]).numel())
        sched = sum(4 * a.numel() for a in args[3:])
        nbytes = (ell_bytes + sched + dense.element_size() * uniq * f
                  + 4 * r * f)
        flops = 2 * nnz * f
    else:
        x, w = args[2], args[3]
        f_in = real[2] if len(real) > 2 else x.shape[1]
        keep = (cols >= 0) & (cols < kw["k_real"])
        nnz = int(keep.sum())
        uniq = int(torch.unique(cols[keep]).numel())
        rows = int(keep.any(dim=1).sum())
        sched = sum(4 * a.numel() for a in args[5:])
        nbytes = (ell_bytes + sched + x.element_size() * uniq * f_in
                  + w.element_size() * f_in * f + 4 * f + 4 * r * f)
        flops = 2 * uniq * f_in * f + 2 * nnz * f
        if not quant:
            flops = min(flops, 2 * nnz * f_in + 2 * rows * f_in * f)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rate = BF16_FLOPS_PER_S if quant else F32_FLOPS_PER_S
    t_flops = flops / rate * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_flops),
            "bound_by": "bytes" if t_bytes >= t_flops else "operations"}


def slabs(fv, dense) -> tuple:
    """``(slab width, slab count)`` of an aggregation launch on ``dense``:
    the kernel's columns are its width rounded to 16 bytes."""
    k, f = dense.shape
    fa = fv.aligned_width(f, dense.dtype)
    width = fv.slab_width(k, fa, dense.dtype)
    return width, -(-fa // width)


def gather_bytes(fv, cols, dense) -> int:
    """Bytes an aggregation launch gathers: one 16-byte-rounded dense row
    for each ELL slot it counts (a column inside [0, K))."""
    k, f = dense.shape
    nnz = int(((cols >= 0) & (cols < k)).sum())
    return nnz * fv.aligned_width(f, dense.dtype) * dense.element_size()


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
    """One PyTorch call computing the kernel's function (a yardstick), and
    what it is.  Under bf16/int8 it takes a bf16 CSR of the (dequantized)
    values if cuSPARSE accepts one, else an f32 CSR with the bf16 operand
    widened inside the call."""
    from repro_torch.kernels.ref import dequantize_rows

    cols, vals = args[0], args[1]
    if kw.get("scales") is not None:
        vals = dequantize_rows(vals, kw["scales"], kw["block_rows"])
    agg = is_aggregation(name)
    k = args[2].shape[0]
    k_limit = k if agg else kw["k_real"]
    if agg:
        def operand(dtype):
            return args[2].to(dtype)
    else:
        x, w, b = args[2], args[3], args[4]

        def operand(dtype):
            return torch.addmm(b.to(dtype), x.to(dtype), w.to(dtype))
    if vals.dtype == torch.float32 and args[2].dtype == torch.float32:
        a = ell_csr(torch, cols, vals, k, k_limit)
        return (lambda: torch.sparse.mm(a, operand(torch.float32)),
                "torch.sparse.mm(f32 CSR, f32)")
    a = ell_csr(torch, cols, vals.to(torch.bfloat16), k, k_limit)
    try:
        torch.sparse.mm(a, operand(torch.bfloat16))
        torch.cuda.synchronize()
        return (lambda: torch.sparse.mm(a, operand(torch.bfloat16)),
                "torch.sparse.mm(bf16 CSR, bf16)")
    except RuntimeError:
        a = ell_csr(torch, cols, vals.to(torch.float32), k, k_limit)
        return (lambda: torch.sparse.mm(a, operand(torch.float32)),
                "torch.sparse.mm(f32 CSR of the values, bf16 widened to f32)")


# -- phases ------------------------------------------------------------------------


def phase_device(torch, build) -> tuple:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
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
            "count": torch.cuda.device_count()}, card


def main_path_cases(torch, rt, graph, cfg, params, feats, dev) -> dict:
    """Each phase 2 entry's (args, kwargs, real) for both layers of one
    forward pass at its precision, built by the same functions the
    dispatch uses; real is the unpadded output shape (rows, width), for a
    fused kernel followed by the unpadded input width."""
    from repro_torch.exec import quant
    from repro_torch.exec.dispatch import (aggregation_args, execute_layer,
                                           prepare_precision)
    from repro_torch.exec.fused import fused_args

    operands, perm, _ = graph.on_device(dev)
    cases = {key: [] for key in KEYS}
    for precision in PRECISIONS:
        blocks = dict(block_rows=cfg.block_rows, block_k=cfg.block_k,
                      block_f=cfg.block_f, precision=precision)
        ref_plan = rt.SpmmPlan(impl="reference", **blocks)
        qparams = quant.quantize_params(params, precision, cfg.block_rows)
        tag = "@bf16" if precision == "bf16" else ""
        x = feats[perm]
        for i in range(len(params)):
            layer = qparams[f"layer_{i}"]
            xw = quant.affine(x, layer, precision, cfg.block_rows)
            for impl in ("cuda", "cuda_sparse"):
                plan = rt.SpmmPlan(impl=impl, **blocks).resolve(
                    schedulable=True)
                vals, scales, dense = prepare_precision(plan, operands, xw)
                name, args, kw, real = aggregation_args(plan, operands, vals,
                                                        dense, scales)
                cases[name + tag].append((args, kw, real))
                name, args, kw, real = fused_args(plan, operands, x, layer,
                                                  cfg.block_rows)
                cases[name + tag].append((args, kw, real + (x.shape[1],)))
            x = execute_layer(ref_plan, operands, x, layer,
                              w_block_rows=cfg.block_rows)
            if i < len(params) - 1:
                x = torch.relu(x)
    return cases


def ragged_cases(torch, np, dev, seed: int) -> dict:
    """Small case off the main path's grid, for every phase 2 entry: F not
    a multiple of 128, a row block with no entries, k_real < K, a schedule
    that omits an occupied tile, a kb_ids list with -1 padding and, for
    int8, one scale fewer than row blocks (the last takes 1.0); fused calls
    get the table's slot lists."""
    from repro_torch.core.dataflow import plan_fused_k_schedule, plan_kernel_grid
    from repro_torch.core.sparse_formats import TiledELL
    from repro_torch.kernels.flexvector_spmm import (column_slots,
                                                     schedule_tile_bitmaps)

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

    c = t(cols, torch.int32)
    dense = t(rng.standard_normal((k, f)))
    x = t(rng.standard_normal((k, f_in)))
    w = t(rng.standard_normal((f_in, f)))
    b = t(rng.standard_normal((1, f)))
    q = t(np.clip(np.rint(vals * 40), -127, 127), torch.int8)
    scales = t(rng.uniform(0.01, 0.1, r // br - 1))
    bm, kb = t(bitmaps, torch.int32), t(kb_f, torch.int32)
    slots = tuple(t(a, torch.int32) for a in column_slots(cols, k))
    kw = dict(block_rows=br, block_k=bk, block_f=bf)
    out = {}
    for precision in PRECISIONS:
        v, extra = t(vals), {"slots": slots}
        d, xx, ww = dense, x, w
        if precision != "f32":
            d, xx, ww = (a.to(torch.bfloat16) for a in (dense, x, w))
            v = v.to(torch.bfloat16)
            extra["cast_xw"] = torch.bfloat16
        if precision == "int8":
            v = q
        akw = dict(kw, scales=scales) if precision == "int8" else kw
        fkw = dict(akw, k_real=k - 5, **extra)
        tag = {"f32": "", "bf16": "@bf16", "int8": "_scaled"}[precision]
        out.update({
            f"spmm_ell_dense_grid{tag}": ((c, v, d), akw),
            f"spmm_ell_sparse_grid{tag}": ((c, v, d, bm), akw),
            f"spmm_ell_fused_dense_grid{tag}": ((c, v, xx, ww, b), fkw),
            f"spmm_ell_fused_sparse_grid{tag}": ((c, v, xx, ww, b, kb), fkw),
        })
    return out


def fused_split(torch, kernel, args, kw, real, full_ms: float) -> dict:
    """A fused kernel's time (``full_ms``) split three ways: the zero fill
    of its output (``torch.zeros`` alone), the product (the same launch
    with one slot left in each chunk, so every tile is formed and almost
    nothing is scattered, less the fill) and the scatter (the rest).

    Beside them, the scatter's floor in device memory: ``runs``, the runs
    of one output row's slots in a chunk of the slot lists, each of which
    reads and writes the 32-byte sectors of the row's ``real[1]`` columns
    once; the zero fill's bytes; and the decode's, the slot ids read once
    and one 32-byte sector each of ``cols`` and ``vals`` per slot (a
    group's slots lie far apart in the table); all over the HBM rate."""
    group, start, ids = kw["slots"]
    one = (group, torch.arange(group.shape[0] + 1, dtype=torch.int32,
                               device=group.device), ids[start[:-1].long()])
    r, f_out = args[0].shape[0], args[3].shape[1]
    fill = device_ms(torch, lambda: torch.zeros(r, f_out, device=args[0].device),
                     REPS)
    tiles = device_ms(torch, lambda: kernel(*args, **dict(kw, slots=one)),
                      REPS)
    rows = ids.long() // args[0].shape[1]
    chunk = torch.repeat_interleave(
        torch.arange(group.shape[0], device=ids.device), start.diff())
    runs = int(rows.numel() > 0) + int(
        ((rows[1:] != rows[:-1]) | (chunk[1:] != chunk[:-1])).sum())
    touched = 32 * -(-4 * real[1] // 32)
    return {"zero_fill_ms": fill, "product_ms": tiles - fill,
            "scatter_ms": full_ms - tiles, "runs": runs,
            "scatter_floor_ms": 2 * runs * touched / HBM_BYTES_PER_S * 1e3,
            "zero_fill_floor_ms": 4 * r * f_out / HBM_BYTES_PER_S * 1e3,
            "decode_floor_ms": (4 + 2 * 32) * ids.numel() / HBM_BYTES_PER_S
            * 1e3}


def phase_kernels(torch, np, fv, cases, dev) -> dict:
    results = {}
    ragged = ragged_cases(torch, np, dev, SEED)
    for key in KEYS:
        name, _ = split_key(key)
        kernel, plain = fv.KERNELS[name], fv.PLAIN[name]
        args, kw = ragged[key]
        got = agreement(torch, kernel(*args, **kw), plain(*args, **kw))
        torch.cuda.synchronize()
        print(f"phase 2: {key} ragged {describe(got)} (tol "
              f"{REL_TOL[key]:.0e}, flip share {FLIP_SHARE:.0e})")
        check(agrees(got, REL_TOL[key]), f"{key} disagrees with its plain "
              f"version on the ragged case: {describe(got)}")
        entry = {"max_abs_err": got["err"], "max_rel_err": got["rel"],
                 "max_flip_share": got["flip_share"], "per_layer": []}
        for layer, (args, kw, real) in enumerate(cases[key]):
            out, ref = kernel(*args, **kw), plain(*args, **kw)
            got = agreement(torch, out, ref, real)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"{key} non-finite output")
            check(agrees(got, REL_TOL[key]), f"{key} layer {layer} disagrees "
                  f"with its plain version: {describe(got)}")
            if kw.get("cast_xw") is not None:
                # control: the plain version without the bf16 rounding of
                # X W + b, what a kernel that skipped it would give
                ctl = agreement(torch, plain(*args, **dict(kw, cast_xw=None)),
                                ref, real)
                print(f"phase 2: {key} layer {layer} control without the "
                      f"cast_xw rounding: {describe(ctl)}")
                check(not agrees(ctl, REL_TOL[key]), f"{key}: the agreement "
                      "check does not tell the missing cast_xw rounding "
                      f"apart: {describe(ctl)}")
            cell = work(torch, name, args, kw, real)
            padded = work(torch, name, args, kw)
            lib, lib_what = library_call(torch, name, args, kw)
            cell.update(
                shape=[list(a.shape) for a in args],
                dtypes=[str(a.dtype).replace("torch.", "") for a in args],
                real_shape=list(real),
                padded_bound_ms=padded["bound_ms"],
                padding_byte_share=1.0 - cell["bytes"] / padded["bytes"],
                max_abs_err=got["err"],
                flip_share=got["flip_share"],
                ms=device_ms(torch, lambda: kernel(*args, **kw), REPS),
                plain_ms=device_ms(torch, lambda: plain(*args, **kw), REPS),
                library_ms=device_ms(torch, lib, REPS),
                library_call=lib_what,
            )
            if is_aggregation(name):
                cell["slab_cols"], cell["slabs"] = slabs(fv, args[2])
                cell["gather_bytes"] = gather_bytes(fv, args[0], args[2])
                cell["gather_tb_per_s"] = (cell["gather_bytes"] / cell["ms"]
                                           / 1e9)
                print(f"phase 2: {key} layer {layer} slabs "
                      f"{cell['slabs']} x {cell['slab_cols']} columns, "
                      f"gathered {cell['gather_bytes']} bytes at "
                      f"{cell['gather_tb_per_s']:.3f} TB/s (HBM "
                      f"{HBM_BYTES_PER_S / 1e12:.2f})")
            else:
                cell["split"] = fused_split(torch, kernel, args, kw, real,
                                            cell["ms"])
                print(f"phase 2: {key} layer {layer} split: " + " ".join(
                    f"{k}={v}" if isinstance(v, int) else f"{k}={v:.4f}"
                    for k, v in cell["split"].items()))
            entry["max_abs_err"] = max(entry["max_abs_err"], got["err"])
            entry["max_rel_err"] = max(entry["max_rel_err"], got["rel"])
            entry["max_flip_share"] = max(entry["max_flip_share"],
                                          got["flip_share"])
            entry["per_layer"].append(cell)
            print(f"phase 2: {key} layer {layer} {cell['shape']} "
                  f"{cell['dtypes'][1]} real {cell['real_shape']} "
                  f"{describe(got)} "
                  f"ms={cell['ms']:.4f} plain_ms={cell['plain_ms']:.4f} "
                  f"library_ms={cell['library_ms']:.4f} ({lib_what}) "
                  f"bound_ms={cell['bound_ms']:.4f} ({cell['bound_by']}) "
                  f"padded_bound_ms={cell['padded_bound_ms']:.4f} "
                  f"padding_byte_share={cell['padding_byte_share']:.3f}")
        results[key] = entry
    return results


def multi_slab_check(torch, np, fv, dev) -> dict:
    """B1 and B2 at every precision on a dense operand too large for one
    slab (MULTI_SLAB_K rows: 77 MB at 64 f32 or 128 bf16 columns), against
    their plain versions; returns each entry's slab count and error."""
    rng = np.random.default_rng(SEED)
    r, tau, k, br, bk = 65_536, 6, MULTI_SLAB_K, 128, 128
    cols = rng.integers(0, k, (r, tau)).astype(np.int32)
    cols[rng.random((r, tau)) < 0.2] = -1
    vals = rng.standard_normal((r, tau)).astype(np.float32)
    n_rb, n_kb = r // br, k // bk
    listed = rng.random((n_rb, n_kb)) < 0.9      # a schedule that drops tiles
    rb_ids, kb_ids = np.nonzero(listed)
    first = np.r_[1, rb_ids[1:] != rb_ids[:-1]]
    bitmaps = torch.as_tensor(fv.schedule_tile_bitmaps(
        rb_ids, kb_ids, first, n_rb, n_kb), device=dev)
    c = torch.as_tensor(cols, device=dev)
    v32 = torch.as_tensor(vals, device=dev)
    kw = dict(block_rows=br, block_k=bk)
    out = {}
    for precision in PRECISIONS:
        f = 64 if precision == "f32" else 128
        dense = torch.as_tensor(rng.standard_normal((k, f)),
                                dtype=torch.float32, device=dev)
        v, extra = v32, {}
        if precision != "f32":
            dense, v = dense.to(torch.bfloat16), v32.to(torch.bfloat16)
        if precision == "int8":
            v = torch.as_tensor(np.clip(np.rint(vals * 40), -127, 127),
                                dtype=torch.int8, device=dev)
            extra["scales"] = torch.as_tensor(
                rng.uniform(0.01, 0.1, n_rb), dtype=torch.float32, device=dev)
        width, n = slabs(fv, dense)
        check(n >= 2, f"the multi-slab case at {precision} has {n} slab")
        for name, args in (("spmm_ell_dense_grid", (c, v, dense)),
                           ("spmm_ell_sparse_grid", (c, v, dense, bitmaps))):
            if precision == "int8":
                name += "_scaled"
            call = dict(kw, block_f=f, **extra)
            got = agreement(torch, fv.KERNELS[name](*args, **call),
                            fv.PLAIN[name](*args, **call))
            torch.cuda.synchronize()
            key = f"{name}@{precision}"
            print(f"phase 2: multi-slab {key} K={k} F={f} slabs {n} x "
                  f"{width} columns {describe(got)}")
            check(agrees(got, REL_TOL[name]), f"multi-slab {key} disagrees "
                  f"with its plain version: {describe(got)}")
            out[key] = {"slabs": n, "slab_cols": width, **got}
    return out


def small_forward_check(torch, np, rt, dev) -> None:
    """A small graph's forward on the card against the same precision on
    the CPU (plain versions), under the four kernel configs."""
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
    params = params_from_numpy(raw, dev)
    for precision in PRECISIONS:
        for impl, fused in CONFIGS:
            plan = rt.SpmmPlan(impl=impl, block_rows=16, block_k=16,
                               block_f=16, fused=fused)
            ref = gcn_forward(params_from_numpy(raw, "cpu"), graph, feats, cfg,
                              plan=plan, precision=precision, device="cpu")
            out = gcn_forward(params, graph, feats, cfg, plan=plan,
                              precision=precision, device=dev)
            got = agreement(torch, out.cpu(), ref)
            print(f"phase 2: small forward {precision} {impl} fused={fused} "
                  f"vs CPU {describe(got)}")
            check(agrees(got, FORWARD_REL_TOL[precision], FORWARD_FLIP_SHARE),
                  f"small forward {precision} {impl} fused={fused}: "
                  f"{describe(got)}")


def timed_forwards(torch, fn) -> tuple:
    """Median host ms of REQUESTS calls of ``fn()`` (each ending in a
    synchronize) after 3 warm ones, and the last output."""
    times = []
    for i in range(3 + REQUESTS):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def phase_main_path(torch, rt, fv, graph, cfg, params, feats, dev,
                    precisions, phase: int) -> dict:
    """The four kernel configs at each of ``precisions``, with the launch
    counts reset before each precision and read after it."""
    from repro_torch.exec.quant import logit_error
    from repro_torch.models.gcn import gcn_forward

    blocks = dict(block_rows=cfg.block_rows, block_k=cfg.block_k,
                  block_f=cfg.block_f)
    ref_plan = rt.SpmmPlan(impl="reference", **blocks)

    def forward(plan, precision):
        return lambda: gcn_forward(params, graph, feats, cfg, plan=plan,
                                   precision=precision, device=dev)

    f32_ref = forward(ref_plan, "f32")()
    refs = {p: forward(ref_plan, p)() for p in precisions}
    torch.cuda.synchronize()
    timings, busy, logit, launches, control = {}, {}, {}, {}, {}
    for precision in precisions:
        tol = FORWARD_REL_TOL[precision]
        if precision != "f32":
            # control: the f32 forward in the place of this precision's
            ctl = agreement(torch, f32_ref, refs[precision])
            control[precision] = ctl
            print(f"phase {phase}: control, the f32 forward vs the reference "
                  f"at {precision}: {describe(ctl)}")
            check(not agrees(ctl, tol, FORWARD_FLIP_SHARE), f"the {precision} "
                  "agreement check does not tell an f32 forward apart: "
                  f"{describe(ctl)}")
        fv.reset_launches()
        for impl, fused in CONFIGS:
            plan = rt.SpmmPlan(impl=impl, fused=fused, **blocks)
            key = (f"{impl}{'+fused' if fused else ''}"
                   + ("" if precision == "f32" else f"@{precision}"))
            timings[key], out = timed_forwards(torch, forward(plan, precision))
            check(tuple(out.shape) == (graph.n_nodes, cfg.out_dim),
                  f"{key}: output shape {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), f"{key}: non-finite logits")
            got = agreement(torch, out, refs[precision])
            check(agrees(got, tol, FORWARD_FLIP_SHARE), f"{key} disagrees "
                  f"with the reference impl at {precision}: {describe(got)}")
            line = (f"phase {phase}: {key} forward median {timings[key]:.3f} "
                    f"ms over {REQUESTS} requests, vs reference at "
                    f"{precision} {describe(got)}")
            if precision != "f32":
                logit[key] = logit_error(f32_ref, out)
                check(logit[key] <= LOGIT_BUDGET[precision], f"{key}: logit "
                      f"error vs f32 {logit[key]:.3e} over the budget "
                      f"{LOGIT_BUDGET[precision]}")
                line += (f", logit error vs f32 {logit[key]:.3e} (budget "
                         f"{LOGIT_BUDGET[precision]})")
            print(line)
            busy[key] = device_busy(torch, forward(plan, precision))
        # every kernel of this precision launched on values of it (PubMed's
        # blocks align the int8 scales with the kernels' row blocks, so no
        # int8 layer falls back to bf16 values), and none on other values
        counts = dict(fv.PRECISION_LAUNCHES)
        print(f"phase {phase}: launches at {precision} {json.dumps(counts)}")
        names = KERNELS[4:] if precision == "int8" else BASE
        for name in names:
            check(counts[f"{name}@{precision}"] > 0, f"kernel {name} was not "
                  f"launched on {precision} values on the main path")
        other = {k: n for k, n in counts.items()
                 if n and not k.endswith(f"@{precision}")}
        check(not other, f"the {precision} forwards launched kernels on "
              f"values of another precision: {other}")
        launches[precision] = {name: counts[f"{name}@{precision}"]
                               for name in names}
    if "f32" in precisions:
        timings["reference"], _ = timed_forwards(torch, forward(ref_plan, "f32"))
        print(f"phase {phase}: reference forward median "
              f"{timings['reference']:.3f} ms")
        busy["reference"] = device_busy(torch, forward(ref_plan, "f32"))
    idle = {}
    for key, kernels in busy.items():
        total = sum(kernels.values())
        if total == 0.0:
            print(f"phase {phase}: {key} device time not measured (no device "
                  "events in the profile)")
            continue
        idle[key] = max(0.0, 1.0 - total / timings[key])
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
        print(f"phase {phase}: {key} device busy {total:.3f} ms of "
              f"{timings[key]:.3f} ms (idle share {idle[key]:.2f}); top: "
              + "; ".join(f"{name[:60]} {ms:.3f}" for name, ms in top))
    return {"launches": launches, "forward_ms": timings,
            "device_busy_ms": {k: sum(v.values()) for k, v in busy.items()},
            "device_idle_share": idle, "logit_error_vs_f32": logit,
            "control_vs_reference": control}


# -- phase 5: serving ------------------------------------------------------------


def serve_draws(np, n_nodes: int, sizes) -> list:
    """The serving CLI's request draw (1 to max_seeds distinct seeds, numpy
    seed 0) with every repeated seed set dropped, cut into consecutive
    slices of ``sizes``: no request of one slice is in another."""
    rng = np.random.default_rng(0)
    seen, reqs = set(), []
    while len(reqs) < sum(sizes):
        seeds = rng.choice(n_nodes, size=rng.integers(1, SERVE["max_seeds"] + 1),
                           replace=False)
        key = tuple(sorted(seeds.tolist()))
        if key not in seen:
            seen.add(key)
            reqs.append(seeds)
    starts = np.cumsum([0, *sizes])
    return [reqs[lo:hi] for lo, hi in zip(starts[:-1], starts[1:])]


def serve_answers(engine, requests, n_queries: int, n_full: int) -> tuple:
    """``(full-graph logits, [logits per request])``: the first
    ``n_queries`` requests one at a time, the rest in one query_batch, and
    ``n_full`` full-graph forwards."""
    answers = [engine.query(s) for s in requests[:n_queries]]
    answers += engine.query_batch(requests[n_queries:])
    full = None
    for _ in range(n_full):
        full = engine.full_forward()
    return full, answers


def eager_answers(torch, engine, subs, precision=None) -> list:
    """Each subgraph's seed logits from an eager ``gcn_forward`` (the
    reference impl) over the subgraph's own operand at ``precision`` (the
    engine's by default): no padding, batcher or graph replay."""
    from repro_torch.models.gcn import gcn_forward

    cfg = dataclasses.replace(engine.cfg, spmm_impl="reference")
    out = []
    for sub in subs:
        logits = gcn_forward(engine.params, sub.graph,
                             engine.features[sub.nodes], cfg,
                             precision=precision or engine.precision,
                             device=engine.device)
        out.append(logits[torch.as_tensor(sub.seed_local,
                                          device=logits.device)].cpu().numpy())
    return out


def hold(torch, np, key: str, what: str, got, want, precision: str,
         flip_share: float, phase: int = 5) -> dict:
    """``got`` vs ``want`` (lists of logits) within FORWARD_REL_TOL at
    ``precision`` and ``flip_share``; prints and returns the reading."""
    check(all(a.shape == b.shape for a, b in zip(got, want))
          and len(got) == len(want), f"{key}: answer shapes ({what})")
    got, want = np.concatenate(got), np.concatenate(want)
    check(bool(np.isfinite(got).all()), f"{key}: non-finite answers ({what})")
    reading = agreement(torch, torch.as_tensor(got), torch.as_tensor(want))
    print(f"phase {phase}: {key} {what}: {describe(reading)} (limits rel "
          f"{FORWARD_REL_TOL[precision]}, flip share {flip_share})")
    check(agrees(reading, FORWARD_REL_TOL[precision], flip_share),
          f"{key} disagrees ({what}): {describe(reading)}")
    return reading


def rung_subgraphs(np, engine, registry) -> dict:
    """Up to SERVE_PER_RUNG subgraphs in each rung the engine warmed, from
    single-seed requests over seeds spread along the degree order (hubs
    first), at fanouts from a quarter of the serving fanout up to 64x it,
    then uncapped.  A candidate is extracted (preprocessed) only when its
    node set fits a warmed rung that still needs one."""
    from repro_torch.serve.sampler import SubgraphSampler

    ladder = engine.batcher.ladder
    warmed = sorted({k[0] for k in engine.batcher._executables})
    found = {b: [] for b in warmed}
    order = np.argsort(-engine.adj_norm.row_nnz(), kind="stable")
    ranks = np.unique(np.geomspace(1, order.size, 48).astype(np.int64)) - 1
    for fanout in [SERVE["fanout"] * 4 ** i // 4 for i in range(5)] + [None]:
        sampler = SubgraphSampler(engine.adj_norm, engine.cfg, fanout=fanout,
                                  registry=registry)
        for r in ranks:
            seeds = [int(order[r])]
            n = sampler.sample_nodes(seeds).size
            fits = [b for b in warmed if b.nodes >= n]
            if not fits or len(found[fits[0]]) >= SERVE_PER_RUNG:
                continue
            sub = sampler.extract(seeds)
            bucket = ladder.bucket_for(sub.n_sub_nodes, sub.n_ell_rows)
            if bucket in found and len(found[bucket]) < SERVE_PER_RUNG:
                found[bucket].append(sub)
            if all(len(s) >= SERVE_PER_RUNG for s in found.values()):
                return found
    return found


def rung_coverage(torch, np, engine, rung_subs: dict, key: str) -> dict:
    """Every warmed rung at batches of 1, 2, 3, 4 and max_batch (the
    rung's requests taken in turn) through ``batcher.run``, each answer
    held against an eager forward over the request's own subgraph.

    A rung's requests are two single seeds, hubs' in the larger rungs: at
    bf16/int8 one rounding flip in a hub's field moves all of its logits,
    so their flip share is 0 or most of them and says nothing.  The check
    there is the relative error alone: a request in the wrong slot, or a
    wrong offset or scale block, moves its logits by far more than the
    limit.  That the rungs run at the engine's precision is held by the
    answer checks and their f32 control."""
    batcher = engine.batcher
    prec = engine.precision
    flips = FORWARD_FLIP_SHARE if prec == "f32" else 1.0
    sizes = sorted({1, 2, 3, 4, batcher.max_batch})
    out = {}
    for bucket, subs in rung_subs.items():
        name = f"{bucket.nodes}x{bucket.rows}"
        reqs = [batcher.prepare(s, engine.features[s.nodes]) for s in subs]
        check(all(r.bucket == bucket for r in reqs), f"{key}: rung request")
        want = eager_answers(torch, engine, subs)
        got, ref = [], []
        for size in sizes:
            take = [i % len(subs) for i in range(size)]
            got += batcher.run(engine.params, [reqs[i] for i in take])
            ref += [want[i] for i in take]
        out[name] = hold(torch, np, key, f"rung {name} at batches {sizes} "
                         "vs eager forwards", got, ref, prec, flips)
    return out


def scenario_stats(report) -> dict:
    """A scenario's report, its p99 dropped under P99_MIN_REQUESTS."""
    r = dataclasses.asdict(report)
    if r["n_requests"] < P99_MIN_REQUESTS:
        r["p99_ms"] = None
    return r


def serving_uncapped_check(torch, np, registry, dev) -> dict:
    """Uncapped queries (the exact receptive field) on phase 2's small
    graph against full-graph rows: at f32 within FORWARD_REL_TOL of the
    same engine's full forward; at bf16/int8 (whose subgraphs quantize in
    their own row blocks) within the reference's logit budget of the f32
    full forward."""
    from repro_torch.core.sparse_formats import random_power_law_csr
    from repro_torch.exec.quant import logit_error
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.gcn import GCNConfig
    from repro_torch.serve import ServeEngine

    adj = random_power_law_csr(96, 96, 700, seed=0)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((96, 12)).astype(np.float32)
    raw = {f"layer_{i}": {"w": rng.standard_normal(s).astype(np.float32),
                          "b": rng.standard_normal(s[1]).astype(np.float32)}
           for i, s in enumerate([(12, 64), (64, 8)])}
    seeds = [rng.choice(96, size=k, replace=False) for k in (1, 2, 3, 4, 4)]

    def engine(impl, precision, fused):
        cfg = GCNConfig(in_dim=12, hidden_dim=64, out_dim=8, spmm_impl=impl)
        return ServeEngine(adj, feats, cfg, params=params_from_numpy(raw, dev),
                           registry=registry, device=dev, precision=precision,
                           fused=fused, **dict(SERVE, fanout=None))

    f32_full = engine("reference", "f32", False).full_forward()
    out = {}
    for impl, precision, fused in SERVE_ENGINES["pubmed"]:
        eng = engine(impl, precision, fused)
        full = eng.full_forward() if precision == "f32" else f32_full
        got = np.concatenate([eng.query(s) for s in seeds])
        want = np.concatenate([full[s] for s in seeds])
        key = f"{impl}{'+fused' if fused else ''}@{precision}"
        if precision == "f32":
            reading = agreement(torch, torch.as_tensor(got),
                                torch.as_tensor(want))
            print(f"phase 5: uncapped queries {key} vs full-graph rows "
                  f"(small graph) {describe(reading)}")
            check(agrees(reading, FORWARD_REL_TOL["f32"], FORWARD_FLIP_SHARE),
                  f"uncapped queries {key} disagree with the full-graph rows: "
                  f"{describe(reading)}")
        else:
            reading = {"logit_error_vs_f32": logit_error(want, got)}
            print(f"phase 5: uncapped queries {key} vs f32 full-graph rows "
                  f"(small graph) logit error "
                  f"{reading['logit_error_vs_f32']:.3e} (budget "
                  f"{LOGIT_BUDGET[precision]})")
            check(reading["logit_error_vs_f32"] <= LOGIT_BUDGET[precision],
                  f"uncapped queries {key}: logit error over the budget")
        eng.batcher.clear_executables()
        out[key] = reading
    return out


def profile_batch(torch, engine, requests) -> dict:
    """Device kernels of one query_batch (torch.profiler), by name, in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.query_batch(requests)
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}


def phase_serving(torch, np, fv, registry, data, cfg, params, dev,
                  dataset: str) -> dict:
    """Phase 5: each of the dataset's engines ((impl, precision, fused))
    warmed, timed over requests nothing has served before, held against
    the reference impl and eager forwards, driven through every warmed
    rung and profiled; returns each engine's record."""
    from repro_torch.serve import ServeEngine

    def build(impl, precision, fused):
        before = registry.stats.builds
        engine = ServeEngine(
            data.adj_norm, data.features,
            dataclasses.replace(cfg, spmm_impl=impl), params=params,
            registry=registry, device=dev, precision=precision, fused=fused,
            **SERVE)
        check(registry.stats.builds == before, "building a serving engine "
              "preprocessed the dataset again")
        return engine

    load = SERVE_LOAD[dataset]
    engines = SERVE_ENGINES[dataset]
    n_req = load["queries"] + load["batch"]
    draws = serve_draws(np, data.adj_norm.rows, [n_req] * len(engines))
    skipped = [e for e in SERVE_ENGINES["pubmed"] if e not in engines]
    if skipped:
        print(f"phase 5: at {dataset} skips the engines {skipped}")
    refs, ref_full, out, rung_subs = {}, {}, {}, None
    for (impl, precision, fused), requests in zip(engines, draws):
        key = f"{impl}{'+fused' if fused else ''}@{precision}"
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", RuntimeWarning)
            engine = build(impl, precision, fused)
        plan = engine.batcher.plan
        if impl == "cuda_sparse":
            check(plan.degraded and plan.effective_impl == "cuda"
                  and any("degraded" in str(w.message) for w in caught),
                  f"{key}: the batcher did not record its degradation")
        built = engine.warmup()
        warm_s = time.perf_counter() - t0
        exes = engine.batcher._executables
        rungs = sorted({k[0] for k in exes})
        print(f"phase 5: {key} ladder "
              f"{[(b.nodes, b.rows) for b in engine.batcher.ladder.entries]}; "
              f"warmed rungs {[(b.nodes, b.rows) for b in rungs]}; "
              f"{built} CUDA graphs captured in {warm_s:.1f} s; impl "
              f"{plan.effective_impl}"
              + (f" ({plan.degraded_reason})" if plan.degraded else ""))
        check(built > 0, f"{key}: warmup captured no CUDA graph")

        # The timed window: requests no engine has served, so every one
        # pays its extraction (the registry's builds say so).
        stats0 = dataclasses.replace(registry.stats)
        replays0 = {k: e.replays for k, e in exes.items()}
        fv.reset_launches()
        t1 = time.perf_counter()
        full, answers = serve_answers(engine, requests, load["queries"],
                                      load["full"])
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t1
        counted = {k: n for k, n in fv.PRECISION_LAUNCHES.items() if n}
        window = {"builds": registry.stats.builds - stats0.builds,
                  "mem_hits": registry.stats.mem_hits - stats0.mem_hits,
                  "requests": len(requests)}
        check(engine.compile_count == built, f"{key}: "
              f"{engine.compile_count - built} captures after warmup")
        replayed = {}
        for k, e in exes.items():
            for name, n in e.launches.items():
                replayed[name] = (replayed.get(name, 0)
                                  + (e.replays - replays0[k]) * n)
        tag = "_scaled" if precision == "int8" else ""
        batch_kernel = ("spmm_ell_fused_dense_grid" if fused
                        else "spmm_ell_dense_grid") + f"{tag}@{precision}"
        # the full-graph step runs the config's plan, unfused here
        full_kernel = ("spmm_ell_sparse_grid" if impl == "cuda_sparse"
                       else "spmm_ell_dense_grid") + f"{tag}@{precision}"
        check(replayed.get(batch_kernel, 0) > 0,
              f"{key}: the replays ran no {batch_kernel}")
        check(counted.get(full_kernel, 0) > 0,
              f"{key}: the full-graph steps launched no {full_kernel}")
        reports = {s: scenario_stats(engine.report(s))
                   for s in ("full", "query", "batch")}
        batch_wall_ms = 1e3 * engine.wall["batch"]
        print(f"phase 5: {key} timed window {window_s:.2f} s; registry "
              f"builds {window['builds']}, mem_hits {window['mem_hits']} for "
              f"{window['requests']} requests; launches counted (full-graph "
              f"steps) {counted}, replayed {replayed}")

        rungs_hit = {}
        for seeds in requests:
            sub = engine.sampler.extract(seeds)
            b = engine.batcher.ladder.bucket_for(sub.n_sub_nodes,
                                                 sub.n_ell_rows)
            rungs_hit[f"{b.nodes}x{b.rows}"] = rungs_hit.get(
                f"{b.nodes}x{b.rows}", 0) + 1
        print(f"phase 5: {key} requests per rung (nodes x ELL rows) "
              f"{rungs_hit}")

        if precision not in refs:
            refs.clear()    # release the previous precision's reference
            refs[precision] = build("reference", precision, False)
            ref_full[precision] = refs[precision].full_forward()
        ref_engine = refs[precision]
        check(full.shape == (data.adj_norm.rows, cfg.out_dim)
              and bool(np.isfinite(full).all()), f"{key}: full-graph logits")
        got_full = hold(torch, np, key, "full graph vs the reference impl",
                        [full], [ref_full[precision]], precision,
                        FORWARD_FLIP_SHARE)
        _, ref_answers = serve_answers(ref_engine, requests, load["queries"],
                                       0)
        flips = SERVE_FLIP_SHARE[precision]
        got = hold(torch, np, key, f"{len(requests)} answers vs the "
                   f"reference impl", answers, ref_answers, precision, flips)
        step = max(1, len(requests) // SERVE_EAGER_CHECKED)
        picked = list(range(0, len(requests), step))[:SERVE_EAGER_CHECKED]
        subs = [engine.sampler.extract(requests[i]) for i in picked]
        want = eager_answers(torch, engine, subs)
        eager = hold(torch, np, key, f"{len(picked)} answers vs eager "
                     "forwards over their own subgraphs",
                     [answers[i] for i in picked], want, precision, flips)
        if precision != "f32":
            # control: the f32 forward in this precision's place must fail
            wrong = eager_answers(torch, engine, subs, "f32")
            control = agreement(torch, torch.as_tensor(np.concatenate(wrong)),
                                torch.as_tensor(np.concatenate(want)))
            print(f"phase 5: {key} control, eager f32 answers in the place "
                  f"of {precision}'s: {describe(control)}")
            check(not agrees(control, FORWARD_REL_TOL[precision], flips),
                  f"{key}: the f32 control passes the {precision} check")
            eager["f32_control"] = control
        if rung_subs is None:
            t2 = time.perf_counter()
            rung_subs = rung_subgraphs(np, engine, registry)
            empty = [f"{b.nodes}x{b.rows}" for b, s in rung_subs.items()
                     if not s]
            print(f"phase 5: requests for every warmed rung found in "
                  f"{time.perf_counter() - t2:.1f} s: "
                  + ", ".join(f"{b.nodes}x{b.rows}: "
                              f"{[x.n_sub_nodes for x in s]} nodes"
                              for b, s in rung_subs.items()))
            check(not empty, f"no request reaches the warmed rungs {empty}")
        coverage = rung_coverage(torch, np, engine, rung_subs, key)
        check(engine.compile_count == built, f"{key}: "
              f"{engine.compile_count - built} captures after warmup")

        kernels = profile_batch(torch, engine, requests[load["queries"]:])
        names = " ".join(kernels)
        ours = FUSED_KERNEL if fused else AGGREGATION_KERNEL
        check(ours in names, f"{key}: {ours} is not among the replayed "
              f"batch's device kernels: {sorted(kernels)[:12]}")
        bad = [n for n in kernels if any(w in n.lower() for w in LIBRARY_SPARSE)]
        check(not bad, f"{key}: library sparse kernels in the batch: {bad}")
        busy = sum(kernels.values())
        idle = max(0.0, 1.0 - busy / batch_wall_ms)
        for scenario, r in reports.items():
            p99 = "n/a" if r["p99_ms"] is None else f"{r['p99_ms']:.3f} ms"
            print(f"phase 5: {key} {scenario}: n={r['n_requests']}, "
                  f"p50 {r['p50_ms']:.3f} ms, p99 {p99}, "
                  f"{r['req_per_s']:.1f} req/s")
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
        print(f"phase 5: {key} batch of {load['batch']}: device busy "
              f"{busy:.3f} ms of {batch_wall_ms:.3f} ms (idle share "
              f"{idle:.3f}); top: "
              + "; ".join(f"{n[:60]} {ms:.3f}" for n, ms in top))
        out[key] = {
            "impl": impl, "precision": precision, "fused": fused,
            "effective_impl": plan.effective_impl,
            "degraded_reason": plan.degraded_reason,
            "ladder": [[b.nodes, b.rows] for b in engine.batcher.ladder.entries],
            "warmed_rungs": [[b.nodes, b.rows] for b in rungs],
            "captures": built, "warmup_s": warm_s,
            "post_warmup_captures": engine.compile_count - built,
            "timed_registry": window, "requests_per_rung": rungs_hit,
            "launches": {"counted": counted, "replayed": replayed},
            "scenarios": reports,
            "vs_reference": got, "full_vs_reference": got_full,
            "vs_eager": eager, "rungs_vs_eager": coverage,
            "batch_wall_ms": batch_wall_ms, "batch_device_busy_ms": busy,
            "batch_device_idle_share": idle,
            "batch_top_kernels": dict(top),
        }
        engine.batcher.clear_executables()
        del engine
        torch.cuda.empty_cache()
    for ref_engine in refs.values():
        ref_engine.batcher.clear_executables()
    return {"engines": out, "skipped": [list(e) for e in skipped]}


# -- phase 6: planning ---------------------------------------------------------


def plan_kernels(pplan) -> set:
    """The ``fv.PRECISION_LAUNCHES`` keys a pipeline plan launches."""
    keys = set()
    for lp in pplan.layers:
        plan = lp.spmm
        if plan.impl == "reference":
            continue
        grid = "sparse" if plan.impl == "cuda_sparse" else "dense"
        name = (f"spmm_ell_fused_{grid}_grid" if plan.fused
                else f"spmm_ell_{grid}_grid")
        if plan.precision == "int8":
            name += "_scaled"
        keys.add(f"{name}@{plan.precision}")
    return keys


def describe_plan(pplan) -> list:
    return [{"impl": lp.spmm.impl, "blocks": [lp.spmm.block_rows,
                                               lp.spmm.block_k,
                                               lp.spmm.block_f],
             "fused": lp.spmm.fused, "hot_k_first": lp.spmm.hot_k_first,
             "precision": lp.spmm.precision, "modeled_ms": 1e3 * lp.seconds}
            for lp in pplan.layers]


def timed_rounds(torch, fns: dict, rounds: int) -> dict:
    """Median host ms of each of ``fns`` (name -> callable), called in
    ``rounds`` interleaved rounds (each call ending in a synchronize)
    after one warm round."""
    times = {name: [] for name in fns}
    for i in range(1 + rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def phase_planning(torch, np, fv, registry, data, graph, cfg, params, feats,
                   dev, dataset: str) -> dict:
    """Phase 6: ``plan="auto"`` forwards at every precision (plans,
    launches, answers, times beside the model's), then at PubMed one
    autoplanned engine with ``precision="auto"``.  Everything plans on
    the H100 model, passed explicitly."""
    from repro_torch.exec.pipeline import (pipeline_seconds, plan_pipeline,
                                           static_pipeline)
    from repro_torch.exec.plan import SpmmPlan
    from repro_torch.models.gcn import gcn_forward
    from repro_torch.plan import cost

    cfg = dataclasses.replace(cfg, spmm_impl="cuda")
    blocks = dict(block_rows=cfg.block_rows, block_k=cfg.block_k,
                  block_f=cfg.block_f)
    model = cost.H100
    print(f"phase 6: device model {model.name}: "
          f"{dataclasses.asdict(model.cuda)}")
    stats = cost.graph_stats_from_ell(graph.pre.ell)
    forwards = {}
    rounds = PLAN_ROUNDS[dataset]
    for precision in PRECISIONS:
        t0 = time.perf_counter()
        pplan = plan_pipeline(cfg, graph.pre.ell, precision=precision,
                              device=model)
        plan_s = time.perf_counter() - t0
        layers = describe_plan(pplan)
        print(f"phase 6: {precision} plan {json.dumps(layers)}; "
              f"{pplan.n_candidates} candidates priced in {plan_s:.3f} s of "
              f"host time; modeled {1e3 * pplan.cost_seconds:.3f} ms vs "
              f"static {1e3 * pplan.static_cost_seconds:.3f} ms")
        fv.reset_launches()
        out = gcn_forward(params, graph, feats, cfg, plan="auto",
                          precision=precision, device=dev,
                          device_model=model)
        torch.cuda.synchronize()
        counts = {k: n for k, n in fv.PRECISION_LAUNCHES.items() if n}
        want = plan_kernels(pplan)
        print(f"phase 6: {precision} plan='auto' launched {counts}, the plan "
              f"names {sorted(want)}")
        check(set(counts) == want, f"{precision} plan='auto' launched "
              f"{sorted(counts)}, its plan names {sorted(want)}")
        check(tuple(out.shape) == (graph.n_nodes, cfg.out_dim)
              and bool(torch.isfinite(out).all()),
              f"{precision} plan='auto': logits")
        ref = gcn_forward(params, graph, feats, cfg,
                          plan=SpmmPlan(impl="reference", **blocks),
                          precision=precision, device=dev)
        got = agreement(torch, out, ref)
        print(f"phase 6: {precision} plan='auto' vs the reference impl "
              f"{describe(got)}")
        check(agrees(got, FORWARD_REL_TOL[precision], FORWARD_FLIP_SHARE),
              f"{precision} plan='auto' disagrees with the reference impl: "
              f"{describe(got)}")
        plans = {"chosen": pplan,
                 "static_unfused": static_pipeline(cfg, precision=precision),
                 "static_fused": static_pipeline(cfg, precision=precision,
                                                 fused=True)}
        medians = timed_rounds(torch, {
            label: (lambda pp=pp: gcn_forward(params, graph, feats, cfg,
                                              plan=pp, device=dev))
            for label, pp in plans.items()}, rounds)
        timed = {}
        for label, pp in plans.items():
            ms = medians[label]
            modeled = 1e3 * pipeline_seconds(stats, pp, device=model)
            timed[label] = {"measured_ms": ms, "modeled_ms": modeled,
                            "measured_over_modeled": ms / modeled}
            print(f"phase 6: {precision} {label} forward median {ms:.3f} ms "
                  f"over {rounds} interleaved rounds, modeled {modeled:.3f} "
                  f"ms (measured / modeled {ms / modeled:.3f})")
        limit = PLAN_SLOWER * timed["static_unfused"]["measured_ms"]
        check(timed["chosen"]["measured_ms"] <= limit, f"{precision}: "
              f"the chosen forward {timed['chosen']['measured_ms']:.3f} ms "
              f"is more than {PLAN_SLOWER}x the static unfused one")
        if dataset == "reddit":
            if precision == "f32":
                check(not any(lp.spmm.fused for lp in pplan.layers),
                      "at Reddit f32 the planner fused a layer")
            for label in ("chosen", "static_unfused"):
                r = timed[label]["measured_over_modeled"]
                check(MODEL_RATIO[0] <= r <= MODEL_RATIO[1],
                      f"{precision} {label}: measured / modeled {r:.3f} "
                      f"outside {MODEL_RATIO}")
        forwards[precision] = {"plan": layers, "n_candidates":
                               pplan.n_candidates, "plan_host_s": plan_s,
                               "launches": counts, "vs_reference": got,
                               "forwards": timed}
    serving = (planned_serving(torch, np, registry, data, cfg, params, dev)
               if dataset == "pubmed" else None)
    return {"device_model": model.name,
            "rates": dataclasses.asdict(model.cuda),
            "rounds": rounds, "forwards": forwards, "serving": serving}


def planned_serving(torch, np, registry, data, cfg, params, dev) -> dict:
    """One engine with ``autoplan=True, precision="auto",
    ladder_growth="auto"`` at the serving CLI's other defaults, against
    an ``impl="reference"`` engine with its ladder and precisions."""
    from repro_torch.plan import cost
    from repro_torch.serve import ServeEngine

    before = registry.stats.builds
    t0 = time.perf_counter()
    engine = ServeEngine(data.adj_norm, data.features, cfg, params=params,
                         registry=registry, device=dev, autoplan=True,
                         precision="auto", ladder_growth="auto",
                         device_model=cost.H100, **SERVE)
    built = engine.warmup()
    warm_s = time.perf_counter() - t0
    check(registry.stats.builds == before, "the autoplanned engine "
          "preprocessed the dataset again")
    batcher = engine.batcher
    rungs = sorted({k[0] for k in batcher._executables})
    errs = {p: float(e) for p, e in engine.precision_errors.items()}
    print(f"phase 6: autoplanned engine ladder "
          f"{[(b.nodes, b.rows) for b in batcher.ladder.entries]}; "
          f"{built} CUDA graphs captured in {warm_s:.1f} s; measured logit "
          f"errors {errs}; full graph at {engine.resolved_precision}")
    # the full-graph step's precision is priced, then measured against f32
    full_modeled = {p: 1e3 * engine.full_step_seconds(p) for p in errs}
    steps = {p: engine._step(p) for p in {"f32", engine.resolved_precision}}
    full_ms = timed_rounds(torch, {
        p: (lambda step=step: step(engine.params, engine._features_dev))
        for p, step in steps.items()}, PLAN_ROUNDS["pubmed"])
    print(f"phase 6: full-graph step modeled ms {full_modeled}; measured "
          f"median ms {full_ms} over {PLAN_ROUNDS['pubmed']} interleaved "
          "rounds")
    check(full_ms[engine.resolved_precision] <= PLAN_SLOWER * full_ms["f32"],
          f"the autoplanned engine's full-graph step at "
          f"{engine.resolved_precision} ({full_ms[engine.resolved_precision]:.3f}"
          f" ms) is more than {PLAN_SLOWER}x its f32 step "
          f"({full_ms['f32']:.3f} ms)")
    rung_plans = {}
    for b in rungs:
        plans = [(p.effective_impl, p.block_rows, p.block_k, p.block_f,
                  p.fused) for p in batcher.layer_plans_for_bucket(
                      b, data.features.shape[1])]
        rung_plans[f"{b.nodes}x{b.rows}"] = {
            "precision": batcher.precision_for_bucket(b), "layers": plans}
        print(f"phase 6: rung {b.nodes}x{b.rows} at "
              f"{batcher.precision_for_bucket(b)}: layers {plans}")
    n_used = sum(SERVE_LOAD["pubmed"][k] for k in ("queries", "batch"))
    n_used *= len(SERVE_ENGINES["pubmed"])
    requests = serve_draws(np, data.adj_norm.rows,
                           [n_used, PLAN_LOAD["queries"] + PLAN_LOAD["batch"]])[1]
    full, answers = serve_answers(engine, requests, PLAN_LOAD["queries"], 1)
    check(engine.compile_count == built, f"the autoplanned engine captured "
          f"{engine.compile_count - built} graphs after warmup")
    ref = ServeEngine(data.adj_norm, data.features,
                      dataclasses.replace(cfg, spmm_impl="reference"),
                      params=params, registry=registry, device=dev,
                      ladder=batcher.ladder,
                      precision=engine.resolved_precision, **SERVE)
    for b in batcher.ladder.entries:
        ref.batcher.set_bucket_precision(b, batcher.precision_for_bucket(b))
    ref_full, ref_answers = serve_answers(ref, requests, PLAN_LOAD["queries"],
                                          1)
    key = "autoplanned engine"
    prec = engine.resolved_precision
    out = {"full_vs_reference": hold(
        torch, np, key, "full graph vs the reference impl", [full],
        [ref_full], prec, FORWARD_FLIP_SHARE, phase=6)}
    groups = {}
    for i, seeds in enumerate(requests):
        sub = engine.sampler.extract(seeds)
        b = batcher.ladder.bucket_for(sub.n_sub_nodes, sub.n_ell_rows)
        groups.setdefault(batcher.precision_for_bucket(b), []).append(i)
    for p, idx in sorted(groups.items()):
        out[f"vs_reference@{p}"] = hold(
            torch, np, key, f"{len(idx)} answers at {p} vs the reference impl",
            [answers[i] for i in idx], [ref_answers[i] for i in idx], p,
            SERVE_FLIP_SHARE[p], phase=6)
    batcher.clear_executables()
    ref.batcher.clear_executables()
    return {"ladder": [[b.nodes, b.rows] for b in batcher.ladder.entries],
            "captures": built, "warmup_s": warm_s,
            "post_warmup_captures": engine.compile_count - built,
            "precision_errors": errs,
            "full_graph_precision": engine.resolved_precision,
            "full_graph_modeled_ms": full_modeled,
            "full_graph_measured_ms": full_ms,
            "rungs": rung_plans, "requests": len(requests), **out}


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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cache_") as cache_dir:
        return drive(torch, np, args, cache_dir)


def drive(torch, np, args, cache_dir: str) -> int:
    """Phases 1-6 on the card; the registry persists under ``cache_dir``."""
    import repro_torch.exec as rt
    from repro_torch.graphs.datasets import DATASETS, load_dataset
    from repro_torch.kernels import _build
    from repro_torch.kernels import flexvector_spmm as fv
    from repro_torch.models.gcn import GCNConfig, init_params
    from repro_torch.serve import ArtifactRegistry

    dev = torch.device("cuda")

    device, card = phase_device(torch, _build)

    t0 = time.perf_counter()
    spec = DATASETS[args.dataset]
    data = load_dataset(args.dataset, seed=SEED)
    cfg = GCNConfig(in_dim=spec.feature_dim, hidden_dim=HIDDEN,
                    out_dim=spec.classes, n_layers=2)
    # phase 5's engines share this registry: the dataset is preprocessed
    # once, here
    # room for every subgraph phase 5 preprocesses, so the LRU never
    # drops the dataset's own artifact
    registry = ArtifactRegistry(cache_dir=cache_dir, mem_capacity=16384)
    graph = registry.get_or_build(data.adj_norm, cfg, persist=False)
    ell = graph.pre.ell
    print(f"setup: {args.dataset} {spec.nodes} nodes, ELL {ell.padded_rows}x"
          f"{ell.tau} ({ell.nnz} nnz), built in "
          f"{time.perf_counter() - t0:.1f} s (registry builds "
          f"{registry.stats.builds})")
    params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    feats = torch.as_tensor(data.features, device=dev)

    cases = main_path_cases(torch, rt, graph, cfg, params, feats, dev)
    kernels = phase_kernels(torch, np, fv, cases, dev)
    multi_slab = multi_slab_check(torch, np, fv, dev)
    small_forward_check(torch, np, rt, dev)
    main = phase_main_path(torch, rt, fv, graph, cfg, params, feats, dev,
                           ("f32",), 3)
    quant = phase_main_path(torch, rt, fv, graph, cfg, params, feats, dev,
                            ("bf16", "int8"), 4)
    t5 = time.perf_counter()
    phase5 = phase_serving(torch, np, fv, registry, data, cfg, params, dev,
                           args.dataset)
    serving = phase5["engines"]
    uncapped = serving_uncapped_check(torch, np, registry, dev)
    print(f"phase 5: {time.perf_counter() - t5:.1f} s; registry builds "
          f"{registry.stats.builds} (the dataset once, then each distinct "
          f"subgraph), mem_hits {registry.stats.mem_hits}")
    t6 = time.perf_counter()
    planning = phase_planning(torch, np, fv, registry, data, graph, cfg,
                              params, feats, dev, args.dataset)
    print(f"phase 6: {time.perf_counter() - t6:.1f} s")

    def summary(key):
        """Per forward pass: the sum over its two layer launches."""
        k = kernels[key]
        cells = k["per_layer"]
        top = max(cells, key=lambda c: c["bound_ms"])
        return {
            "max_abs_err": k["max_abs_err"],
            "max_rel_err": k["max_rel_err"],
            "max_flip_share": k["max_flip_share"],
            "rel_tol": REL_TOL[key],
            "flip_share_limit": FLIP_SHARE,
            "ms": sum(c["ms"] for c in cells),
            "us": 1e3 * sum(c["ms"] for c in cells),
            "plain_ms": sum(c["plain_ms"] for c in cells),
            "bound_ms": sum(c["bound_ms"] for c in cells),
            "bound_by": top["bound_by"],
            "padded_bound_ms": sum(c["padded_bound_ms"] for c in cells),
            "library_ms": sum(c["library_ms"] for c in cells),
            "library_call": cells[0]["library_call"],
            "per_layer": cells,
        }

    lines = []
    for name in KERNELS:
        line = {"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name]}
        if name in BASE:   # f32, with its bf16 instantiation beside it
            line["launches"] = main["launches"]["f32"][name]
            line.update(summary(name))
            line["bf16"] = dict(summary(f"{name}@bf16"),
                                launches=quant["launches"]["bf16"][name])
        else:
            line["launches"] = quant["launches"]["int8"][name]
            line.update(summary(name))
        line["serving_launches"] = {
            key: {how: {k: n for k, n in counts.items()
                        if k.split("@")[0] == name}
                  for how, counts in e["launches"].items()}
            for key, e in serving.items()}
        lines.append(line)
    print(json.dumps({"fused_split": {
        key: [cell["split"] for cell in kernels[key]["per_layer"]]
        for key in KEYS if not is_aggregation(split_key(key)[0])}}))
    merged = {key: {**main[key], **quant[key]}
              for key in ("forward_ms", "device_busy_ms", "device_idle_share")}
    print(json.dumps({"kernels": lines, "dataset": args.dataset, **merged,
                      "multi_slab": multi_slab,
                      "logit_error_vs_f32": quant["logit_error_vs_f32"],
                      "f32_control_vs_reference":
                          quant["control_vs_reference"]}))
    print(json.dumps({"serving": {
        "dataset": args.dataset, "card": card, "settings": SERVE,
        "load": SERVE_LOAD[args.dataset], "engines": serving,
        "skipped_engines": phase5["skipped"],
        "uncapped_small_graph": uncapped,
        "registry": dataclasses.asdict(registry.stats)}}))
    print(json.dumps({"planning": dict(planning, dataset=args.dataset,
                                       card=card)}))
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
