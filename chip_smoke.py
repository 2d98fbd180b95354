#!/usr/bin/env python3
"""Drive the repro_torch port on one CUDA card and check it end to end.

    python3 chip_smoke.py                    # PubMed, the default
    python3 chip_smoke.py --dataset reddit   # ~2 min of host preprocessing
    python3 chip_smoke.py --dataset yelp     # ~5 min of host preprocessing

Phases, in order; any failure exits non-zero.  ``--dataset yelp`` (the
paper's largest graph: 716,847 nodes, ELL 5,667,712 x 6) runs phases
1-8, 10 and 13 (b) and (c) at Reddit's loads; it leaves out phases 11,
12, 13 (a), 13 (d) and 14, which the default run drives (all but 12 (d)
read no dataset), and phase 9, whose fleet sheds most of its cold
requests there (``OMITTED``), and names each with its reason on a line of
its own:

1. Device: the card's name and power limit (``nvidia-smi``), then the
   kernel library built from ``src/repro_torch/csrc`` and its build time.
2. Kernels: each CUDA kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it (both GCN layers) and on a
   small ragged case: the four f32 kernels, their bf16 instantiations
   (``name@bf16``) and their int8 ``_scaled`` variants, and the
   aggregation kernels' other stores (``STORE_KEYS``): the bf16 store of
   f32, bf16 and scaled int8 values (``name@f32->bf16``, ``@bf16->bf16``,
   ``_scaled@int8->bf16``: within one bf16 ulp of the plain version, the
   plain f32 sum rounded to bf16) and the exact int8 x int8 -> int32
   product (``name@int8->int32``: the main path's int8 values without
   their scales times an int8 operand of the layer's width from numpy
   seed ``SEED``, ``torch.equal`` to the plain version).  Each is timed with
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
   precision on the CPU.  Then the public path at full size
   (``public_dtype_check``): ``repro_torch.core.spmm_ell`` over the
   dataset's own ELL with the main path's int8 values, unscaled, times an
   int8 operand of each layer's width, under ``cuda`` and ``cuda_sparse``,
   each answer ``torch.equal`` to ``impl="reference"``'s int32 answer;
   and ``SpmmPlan(out_dtype=torch.bfloat16)`` at f32, bf16 and int8 under
   both impls against the reference impl at that precision, within the
   bound of a bf16 store and a bf16 fold.  The launch counts are reset
   just before and read just after: each of ``STORE_KEYS`` must have
   launched.
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
   rounds (300 at PubMed, 20 at Reddit; each round in the next of their
   orders; plans that run the same layers timed once), each median beside
   the model's ms and the measured-to-modeled ratio: the median of each
   chosen forward's per-round ratio to the static unfused one (both calls
   of a round adjacent, so the drift between rounds cancels) must be at
   most 1.10; its interquartile range is printed.  At Reddit the f32 choice must
   be unfused and the model within 0.5x-2x of the chosen and static
   unfused forwards.  At PubMed one engine with ``autoplan=True``,
   ``precision="auto"`` and ``ladder_growth="auto"`` (the registry of
   phase 3, the serving CLI's other defaults) prints each warmed rung's
   plans and precision and the full-graph step's modeled ms per
   precision; its full-graph step, timed against its f32 step over 300
   interleaved rounds, must have a median per-round ratio to it of at
   most 1.10.  It serves 100 queries
   and 100 batched requests that phase 5 did not, captures nothing after
   warmup and answers as an ``impl="reference"`` engine at the same
   precisions does, within phase 5's limits.

7. Sharding: ``gcn_forward(mesh=)`` in two spawned ranks over one process
   group on a ``launch.mesh.make_data_mesh`` data mesh: gloo with both
   ranks on the card when there is one (NCCL refuses two ranks on one
   card; gloo takes CUDA tensors), NCCL with a card each when there are
   two.  The dataset is preprocessed once, here, and the graph, features,
   weights and the unsharded reference-impl logits of each precision are
   handed to the ranks in files.  Each rank runs the four kernel configs
   with a replicated chain (an all-reduce per layer) and a row-sharded one
   (``static_pipeline``: reduce-scatter, then the next layer's all-gather),
   at f32, bf16 and int8, and holds the logits against the unsharded
   forward at phase 4's limits (int8 values are re-quantized per shard, so
   int8 is held against the sharded reference impl and within the int8
   logit budget of the f32 logits); each forward's ledger must equal the
   cost model's collective formulas; the launch counts, reset before each
   precision, must show that precision's four kernels on both ranks and
   no other; a profile of one f32 forward per config must show the port's
   aggregation and fused kernels and no library sparse kernel; and
   ``plan="auto"`` on the 2-wide mesh (the H100 model, which prices the
   collectives at NVLink's published rate) must launch exactly its plan's
   kernels and agree.  Forward times are CUDA-event medians per rank; with
   both ranks on one card they are per-shard times, not multi-GPU times.

8. The async runtime: ``ServeEngine.runtime()`` (the port's queue,
   deadline-aware scheduler and worker thread, which replays the rungs'
   CUDA graphs) driven open-loop by ``runtime.run_open_loop`` at the
   serving CLI's defaults (deadline 200 ms), each run with a ``Tracer``
   and the engine's ``PlanFeedback`` store.  PubMed: ``cuda`` f32 and
   fused int8, each at 150 req/s (capacity 256) and at 1,500 req/s
   (capacity 32, which must shed); Reddit: ``cuda`` f32 at 10 req/s.  Every
   completed answer is held against an eager forward over the request's
   own subgraph; submitted = completed + the rejections, sheds and
   cancels, none failed, no future pending, no capture in the window;
   every trace complete, each served one with its admission, prepare,
   queue_wait and execute spans, one execute_layer per layer, the rung's
   plan key and the ledger events ``record_batch_dram`` gives its batch;
   one feedback entry per (rung, plan) served, saved under
   ``build/chip_smoke/`` and loaded back, and (f32) an autoplanned engine
   over the loaded store pins each measured rung's plan on every layer
   at warmup.  An eager forward under an active span opens one
   ``execute_layer`` span per layer with ledger events, and a capture
   under the span opens none.  Prints per engine and load the offered
   rate, completed, shed rate, SLO attainment, goodput, e2e / wait / exec
   p50 and p99, the batches' close reasons and the median ``admission``,
   ``prepare``, ``queue_wait`` and ``execute`` spans.

9. The fleet: three ``GcnServable``s behind one ``FleetRuntime`` at the
   serving CLI's defaults and hidden 64 — the dataset (``cuda`` f32),
   Cora (fused int8) and CiteSeer (``cuda`` bf16) — in a capacity of the
   dataset's cost units + 1, so at most two are resident and traffic
   forces unloads and reloads (each a capture of the servable's grid).
   The tenants of ``examples/fleet_smoke.json`` (the file as a whole,
   its LM included, runs in phase 11): cold (priority 1, 400 ms) at 5 req/s on every servable
   and hot (20 req/s quota, burst 4, 32 in flight) at 80 req/s on the
   dataset, open loop for 40 s through ``fleet.run_open_loop_mix`` with
   tracing, then the cold streams alone for 40 s.  Checks: every
   completed answer within phase 5's limits of a reference-impl engine of
   its servable; per tenant every submit completed, rejected or shed,
   none failed, the hot tenant held to its quota; at least two loads and
   two unloads; every capture inside a load, each load capturing the
   servable's whole grid; no batch mixing servables; every trace
   complete, a served one's execute span naming its servable; each
   servable's kernel replayed; the device memory after a third unload of
   the dataset's servable within 16 MiB of the first; and a one-servable
   fleet, on a scripted ``VirtualClock`` scenario, closing the batches
   of the engine's own ``ServeRuntime``, with its counters and sheds,
   and feeding the same executables the same input bytes, its answers
   within phase 5's f32 limits of the runtime's (their bitwise share is
   printed beside that of a second runtime run).  Prints per tenant
   completed, shed rate, SLO attainment mixed and alone, e2e p50/p99,
   goodput, each servable's loads and mean reload time, and the cold
   tenant's attainment difference with its 95% interval against the
   reference's isolation bar (within 5%): met, not met, or not resolved
   by the run's sample (reported, not gated).
10. The serving mesh: ``ServeEngine(mesh=)`` in two spawned ranks over
   one process group (gloo with both ranks on the card; NCCL given a
   card each), ``cuda`` f32 and fused int8 at the dataset, under a time
   limit as in phase 7.  Rank 0 leads: 200 requests through
   ``query_batch`` and 200 open loop at 150 req/s through a traced
   runtime (100 and 100 at 10 req/s at Reddit); rank 1 follows.  Checks:
   rank 0's answers within phase 5's limits of an unmeshed engine's and
   of the reference impl's; every rank replayed one chunk of each batch
   the ranks divide and the whole of every other; the follower followed
   every forward; no capture after warmup on either rank; the traces
   (mesh width 1) and their ledger events those of an unmeshed engine.
   Requests/s is printed as two ranks on one card, not a multi-GPU
   figure.
11. The LM/SSM models (``repro_torch.models.lm``; no TPU kernel lies on
   this path, its matrix products are ``torch.matmul`` / ``einsum``),
   with bf16 GEMMs reducing in f32 as the reference's do: (a) the ten
   reduced archs on the card against the CPU from the same weights, the
   forward logits and 8 decode steps with the cross caches filled,
   within the CPU parity tests' bars (2e-2 of max|logits|; jamba 4e-2,
   xlstm 1e-1); (b) one block of each mixer at its arch's published
   widths (batch 2 x seq 16; cross-attention over 1,601 image tokens,
   seamless's encoder layer and ``attnx`` over 1,024 frames), card
   against CPU within 2e-2; (c) qwen3-8b at full width and depth (36
   layers, 16.4 GB of bf16 weights drawn on the card): the LM CLI
   (``repro_torch.launch.serve``) at batch 4, max-seq 64, 32 greedy
   tokens, the prefill of 4 x 64 tokens, 16 decode steps against a
   teacher-forced forward within 5e-2 of max|logits| (a decode at
   positions off by one must exceed it), the weight-read bound per step
   (weight bytes / 3.35 TB/s), peak memory and the decode step's leading
   device ops (``torch.profiler``); (d) ``examples/fleet_smoke.json``
   whole through ``fleet_from_config`` on the card: its three loads open
   loop, every LM answer within 1e-3 of an eager forward, every capture
   inside a load, the accounting closed.  Bf16 GEMMs reduce in f32 as
   the reference's do: the LM entry points scope the setting themselves
   (``layers.bf16_full_reduction``) and the direct calls here set it;
   the decode-vs-forward agreement is also printed at torch's default.
12. Training (``repro_torch.train``, ``launch.steps.build_train_step``;
   no TPU kernel lies on this path): (a) the LM training CLI
   (``repro_torch.launch.train``) at its defaults, internlm2-1.8b uncut
   (24 layers, d 2048, vocab 92,544), 20 steps of batch 8 x seq 128 with
   remat: the loss must fall; the median step ms over steps 3-20,
   tokens/s, peak memory, one more step's device busy ms and leading ops
   (``torch.profiler``) beside its bound (8 x params x tokens / 989
   TFLOP/s against AdamW's 22 bytes a parameter / 3.35 TB/s); the
   trained state through ``save_async`` and ``restore``, bit-equal;
   (b) one step's loss and gradients of the ten reduced archs on the
   card against the CPU from one state, each leaf held by
   ``train.grad.hold_leaf`` given the CPU's own move under 1-ulp
   embedding moves (the CPU tests' rule: within 2e-2 of max|CPU grad| or
   twice that move, up to 0.25; beyond, by cosine distance and norm
   ratio), with bf16 reductions in f32 (gated) and at torch's default
   (printed); (c) a reduced internlm2 through the trainer
   with a StepFailure at step 10 resumes from its checkpoint and its
   losses stay within 1e-2 of an uninterrupted run's; (d) the GCN as
   ``examples/train_gcn.py`` trains it: the dataset at its published
   widths, hidden 64, ``impl="reference"``, 100 steps with a failure at
   step 40 (at Reddit 30 steps, failing at 12: its steps take ~1.8 s),
   the first step's gradients on the card and on the CPU each
   within 2^-23 sqrt(nnz) of an f64 plain GCN's on the CPU, one step's
   device ops, and a ``cuda`` impl refusing gradients.
13. The simulator and the examples (no TPU kernel lies on the simulator's
   path: its group-bys are torch sorts, cumulative sums and uniques):
   (a) Cora, CiteSeer and PubMed through ``graphs.partition``'s label
   propagation, ``apply_symmetric_permutation`` (host), and
   ``sim.compute_block_stats(tile=16)``, ``simulate_flexvector(HWConfig())``
   and ``simulate_grow(GROWConfig(m=6))`` on the card, then the same on
   the CPU through the port's own code: the permutation, every
   ``BlockStats`` array (values and dtypes), Algorithm 2 in both modes
   and every ``SimResult`` field must be equal.  Prints per dataset the
   GROW / FlexVector cycle ratio and energy ratio (the simulator's
   modeled ASIC figures, not card times) and each step's card and CPU
   seconds, then their geomeans beside the survey's 3.78x / -40.5% (a
   five-dataset figure).  (b) Under ``--dataset reddit`` or ``yelp``, that
   dataset's simulator on the card over phase 1's adjacency (no CPU
   comparison).
   (c) ``kernels.ops.flexvector_spmm`` at the dataset's ELL and a
   64-wide dense operand, f32 / bf16 / int8 with ``skip_empty`` both
   ways, the launch counts reset before each call: each call must launch
   its own kernel at its own precision once and nothing else, and agree
   with that kernel's plain version on the card within phase 2's limits.
   (d) ``examples/torch_quickstart.py --impl cuda_sparse`` and
   ``examples/torch_train_gcn.py --inject-failure`` (100 steps) at Cora,
   each a subprocess on the card, run side by side; each must exit 0.
14. The LM under a mesh (``dist.sharding.ShardingPlan``,
   ``launch.mesh.make_production_mesh``, DTensor steps; no TPU kernel
   lies on this path): (a) phase 11's qwen3-8b (its seed, published
   widths, 36 layers) placed by ``ShardingPlan`` on a (1, 2) data x model
   mesh of two gloo ranks on the one card (NCCL refuses two ranks on one
   card; each rank draws the full weights and keeps its shards), the
   prefill of phase 11's 4 x 64 prompt and 8 cached decode steps through
   ``build_prefill_step`` / ``build_serve_step(mesh=)``: every rank's
   whole logits within 2e-2 of max|logits| of the single-card steps', or
   within twice the single card's own move when only its kernels change
   (each sequence run alone against the batch, measured beside; at most
   5e-2, phase 11's full-width bar), each rank's peak memory during the steps at most 0.6 of the single
   card's, the decode ms a token and a step's collectives (calls and
   bytes, ``roofline.analysis.CollectiveCounter``); (b) one
   internlm2-1.8b train step at the training CLI's batch 8 x seq 128 on
   the same mesh, its loss within 1e-2 of the single card's, peak memory
   and the second step's ms, then on a (2, 1) data x model mesh of the
   same ranks with ``ShardingPlan(fsdp=True)`` (each weight gathered over
   ``data`` before its products): its loss within 1e-2 of the single
   card's, its peak at most 0.6 of the single card's (the weights and
   moments sharded), the second step's ms; (c) ``python -m
   repro_torch.launch.dryrun`` for qwen3-8b x train_4k and decode_32k and
   deepseek-v2-lite-16b x train_4k (the reference's cell: its MoE
   dispatch and combine on token shards) on a fake 16 x 16 mesh, on the
   host (no tensor on the card;
   each process holds a CUDA context, which autograd's device thread needs),
   side by side with (a), (b) and (d): each record (its peak and its
   collectives by kind) and its H100 roofline terms (the device model's
   peaks, not card times); (d) the reduced qwen3-8b, deepseek-v2-lite and
   jamba (phase 11's seed) on a (2, 2) mesh of four gloo ranks on the
   card with FSDP: the prefill of a 4 x 16 prompt, 8 cached decode steps
   and one train step, every rank's whole logits within the arch's bar
   of phase 11 (2e-2, jamba 4e-2) of the single card's, the loss within
   1e-2, and the collectives of the MoE layers in the prefill and the
   train step (calls, bytes, the largest result beside the (E, cap, D)
   buffer).  Gloo's functional
   all-gather crashes on CUDA tensors on the card's torch, so the mesh
   routes it through ``all_gather_into_tensor``
   (``launch.mesh.gloo_cuda_all_gather``).  At Reddit, phase 9's open
   loops last 10 s each (40 s at PubMed) to fit the run in 1,200 s.

Prints one ``{"fused_split": ...}`` line, one ``{"kernels": [...]}`` line,
one ``{"serving": ...}`` line, one ``{"planning": ...}`` line, one
``{"sharding": ...}`` line, one ``{"async": ...}`` line, one
``{"fleet": ...}`` line, one ``{"serving_mesh": ...}`` line, one
``{"lm": ...}`` line, one ``{"train": ...}`` line, one ``{"sim": ...}``
line, one ``{"lm_mesh": ...}`` line and one ``{"dryrun": ...}`` line, then
as the last
line ``{"ok": true, "device": {...}}`` (at Yelp the lines of the phases
it leaves out hold ``{"omitted": ...}``).  Without CUDA, or without the
repository's ``src/repro_torch`` beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
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
# The aggregation kernels' other stores, "<name>@<values>-><store>": the
# bf16 store of each precision's values and the exact int8 x int8 ->
# int32 product (which the TPU computes in its unscaled pallas_call).
STORE_KEYS = tuple(
    f"{base}{'_scaled' if precision == 'int8->bf16' else ''}@{precision}"
    for base in BASE[:2]
    for precision in ("f32->bf16", "bf16->bf16", "int8->bf16", "int8->int32"))
# Phase 2's entries: a kernel name, "@bf16" for its bf16 instantiation,
# then the other stores.
KEYS = BASE + tuple(f"{n}@bf16" for n in BASE) + KERNELS[4:] + STORE_KEYS
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 on
# the CUDA cores (the f32 kernels do f32 FMA, no TF32) and dense bf16 on
# the tensor cores, the least time for products of bf16 and int8 inputs.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
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
# The other stores are held element by element (``store_holds``): the
# int32 product exactly (integer sums in any order), a bf16 store within
# one bf16 ulp of the plain f32 sum rounded to bf16 (2^-7 of the larger
# magnitude's power of two) beyond the f32 store's bar (1e-5 of
# max|plain|): the two f32 sums differ by FMA contraction only, and each
# rounding to bf16 adds at most half an ulp.  REL_TOL holds the ulp's
# share of its power of two.
for _k in STORE_KEYS:
    REL_TOL[_k] = 0.0 if _k.endswith("int32") else 2.0 ** -7
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
              "reddit": dict(queries=200, batch=300, full=100),
              "yelp": dict(queries=200, batch=300, full=100)}
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
    "yelp": (("cuda", "f32", False), ("cuda", "int8", True)),
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
PLAN_ROUNDS = {"pubmed": 300, "reddit": 20, "yelp": 20}
# Phase 8: the async runtime at the serving CLI's defaults (deadline
# 200 ms, queue capacity 256) with the requests drawn as phase 5 draws
# them, after every request phases 5 and 6 served.  PubMed: under
# capacity (150 req/s, below the 332-458 req/s of phase 5's batches) and
# overloaded (1,500 req/s into 32 places); Reddit under capacity (10
# req/s, below its ~22 req/s).  The feedback check builds an autoplanned
# engine on the CLI's ladder (growth 4, autoplan's own is "auto").
ASYNC_ENGINES = {"pubmed": (("cuda", "f32", False), ("cuda", "int8", True)),
                 "reddit": (("cuda", "f32", False),),
                 "yelp": (("cuda", "f32", False),)}
ASYNC_LOADS = {
    "pubmed": (dict(name="under", requests=400, qps=150.0, capacity=256),
               dict(name="overload", requests=400, qps=1500.0, capacity=32)),
    "reddit": (dict(name="under", requests=150, qps=10.0, capacity=256),),
    "yelp": (dict(name="under", requests=150, qps=10.0, capacity=256),),
}
ASYNC_DEADLINE_S = 0.2
SERVE_GROWTH = 4
# Kernel names in the profile of a replayed batch (csrc/flexvector_spmm.cu),
# and names of library sparse kernels that must not appear there.
AGGREGATION_KERNEL = "ell_aggregate_kernel"
FUSED_KERNEL = "ell_fused_xw_kernel"
LIBRARY_SPARSE = ("sparse", "csrmm", "coomm", "spmm")
# Phase 7: sharding.  Two ranks over one process group: gloo when one card
# holds both (NCCL refuses two ranks on one card), NCCL given two cards.
# Each (config, chain) forward is timed over SHARD_REPS calls after one
# warm call; the spawn has SHARD_SECONDS in all.
SHARD_RANKS = 2
SHARD_CHAINS = ("replicated", "pipelined")
SHARD_REPS = {"pubmed": 10, "reddit": 3, "yelp": 3}
SHARD_SECONDS = 900
# Phase 9: the fleet.  Three servables at the serving CLI's defaults and
# hidden 64: the run's dataset, Cora and CiteSeer, each ``(dataset,
# impl, precision, fused)``; a capacity of the run's dataset's cost units
# + 1, so two at most are resident and the cold traffic forces reloads.
# The tenants are examples/fleet_smoke.json's (phase 11 runs the file
# whole, its LM included): cold at 5 req/s on every servable, hot at 80 req/s on the
# run's dataset, open loop for FLEET_SECONDS (600 cold requests, 3,200 hot);
# then the cold streams alone for as long.
FLEET_SERVABLES = ((None, "cuda", "f32", False), ("cora", "cuda", "int8", True),
                   ("citeseer", "cuda", "bf16", False))
FLEET_TENANTS = (dict(name="cold", priority=1, deadline_s=0.4),
                 dict(name="hot", qps=20.0, burst=4.0, max_inflight=32))
FLEET_COLD_QPS, FLEET_HOT_QPS = 5.0, 80.0
FLEET_SECONDS = 40.0
# Reddit's open loops are cut to fit the run's 1,200 s: each of its
# payloads costs ~65 ms of host preparation (3,400 at 40 s), so at Reddit
# each window lasts 10 s (50 cold requests a servable, 800 hot: still
# above FLEET_MIN_SAMPLE, and the hot tenant still over its quota).
FLEET_SECONDS_CUT = {"reddit": 10.0}
FLEET_ISOLATION = 0.05   # the reference's bar: cold attainment within 5%
FLEET_MIN_SAMPLE = 30    # answers a share needs for its normal interval
FLEET_MEMORY_SLACK = 16 * 2 ** 20   # bytes, across three unload cycles
FLEET_IDENTITY_REQUESTS = 24
# Phase 10: the serving mesh.  Two ranks over gloo on the one card (or a
# card each over NCCL), ``(impl, precision, fused)`` engines at the
# run's dataset; rank 0 serves ``batch`` requests through query_batch,
# then ``async`` open loop at ``qps``; the spawn has MESH_SECONDS.
MESH_RANKS = 2
MESH_ENGINES = (("cuda", "f32", False), ("cuda", "int8", True))
MESH_LOAD = {"pubmed": dict(batch=200, async_=200, qps=150.0),
             "reddit": dict(batch=100, async_=100, qps=10.0),
             "yelp": dict(batch=100, async_=100, qps=10.0)}
MESH_SECONDS = 600
# Yelp runs the phases that read the dataset at Reddit's loads and cuts
# (the tables above) and leaves out these, each for its reason.  Phase 9
# fails by chance at Yelp: a reload of its 11-unit servable evicts the
# others, and the reloads fold into the buckets' estimates, which then
# exceed the cold tenant's deadline (ROADMAP S3), so admission refuses
# ~90% of the cold requests and a small servable may serve none in a
# window (PR 25: CiteSeer 3 answers in one run, none in the next).
_DRIVEN = "reads no dataset; the default run drives it"
OMITTED = {"yelp": {
    "9": "the fleet sheds ~90% of its cold requests as infeasible "
         "(ROADMAP S3), so a servable may serve none in a window",
    "11": _DRIVEN,
    "12": "(a)-(c) read no dataset, the default run drives them; (d), "
          "the GCN's training at the dataset, is not run",
    "13 (a)": _DRIVEN,
    "13 (d)": _DRIVEN,
    "14": _DRIVEN,
}}


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
    """``(kernel name, precision)`` of a phase 2 entry (the precision with
    ``-><store>`` for the other stores)."""
    if "@" in key:
        return tuple(key.split("@"))
    return key, "int8" if key.endswith("_scaled") else "f32"


def within_one_bf16_ulp(torch, out, ref, f32_tol: float) -> bool:
    """Every element of bf16 ``out`` within one bf16 ulp of bf16 ``ref``
    (the larger magnitude's: 2^-7 of its power of two) beyond ``f32_tol``
    of max|ref|, the bar of the two f32 sums they round (which rounding
    carries across, however many ulps of a cancelled sum it is)."""
    out, ref = out.double(), ref.double()
    mag = torch.maximum(out.abs(), ref.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    slack = f32_tol * float(ref.abs().max())
    return bool(((out - ref).abs() <= ulp + slack).all())


def store_holds(torch, key: str, out, ref, real) -> bool:
    """A phase 2 output against its plain version: the other stores
    element by element (``REL_TOL``'s note), the rest by ``agrees``."""
    if key not in STORE_KEYS:
        return agrees(agreement(torch, out, ref, real), REL_TOL[key])
    out, ref = out[:real[0], :real[1]], ref[:real[0], :real[1]]
    if out.dtype != ref.dtype:
        return False
    if key.endswith("int32"):
        return bool(torch.equal(out, ref))
    return within_one_bf16_ulp(torch, out, ref,
                               REL_TOL[split_key(key)[0]])


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
    bf16/int8 ones at the bf16 tensor-core peak, int8 x int8 ones at the
    int8 tensor-core peak.  The output is written at its store's width
    (``out_dtype``).
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
    out_size = torch.empty(0, dtype=kw.get("out_dtype") or torch.float32
                           ).element_size()
    if is_aggregation(name):
        dense = args[2]
        k = dense.shape[0]
        keep = (cols >= 0) & (cols < k)
        nnz = int(keep.sum())
        uniq = int(torch.unique(cols[keep]).numel())
        sched = sum(4 * a.numel() for a in args[3:])
        nbytes = (ell_bytes + sched + dense.element_size() * uniq * f
                  + out_size * r * f)
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
    if is_aggregation(name) and args[2].dtype == torch.int8:
        rate = INT8_OPS_PER_S
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
    widened inside the call.  An int8 x int8 product takes int32 operands
    if a call accepts them, else the f32 call over the widened operands,
    so labelled.  A bf16 store has no call of its own: the call of its
    values' precision stands in (its output f32, or bf16 from bf16
    operands)."""
    from repro_torch.kernels.ref import dequantize_rows

    cols, vals = args[0], args[1]
    if kw.get("scales") is not None:
        vals = dequantize_rows(vals, kw["scales"], kw["block_rows"])
    agg = is_aggregation(name)
    if agg and args[2].dtype == torch.int8:
        k = args[2].shape[0]
        a = ell_csr(torch, cols, vals.to(torch.int32), k, k)
        dense = args[2].to(torch.int32)
        try:
            torch.sparse.mm(a, dense)
            torch.cuda.synchronize()
            return (lambda: torch.sparse.mm(a, dense),
                    "torch.sparse.mm(int32 CSR, int32)")
        except RuntimeError:
            a = ell_csr(torch, cols, vals.to(torch.float32), k, k)
            dense = args[2].to(torch.float32)
            return (lambda: torch.sparse.mm(a, dense),
                    "none takes int8 x int8 -> int32 on CUDA; timed: "
                    "torch.sparse.mm(f32 CSR, f32) over the widened "
                    "operands")
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


def host_sizes(np, fv, ell, cfg) -> dict:
    """The wrappers' host-side sizes at the dataset's ELL, each held to
    the index type that carries it: the row count, the flat slot index
    of the fused kernels' slot lists (int32), the sub-row output's
    elements at a block of columns (64-bit offsets in the kernels) and
    the sparse grid's bitmaps."""
    r, tau = ell.padded_rows, ell.tau
    n_rb = -(-r // cfg.block_rows)
    n_kb = -(-ell.n_dense_rows // cfg.block_k)
    sizes = {"rows": r, "slots": r * tau, "out_elements": r * cfg.block_f,
             "bitmap_words": n_rb * fv._bitmap_words(n_kb),
             "row_map_max": int(ell.row_map.max())}
    print(f"setup: host-side sizes {sizes}: rows, slots and the row map "
          f"in int32 (limit {2 ** 31 - 1}), the output offsets in int64")
    check(max(r, r * tau, sizes["row_map_max"]) < 2 ** 31,
          f"the ELL's host-side sizes {sizes} overflow int32")
    return sizes


def main_path_cases(torch, rt, graph, cfg, params, feats, dev) -> dict:
    """Each phase 2 entry's (args, kwargs, real) for both layers of one
    forward pass at its precision, built by the same functions the
    dispatch uses; real is the unpadded output shape (rows, width), for a
    fused kernel followed by the unpadded input width.  The other stores
    take each precision's aggregation arguments with ``out_dtype``; the
    int8 x int8 product the int8 values without their scales and an int8
    operand of the layer's shape from numpy seed ``SEED``."""
    import numpy as np

    from repro_torch.exec import quant
    from repro_torch.exec.dispatch import (aggregation_args, execute_layer,
                                           prepare_precision)
    from repro_torch.exec.fused import fused_args

    operands, perm, _ = graph.on_device(dev)
    cases = {key: [] for key in KEYS}
    rng = np.random.default_rng(SEED)
    int8_dense = {}
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
                cases[f"{name}@{precision}->bf16"].append(
                    (args, dict(kw, out_dtype=torch.bfloat16), real))
                if precision == "int8":
                    if i not in int8_dense:
                        int8_dense[i] = torch.as_tensor(rng.integers(
                            -128, 128, tuple(xw.shape), dtype=np.int8),
                            device=dev)
                    name, args, kw, real = aggregation_args(
                        plan, operands, vals, int8_dense[i], None)
                    cases[f"{name}@int8->int32"].append(
                        (args, dict(kw, out_dtype=torch.int32), real))
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
    get the table's slot lists.  The int8 x int8 product takes the int8
    values without scales and 40 int8 columns (padded to 48)."""
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
        suffix = "_scaled" if precision == "int8" else ""
        bf = dict(akw, out_dtype=torch.bfloat16)
        out.update({
            f"spmm_ell_dense_grid{suffix}@{precision}->bf16": ((c, v, d), bf),
            f"spmm_ell_sparse_grid{suffix}@{precision}->bf16": (
                (c, v, d, bm), bf),
        })
    # int8 x int8 -> int32: 40 int8 columns, padded to 48 by the wrapper
    d8 = t(rng.integers(-128, 128, (k, f)), torch.int8)
    i32 = dict(kw, out_dtype=torch.int32)
    out["spmm_ell_dense_grid@int8->int32"] = ((c, q, d8), i32)
    out["spmm_ell_sparse_grid@int8->int32"] = ((c, q, d8, bm), i32)
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
        out, ref = kernel(*args, **kw), plain(*args, **kw)
        got = agreement(torch, out, ref)
        torch.cuda.synchronize()
        print(f"phase 2: {key} ragged {describe(got)} (tol "
              f"{REL_TOL[key]:.0e}, flip share {FLIP_SHARE:.0e})")
        check(store_holds(torch, key, out, ref, tuple(ref.shape)),
              f"{key} disagrees with its plain version on the ragged case: "
              f"{describe(got)}")
        entry = {"max_abs_err": got["err"], "max_rel_err": got["rel"],
                 "max_flip_share": got["flip_share"], "per_layer": []}
        for layer, (args, kw, real) in enumerate(cases[key]):
            out, ref = kernel(*args, **kw), plain(*args, **kw)
            got = agreement(torch, out, ref, real)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), f"{key} non-finite output")
            check(store_holds(torch, key, out, ref, real), f"{key} layer "
                  f"{layer} disagrees with its plain version: {describe(got)}")
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


def public_dtype_check(torch, np, rt, graph, cfg, dev) -> dict:
    """The dtype contract through the public entry point at full size.

    ``repro_torch.core.spmm_ell`` over the dataset's own ELL: (a) with the
    main path's int8 values, unscaled, times an int8 operand of each
    layer's width (numpy seed ``SEED``) under ``cuda`` and ``cuda_sparse``,
    each int32 answer ``torch.equal`` to ``impl="reference"``'s; (b) under
    ``SpmmPlan(out_dtype=torch.bfloat16)`` at each precision, times an f32
    operand of the hidden width, against the reference impl at that
    precision (which does not read ``out_dtype``, so its answer is f32).
    (b)'s bound per element: each sub-row rounded to bf16 once (2^-9 of
    its magnitude) and each of a row's ``n`` bf16 additions in the fold
    (2^-9 of the running sum), so at most 2^-8 (n + 1) S, S the row's sum
    of |value| x |operand| (the reference impl over the magnitudes).  The
    launch counts are reset just before the kernel calls and read just
    after: each of ``STORE_KEYS`` must have launched."""
    from repro_torch.core import spmm_ell
    from repro_torch.kernels import flexvector_spmm as fv

    ell = graph.pre.ell
    operands, _, _ = graph.on_device(dev)
    q, _ = operands.values_for("int8", cfg.block_rows)
    ell8 = dataclasses.replace(ell, vals=q.cpu().numpy())
    ell_abs = dataclasses.replace(ell, vals=np.abs(ell.vals))
    blocks = dict(block_rows=cfg.block_rows, block_k=cfg.block_k,
                  block_f=cfg.block_f)
    rng = np.random.default_rng(SEED)
    k = ell.n_dense_rows
    int8_dense = {w: torch.as_tensor(rng.integers(-128, 128, (k, w),
                                                  dtype=np.int8), device=dev)
                  for w in (cfg.hidden_dim, cfg.out_dim)}
    dense = torch.as_tensor(rng.standard_normal((k, cfg.hidden_dim)).astype(
        np.float32), device=dev)
    row_map = torch.as_tensor(ell.row_map, device=dev).long()
    parts = torch.bincount(row_map[row_map >= 0], minlength=ell.n_orig_rows)

    def ref_plan(precision):
        return rt.SpmmPlan(impl="reference", precision=precision, **blocks)

    int32_ref = {w: spmm_ell(ell8, d, impl="reference", device=dev, **blocks)
                 for w, d in int8_dense.items()}
    bf16_ref, bound = {}, {}
    for precision in PRECISIONS:
        bf16_ref[precision] = spmm_ell(ell, dense, plan=ref_plan(precision),
                                       device=dev).double()
        mag = spmm_ell(ell_abs, dense.abs(), plan=ref_plan(precision),
                       device=dev).double()
        bound[precision] = 2.0 ** -8 * (parts + 1).double()[:, None] * mag
    torch.cuda.synchronize()
    fv.reset_launches()
    int32, bf16 = {}, {}
    for impl in ("cuda", "cuda_sparse"):
        for w, d in int8_dense.items():
            got = spmm_ell(ell8, d, impl=impl, device=dev, **blocks)
            want = int32_ref[w]
            check(got.dtype == want.dtype == torch.int32, f"int8 x int8 "
                  f"{impl} width {w}: dtypes {got.dtype} / {want.dtype}")
            equal = bool(torch.equal(got, want))
            int32[f"{impl} width {w}"] = {
                "equal": equal, "shape": list(got.shape),
                "max_abs": int(want.abs().max())}
            print(f"phase 2: public spmm_ell int8 x int8 -> int32 {impl} "
                  f"width {w}: {tuple(got.shape)} torch.equal to the "
                  f"reference impl: {equal} (max |answer| "
                  f"{int(want.abs().max())})")
            check(equal, f"int8 x int8 {impl} width {w}: not equal to the "
                  "reference impl's int32 answer")
        for precision in PRECISIONS:
            plan = rt.SpmmPlan(impl=impl, precision=precision,
                               out_dtype=torch.bfloat16, **blocks)
            got = spmm_ell(ell, dense, plan=plan, device=dev)
            check(got.dtype == torch.bfloat16, f"out_dtype=bf16 {impl} "
                  f"{precision}: dtype {got.dtype}")
            err = (got.double() - bf16_ref[precision]).abs()
            use = float((err / bound[precision].clamp(min=1e-30)).max())
            reading = agreement(torch, got, bf16_ref[precision])
            bf16[f"{impl} {precision}"] = dict(reading, bound_use=use)
            print(f"phase 2: public spmm_ell out_dtype=bf16 {impl} at "
                  f"{precision}: {describe(reading)}, largest error / bound "
                  f"{use:.3f}")
            check(use <= 1.0, f"out_dtype=bf16 {impl} at {precision}: an "
                  f"error {use:.3f}x its bound")
    torch.cuda.synchronize()
    counts = dict(fv.PRECISION_LAUNCHES)
    print(f"phase 2: public spmm_ell launches "
          f"{json.dumps({k: n for k, n in counts.items() if n})}")
    for key in STORE_KEYS:
        check(counts[key] > 0, f"{key} was not launched by the public path")
    return {"launches": {key: counts[key] for key in STORE_KEYS},
            "int8_x_int8": int32, "out_dtype_bf16": bf16}


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
    """Host ms of each of ``fns`` (name -> callable) in each of ``rounds``
    interleaved rounds (each call ending in a synchronize) after one warm
    round: name -> the list of its times, entry ``i`` from round ``i``.
    Round ``i`` calls them in the ``i``-th of their orders (cycling
    through all of them), so that every callable follows every other one
    equally often: at PubMed a forward runs 1-6% slower right after the
    fused one, and a fixed cyclic order put the same plan there in every
    round."""
    orders = list(itertools.permutations(fns))
    times = {name: [] for name in fns}
    for i in range(1 + rounds):
        for name in orders[i % len(orders)]:
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            if i:
                times[name].append((time.perf_counter() - t0) * 1e3)
    return times


def round_ratios(times: dict, name: str, base: str) -> dict:
    """The median and interquartile range of ``name``'s time over
    ``base``'s, round by round.  Both calls of a round are adjacent, so the
    slow drift of host-bound times between blocks of rounds (12-60% at
    PubMed) cancels in each ratio, where a ratio of two medians keeps it."""
    r = [a / b for a, b in zip(times[name], times[base])]
    q1, _, q3 = statistics.quantiles(r, n=4, method="inclusive")
    return {"median": statistics.median(r), "q1": q1, "q3": q3}


def layer_runs(pplan) -> str:
    """What a pipeline plan runs, layer by layer (not its modeled times)."""
    return repr([(lp.spmm, lp.f_in, lp.f_out, lp.in_layout, lp.out_layout)
                 for lp in pplan.layers])


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
        # plans that run the same layers (the chosen one is often the
        # static unfused one) are one forward, timed once for both labels
        runs = {}
        for label, pp in plans.items():
            runs.setdefault(layer_runs(pp), label)
        times = timed_rounds(torch, {
            label: (lambda pp=plans[label]: gcn_forward(
                params, graph, feats, cfg, plan=pp, device=dev))
            for label in runs.values()}, rounds)
        medians = {label: statistics.median(t) for label, t in times.items()}
        timed = {}
        for label, pp in plans.items():
            ms = medians[runs[layer_runs(pp)]]
            modeled = 1e3 * pipeline_seconds(stats, pp, device=model)
            timed[label] = {"measured_ms": ms, "modeled_ms": modeled,
                            "measured_over_modeled": ms / modeled,
                            "timed_as": runs[layer_runs(pp)]}
            print(f"phase 6: {precision} {label} forward median {ms:.3f} ms "
                  f"over {rounds} interleaved rounds (timed as "
                  f"{runs[layer_runs(pp)]}), modeled {modeled:.3f} "
                  f"ms (measured / modeled {ms / modeled:.3f})")
        ratio = round_ratios(times, timed["chosen"]["timed_as"],
                             timed["static_unfused"]["timed_as"])
        print(f"phase 6: {precision} chosen / static unfused per round: "
              f"median {ratio['median']:.4f}, interquartile range "
              f"{ratio['q1']:.4f}-{ratio['q3']:.4f} (limit {PLAN_SLOWER})")
        check(ratio["median"] <= PLAN_SLOWER, f"{precision}: the chosen "
              f"forward's median per-round ratio to the static unfused one "
              f"is {ratio['median']:.4f}, more than {PLAN_SLOWER}")
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
                               "forwards": timed,
                               "chosen_over_static_unfused": ratio}
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
    full_times = timed_rounds(torch, {
        p: (lambda step=step: step(engine.params, engine._features_dev))
        for p, step in steps.items()}, PLAN_ROUNDS["pubmed"])
    full_ms = {p: statistics.median(t) for p, t in full_times.items()}
    full_ratio = round_ratios(full_times, engine.resolved_precision, "f32")
    print(f"phase 6: full-graph step modeled ms {full_modeled}; measured "
          f"median ms {full_ms} over {PLAN_ROUNDS['pubmed']} interleaved "
          f"rounds; {engine.resolved_precision} / f32 per round: median "
          f"{full_ratio['median']:.4f}, interquartile range "
          f"{full_ratio['q1']:.4f}-{full_ratio['q3']:.4f}")
    check(full_ratio["median"] <= PLAN_SLOWER,
          f"the autoplanned engine's full-graph step at "
          f"{engine.resolved_precision} has a median per-round ratio of "
          f"{full_ratio['median']:.4f} to its f32 step, more than "
          f"{PLAN_SLOWER}")
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
            "full_graph_over_f32": full_ratio,
            "rungs": rung_plans, "requests": len(requests), **out}


# -- phase 7: sharding -------------------------------------------------------------


def phase_sharding(torch, np, graph, cfg, params, feats, dev, dataset: str,
                   card: str) -> dict:
    """Phase 7: ``gcn_forward(mesh=)`` in SHARD_RANKS spawned ranks.  The
    dataset's preprocessed graph, its features and weights, and the
    unsharded forwards the ranks are held against (the reference impl on
    the card, per precision) are computed here once and handed over in
    files; each rank checks its own results and returns them."""
    import pickle

    from repro_torch.exec.plan import SpmmPlan
    from repro_torch.models.gcn import GCNGraph, gcn_forward

    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= SHARD_RANKS else "gloo"
    blocks = dict(block_rows=cfg.block_rows, block_k=cfg.block_k,
                  block_f=cfg.block_f)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shards_") as d:
        t0 = time.perf_counter()
        # the per-tile views of the vertex-cut stay behind: a forward
        # reads the ELL, the permutation and its inverse
        handed = GCNGraph(pre=dataclasses.replace(graph.pre, tiles=[]),
                          n_nodes=graph.n_nodes, inv=graph.inv)
        with open(os.path.join(d, "graph.pkl"), "wb") as fh:
            pickle.dump(handed, fh, protocol=pickle.HIGHEST_PROTOCOL)
        np.save(os.path.join(d, "features.npy"), feats.cpu().numpy())
        torch.save({name: {k: v.cpu() for k, v in layer.items()}
                    for name, layer in params.items()},
                   os.path.join(d, "params.pt"))
        t1 = time.perf_counter()
        for precision in PRECISIONS:
            ref = gcn_forward(params, graph, feats, cfg,
                              plan=SpmmPlan(impl="reference", **blocks),
                              precision=precision, device=dev)
            torch.save(ref.cpu(), os.path.join(d, f"ref_{precision}.pt"))
        print(f"phase 7: graph, features and weights written in "
              f"{t1 - t0:.1f} s, the unsharded reference forwards in "
              f"{time.perf_counter() - t1:.1f} s; {SHARD_RANKS} ranks on "
              f"{min(n_cards, SHARD_RANKS)} card(s) over {backend}")
        ranks = spawn_ranks(sharding_rank, SHARD_RANKS, d,
                            (backend, dataset, dataclasses.asdict(cfg)),
                            SHARD_SECONDS, 7)
    for key in ranks[0]["configs"]:
        print(f"phase 7: {key} forward median ms per rank "
              + ", ".join(f"{rk['configs'][key]['ms']:.3f}" for rk in ranks))
    return {"dataset": dataset, "card": card, "ranks": SHARD_RANKS,
            "cards": n_cards, "ranks_per_card":
                SHARD_RANKS / min(n_cards, SHARD_RANKS),
            "backend": backend, "per_rank": ranks,
            "note": ("ranks share one card: per-shard kernel times, not "
                     "multi-GPU times") if n_cards < SHARD_RANKS else None}


def spawn_ranks(target, world: int, directory: str, args: tuple,
                seconds: float, phase: int) -> list:
    """Run ``target(rank, world, directory, *args)`` in ``world`` spawned
    processes under a limit of ``seconds`` in all: a rank that fails ends
    its peers (a peer blocked in a collective would wait forever) and the
    phase; returns each rank's ``rank<r>.json`` record."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, directory) + tuple(args),
                         daemon=True)
             for r in range(world)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + seconds
    while True:
        codes = [proc.exitcode for proc in procs]
        if all(c is not None for c in codes) or any(codes):
            break
        if time.monotonic() > deadline:
            break
        time.sleep(0.1)
    for proc in procs:
        if proc.exitcode is None:
            proc.terminate()
    for proc in procs:
        proc.join(10)
        if proc.exitcode is None:
            proc.kill()
            proc.join()
    errors = []
    for r, proc in enumerate(procs):
        err = os.path.join(directory, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as fh:
                errors.append(f"rank {r}: {fh.read().strip()}")
        elif proc.exitcode != 0:
            errors.append(f"rank {r}: exit code {proc.exitcode} (the "
                          f"spawn's limit is {seconds} s)")
    check(not errors, f"phase {phase}: " + "\n".join(errors))
    ranks = []
    for r in range(world):
        with open(os.path.join(directory, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    return ranks


def sharding_rank(rank: int, world: int, directory: str, backend: str,
                  dataset: str, cfg: dict) -> None:
    """One rank of phase 7: joins the process group (a ``FileStore`` in
    ``directory``), runs :func:`shard_forwards` and writes its record, or
    its error, beside the inputs."""
    import datetime
    import traceback

    try:
        import torch
        import torch.distributed as dist

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(directory, "store"),
                                          world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=SHARD_SECONDS))
        out = shard_forwards(torch, rank, world, directory, dataset, cfg)
        with open(os.path.join(directory, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(directory, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        os._exit(1)


def shard_ledger_want(cost, pplan, n_nodes: int) -> dict:
    """The collective bytes one forward under ``pplan`` records, by the
    cost model's formulas (per-device ring bytes of each epilogue, and of
    each row-sharded dense operand's all-gather: at ``F_in`` width for a
    fused layer, ``F_out`` unfused)."""
    want = {"psum": 0.0, "reduce_scatter": 0.0, "all_gather": 0.0}
    for lp in pplan.layers:
        plan = lp.spmm
        n = plan.n_shards
        act = 4 if plan.precision == "f32" else 2
        if plan.out_layout == "row_sharded":
            want["reduce_scatter"] += cost.reduce_scatter_bytes(
                n_nodes, lp.f_out, n)
        else:
            want["psum"] += cost.psum_bytes(n_nodes, lp.f_out, n)
        if plan.dense_layout == "row_sharded":
            f = lp.f_in if plan.fused else lp.f_out
            want["all_gather"] += cost.all_gather_bytes(n_nodes, f, n, act)
    return want


def shard_forwards(torch, rank: int, world: int, directory: str,
                   dataset: str, cfg_fields: dict) -> dict:
    """Every (config, chain) forward at every precision on this rank's
    shard, each held against the unsharded reference forward; the launch
    counts per precision, the ledger against the cost model's formulas,
    one profile, and ``plan="auto"`` at this width."""
    import math
    import pickle

    import numpy as np

    from repro_torch.dist import collectives as coll
    from repro_torch.exec.pipeline import plan_pipeline, static_pipeline
    from repro_torch.exec.quant import logit_error
    from repro_torch.kernels import _build
    from repro_torch.kernels import flexvector_spmm as fv
    from repro_torch.launch.mesh import make_data_mesh, mesh_device
    from repro_torch.models.gcn import GCNConfig, gcn_forward
    from repro_torch.plan import cost

    _build.load_library()
    mesh = make_data_mesh(world)
    dev = mesh_device(mesh)
    cfg = GCNConfig(**cfg_fields)
    with open(os.path.join(directory, "graph.pkl"), "rb") as fh:
        graph = pickle.load(fh)
    feats = torch.as_tensor(np.load(os.path.join(directory, "features.npy")),
                            device=dev)
    params = {name: {k: v.to(dev) for k, v in layer.items()}
              for name, layer in torch.load(
                  os.path.join(directory, "params.pt")).items()}
    refs = {p: torch.load(os.path.join(directory, f"ref_{p}.pt")).to(dev)
            for p in PRECISIONS}
    reps = SHARD_REPS[dataset]

    def hold(key, out, precision, sharded_ref=None) -> dict:
        check(tuple(out.shape) == (graph.n_nodes, cfg.out_dim)
              and bool(torch.isfinite(out).all()),
              f"rank {rank} {key}: logits {tuple(out.shape)}")
        reading = {"vs_unsharded": agreement(torch, out, refs[precision])}
        if precision == "int8":
            # int8 values are re-quantized per shard (the shard boundaries
            # are not on scale blocks): held against the sharded reference
            # impl, and within the int8 logit budget of the f32 logits
            reading["vs_sharded_reference"] = agreement(torch, out,
                                                        sharded_ref)
            reading["logit_error_vs_f32"] = logit_error(refs["f32"], out)
            check(agrees(reading["vs_sharded_reference"],
                         FORWARD_REL_TOL[precision], FORWARD_FLIP_SHARE)
                  and reading["logit_error_vs_f32"] <= LOGIT_BUDGET["int8"],
                  f"rank {rank} {key} disagrees: {reading}")
        else:
            check(agrees(reading["vs_unsharded"], FORWARD_REL_TOL[precision],
                         FORWARD_FLIP_SHARE),
                  f"rank {rank} {key} disagrees with the unsharded forward: "
                  f"{describe(reading['vs_unsharded'])}")
        return reading

    def timed(fn) -> list:
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return times

    t0 = time.perf_counter()
    configs, launches, paths = {}, {}, {}
    for precision in PRECISIONS:
        sharded_ref = {}
        if precision == "int8":
            for chain in SHARD_CHAINS:
                pp = static_pipeline(cfg, mesh, impl="reference",
                                     pipelined=chain == "pipelined",
                                     precision=precision)
                sharded_ref[chain] = gcn_forward(params, graph, feats, cfg,
                                                 plan=pp, device=dev)
        fv.reset_launches()
        coll.reset_collective_calls()
        for impl, fused in CONFIGS:
            for chain in SHARD_CHAINS:
                key = (f"{impl}{'+fused' if fused else ''}/{chain}"
                       + ("" if precision == "f32" else f"@{precision}"))
                pp = static_pipeline(cfg, mesh, impl=impl,
                                     pipelined=chain == "pipelined",
                                     precision=precision, fused=fused)
                coll.LEDGER.reset()
                out = gcn_forward(params, graph, feats, cfg, plan=pp,
                                  device=dev)
                torch.cuda.synchronize()
                ledger = coll.LEDGER.snapshot()["bytes"]
                want = shard_ledger_want(cost, pp, graph.n_nodes)
                for kind, nbytes in want.items():
                    check(math.isclose(ledger.get(kind, 0.0), nbytes,
                                       rel_tol=1e-12),
                          f"rank {rank} {key}: ledger {kind} "
                          f"{ledger.get(kind, 0.0)} vs the model's {nbytes}")
                reading = hold(key, out, precision, sharded_ref.get(chain))
                times = timed(lambda: gcn_forward(params, graph, feats, cfg,
                                                  plan=pp, device=dev))
                configs[key] = {"ms": statistics.median(times),
                                "times_ms": times, "ledger": ledger,
                                **reading}
        counts = dict(fv.PRECISION_LAUNCHES)
        names = KERNELS[4:] if precision == "int8" else BASE
        for name in names:
            check(counts[f"{name}@{precision}"] > 0, f"rank {rank}: kernel "
                  f"{name} was not launched on {precision} values on the "
                  "sharded path")
        other = {k: n for k, n in counts.items()
                 if n and not k.endswith(f"@{precision}")}
        check(not other, f"rank {rank}: the sharded {precision} forwards "
              f"launched kernels on values of another precision: {other}")
        launches[precision] = {name: counts[f"{name}@{precision}"]
                               for name in names}
        paths[precision] = dict(coll.COLLECTIVE_CALLS)

    # the device kernels of one f32 forward of each config, by name
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    plans = [static_pipeline(cfg, mesh, impl=impl, fused=fused)
             for impl, fused in CONFIGS]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for pp in plans:
            gcn_forward(params, graph, feats, cfg, plan=pp, device=dev)
        torch.cuda.synchronize()
    kernels = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0}
    if kernels:
        check(any(AGGREGATION_KERNEL in k for k in kernels)
              and any(FUSED_KERNEL in k for k in kernels),
              f"rank {rank}: the profile misses the port's kernels")
        check(not any(lib in k.lower() for k in kernels
                      for lib in LIBRARY_SPARSE),
              f"rank {rank}: a library sparse kernel ran: {sorted(kernels)}")

    auto = {}
    for precision in PRECISIONS:
        pp = plan_pipeline(cfg, graph.pre.ell, mesh=mesh, precision=precision,
                           device=cost.H100)
        fv.reset_launches()
        out = gcn_forward(params, graph, feats, cfg, plan="auto", mesh=mesh,
                          precision=precision, device_model=cost.H100)
        torch.cuda.synchronize()
        counts = {k: n for k, n in fv.PRECISION_LAUNCHES.items() if n}
        check(set(counts) == plan_kernels(pp), f"rank {rank} {precision} "
              f"plan='auto' launched {sorted(counts)}, its plan names "
              f"{sorted(plan_kernels(pp))}")
        sharded_ref = None
        if precision == "int8" and pp.n_shards > 1:
            sharded_ref = gcn_forward(params, graph, feats, cfg, plan=(
                static_pipeline(cfg, mesh, impl="reference", pipelined=any(
                    lp.out_layout == "row_sharded" for lp in pp.layers),
                    precision=precision)), device=dev)
        if sharded_ref is None and precision == "int8":
            sharded_ref = refs["int8"]
        auto[precision] = {
            "width": pp.n_shards, "plan": describe_plan(pp),
            "layouts": [[lp.in_layout, lp.out_layout] for lp in pp.layers],
            "modeled_ms": 1e3 * pp.cost_seconds, "launches": counts,
            **hold(f"plan='auto' {precision}", out, precision, sharded_ref),
            "ms": statistics.median(timed(
                lambda: gcn_forward(params, graph, feats, cfg, plan=pp,
                                    device=dev)))}
    return {"rank": rank, "device": str(dev), "configs": configs,
            "launches": launches, "collective_calls": paths,
            "collective_path": sorted({k.split("@")[1] for calls in
                                       paths.values() for k in calls}),
            "profile_ms": kernels, "auto": auto,
            "seconds": time.perf_counter() - t0}


# -- phase 8: the async runtime ------------------------------------------------


def batch_ledger(engine, bucket, padded: int) -> dict:
    """``kind -> (bytes, n)`` of the ledger records ``record_batch_dram``
    makes for one batch, taken as ``RuntimeLoop`` takes a batch's."""
    from repro_torch.dist.collectives import LEDGER

    counts, nbytes = dict(LEDGER.counts), dict(LEDGER.bytes)
    engine.batcher.record_batch_dram(bucket, padded,
                                     int(engine.features.shape[1]))
    out = {}
    for kind in set(LEDGER.counts) | set(counts):
        n = LEDGER.counts.get(kind, 0) - counts.get(kind, 0)
        b = LEDGER.bytes.get(kind, 0.0) - nbytes.get(kind, 0.0)
        if n > 0 or b != 0.0:
            out[kind] = (b, n)
    return out


def served_plan_key(engine, bucket) -> str:
    """``plan_key_from_plan`` of the rung's plan (``plan_for_bucket``)
    at the rung's storage precision, the key a served batch files under."""
    from repro_torch.obs import plan_key_from_plan

    fdim = int(engine.features.shape[1])
    plan = engine.batcher.plan_for_bucket(bucket, fdim)
    prec = engine.batcher.precision_for_bucket(bucket)
    return plan_key_from_plan(dataclasses.replace(plan, precision=prec))


def median_ms(spans) -> float:
    return 1e3 * statistics.median(s.end - s.start for s in spans) \
        if spans else float("nan")


def check_traces(engine, key: str, traces, admitted, submitted: int) -> dict:
    """Every trace complete, every served one with its spans, plan key
    and the ledger events ``record_batch_dram`` gives its batch; returns
    the span medians (ms) of the served requests."""
    from repro_torch.obs import bucket_key

    n_layers = engine.cfg.n_layers
    check(len(traces) == submitted, f"{key}: {len(traces)} traces for "
          f"{submitted} submitted requests")
    bad = [t.status for t in traces if not t.done or not (
        t.status == "ok" or t.status.startswith(("rejected", "shed")))]
    check(not bad, f"{key}: traces ended as {sorted(set(bad))}")
    served = [t for t in traces if t.status == "ok"]
    check(len(served) == sum(1 for r in admitted if r.future.done()
                             and not r.future.cancelled()
                             and r.future.exception() is None),
          f"{key}: {len(served)} ok traces for the completed requests")
    fdim = int(engine.features.shape[1])
    rungs = {bucket_key(b, fdim): b for b in engine.batcher.ladder.entries}
    expected = {}
    for t in served:
        names = [s.name for s in t.spans]
        for name in ("admission", "prepare", "queue_wait", "execute"):
            check(names.count(name) == 1, f"{key}: trace {t.trace_id} has "
                  f"{names.count(name)} {name} spans")
        [ex] = t.find("execute")
        layers = t.find("execute_layer")
        check(len(layers) == n_layers and all(
            s.parent_id == ex.span_id for s in layers),
            f"{key}: trace {t.trace_id}: {len(layers)} execute_layer spans "
            f"under execute, want {n_layers}")
        bucket = rungs[ex.attributes["bucket_key"]]
        check(ex.attributes["plan_key"] == served_plan_key(engine, bucket),
              f"{key}: trace {t.trace_id} plan_key "
              f"{ex.attributes['plan_key']} is not its rung's")
        padded = ex.attributes["padded_batch"]
        if (bucket, padded) not in expected:
            expected[bucket, padded] = batch_ledger(engine, bucket, padded)
        want = expected[bucket, padded]
        got = {e.attributes["kind"]: (e.attributes["bytes"], e.attributes["n"])
               for e in ex.events if e.name == "ledger"}
        check(set(got) == set(want) and all(
            got[k][1] == want[k][1]
            and abs(got[k][0] - want[k][0]) <= 1e-9 * max(abs(want[k][0]), 1)
            for k in want),
            f"{key}: trace {t.trace_id} ledger events {got} are not "
            f"record_batch_dram's {want}")
    return {name: median_ms([s for t in served for s in t.find(name)])
            for name in ("admission", "prepare", "queue_wait", "execute")}


def export_checks(key: str, traces, metrics, stem: str) -> dict:
    """The traces JSON, metrics JSON and Prometheus text of a run, written
    to ``<stem>.traces.json`` / ``.metrics.json`` / ``.prom`` and parsed
    back."""
    from repro_torch.obs import (write_metrics_json, write_prometheus,
                                 write_traces_json)

    paths = {k: f"{stem}.{k}" for k in ("traces.json", "metrics.json",
                                        "prom")}
    n = write_traces_json(paths["traces.json"], traces)
    snap = write_metrics_json(paths["metrics.json"], metrics)
    write_prometheus(paths["prom"], snap)
    with open(paths["traces.json"]) as f:
        back = json.load(f)["traces"]
    check(n == len(traces) == len(back) and [t["trace_id"] for t in back]
          == [t.trace_id for t in traces], f"{key}: traces JSON")
    with open(paths["metrics.json"]) as f:
        check(json.load(f) == json.loads(json.dumps(snap)),
              f"{key}: metrics JSON")
    series = {}
    with open(paths["prom"]) as f:
        for line in f:
            if line.strip() and not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                series[name] = float(value)
    counters = snap["counters"]
    check(all(series[f"repro_{k}"] == v for k, v in counters.items())
          and series["repro_e2e_s_ms_count"]
          == snap["latency_ms"]["e2e_s"]["count"],
          f"{key}: the Prometheus text does not read back the snapshot")
    return {k: os.path.relpath(v, ROOT) for k, v in paths.items()}


def async_load(torch, np, engine, key: str, requests, load: dict, fb,
               stem: str) -> dict:
    """One open-loop run (``runtime.run_open_loop``) through a traced
    runtime; every check of the run, its exports (under ``stem``), and
    what it prints."""
    from repro_torch.obs import Tracer
    from repro_torch.runtime import run_open_loop

    tracer = Tracer()
    built = engine.compile_count
    admitted, batches = [], []
    rt = engine.runtime(capacity=load["capacity"], tracer=tracer,
                        feedback=fb)
    submit, execute = rt.submit, rt.loop.execute

    def recording_submit(*a, **kw):
        req = submit(*a, **kw)
        admitted.append(req)
        return req

    def recording_execute(batch):
        batches.append((batch.reason, [r.deadline for r in batch.requests]))
        return execute(batch)

    rt.submit, rt.loop.execute = recording_submit, recording_execute
    with rt:
        wall = run_open_loop(rt, requests, qps=load["qps"],
                             deadline_s=ASYNC_DEADLINE_S,
                             rng=np.random.default_rng(1))
    pending = [r for r in admitted if not r.future.done()]
    check(not pending, f"{key}: {len(pending)} futures pending after shutdown")
    check(engine.compile_count == built, f"{key}: "
          f"{engine.compile_count - built} captures in the timed window")
    snap = rt.metrics.snapshot()
    c = snap["counters"]
    accounted = (c["completed"] + c["rejected_queue_full"]
                 + c["rejected_infeasible"] + c["shed_expired"]
                 + c["cancelled"])
    check(c["submitted"] == len(requests) == accounted,
          f"{key}: {c['submitted']} submitted, {accounted} accounted for")
    check(c["failed"] == 0, f"{key}: {c['failed']} requests failed")
    shed = (c["rejected_queue_full"] + c["rejected_infeasible"]
            + c["shed_expired"])
    if load["name"] == "overload":
        check(shed >= 1, f"{key}: the overload shed nothing")
    traces = tracer.drain()
    spans = check_traces(engine, key, traces, admitted, c["submitted"])
    exports = export_checks(key, traces, rt.metrics, stem)

    done = [r for r in admitted
            if not r.future.cancelled() and r.future.exception() is None]
    subs = [engine.sampler.extract(r.seeds) for r in done]
    got = [r.future.result() for r in done]
    prec = engine.precision
    agreement_ = hold(torch, np, key, f"{len(done)} async answers vs eager "
                      "forwards over their own subgraphs", got,
                      eager_answers(torch, engine, subs), prec,
                      SERVE_FLIP_SHARE[prec], phase=8)
    max_wait = sum(1 for reason, deadlines in batches if reason == "deadline"
                   and all(d is None for d in deadlines))
    closes = {"full": c["batches_full"],
              "deadline": c["batches_deadline"] - max_wait,
              "max_wait": max_wait, "flush": c["batches_flush"]}
    lat = {h: snap["latency_ms"][f"{h}_s"] for h in ("e2e", "wait", "exec")}
    record = {
        "offered_qps": load["qps"], "requests": len(requests),
        "capacity": load["capacity"], "deadline_ms": 1e3 * ASYNC_DEADLINE_S,
        "wall_s": wall, "completed": c["completed"],
        "rejected_queue_full": c["rejected_queue_full"],
        "rejected_infeasible": c["rejected_infeasible"],
        "shed_expired": c["shed_expired"], "cancelled": c["cancelled"],
        "shed_rate": snap["derived"]["shed_rate"],
        "slo_attainment": snap["derived"]["slo_attainment"],
        "goodput_rps": c["slo_met"] / max(wall, 1e-9),
        "latency_ms": lat, "closes": closes, "span_median_ms": spans,
        "post_warmup_captures": engine.compile_count - built,
        "vs_eager": agreement_, "exports": exports,
    }
    print(f"phase 8: {key} {load['name']}: offered {load['qps']:.0f} req/s x "
          f"{len(requests)} (capacity {load['capacity']}, deadline "
          f"{1e3 * ASYNC_DEADLINE_S:.0f} ms) in {wall:.2f} s; completed "
          f"{c['completed']}, shed rate {record['shed_rate']:.3f} (queue "
          f"full {c['rejected_queue_full']}, infeasible "
          f"{c['rejected_infeasible']}, expired {c['shed_expired']}); SLO "
          f"attainment {record['slo_attainment']:.3f}, goodput "
          f"{record['goodput_rps']:.1f} req/s")
    print(f"phase 8: {key} {load['name']}: p50/p99 ms e2e "
          f"{lat['e2e']['p50']:.3f}/{lat['e2e']['p99']:.3f}, wait "
          f"{lat['wait']['p50']:.3f}/{lat['wait']['p99']:.3f}, exec "
          f"{lat['exec']['p50']:.3f}/{lat['exec']['p99']:.3f}; batches "
          f"closed {closes}; span medians ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in spans.items()))
    return record


def feedback_checks(torch, np, engine, key: str, fb, path: str,
                    requests) -> dict:
    """The store holds one entry per (bucket, plan) served, round-trips
    through ``path``, and an autoplanned engine built with the loaded
    store (the serving CLI's ladder) serves each measured rung with one
    feedback-informed plan on every layer, captured at warmup."""
    from repro_torch.obs import PlanFeedback, bucket_key
    from repro_torch.plan.autoplan import choose_plan
    from repro_torch.serve import ServeEngine

    fdim = int(engine.features.shape[1])
    served = {}
    for b in engine.batcher.ladder.entries:
        bkey = bucket_key(b, fdim)
        if fb.has_bucket(bkey):
            served[bkey] = b
            check(list(fb.entries()[bkey]) == [served_plan_key(engine, b)],
                  f"{key}: feedback entries {fb.entries()[bkey]} for {bkey}")
    check(served and len(fb) == len(served),
          f"{key}: {len(fb)} feedback entries for the rungs {list(served)}")
    fb.save(path)
    back = PlanFeedback.load(path)
    check(back.entries() == fb.entries() and os.path.exists(path),
          f"{key}: the feedback store does not round-trip through {path}")
    out = {"entries": fb.entries(), "path": os.path.relpath(path, ROOT)}
    if engine.precision != "f32" or engine.batcher.fused:
        # plan_for_bucket's candidates are f32 and unfused: no key of this
        # store can match one
        print(f"phase 8: {key} feedback {fb.entries()} saved and loaded "
              f"back ({out['path']})")
        return out
    pinned_engine = ServeEngine(
        engine.adj_norm, engine.features, engine.cfg, params=engine.params,
        registry=engine.registry, device=engine.device, autoplan=True,
        ladder_growth=SERVE_GROWTH, feedback=back, **SERVE)
    batcher = pinned_engine.batcher
    check(batcher.ladder == engine.batcher.ladder,
          f"{key}: the pinned engine's ladder differs")
    pins = {}
    for bkey, b in served.items():
        choice = choose_plan(batcher._rung_stats(b), fdim, pinned_engine.cfg,
                             impls=("reference", "cuda"), schedulable=False,
                             feedback=back, feedback_key=bkey)
        plan = batcher.plan_for_bucket(b, fdim)
        layers = batcher.layer_plans_for_bucket(b, fdim)
        check(choice.measured_used >= 1
              and plan == choice.plan.resolve(schedulable=False)
              and layers == [plan] * pinned_engine.cfg.n_layers,
              f"{key}: rung {bkey} is not pinned to its feedback-informed "
              f"plan")
        pins[bkey] = served_plan_key(pinned_engine, b)
    built = pinned_engine.warmup()
    check(all(any(k[0] == b for k in batcher._executables)
              for b in served.values()), f"{key}: a pinned rung was not "
          "captured at warmup")
    got = pinned_engine.query_batch(requests)
    check(pinned_engine.compile_count == built,
          f"{key}: the pinned engine captured after warmup")
    subs = [pinned_engine.sampler.extract(s) for s in requests]
    hold(torch, np, key, f"{len(requests)} answers of the pinned engine vs "
         "eager forwards", got, eager_answers(torch, engine, subs), "f32",
         SERVE_FLIP_SHARE["f32"], phase=8)
    print(f"phase 8: {key} feedback {fb.entries()} saved and loaded back "
          f"({out['path']}); an autoplanned engine over it pins {pins} on "
          f"every layer ({built} graphs captured at warmup, none after)")
    batcher.clear_executables()
    out["pinned_plans"] = pins
    return out


def span_checks(torch, np, engine, requests, dev) -> dict:
    """An eager forward on the card under an active span opens one
    ``execute_layer`` span per layer, each with ledger events; a capture
    of a rung's forward inside the span opens none and captures without
    error, and its replay answers as the eager pass did."""
    from repro_torch.models.gcn import gcn_forward
    from repro_torch.obs import Tracer, use_span
    from repro_torch.serve.batcher import _CapturedForward

    sub = engine.sampler.extract(requests[0])
    tracer = Tracer()
    trace = tracer.trace("eager")
    with use_span(trace.root):
        gcn_forward(engine.params, sub.graph, engine.features[sub.nodes],
                    engine.cfg, precision=engine.precision, device=dev).cpu()
    layers = trace.find("execute_layer")
    check(len(layers) == engine.cfg.n_layers and all(
        any(e.name == "ledger" for e in s.events) for s in layers),
        f"an eager forward under a span gave {len(layers)} execute_layer "
        "spans (or one without ledger events)")
    # a rung's forward (an unfused engine's: no slot lists to stack)
    padded = engine._prepare(requests[0])
    fdim = padded.feats.shape[1]
    batcher = engine.batcher
    fwd = batcher._make_forward(padded.bucket, fdim)
    specs = batcher.input_specs(padded.bucket, 1, fdim)
    inputs = {name: torch.as_tensor(getattr(padded, name))[None]
              for name in specs}
    exe = _CapturedForward(fwd, engine.params, specs, dev,
                           torch.cuda.graph_pool_handle())
    served = batcher.run(engine.params, [padded])[0]
    before = len(trace.spans)
    with use_span(trace.root):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fwd(exe.params, exe.inputs)
    check(len(trace.spans) == before,
          "a capture under an active span opened a span")
    replayed = exe(engine.params, inputs)[0, : padded.n_seeds]
    reading = agreement(torch, torch.as_tensor(replayed),
                        torch.as_tensor(served))
    check(agrees(reading, FORWARD_REL_TOL["f32"], FORWARD_FLIP_SHARE),
          f"the graph captured under a span disagrees: {describe(reading)}")
    print(f"phase 8: eager forward under a span: {len(layers)} execute_layer "
          f"spans with ledger events; a capture under the span opened none; "
          f"its replay vs the rung's {describe(reading)}")
    return {"eager_layer_spans": len(layers), "capture_spans": 0,
            "capture_vs_replay": reading}


def phase_async(torch, np, registry, data, cfg, params, dev,
                dataset: str) -> dict:
    """Phase 8: each of the dataset's engines warmed, then driven
    open-loop through a traced ``ServeRuntime`` with a ``PlanFeedback``
    store at each load; every check of ``async_load`` and
    ``feedback_checks``, and the span checks."""
    from repro_torch.obs import PlanFeedback
    from repro_torch.serve import ServeEngine

    engines, loads = ASYNC_ENGINES[dataset], ASYNC_LOADS[dataset]
    served_before = sum(SERVE_LOAD[dataset][k] for k in ("queries", "batch"))
    served_before = served_before * len(SERVE_ENGINES[dataset]) + sum(
        PLAN_LOAD.values())
    sizes = [served_before] + [ld["requests"] for ld in loads] * len(engines)
    draws = serve_draws(np, data.adj_norm.rows, sizes)[1:]
    directory = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(directory, exist_ok=True)
    out, spans = {}, None
    for e, (impl, precision, fused) in enumerate(engines):
        key = f"{impl}{'+fused' if fused else ''}@{precision}"
        t0 = time.perf_counter()
        engine = ServeEngine(
            data.adj_norm, data.features,
            dataclasses.replace(cfg, spmm_impl=impl), params=params,
            registry=registry, device=dev, precision=precision, fused=fused,
            **SERVE)
        built = engine.warmup()
        print(f"phase 8: {key} {built} CUDA graphs captured in "
              f"{time.perf_counter() - t0:.1f} s")
        fb = PlanFeedback()
        record = {"captures": built, "loads": {}}
        for i, load in enumerate(loads):
            requests = draws[e * len(loads) + i]
            stem = os.path.join(directory, f"{dataset}_{e}_{load['name']}")
            record["loads"][load["name"]] = async_load(
                torch, np, engine, key, requests, load, fb, stem)
        path = os.path.join(directory, f"plan_feedback_{dataset}_{e}.json")
        record["feedback"] = feedback_checks(
            torch, np, engine, key, fb, path, draws[e * len(loads)][:16])
        if spans is None:
            spans = span_checks(torch, np, engine, draws[0], dev)
        engine.batcher.clear_executables()
        del engine
        torch.cuda.empty_cache()
        out[key] = record
    return {"engines": out, "spans": spans}


# -- phase 9: the fleet ------------------------------------------------------------


class FleetWatch:
    """Wraps each servable's ``load`` and ``unload``: every load's seconds,
    captures and thread, and the launches the servable's executables
    replayed (harvested before each unload, which drops them)."""

    def __init__(self, manager):
        import threading

        self.loads = {key: [] for key in manager.keys()}
        self.replayed = {}
        self._counted = {}
        for key in manager.keys():
            sv = manager.servable(key)
            load, unload = sv.load, sv.unload

            def timed_load(key=key, sv=sv, load=load):
                before = sv.engine.compile_count
                t0 = time.perf_counter()
                load()
                self.loads[key].append(
                    (time.perf_counter() - t0,
                     sv.engine.compile_count - before,
                     threading.current_thread().name))

            def harvested_unload(sv=sv, unload=unload):
                self.harvest(sv, dropping=True)
                unload()

            sv.load, sv.unload = timed_load, harvested_unload

    def harvest(self, sv, dropping: bool = False) -> None:
        for e in list(sv.engine.batcher._executables.values()):
            seen = (self._counted.pop(id(e), 0) if dropping
                    else self._counted.get(id(e), 0))
            for name, n in e.launches.items():
                self.replayed[name] = (self.replayed.get(name, 0)
                                       + (e.replays - seen) * n)
            if not dropping:
                self._counted[id(e)] = e.replays


def fleet_servables(torch, registry, data, cfg, params, dev,
                    dataset: str, impl_override=None) -> dict:
    """``key -> (engine, precision)`` of FLEET_SERVABLES (``impl_override``
    builds them all with that impl, fused off: the reference engines)."""
    from repro_torch.graphs.datasets import DATASETS, load_dataset
    from repro_torch.models.gcn import GCNConfig, init_params
    from repro_torch.serve import ServeEngine

    out = {}
    for name, impl, precision, fused in FLEET_SERVABLES:
        if name is None:
            key, d, c, p = dataset, data, cfg, params
        else:
            spec = DATASETS[name]
            key, d = name, load_dataset(name, seed=SEED)
            c = GCNConfig(in_dim=spec.feature_dim, hidden_dim=HIDDEN,
                          out_dim=spec.classes, n_layers=2)
            p = init_params(c, torch.Generator().manual_seed(SEED), dev)
        if impl_override is not None:
            impl, fused = impl_override, False
        engine = ServeEngine(
            d.adj_norm, d.features, dataclasses.replace(c, spmm_impl=impl),
            params=p, registry=registry, device=dev, precision=precision,
            fused=fused, **SERVE)
        out[key] = (engine, precision)
    return out


def per_tenant(counters: dict) -> dict:
    """``tenant -> counter -> n``, summed over the other labels."""
    from repro_torch.runtime.metrics import parse_labeled

    out = {}
    for k, v in counters.items():
        name, labels = parse_labeled(k)
        if "tenant" in labels:
            t = out.setdefault(labels["tenant"], {})
            t[name] = t.get(name, 0) + v
    return out


def fleet_mix(np, manager, loads, watch, *, traced: bool) -> dict:
    """One open-loop run of ``loads`` through a fresh ``FleetRuntime``
    over ``manager``: the per-tenant accounting (every attempt completed,
    rejected or shed; none failed), no batch mixing servables, every
    trace complete with the servable on its execute span; returns the
    admitted requests, the per-tenant figures and the snapshot."""
    from repro_torch.fleet import FleetRuntime, TenantPolicy, TenantTable
    from repro_torch.obs import Tracer
    from repro_torch.runtime.metrics import labeled

    tracer = Tracer() if traced else None
    rt = FleetRuntime(manager, tracer=tracer, tenants=TenantTable(
        [TenantPolicy(**t) for t in FLEET_TENANTS]))
    attempts, admitted, mixed = {}, [], []
    submit, execute = rt.submit, rt.loop.execute

    def recording_submit(servable, payload, **kw):
        t = kw.get("tenant")
        attempts[t] = attempts.get(t, 0) + 1
        req = submit(servable, payload, **kw)
        admitted.append(req)
        return req

    def checked_execute(batch):
        mixed.extend(r.graph_key for r in batch.requests
                     if r.graph_key != batch.bucket.servable)
        return execute(batch)

    rt.submit, rt.loop.execute = recording_submit, checked_execute
    from repro_torch.fleet import run_open_loop_mix

    with rt:
        wall = run_open_loop_mix(rt, loads, rng=np.random.default_rng(1))
    check(all(r.future.done() for r in admitted),
          "phase 9: futures pending after shutdown")
    check(not mixed, f"phase 9: batches mixed servables ({len(mixed)} "
          f"requests in another servable's batch)")
    snap = rt.metrics.snapshot()
    c = snap["counters"]
    check(c["failed"] == 0 and c["cancelled"] == 0,
          f"phase 9: {c['failed']} failed, {c['cancelled']} cancelled")
    tenants = per_tenant(c)
    figures = {}
    for t, n in attempts.items():
        got = tenants.get(t, {})
        settled = sum(v for k, v in got.items()
                      if k in ("completed", "failed")
                      or k.startswith(("rejected_", "shed_")))
        check(settled == n, f"phase 9: tenant {t}: {n} submitted, "
              f"{settled} completed, rejected or shed ({got})")
        met, missed = got.get("slo_met", 0), got.get("slo_missed", 0)
        e2e = snap["latency_ms"].get(labeled("e2e_s", tenant=t),
                                     {"p50": None, "p99": None})
        figures[t] = {
            "submitted": n, "completed": got.get("completed", 0),
            "rejected_quota": got.get("rejected_quota", 0),
            "rejected_inflight": got.get("rejected_inflight", 0),
            "rejected_infeasible": got.get("rejected_infeasible", 0),
            "rejected_queue_full": got.get("rejected_queue_full", 0),
            "shed_expired": got.get("shed_expired", 0),
            "shed_rate": 1.0 - got.get("completed", 0) / n,
            "slo_attainment": met / max(met + missed, 1),
            "slo_counted": met + missed,
            "e2e_p50_ms": e2e["p50"], "e2e_p99_ms": e2e["p99"],
            "goodput_rps": met / max(wall, 1e-9)}
    traces = tracer.drain() if traced else []
    spans = {}
    if traced:
        check(len(traces) == sum(attempts.values()) and all(
            t.done for t in traces), f"phase 9: {len(traces)} traces for "
            f"{sum(attempts.values())} submitted requests")
        served = [t for t in traces if t.status == "ok"]
        for t in served:
            [ex] = t.find("execute")
            check(ex.attributes.get("servable") == t.root.attributes[
                "servable"] and ex.attributes.get("mesh_width") == 1
                and any(e.name == "ledger" for e in ex.events),
                f"phase 9: trace {t.trace_id}'s execute span lacks its "
                f"servable, mesh width or ledger events")
        spans = {name: median_ms([s for t in served for s in t.find(name)])
                 for name in ("prepare", "queue_wait", "execute")}
    return {"admitted": admitted, "tenants": figures, "wall_s": wall,
            "snapshot": snap, "traces": len(traces),
            "span_median_ms": spans}


def step_drive(rt) -> None:
    """Step a runtime on a VirtualClock at each close trigger, then drain."""
    for _ in range(256):
        rt.loop.step()
        nxt = rt.scheduler.next_close_time()
        if nxt is None:
            break
        if nxt > rt.clock.now():
            rt.clock.set_time(nxt)
    rt.loop.drain()


def fleet_identity(torch, np, engine, requests) -> dict:
    """A fleet holding one GcnServable of ``engine`` and the engine's own
    ``ServeRuntime``, the same submissions (1-3 s deadlines, 0.1 s apart)
    on a VirtualClock: the same batches, counters and outcomes, and every
    replay fed the same executable with the same input bytes.  The
    answers are held to phase 5's f32 limits and their bitwise share is
    printed beside that of a second ServeRuntime run: a replay folds the
    vertex-cut partials with ``index_add_``'s atomics, whose order (and
    so the last bits of a row with three or more partials) changes from
    run to run."""
    import hashlib

    from repro_torch.fleet import FleetManager, FleetRuntime
    from repro_torch.runtime import VirtualClock

    engine.warmup()
    batcher = engine.batcher
    executable = batcher.executable

    def script(rt, submit):
        log, fed = [], []
        execute = rt.loop.execute

        def logged(batch):
            log.append(([r.seq for r in batch.requests], batch.reason,
                        batch.closed_at))
            return execute(batch)

        def recording(params, bucket, batch, fdim):
            exe = executable(params, bucket, batch, fdim)

            def call(p, inputs):
                h = hashlib.sha1()
                for name in sorted(inputs):
                    h.update(name.encode())
                    h.update(inputs[name].contiguous().view(-1).view(
                        torch.uint8).numpy().tobytes())
                fed.append((bucket, batch, id(exe), h.hexdigest()))
                return exe(p, inputs)

            return call

        rt.loop.execute, batcher.executable = logged, recording
        try:
            reqs = []
            for i, seeds in enumerate(requests):
                reqs.append(submit(rt, seeds, float(1 + i % 3)))
                rt.clock.advance(0.1)
            step_drive(rt)
            rt.shutdown()
        finally:
            del batcher.executable
        outs = [type(r.future.exception()).__name__
                if r.future.exception(timeout=60) is not None
                else r.future.result() for r in reqs]
        counts = {k: rt.metrics.count(k) for k in (
            "batches_full", "batches_deadline", "batches_flush",
            "completed", "shed_expired")}
        return outs, log, counts, fed

    def solo_run():
        rt = engine.runtime(capacity=64, clock=VirtualClock(start=100.0))
        return script(rt, lambda rt, s, d: rt.submit(s, deadline_s=d))

    want = solo_run()
    mgr = FleetManager(capacity_units=4.0)
    mgr.register(engine.servable(key="identity"))
    mgr.resolve("identity")
    fleet = FleetRuntime(mgr, capacity=64, clock=VirtualClock(start=100.0))
    got = script(fleet, lambda rt, s, d: rt.submit("identity", s,
                                                   deadline_s=d))
    again = solo_run()
    check(got[1] == want[1] and got[2] == want[2],
          f"phase 9: the one-servable fleet closed other batches than the "
          f"engine's runtime ({got[2]} vs {want[2]})")
    check(got[3] == want[3], "phase 9: the one-servable fleet fed its "
          "executables other inputs than the engine's runtime")
    check([isinstance(o, str) and o for o in got[0]]
          == [isinstance(o, str) and o for o in want[0]],
          "phase 9: the one-servable fleet shed other requests")
    served = [i for i, o in enumerate(want[0]) if not isinstance(o, str)]
    check(got[2]["completed"] == len(served) > 0,
          "phase 9: the identity scenario completed nothing")

    def bitwise(a, b):
        return sum(1 for i in served if np.array_equal(a[0][i], b[0][i]))

    reading = hold(torch, np, "identity", f"{len(served)} one-servable "
                   f"fleet answers vs the engine's runtime",
                   [got[0][i] for i in served],
                   [want[0][i] for i in served], "f32", FORWARD_FLIP_SHARE,
                   phase=9)
    out = {"requests": len(requests), "served": len(served),
           "counters": got[2], "replays": len(got[3]),
           "bitwise_fleet_vs_runtime": bitwise(got, want),
           "bitwise_runtime_rerun": bitwise(again, want),
           "vs_runtime": reading}
    print(f"phase 9: one-servable fleet vs ServeRuntime: the same "
          f"{len(got[3])} replays on the same input bytes, batches "
          f"{got[2]}; answers bitwise equal {out['bitwise_fleet_vs_runtime']}"
          f" of {len(served)} (a second ServeRuntime run: "
          f"{out['bitwise_runtime_rerun']} of {len(served)})")
    return out


def isolation_verdict(mixed: dict, alone: dict) -> dict:
    """The cold tenant's attainment mixed minus alone, with the half-width
    of its 95% interval (two independent binomial shares); the bar of
    FLEET_ISOLATION is met when the whole interval lies within it, not
    met when the whole interval lies outside, and else, or when either
    share counts fewer than FLEET_MIN_SAMPLE answers, not resolved by the
    run's sample."""
    p1, n1 = mixed["slo_attainment"], mixed["slo_counted"]
    p2, n2 = alone["slo_attainment"], alone["slo_counted"]
    diff = p1 - p2
    half = 1.96 * (p1 * (1 - p1) / max(n1, 1)
                   + p2 * (1 - p2) / max(n2, 1)) ** 0.5
    if min(n1, n2) < FLEET_MIN_SAMPLE:
        verdict = "not resolved by this sample"
    elif abs(diff) + half <= FLEET_ISOLATION:
        verdict = "met"
    elif abs(diff) - half > FLEET_ISOLATION:
        verdict = "not met"
    else:
        verdict = "not resolved by this sample"
    return {"difference": diff, "ci95": half, "verdict": verdict}


def phase_fleet(torch, np, fv, registry, data, cfg, params, dev,
                dataset: str) -> dict:
    """Phase 9: three GcnServables behind one FleetRuntime under two
    tenants, the cold streams alone after, then the memory of three
    unload cycles and the one-servable identity."""
    import gc

    from repro_torch.fleet import FleetManager, TenantLoad

    t0 = time.perf_counter()
    built = fleet_servables(torch, registry, data, cfg, params, dev, dataset)
    servables = {k: e.servable(key=k) for k, (e, _) in built.items()}
    capacity = servables[dataset].cost_units() + 1.0
    manager = FleetManager(capacity_units=capacity)
    for sv in servables.values():
        manager.register(sv)
    watch = FleetWatch(manager)
    print(f"phase 9: servables {[(k, e.cfg.spmm_impl, p) for k, (e, p) in built.items()]} "
          f"(costs {[sv.cost_units() for sv in servables.values()]}) in a "
          f"capacity of {capacity} units, built in "
          f"{time.perf_counter() - t0:.1f} s")
    seconds = FLEET_SECONDS_CUT.get(dataset, FLEET_SECONDS)
    n = {"cold": int(FLEET_COLD_QPS * seconds),
         "hot": int(FLEET_HOT_QPS * seconds)}
    print(f"phase 9: settings: open loops of {seconds:.0f} s "
          + (f"(cut from {FLEET_SECONDS:.0f} s at {dataset}: the run's "
             f"1,200 s limit)" if seconds != FLEET_SECONDS else "")
          + f": {n['cold']} cold requests a servable, {n['hot']} hot")
    cold, hot = {}, None
    for key, sv in servables.items():
        n_nodes = sv.engine.graph.n_nodes
        sizes = [n["cold"], n["hot"]] if key == dataset else [n["cold"]]
        draws = serve_draws(np, n_nodes, sizes)
        cold[key] = draws[0]
        if key == dataset:
            hot = draws[1]
    deadline = FLEET_TENANTS[0]["deadline_s"]
    cold_loads = [TenantLoad("cold", key, cold[key], FLEET_COLD_QPS,
                             deadline_s=deadline) for key in servables]
    hot_load = TenantLoad("hot", dataset, hot, FLEET_HOT_QPS,
                          deadline_s=deadline)
    start = {k: sv.engine.compile_count for k, sv in servables.items()}

    fv.reset_launches()
    mixed = fleet_mix(np, manager, cold_loads + [hot_load], watch,
                      traced=True)
    solo = fleet_mix(np, manager, cold_loads, watch, traced=False)
    for sv in servables.values():
        watch.harvest(sv)
    counted = {k: v for k, v in fv.PRECISION_LAUNCHES.items() if v}
    replayed = {k: v for k, v in watch.replayed.items() if v}
    for name, impl, precision, fused in FLEET_SERVABLES:
        tag = "_scaled" if precision == "int8" else ""
        kernel = ("spmm_ell_fused_dense_grid" if fused
                  else "spmm_ell_dense_grid") + f"{tag}@{precision}"
        check(replayed.get(kernel, 0) > 0,
              f"phase 9: {name or dataset}'s replays ran no {kernel}")
    print(f"phase 9: launches counted (captures in loads) {counted}, "
          f"replayed {replayed}")

    loads_out = {}
    for key, sv in servables.items():
        loads = watch.loads[key]
        grid = {c for _, c, _ in loads}
        check(len(grid) == 1 and min(grid) > 0 and sum(
            c for _, c, _ in loads) == sv.engine.compile_count - start[key],
            f"phase 9: {key}: captures outside load(), or a load that did "
            f"not capture the grid ({[c for _, c, _ in loads]}; compiles "
            f"{sv.engine.compile_count - start[key]})")
        reloads = [s for s, _, _ in loads[1:]]
        loads_out[key] = {
            "loads": len(loads), "captures_per_load": min(grid),
            "first_load_s": loads[0][0],
            "mean_reload_s": (sum(reloads) / len(reloads) if reloads
                              else None),
            "threads": sorted({t for _, _, t in loads})}
    check(manager.loads >= 2 and manager.unloads >= 2,
          f"phase 9: {manager.loads} loads, {manager.unloads} unloads")
    hot_fig = mixed["tenants"]["hot"]
    check(hot_fig["rejected_quota"] > 0,
          "phase 9: the hot tenant was never held to its quota")

    # every completed answer against a reference-impl engine of its servable
    refs = fleet_servables(torch, registry, data, cfg, params, dev, dataset,
                           impl_override="reference")
    answers = {}
    for key, (ref, precision) in refs.items():
        done = [r for run in (mixed, solo) for r in run["admitted"]
                if r.graph_key == key and r.future.exception() is None]
        got = [r.future.result() for r in done]
        want = ref.query_batch([list(r.seeds) for r in done])
        answers[key] = hold(torch, np, key, f"{len(done)} fleet answers vs "
                            f"the reference impl", got, want, precision,
                            SERVE_FLIP_SHARE[precision], phase=9)
        ref.batcher.clear_executables()
    del refs

    engine = servables[dataset].engine
    identity = fleet_identity(torch, np, engine, serve_draws(
        np, engine.graph.n_nodes, [FLEET_IDENTITY_REQUESTS])[0])

    # three unload/reload cycles of the run's servable
    sv = servables[dataset]
    levels = []
    for _ in range(3):
        sv.load()
        sv.unload()
        gc.collect()
        torch.cuda.synchronize()
        levels.append(torch.cuda.memory_allocated(dev))
    drift = levels[2] - levels[0]
    print(f"phase 9: device memory allocated after each of three unloads "
          f"of {dataset}: {levels} bytes (drift {drift} bytes, limit "
          f"{FLEET_MEMORY_SLACK})")
    check(abs(drift) <= FLEET_MEMORY_SLACK,
          f"phase 9: {drift} bytes held across three unload cycles")

    cold_mixed = mixed["tenants"]["cold"]["slo_attainment"]
    cold_solo = solo["tenants"]["cold"]["slo_attainment"]
    for label, run in (("mixed", mixed), ("cold alone", solo)):
        for t, f in run["tenants"].items():
            p50 = ("n/a" if f["e2e_p50_ms"] is None
                   else f"{f['e2e_p50_ms']:.3f}/{f['e2e_p99_ms']:.3f}")
            print(f"phase 9: {label}, tenant {t}: {f['completed']} of "
                  f"{f['submitted']} completed, shed rate "
                  f"{f['shed_rate']:.3f} (quota {f['rejected_quota']}, "
                  f"inflight {f['rejected_inflight']}, infeasible "
                  f"{f['rejected_infeasible']}, expired "
                  f"{f['shed_expired']}); SLO attainment "
                  f"{f['slo_attainment']:.3f}; e2e p50/p99 ms {p50}; "
                  f"goodput {f['goodput_rps']:.1f} req/s")
    isolation = isolation_verdict(mixed["tenants"]["cold"],
                                  solo["tenants"]["cold"])
    print("phase 9: mixed run, median span ms of served requests "
          + ", ".join(f"{k} {v:.3f}"
                      for k, v in mixed["span_median_ms"].items()))
    print(f"phase 9: cold attainment mixed {cold_mixed:.3f} of "
          f"{mixed['tenants']['cold']['slo_counted']} vs alone "
          f"{cold_solo:.3f} of {solo['tenants']['cold']['slo_counted']}: "
          f"difference {isolation['difference']:+.3f} +- "
          f"{isolation['ci95']:.3f} (95%); the reference's isolation bar "
          f"(within {FLEET_ISOLATION:.0%}) {isolation['verdict']} (not "
          f"gated); loads "
          f"{manager.loads}, unloads {manager.unloads}; "
          + "; ".join(f"{k} {v['loads']} loads of {v['captures_per_load']} "
                      f"graphs, first {v['first_load_s']:.3f} s, reload "
                      + ("n/a" if v["mean_reload_s"] is None
                         else f"{v['mean_reload_s']:.3f} s")
                      for k, v in loads_out.items()))
    for sv in servables.values():
        sv.engine.batcher.clear_executables()
    torch.cuda.empty_cache()
    return {
        "dataset": dataset, "capacity_units": capacity,
        "servables": {k: {"impl": e.cfg.spmm_impl, "precision": p,
                          "fused": e.batcher.fused,
                          "cost_units": servables[k].cost_units(),
                          **loads_out[k]} for k, (e, p) in built.items()},
        "tenants": list(FLEET_TENANTS), "load": n,
        "mixed": {k: mixed[k] for k in ("tenants", "wall_s", "traces",
                                        "span_median_ms")},
        "cold_alone": {k: solo[k] for k in ("tenants", "wall_s")},
        "isolation": isolation,
        "manager": {"loads": manager.loads, "unloads": manager.unloads},
        "launches": {"counted": counted, "replayed": replayed},
        "vs_reference": answers, "identity": identity,
        "memory_after_unloads": levels,
    }


# -- phase 10: the serving mesh ---------------------------------------------------


def phase_serving_mesh(torch, np, registry, data, graph, cfg, params, dev,
                       dataset: str, card: str) -> dict:
    """Phase 10: ``ServeEngine(mesh=)`` in MESH_RANKS spawned ranks, rank 0
    leading and the others following.  The dataset, its preprocessed
    graph (in a registry cache), the weights, the requests and the
    answers of an unmeshed engine and of the reference impl on the card
    are handed over in files; rank 0 holds its answers, traces and
    ledger against them, and every rank reports its chunks and captures.
    """
    import pickle

    from repro_torch.models.gcn import GCNGraph
    from repro_torch.serve import ServeEngine
    from repro_torch.serve import cache as disk_cache
    from repro_torch.serve.registry import graph_key

    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= MESH_RANKS else "gloo"
    load = MESH_LOAD[dataset]
    requests = serve_draws(np, data.adj_norm.rows,
                           [load["batch"] + load["async_"]])[0]
    t0 = time.perf_counter()
    answers = {}
    refs = {}
    for impl, precision, fused in MESH_ENGINES:
        key = f"{impl}{'+fused' if fused else ''}@{precision}"
        plain = ServeEngine(
            data.adj_norm, data.features,
            dataclasses.replace(cfg, spmm_impl=impl), params=params,
            registry=registry, device=dev, precision=precision, fused=fused,
            **SERVE)
        plain.warmup()
        if precision not in refs:
            ref = ServeEngine(
                data.adj_norm, data.features,
                dataclasses.replace(cfg, spmm_impl="reference"),
                params=params, registry=registry, device=dev,
                precision=precision, **SERVE)
            refs[precision] = ref.query_batch(requests)
            ref.batcher.clear_executables()
        answers[key] = {"plain": plain.query_batch(requests),
                        "reference": refs[precision]}
        plain.batcher.clear_executables()
        del plain
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
        adj = data.adj_norm
        np.savez(os.path.join(d, "adj.npz"), indptr=adj.indptr,
                 indices=adj.indices, data=adj.data, shape=np.asarray(
                     adj.shape))
        np.save(os.path.join(d, "features.npy"), data.features)
        torch.save({name: {k: v.cpu() for k, v in layer.items()}
                    for name, layer in params.items()},
                   os.path.join(d, "params.pt"))
        with open(os.path.join(d, "requests.pkl"), "wb") as fh:
            pickle.dump({"requests": requests, "answers": answers}, fh)
        # the preprocessed graph (without its per-tile views) where each
        # rank's registry finds it on disk
        handed = GCNGraph(pre=dataclasses.replace(graph.pre, tiles=[]),
                          n_nodes=graph.n_nodes, inv=graph.inv)
        disk_cache.store_pickle(
            graph_key(adj, cfg), handed,
            os.path.join(d, "cache", disk_cache.NAMESPACE))
        print(f"phase 10: unmeshed and reference-impl answers to "
              f"{len(requests)} requests in {t1 - t0:.1f} s, handed over in "
              f"{time.perf_counter() - t1:.1f} s; {MESH_RANKS} ranks on "
              f"{min(n_cards, MESH_RANKS)} card(s) over {backend}")
        ranks = spawn_ranks(mesh_rank, MESH_RANKS, d,
                            (backend, dataset, dataclasses.asdict(cfg)),
                            MESH_SECONDS, 10)
    out = {}
    for key in ranks[0]["engines"]:
        lead = ranks[0]["engines"][key]
        widths = lead["widths"]
        sharded = sum(1 for w in widths if w % MESH_RANKS == 0)
        want = {"sharded": sharded, "replicated": len(widths) - sharded}
        for r, rk in enumerate(ranks):
            e = rk["engines"][key]
            check(e["mesh_runs"] == want, f"phase 10: {key}: rank {r} ran "
                  f"{e['mesh_runs']} chunks, want {want}")
            check(e["post_warmup_captures"] == 0, f"phase 10: {key}: rank "
                  f"{r} captured {e['post_warmup_captures']} graphs after "
                  f"warmup")
        for r, rk in enumerate(ranks[1:], 1):
            e = rk["engines"][key]
            check(e["followed"] == lead["calls"] == len(widths),
                  f"phase 10: {key}: rank {r} followed {e['followed']} of "
                  f"{lead['calls']} forwards")
        print(f"phase 10: {key}: {len(widths)} coalesced forwards, "
              f"{sharded} split over the ranks, {len(widths) - sharded} "
              f"replicated; query_batch of {load['batch']} at "
              f"{lead['batch_rps']:.1f} req/s (two ranks on one card over "
              f"gloo, not a multi-GPU figure); replayed launches per rank "
              + "; ".join(str(rk["engines"][key]["replayed"])
                          for rk in ranks))
        out[key] = {"per_rank": [rk["engines"][key] for rk in ranks],
                    "expected_chunks": want}
    return {"dataset": dataset, "card": card, "ranks": MESH_RANKS,
            "cards": n_cards, "backend": backend, "load": load,
            "engines": out,
            "note": ("two ranks on one card over gloo, not a multi-GPU "
                     "figure") if n_cards < MESH_RANKS else None}


def mesh_rank(rank: int, world: int, directory: str, backend: str,
              dataset: str, cfg: dict) -> None:
    """One rank of phase 10: joins the process group (a ``FileStore`` in
    ``directory``), runs :func:`mesh_serve` and writes its record, or its
    error, beside the inputs."""
    import datetime
    import traceback

    try:
        import torch
        import torch.distributed as dist

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(directory, "store"),
                                          world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=MESH_SECONDS))
        out = mesh_serve(torch, rank, world, directory, dataset, cfg)
        with open(os.path.join(directory, f"rank{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(directory, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        os._exit(1)


def mesh_serve(torch, rank: int, world: int, directory: str, dataset: str,
               cfg_fields: dict) -> dict:
    """Each MESH_ENGINES engine with ``mesh=`` on this rank.  Rank 0 serves
    ``query_batch`` and an open-loop traced runtime, stops the followers
    and holds its answers against the unmeshed engine's and the reference
    impl's, and its traces against an unmeshed engine's plans and
    ledger; the other ranks follow."""
    import pickle

    import numpy as np

    from repro_torch.core.sparse_formats import CSRMatrix
    from repro_torch.launch.mesh import make_data_mesh, mesh_device
    from repro_torch.models.gcn import GCNConfig
    from repro_torch.obs import Tracer
    from repro_torch.runtime import run_open_loop
    from repro_torch.serve import ArtifactRegistry, ServeEngine

    cfg = GCNConfig(**cfg_fields)
    z = np.load(os.path.join(directory, "adj.npz"))
    adj = CSRMatrix(indptr=z["indptr"], indices=z["indices"], data=z["data"],
                    shape=tuple(int(x) for x in z["shape"]))
    feats = np.load(os.path.join(directory, "features.npy"))
    mesh = make_data_mesh(world)
    dev = mesh_device(mesh)
    params = {name: {k: v.to(dev) for k, v in layer.items()}
              for name, layer in torch.load(
                  os.path.join(directory, "params.pt")).items()}
    with open(os.path.join(directory, "requests.pkl"), "rb") as fh:
        handed = pickle.load(fh)
    requests = handed["requests"]
    registry = ArtifactRegistry(cache_dir=os.path.join(directory, "cache"))
    load = MESH_LOAD[dataset]
    out = {"rank": rank, "engines": {}}
    for impl, precision, fused in MESH_ENGINES:
        key = f"{impl}{'+fused' if fused else ''}@{precision}"
        kw = dict(params=params, registry=registry, device=dev,
                  precision=precision, fused=fused, **SERVE)
        engine = ServeEngine(adj, feats,
                             dataclasses.replace(cfg, spmm_impl=impl),
                             mesh=mesh, **kw)
        t0 = time.perf_counter()
        built = engine.warmup()
        rec = {"captures": built, "warmup_s": time.perf_counter() - t0}
        exes = engine.batcher._executables
        if rank == 0:
            widths = []
            run = engine.batcher.run

            def logged(p, reqs, run=run):
                widths.append(engine.batcher.pad_batch(len(reqs)))
                return run(p, reqs)

            engine.batcher.run = logged
            t1 = time.perf_counter()
            got = engine.query_batch(requests[:load["batch"]])
            batch_s = time.perf_counter() - t1
            tracer, admitted = Tracer(), []
            rt = engine.runtime(capacity=256, tracer=tracer)
            submit = rt.submit

            def recording_submit(*a, **k):
                req = submit(*a, **k)
                admitted.append(req)
                return req

            rt.submit = recording_submit
            with rt:
                wall = run_open_loop(rt, requests[load["batch"]:],
                                     qps=load["qps"],
                                     deadline_s=ASYNC_DEADLINE_S,
                                     rng=np.random.default_rng(1))
            engine.stop_followers()
            check(all(r.future.done() for r in admitted),
                  f"phase 10: {key}: futures pending after shutdown")
            snap = rt.metrics.snapshot()
            c = snap["counters"]
            check(c["failed"] == 0 and c["submitted"] == load["async_"]
                  == c["completed"] + c["rejected_queue_full"]
                  + c["rejected_infeasible"] + c["shed_expired"]
                  + c["cancelled"],
                  f"phase 10: {key}: accounting {c}")
            index = {tuple(s.tolist()): i for i, s in enumerate(requests)}
            done = [r for r in admitted if r.future.exception() is None]
            picked = list(range(load["batch"])) + [
                index[tuple(r.seeds)] for r in done]
            got += [r.future.result() for r in done]
            answers = handed["answers"][key]
            flips = SERVE_FLIP_SHARE[precision]
            rec["vs_unmeshed"] = hold(
                torch, np, key, f"{len(got)} meshed answers vs the unmeshed "
                f"engine's", got, [answers["plain"][i] for i in picked],
                precision, flips, phase=10)
            rec["vs_reference"] = hold(
                torch, np, key, f"{len(got)} meshed answers vs the "
                f"reference impl", got,
                [answers["reference"][i] for i in picked], precision,
                flips, phase=10)
            traces = tracer.drain()
            unmeshed = ServeEngine(adj, feats,
                                   dataclasses.replace(cfg, spmm_impl=impl),
                                   **kw)
            rec["span_median_ms"] = check_traces(
                unmeshed, key, traces, admitted, c["submitted"])
            widths_ok = all(
                s.attributes["mesh_width"] == 1
                for t in traces for s in t.find("execute"))
            check(widths_ok, f"phase 10: {key}: a trace names a mesh width "
                  f"other than 1")
            rec.update(widths=widths, batch_rps=load["batch"] / batch_s,
                       async_wall_s=wall, completed=c["completed"],
                       slo_attainment=snap["derived"]["slo_attainment"])
        else:
            rec["followed"] = engine.follow()
        rec["post_warmup_captures"] = engine.compile_count - built
        rec["calls"] = engine.batcher.calls
        rec["mesh_runs"] = dict(engine.batcher.mesh_runs)
        replayed = {}
        for e in exes.values():
            for name, n in e.launches.items():
                replayed[name] = replayed.get(name, 0) + e.replays * n
        rec["replayed"] = replayed
        tag = "_scaled" if precision == "int8" else ""
        kernel = ("spmm_ell_fused_dense_grid" if fused
                  else "spmm_ell_dense_grid") + f"{tag}@{precision}"
        check(replayed.get(kernel, 0) > 0,
              f"phase 10: {key}: rank {rank} replayed no {kernel}")
        engine.batcher.clear_executables()
        del engine
        torch.cuda.empty_cache()
        out["engines"][key] = rec
    return out


# -- phase 11: the LM/SSM models ---------------------------------------------------

# Card-vs-CPU bars on the logits, a share of max|CPU logits|: the CPU tests'
# bars against the JAX package (tests/test_torch_lm.py), where bf16
# rounding flips that the blocks amplify set them at jamba and xlstm.
LM_REL = {"jamba-1.5-large-398b": 4e-2, "xlstm-1.3b": 1e-1}
LM_REL_DEFAULT = 2e-2
LM_DECODE_STEPS = 8
# (b): one block of each mixer at its arch's published widths, batch 2 x
# seq 16: (label, arch, block kind, memory tokens).  "encoder" is one
# encoder layer over the memory (1,024 frames: the query-blocked path).
# Jamba's FFN is left out (its mixer alone): the CPU side runs it too.
LM_BLOCKS = (
    ("qwen3-8b attn+mlp", "qwen3-8b", "attn+mlp", 0),
    ("qwen2.5-14b attn (QKV bias)", "qwen2.5-14b", "attn", 0),
    ("deepseek-v2-lite-16b MLA+MoE", "deepseek-v2-lite-16b", "attn+moe", 0),
    ("jamba-1.5-large mamba", "jamba-1.5-large-398b", "mamba", 0),
    ("xlstm-1.3b mlstm", "xlstm-1.3b", "mlstm", 0),
    ("xlstm-1.3b slstm", "xlstm-1.3b", "slstm", 0),
    ("llama-3.2-vision-11b xattn", "llama-3.2-vision-11b", "xattn", 1601),
    ("seamless-m4t-large-v2 encoder layer", "seamless-m4t-large-v2",
     "encoder", 1024),
    ("seamless-m4t-large-v2 attnx", "seamless-m4t-large-v2", "attnx", 1024),
)
LM_BLOCK_SHAPE = (2, 16)
LM_BLOCK_REL = 2e-2
# (c): the LM CLI's default arch at full width and depth, its defaults
# (batch 4, max-seq 64) and 32 greedy tokens; decode held against a
# teacher-forced forward over LM_CHECKED tokens within LM_DECODE_REL of
# max|forward logits| (rounding flips through 36 layers), which a decode
# at positions off by one must exceed.
LM_FULL = dict(arch="qwen3-8b", batch=4, max_seq=64, tokens=32)
LM_CHECKED = 16
LM_DECODE_REL = 5e-2
LM_PREFILL_REPS = 5
LM_FLEET_CONFIG = "examples/fleet_smoke.json"
LM_FLEET_REL = 1e-3      # graph replays vs eager forwards on the same card


def reduced_precision_allowed(torch) -> bool:
    """Whether cuBLAS may reduce bf16 products in bf16 inside: torch's
    default (``True``) outside the port's LM entry points, which scope
    ``False`` (``layers.bf16_full_reduction``)."""
    return torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def lm_to(torch, tree, dev):
    from repro_torch.models.lm import tree_map

    return tree_map(lambda t: t.to(dev), tree)


def lm_held(torch, got, want) -> dict:
    return agreement(torch, got.float().cpu(), want.float().cpu())


def lm_reduced_archs(torch, np, dev) -> dict:
    """(a): each reduced arch's forward logits and 8 decode steps (cross
    caches filled from the same memory) on the card against the CPU, the
    same weights on both."""
    from repro_torch.configs import get_config, list_archs, reduced
    from repro_torch.models import lm

    out = {}
    for arch in list_archs():
        cfg = reduced(get_config(arch))
        cpu = torch.device("cpu")
        p_cpu = lm.init_lm(cfg, torch.Generator().manual_seed(SEED), cpu)
        p_dev = lm_to(torch, p_cpu, dev)
        rng = np.random.default_rng(SEED)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)))
        memory = None
        if cfg.frontend_tokens:
            memory = torch.as_tensor(rng.standard_normal(
                (2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
            ).to(torch.bfloat16)
        bar = LM_REL.get(arch, LM_REL_DEFAULT)
        rec = {"bar": bar}
        want = lm.forward(p_cpu, cfg, tokens, memory)
        got = lm.forward(p_dev, cfg, tokens.to(dev),
                         None if memory is None else memory.to(dev))
        rec["forward"] = lm_held(torch, got, want)
        caches = {}
        for side, p, d in (("cpu", p_cpu, cpu), ("card", p_dev, dev)):
            cache = lm.init_cache(cfg, 2, 32, device=d)
            if memory is not None:
                cache = lm.fill_cross_cache(p, cfg, cache, memory.to(d))
            caches[side] = cache
        worst = 0.0
        for t in range(LM_DECODE_STEPS):
            want, caches["cpu"] = lm.decode_step(
                p_cpu, cfg, caches["cpu"], tokens[:, t:t + 1], t)
            got, caches["card"] = lm.decode_step(
                p_dev, cfg, caches["card"], tokens[:, t:t + 1].to(dev), t)
            worst = max(worst, lm_held(torch, got, want)["rel"])
        rec["decode_worst_rel"] = worst
        print(f"phase 11: {arch}: forward {describe(rec['forward'])}; "
              f"{LM_DECODE_STEPS} decode steps worst rel {worst:.3e} "
              f"(bar {bar})")
        check(rec["forward"]["rel"] <= bar and worst <= bar,
              f"phase 11: {arch}: card disagrees with the CPU")
        out[arch] = rec
    return out


def lm_blocks(torch, np, dev) -> dict:
    """(b): one block of each mixer at its arch's published widths on the
    card against the CPU, the same weights and inputs on both."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    out = {}
    b, s = LM_BLOCK_SHAPE
    for label, arch, kind, mem_t in LM_BLOCKS:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        gen = torch.Generator().manual_seed(SEED)
        cpu = torch.device("cpu")
        rng = np.random.default_rng(SEED)

        def bf16(*shape):
            return torch.as_tensor(rng.standard_normal(shape).astype(
                np.float32)).to(torch.bfloat16)

        if kind == "encoder":
            enc_cfg = dataclasses.replace(cfg, encoder_layers=1)
            p = {"encoder": lm._stacked(1, lambda _: lm._init_block(
                    lm._dense(cfg), "attn+mlp", gen, cpu)),
                 "enc_norm": torch.ones(cfg.d_model, dtype=torch.bfloat16)}
            x = bf16(b, mem_t, cfg.d_model)

            def block(p, x, memory, positions):
                return lm.encode(p, enc_cfg, x)
            memory = None
        else:
            p = lm._init_block(cfg, kind, gen, cpu)
            if "bq" in p["mix"]:   # zero at init: give the bias path values
                for name in ("bq", "bk", "bv"):
                    p["mix"][name] = bf16(p["mix"][name].shape[0]) * 0.1
            x = bf16(b, s, cfg.d_model)
            memory = bf16(b, mem_t, cfg.d_model) if mem_t else None

            def block(p, x, memory, positions, kind=kind, cfg=cfg):
                return lm._apply_block(cfg, kind, p, x, positions, memory,
                                       None, None)[0]
        pos = torch.arange(x.shape[1])
        want = block(p, x, memory, pos)
        cpu_s = time.perf_counter() - t0
        p_dev = lm_to(torch, p, dev)
        args = (p_dev, x.to(dev), None if memory is None else memory.to(dev),
                pos.to(dev))
        got = block(*args)
        reading = lm_held(torch, got, want)
        ms = device_ms(torch, lambda: block(*args), reps=5, warm=1)
        n_params = sum(t.numel() for _, t in lm_leaves(p))
        print(f"phase 11: {label}: {n_params:,} params, x {tuple(x.shape)}"
              + (f", memory {tuple(memory.shape)}" if memory is not None
                 else "") + f": {describe(reading)} (bar {LM_BLOCK_REL}); "
              f"card {ms:.3f} ms; CPU side {cpu_s:.1f} s")
        check(reading["rel"] <= LM_BLOCK_REL,
              f"phase 11: {label}: card disagrees with the CPU")
        out[label] = dict(reading, params=n_params, card_ms=ms,
                          x=list(x.shape),
                          memory=None if memory is None else list(memory.shape))
        del p, p_dev, args, got, want
        torch.cuda.empty_cache()
    return out


def lm_leaves(tree) -> list:
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            out.append((path, t))

    walk(tree, ())
    return out


def lm_decode_check(torch, lm, params, cfg, tokens, dev, offset: int) -> list:
    """Per-step agreement of ``decode_step`` at positions ``t + offset``
    with the teacher-forced forward over the same tokens."""
    full = lm.forward(params, cfg, tokens)
    cache = lm.init_cache(cfg, tokens.shape[0], LM_FULL["max_seq"], device=dev)
    rels = []
    for t in range(tokens.shape[1]):
        logits, cache = lm.decode_step(params, cfg, cache,
                                       tokens[:, t:t + 1], t + offset)
        rels.append(agreement(torch, logits, full[:, t])["rel"])
    return rels


def lm_full_width(torch, np, dev, card: str) -> dict:
    """(c): the LM CLI at full width and depth, then prefill timing, the
    decode-vs-forward agreement with its off-by-one control, the weight
    read bound and the decode step's leading device ops."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.launch.steps import build_prefill_step
    from repro_torch.models import lm
    from repro_torch.models.layers import bf16_full_reduction

    arch, batch = LM_FULL["arch"], LM_FULL["batch"]
    cfg = get_config(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cli = lm_serve.main(["--arch", arch, "--batch", str(batch),
                         "--max-seq", str(LM_FULL["max_seq"]),
                         "--tokens", str(LM_FULL["tokens"])])
    cli_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()

    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    param_bytes = sum(t.numel() * t.element_size()
                      for _, t in lm_leaves(params))
    bound_ms = param_bytes / HBM_BYTES_PER_S * 1e3
    rng = np.random.default_rng(SEED)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (batch, LM_FULL["max_seq"])),
                             device=dev)
    prefill = build_prefill_step(cfg, device=dev)
    prefill(params, prompt)
    times = []
    for _ in range(LM_PREFILL_REPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = prefill(params, prompt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    check(bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (batch, cfg.vocab),
          "phase 11: prefill logits")
    prefill_ms = statistics.median(times)

    tokens = prompt[:, :LM_CHECKED]
    with bf16_full_reduction():             # as the port's entry points
        rels = lm_decode_check(torch, lm, params, cfg, tokens, dev, 0)
        control = lm_decode_check(torch, lm, params, cfg, tokens, dev, 1)
    default = reduced_precision_allowed(torch)
    rels_default = lm_decode_check(torch, lm, params, cfg, tokens, dev, 0)
    print(f"phase 11: {arch} decode vs forward over {LM_CHECKED} tokens: "
          f"worst rel {max(rels):.3e} (limit {LM_DECODE_REL}); control at "
          f"positions + 1: worst rel {max(control):.3e}, first step "
          f"{control[0]:.3e}; with bf16 reduced-precision reductions "
          f"allowed={default} (torch's default, not gated): worst rel "
          f"{max(rels_default):.3e}")
    check(max(rels) <= LM_DECODE_REL,
          f"phase 11: {arch}: decode disagrees with forward ({max(rels):.3e})")
    check(max(control) > LM_DECODE_REL,
          f"phase 11: {arch}: the off-by-one control passed "
          f"({max(control):.3e})")

    cache = lm.init_cache(cfg, batch, LM_FULL["max_seq"], device=dev)
    for t in range(LM_CHECKED):
        _, cache = lm.decode_step(params, cfg, cache, tokens[:, t:t + 1], t)
    tok = tokens[:, -1:]
    busy = device_busy(torch, lambda: lm.decode_step(params, cfg, cache, tok,
                                                     LM_CHECKED))
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:8]
    busy_ms = sum(busy.values())
    print(f"phase 11: {arch} ({param_bytes / 1e9:.2f} GB of weights): "
          f"prefill {batch} x {LM_FULL['max_seq']} {prefill_ms:.3f} ms; "
          f"decode p50 {cli['p50_ms']:.3f} / p99 {cli['p99_ms']:.3f} ms per "
          f"token, {cli['tok_s']:.1f} tok/s at batch {batch}; weight-read "
          f"bound {bound_ms:.3f} ms a step; device busy {busy_ms:.3f} ms a "
          f"step; peak memory {peak / 2**30:.2f} GiB; CLI {cli_s:.1f} s; "
          f"{card}")
    print("phase 11: decode step's leading device ops (ms): "
          + "; ".join(f"{k} {v:.3f}" for k, v in top))
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "arch": arch, "card": card, "batch": batch,
        "max_seq": LM_FULL["max_seq"], "tokens": LM_FULL["tokens"],
        "param_bytes": param_bytes, "weight_read_bound_ms": bound_ms,
        "prefill_ms": prefill_ms, "prefill_ms_runs": times,
        "decode_p50_ms": cli["p50_ms"], "decode_p99_ms": cli["p99_ms"],
        "tok_s": cli["tok_s"], "decode_ms": cli["lat_ms"],
        "peak_memory_bytes": peak, "decode_busy_ms": busy_ms,
        "decode_top_ops_ms": dict(top),
        "decode_vs_forward_rel": rels, "control_rel": control,
        "decode_vs_forward_rel_reduced_allowed": rels_default,
        "limit": LM_DECODE_REL,
    }


def lm_fleet(torch, np, dev) -> dict:
    """(d): ``examples/fleet_smoke.json`` whole through the port's
    ``fleet_from_config`` on the card: its loads open loop, the LM answers
    held against eager forwards, every capture inside a load."""
    from repro_torch.fleet import (GcnServable, LmServable, TenantLoad,
                                   fleet_from_config, run_open_loop_mix)
    from repro_torch.models import lm

    with open(os.path.join(ROOT, LM_FLEET_CONFIG)) as f:
        config = json.load(f)
    rt = fleet_from_config(config, device=dev)
    t0 = time.perf_counter()
    for key in rt.manager.keys():
        rt.manager.resolve(key)
    load_s = time.perf_counter() - t0

    def builds():
        return {k: (sv.compiles if isinstance(sv, LmServable)
                    else sv.engine.compile_count)
                for k in rt.manager.keys()
                for sv in [rt.manager.servable(k)]}

    loaded = builds()
    rng = np.random.default_rng(0)
    loads = []
    for spec in config["loads"]:
        sv = rt.manager.servable(spec["servable"])
        n = int(spec["requests"])
        if isinstance(sv, GcnServable):
            payloads = [rng.choice(sv.engine.graph.n_nodes,
                                   size=rng.integers(1, 5), replace=False)
                        for _ in range(n)]
        else:
            payloads = [rng.integers(0, sv.cfg.vocab,
                                     size=int(spec.get("seq_len", 12)))
                        for _ in range(n)]
        loads.append(TenantLoad(tenant=spec["tenant"],
                                servable=spec["servable"], payloads=payloads,
                                qps=float(spec["qps"]),
                                deadline_s=float(spec["deadline_ms"]) / 1e3))
    log = []
    submit = rt.submit

    def logged(key, payload, **kw):
        req = submit(key, payload, **kw)
        log.append((key, payload, req))
        return req

    rt.submit = logged
    with rt:
        wall = run_open_loop_mix(rt, loads, rng=np.random.default_rng(1))
    check(builds() == loaded,
          f"phase 11: fleet built executables outside its loads "
          f"({loaded} -> {builds()})")
    c = rt.metrics.snapshot()["counters"]
    answered = {"lm": [], "gcn": 0}
    for key, payload, req in log:
        if not req.future.done() or req.future.exception() is not None:
            continue
        out = req.future.result()
        sv = rt.manager.servable(key)
        check(bool(np.isfinite(out).all()), f"phase 11: {key}: non-finite")
        if isinstance(sv, LmServable):
            prep = sv.prepare(payload)
            toks = torch.as_tensor(prep.tokens[None], device=dev).long()
            want = lm.forward(sv.params, sv.cfg, toks)[0, prep.n_tokens - 1]
            answered["lm"].append(agreement(torch, torch.as_tensor(out),
                                            want.cpu())["rel"])
        else:
            answered["gcn"] += 1
    worst = max(answered["lm"], default=0.0)
    accounted = (c["completed"] + c["rejected_quota"] + c["rejected_inflight"]
                 + c["rejected_queue_full"] + c["rejected_infeasible"]
                 + c["shed_expired"])
    print(f"phase 11: {LM_FLEET_CONFIG}: servables {rt.manager.keys()} "
          f"loaded in {load_s:.1f} s ({loaded} executables); offered "
          f"{c['submitted']} over {wall:.2f} s, completed {c['completed']} "
          f"(LM {len(answered['lm'])}, GCN {answered['gcn']}), quota "
          f"{c['rejected_quota']}, infeasible {c['rejected_infeasible']}, "
          f"expired {c['shed_expired']}, failed {c['failed']}; LM answers "
          f"vs eager forwards worst rel {worst:.3e} (limit {LM_FLEET_REL}); "
          f"no build outside the loads")
    check(c["failed"] == 0 and accounted == c["submitted"],
          "phase 11: fleet accounting")
    check(len(answered["lm"]) > 0 and answered["gcn"] > 0,
          "phase 11: the fleet answered no LM or no GCN request")
    check(worst <= LM_FLEET_REL,
          f"phase 11: LM answers disagree with eager forwards ({worst:.3e})")
    for key in rt.manager.keys():
        rt.manager.servable(key).unload()
    torch.cuda.empty_cache()
    return {"config": LM_FLEET_CONFIG, "executables": loaded,
            "load_s": load_s, "wall_s": wall,
            "counters": {k: c[k] for k in (
                "submitted", "completed", "rejected_quota",
                "rejected_inflight", "rejected_queue_full",
                "rejected_infeasible", "shed_expired", "failed")},
            "lm_answers": len(answered["lm"]), "gcn_answers": answered["gcn"],
            "lm_worst_rel": worst}


def phase_lm(torch, np, dev, card: str) -> dict:
    """Phase 11: the LM/SSM models on the card (no TPU kernel lies on
    this path: matrix products are ``torch.matmul`` / ``einsum``)."""
    from repro_torch.models.layers import bf16_full_reduction

    t0 = time.perf_counter()
    with bf16_full_reduction():             # as the port's entry points
        reduced_archs = lm_reduced_archs(torch, np, dev)
        t1 = time.perf_counter()
        blocks = lm_blocks(torch, np, dev)
    t2 = time.perf_counter()
    full = lm_full_width(torch, np, dev, card)
    t3 = time.perf_counter()
    fleet = lm_fleet(torch, np, dev)
    t4 = time.perf_counter()
    seconds = {"reduced": t1 - t0, "blocks": t2 - t1, "full": t3 - t2,
               "fleet": t4 - t3}
    print("phase 11: seconds " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in seconds.items()))
    return {"card": card, "reduced": reduced_archs, "blocks": blocks,
            "full": full, "fleet": fleet, "seconds": seconds}


# -- phase 12: training -------------------------------------------------------------

# (a): the LM training CLI at its defaults (internlm2-1.8b uncut, 20 steps,
# batch 8 x seq 128, lr 3e-3, remat on); steps 3-20 are timed.
TRAIN_TIMED_FROM = 2
BF16_FLOPS_PER_S = 989e12
# AdamW's bytes a parameter: bf16 param and grad read, f32 moments read
# and written, the bf16 param written.
ADAMW_BYTES_PER_PARAM = 2 + 2 + 4 + 4 + 4 + 4 + 2
TRAIN_TOP_OPS = 10
# (b): card vs CPU gradients of the ten reduced archs, each leaf held by
# ``repro_torch.train.grad.hold_leaf`` given the CPU's own move of that
# leaf when 1% of its embedding entries move one bf16 ulp (the CPU tests'
# rule against the JAX package, tests/_lm_parity.py); the loss within
# TRAIN_LOSS_REL.
TRAIN_SPREAD_SEEDS = 4
TRAIN_LOSS_REL = 1e-3
# (c): a reduced internlm2 through the trainer at the CLI's settings, a
# StepFailure at step 10 with checkpoints every 4 steps (it resumes from
# step 8 and redoes 8 and 9), against an uninterrupted run: every loss
# within TRAIN_RESUME_REL (the card's atomics make reruns differ in bits).
TRAIN_RESUME = dict(steps=20, fail_at=10, ckpt_every=4)
TRAIN_RESUME_REL = 1e-2
# (d): the GCN as examples/train_gcn.py trains it, on the dataset at its
# published widths, hidden 64, through impl="reference".  The first
# step's gradients, on the card and on the CPU in f32, are each held
# against an f64 plain GCN on the CPU (torch.sparse over the normalized
# adjacency) within gcn_grad_limit(nnz) of max|f64 grad|: an f32 sum over
# n terms in one order or another rounds by about sqrt(n) ulp of its
# terms' size, and the backward sums over the graph's nnz edges.
def gcn_grad_limit(nnz: int) -> float:
    return 2.0 ** -23 * math.sqrt(nnz)


GCN_TRAIN = dict(steps=100, fail_at=40, ckpt_every=25, lr=5e-3, warmup=20)
# Reddit's GCN steps take ~1.8 s each (115 with the replay: 210 s); cut to
# fit the run's 1,200 s, with the failure, the checkpoints and the warmup
# scaled alike.
GCN_TRAIN_CUT = {"reddit": dict(steps=30, fail_at=12, ckpt_every=8,
                                lr=5e-3, warmup=6)}


def tree_equal(torch, a, b) -> bool:
    from repro_torch.train.tree import flatten_with_paths

    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    return [k for k, _ in fa] == [k for k, _ in fb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(fa, fb))


def train_full_width(torch, np, dev, card: str, root: str) -> dict:
    """(a) and the checkpoint half of (c): the LM training CLI at its
    defaults on the card, then an explicit ``save_async`` of the trained
    state restored bit-equal, then one step profiled."""
    import gc
    import shutil

    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch import train as lm_train
    from repro_torch.launch.steps import build_train_step
    from repro_torch.train import AdamWConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.tree import leaves

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cli = lm_train.main(["--ckpt-dir", os.path.join(root, "cli")])
    cli_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    report, state, cfg = cli["report"], cli["state"], cli["cfg"]
    shutil.rmtree(os.path.join(root, "cli"), ignore_errors=True)
    n = cli["n_params"]
    batch, seq = 8, 128
    tokens = batch * seq
    check(report.steps_done == 20 and report.restarts == 0,
          "phase 12: the CLI did not run its 20 steps")
    check(bool(np.isfinite(report.losses).all())
          and report.losses[-1] < report.losses[0],
          f"phase 12: the loss did not fall ({report.losses[0]:.4f} -> "
          f"{report.losses[-1]:.4f})")
    timed = [t * 1e3 for t in report.step_times[TRAIN_TIMED_FROM:]]
    step_ms = statistics.median(timed)
    flops = 8 * n * tokens          # 6NT for forward + backward, 2NT remat
    adamw_bytes = ADAMW_BYTES_PER_PARAM * n
    flops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = adamw_bytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(flops_ms, bytes_ms)

    # a checkpoint of the full-width state, saved and restored bit-equal
    path = os.path.join(root, "full")
    t1 = time.perf_counter()
    thread = ckpt.save_async(path, 20, state)
    snapshot_s = time.perf_counter() - t1
    thread.join()
    ckpt.wait_pending()
    write_s = time.perf_counter() - t1
    state_bytes = sum(t.numel() * t.element_size() for t in leaves(state))
    t2 = time.perf_counter()
    restored, step = ckpt.restore(path, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t2
    equal = step == 20 and tree_equal(torch, restored, state)
    del restored
    shutil.rmtree(path, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    check(equal, "phase 12: the restored full-width checkpoint differs")

    # one more step, profiled (the update is in place: after the check)
    step_fn = build_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=5,
                                                total_steps=20), device=dev)
    batch_t = token_batch(cfg.vocab, batch, seq, 0, 20)
    params, opt = state["params"], state["opt"]

    def one_step():
        step_fn(params, opt, batch_t)

    busy = device_busy(torch, one_step)
    busy_ms = sum(busy.values())
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:TRAIN_TOP_OPS]
    print(f"phase 12: {cfg.name} ({n / 1e9:.3f} B params) training CLI, "
          f"batch {batch} x seq {seq}: loss {report.losses[0]:.4f} -> "
          f"{report.losses[-1]:.4f} over {report.steps_done} steps; median "
          f"step {step_ms:.3f} ms over steps {TRAIN_TIMED_FROM + 1}-20 "
          f"({tokens / step_ms * 1e3:.0f} tokens/s); bound {bound_ms:.3f} "
          f"ms a step (FLOPs {flops_ms:.3f} ms: 8 x N x tokens / 989 "
          f"TFLOP/s; AdamW bytes {bytes_ms:.3f} ms: {ADAMW_BYTES_PER_PARAM} "
          f"B a param / 3.35 TB/s); device busy {busy_ms:.3f} ms a step; "
          f"peak memory {peak / 2**30:.2f} GiB; CLI {cli_s:.1f} s; {card}")
    print("phase 12: train step's leading device ops (ms): "
          + "; ".join(f"{k[:90]} {v:.3f}" for k, v in top))
    print(f"phase 12: checkpoint of the full-width state "
          f"({state_bytes / 1e9:.2f} GB): save_async returned after "
          f"{snapshot_s:.1f} s (host snapshot), written after {write_s:.1f} "
          f"s, restored in {restore_s:.1f} s, bit-equal")
    del state, params, opt, cli
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "arch": cfg.name, "card": card, "params": n, "batch": batch,
        "seq": seq, "steps": report.steps_done, "losses": report.losses,
        "step_ms": [t * 1e3 for t in report.step_times],
        "median_step_ms": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
        "bound_ms": bound_ms, "bound_by": ("operations" if flops_ms >= bytes_ms
                                           else "bytes"),
        "flops_bound_ms": flops_ms, "adamw_bytes_bound_ms": bytes_ms,
        "busy_ms": busy_ms, "top_ops_ms": dict(top),
        "peak_memory_bytes": peak, "cli_s": cli_s,
        "checkpoint": {"bytes": state_bytes, "snapshot_s": snapshot_s,
                       "write_s": write_s, "restore_s": restore_s,
                       "bit_equal": equal},
    }


def train_reduced_grads(torch, np, dev) -> dict:
    """(b): one train step's loss and gradients of each reduced arch on the
    card against the port on the CPU, from one state carried across, with
    bf16 reductions in f32 (the entry points' setting, gated) and at
    torch's default (printed)."""
    from repro_torch.configs import get_config, list_archs, reduced
    from repro_torch.models import lm
    from repro_torch.models.layers import bf16_full_reduction
    from repro_torch.train import value_and_grad
    from repro_torch.train.grad import hold_leaf, leaf_spread
    from repro_torch.train.tree import flatten_with_paths

    out = {}
    cpu = torch.device("cpu")
    for arch in list_archs():
        cfg = reduced(get_config(arch))
        p_cpu = lm.init_lm(cfg, torch.Generator().manual_seed(SEED), cpu)
        rng = np.random.default_rng(SEED)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16)))
        memory = None
        if cfg.frontend_tokens:
            memory = torch.as_tensor(rng.standard_normal(
                (2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
            ).to(torch.bfloat16)

        def grads(p, d):
            fn = value_and_grad(lambda q: lm.lm_loss(
                q, cfg, tokens.to(d), None if memory is None
                else memory.to(d), remat=True))
            loss, g = fn(p)
            return float(loss), {k: v.float().cpu()
                                 for k, v in flatten_with_paths(g)}

        loss, want = grads(p_cpu, cpu)
        draws = []
        for s in range(TRAIN_SPREAD_SEEDS):
            bits = p_cpu["embed"].view(torch.int16).clone()
            hit = torch.as_tensor(
                np.random.default_rng(s).random(tuple(bits.shape)) < 0.01)
            bits[hit] += 1
            draws.append(grads(dict(p_cpu, embed=bits.view(torch.bfloat16)),
                               cpu)[1])
        spread = {k: leaf_spread(want[k], [d[k] for d in draws])
                  for k in want}
        p_dev = lm_to(torch, p_cpu, dev)
        rec = {}
        with bf16_full_reduction():         # as the port's train step
            f32_reductions = grads(p_dev, dev)
        default = reduced_precision_allowed(torch)
        for label, (got_loss, got) in (("f32_reductions", f32_reductions),
                                       ("torch_default", grads(p_dev, dev))):
            held = {k: hold_leaf(got[k], want[k], spread[k]) for k in want}
            worst = max(held, key=lambda k: held[k]["err"] / held[k]["bar"])
            rec[label] = {"loss_rel": abs(got_loss - loss) / abs(loss),
                          "worst_leaf": worst,
                          "worst": held[worst],
                          "cos_held": sum(h["test"] == "cos"
                                          for h in held.values()),
                          "over": sum(not h["ok"] for h in held.values())}
        main = rec["f32_reductions"]
        w = main["worst"]
        print(f"phase 12: {arch}: card vs CPU loss rel "
              f"{main['loss_rel']:.2e}; gradients worst {w['test']} "
              f"{w['err']:.3e} at {main['worst_leaf']} (bar {w['bar']:.3e}, "
              f"norm ratio {w['norm_ratio']:.4f}), {main['cos_held']} of "
              f"{len(want)} leaves held by direction, {main['over']} over "
              f"their bars; with bf16 reduced-precision reductions "
              f"allowed={default} (torch's default, not gated): loss rel "
              f"{rec['torch_default']['loss_rel']:.2e}, worst "
              f"{rec['torch_default']['worst']['test']} "
              f"{rec['torch_default']['worst']['err']:.3e} "
              f"({rec['torch_default']['over']} over)")
        check(main["loss_rel"] <= TRAIN_LOSS_REL and main["over"] == 0,
              f"phase 12: {arch}: card gradients disagree with the CPU")
        out[arch] = dict(rec, loss=loss,
                         max_spread=max(v[0] for v in spread.values()))
    return out


def lm_train_run(torch, cfg, dev, root: str, fail_at) -> tuple:
    """The training CLI's loop (its AdamW and trainer) on ``cfg``,
    checkpoints every TRAIN_RESUME["ckpt_every"] steps and a StepFailure
    at ``fail_at``: (final state, report).  Each step draws the batch of
    its own step number (``token_batch`` is deterministic in (seed,
    step)), so a resumed run sees the batches the uninterrupted one saw;
    the CLI, as the reference's, takes the next batch of its stream
    instead, and a restart shifts the data."""
    from repro_torch.data.synthetic import token_batch
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import lm
    from repro_torch.train import (AdamWConfig, StepFailure, TrainerConfig,
                                   adamw_init, run)

    steps = TRAIN_RESUME["steps"]
    params = lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    step = build_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=5,
                                             total_steps=steps), device=dev)

    def step_fn(state, _batch):
        batch = token_batch(cfg.vocab, 8, 128, 0, int(state["opt"].step))
        p, o, m = step(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, {k: float(v) for k, v in m.items()}

    fired = {"done": False}

    def hook(s):
        if s == fail_at and not fired["done"]:
            fired["done"] = True
            raise StepFailure("injected node loss")

    tcfg = TrainerConfig(total_steps=steps, ckpt_dir=root,
                         ckpt_every=TRAIN_RESUME["ckpt_every"], log_every=100)
    state, report = run(tcfg, {"params": params, "opt": adamw_init(params)},
                        step_fn, iter(lambda: None, 1), failure_hook=hook,
                        log=lambda *_: None)
    return state, report


def train_resume(torch, np, dev, root: str) -> dict:
    """(c): a run with a StepFailure resumes from its checkpoint and ends
    within TRAIN_RESUME_REL of an uninterrupted run."""
    import dataclasses as dc

    from repro_torch.configs import get_config, reduced

    cfg = reduced(get_config("internlm2-1.8b"))
    cfg = dc.replace(cfg, loss_chunk=min(cfg.loss_chunk, 128))
    _, clean = lm_train_run(torch, cfg, dev, os.path.join(root, "clean"),
                            None)
    _, failed = lm_train_run(torch, cfg, dev, os.path.join(root, "failed"),
                             TRAIN_RESUME["fail_at"])
    # the failed run redoes the steps after its last checkpoint: its
    # losses are the clean run's up to the failure, then again from there
    fail = TRAIN_RESUME["fail_at"]
    redo = fail % TRAIN_RESUME["ckpt_every"]
    want = clean.losses[:fail] + clean.losses[fail - redo:]
    worst = max(abs(a - b) / abs(b) for a, b in zip(failed.losses, want))
    print(f"phase 12: {cfg.name} through the trainer, StepFailure at step "
          f"{TRAIN_RESUME['fail_at']}, checkpoints every "
          f"{TRAIN_RESUME['ckpt_every']}: restarts {failed.restarts}, "
          f"{len(failed.losses)} steps run ({redo} redone), final loss "
          f"{failed.losses[-1]:.6f} vs {clean.losses[-1]:.6f} uninterrupted; "
          f"worst loss rel after the resume {worst:.3e} (limit "
          f"{TRAIN_RESUME_REL})")
    check(failed.restarts == 1 and clean.restarts == 0
          and len(failed.losses) == len(want),
          "phase 12: the failed run did not resume from its checkpoint")
    check(worst <= TRAIN_RESUME_REL,
          f"phase 12: the resumed run ends away from the uninterrupted one "
          f"({worst:.3e})")
    return {"arch": cfg.name, "restarts": failed.restarts, "redone": redo,
            "losses_clean": clean.losses, "losses_resumed": failed.losses,
            "worst_rel": worst, "limit": TRAIN_RESUME_REL}


def gcn_grads_f64(torch, np, a, features, labels, params) -> tuple:
    """The loss and gradients of a plain GCN in f64 on the CPU, written
    apart from the port: each layer ``A (x W + b)`` with ``A`` the
    normalized adjacency ``a`` (scipy) as a torch CSR tensor, ReLU between
    layers, the mean NLL of ``labels``."""
    import scipy.sparse as sp

    from repro_torch.train import value_and_grad
    from repro_torch.train.tree import tree_map

    csr = sp.csr_matrix(a, dtype=np.float64)
    with warnings.catch_warnings():     # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        adj = torch.sparse_csr_tensor(
            torch.as_tensor(csr.indptr).long(),
            torch.as_tensor(csr.indices).long(), torch.as_tensor(csr.data),
            size=csr.shape)
    x0 = torch.as_tensor(features).double()
    target = torch.as_tensor(labels).long()[:, None]

    def loss(p):
        x = x0
        for i in range(len(p)):
            x = adj @ (x @ p[f"layer_{i}"]["w"] + p[f"layer_{i}"]["b"])
            if i < len(p) - 1:
                x = torch.relu(x)
        return -torch.log_softmax(x, -1).gather(1, target).mean()

    value, grads = value_and_grad(loss)(
        tree_map(lambda t: t.detach().double(), params))
    return float(value), grads


def train_gcn(torch, np, data, cfg, graph, dev, card: str, root: str,
              dataset: str) -> dict:
    """(d): examples/train_gcn.py's loop on the card: AdamW over the
    autograd gradient of ``gcn_loss`` through ``impl="reference"``, the
    trainer with checkpoints and an injected failure; the first step's
    gradients against the CPU's, and the kernel impls refusing gradients
    on the card."""
    from repro_torch.models.gcn import gcn_accuracy, gcn_loss, init_params
    from repro_torch.train import (AdamWConfig, StepFailure, TrainerConfig,
                                   adamw_init, adamw_update, run,
                                   value_and_grad)
    from repro_torch.train.grad import rel_error
    from repro_torch.train.tree import flatten_with_paths

    check(cfg.spmm_impl == "reference", "phase 12: the GCN trains through "
          "impl='reference'")
    gtrain = GCN_TRAIN_CUT.get(dataset, GCN_TRAIN)
    print(f"phase 12: GCN settings {gtrain}"
          + (f" (cut from {GCN_TRAIN} at {dataset}: the run's 1,200 s limit)"
             if gtrain is not GCN_TRAIN else ""))
    # learnable labels: 2-hop aggregated feature argmax (examples/train_gcn.py)
    a = data.adj_norm.to_scipy()
    labels = np.argmax(np.asarray(a @ (a @ data.features[:, :cfg.out_dim])),
                       axis=1).astype(np.int32)
    cpu = torch.device("cpu")
    p_cpu = init_params(cfg, torch.Generator().manual_seed(SEED), cpu)
    feats = {cpu: torch.as_tensor(data.features),
             dev: torch.as_tensor(data.features, device=dev)}
    lab = {cpu: torch.as_tensor(labels).long(),
           dev: torch.as_tensor(labels, device=dev).long()}

    def loss_fn(d):
        return lambda p: gcn_loss(p, graph, feats[d], lab[d], cfg, device=d)

    loss_c, g_cpu = value_and_grad(loss_fn(cpu))(p_cpu)
    params = lm_to(torch, p_cpu, dev)
    loss_d, g_dev = value_and_grad(loss_fn(dev))(params)
    t0 = time.perf_counter()
    loss_64, g_64 = gcn_grads_f64(torch, np, a, data.features, labels, p_cpu)
    f64_s = time.perf_counter() - t0
    g_64 = dict(flatten_with_paths(g_64))
    bar = gcn_grad_limit(graph.pre.ell.nnz)
    grad_rel = {side: max(rel_error(x, g_64[k])
                          for k, x in flatten_with_paths(g))
                for side, g in (("card", g_dev), ("cpu", g_cpu))}
    loss_rel = {side: abs(float(x) - loss_64) / abs(loss_64)
                for side, x in (("card", loss_d), ("cpu", loss_c))}
    want = dict(flatten_with_paths(g_cpu))
    card_vs_cpu = max(rel_error(x, want[k])
                      for k, x in flatten_with_paths(g_dev))

    kernel_cfg = dataclasses.replace(cfg, spmm_impl="cuda")
    try:
        value_and_grad(lambda p: gcn_loss(p, graph, feats[dev], lab[dev],
                                          kernel_cfg, device=dev))(params)
        refused = False
    except RuntimeError as e:
        refused = "has no backward" in str(e)

    opt_cfg = AdamWConfig(lr=gtrain["lr"], total_steps=gtrain["steps"],
                          warmup_steps=gtrain["warmup"])
    grad = value_and_grad(loss_fn(dev))

    def step_fn(state, _batch):
        loss, g = grad(state["params"])
        p, o, m = adamw_update(opt_cfg, g, state["opt"], state["params"])
        return {"params": p, "opt": o}, {"loss": float(loss),
                                         **{k: float(v) for k, v in m.items()}}

    fired = {"done": False}

    def hook(s):
        if s == gtrain["fail_at"] and not fired["done"]:
            fired["done"] = True
            raise StepFailure("injected node loss")

    tcfg = TrainerConfig(total_steps=gtrain["steps"],
                         ckpt_dir=os.path.join(root, "gcn"),
                         ckpt_every=gtrain["ckpt_every"],
                         log_every=gtrain["ckpt_every"])
    t0 = time.perf_counter()
    state, report = run(tcfg, {"params": params, "opt": adamw_init(params)},
                        step_fn, iter(lambda: None, 1), failure_hook=hook,
                        log=lambda *_: None)
    wall = time.perf_counter() - t0
    with torch.no_grad():
        acc = float(gcn_accuracy(state["params"], graph, feats[dev], lab[dev],
                                 cfg, device=dev))
    step_ms = statistics.median(t * 1e3 for t in report.step_times)
    busy = device_busy(torch, lambda: step_fn(state, None))
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:TRAIN_TOP_OPS]
    print(f"phase 12: GCN on {dataset} ({graph.n_nodes} nodes, widths "
          f"{cfg.in_dim}-{cfg.hidden_dim}-{cfg.out_dim}, impl reference): "
          f"loss {report.losses[0]:.4f} -> {report.losses[-1]:.4f} over "
          f"{len(report.losses)} steps, train accuracy {acc:.3f}, median "
          f"step {step_ms:.3f} ms (device busy {sum(busy.values()):.3f} ms),"
          f" restarts {report.restarts}, {wall:.1f} s; first step against "
          f"f64 on the CPU ({f64_s:.1f} s): card loss rel "
          f"{loss_rel['card']:.2e}, gradients worst rel "
          f"{grad_rel['card']:.3e}; CPU f32 loss rel {loss_rel['cpu']:.2e},"
          f" gradients worst rel {grad_rel['cpu']:.3e} (limit {bar:.3e} at "
          f"{graph.pre.ell.nnz} nnz); card vs CPU {card_vs_cpu:.3e}; the "
          f"cuda impl refuses gradients: {refused}; {card}")
    print("phase 12: GCN step's leading device ops (ms): "
          + "; ".join(f"{k[:90]} {v:.3f}" for k, v in top))
    check(report.restarts == 1 and report.losses[-1] < report.losses[0]
          and bool(np.isfinite(report.losses).all()),
          "phase 12: GCN training did not resume or its loss did not fall")
    for side in ("card", "cpu"):
        check(grad_rel[side] <= bar and loss_rel[side] <= bar,
              f"phase 12: GCN gradients ({side}, f32) disagree with f64 "
              f"({grad_rel[side]:.3e}, limit {bar:.3e})")
    check(refused, "phase 12: the cuda impl took gradients")
    return {"dataset": dataset, "card": card, "steps": gtrain["steps"],
            "losses": report.losses, "train_accuracy": acc,
            "median_step_ms": step_ms, "restarts": report.restarts,
            "busy_ms": sum(busy.values()), "top_ops_ms": dict(top),
            "grad_rel_vs_f64": grad_rel, "grad_limit": bar,
            "loss_rel_vs_f64": loss_rel, "card_vs_cpu": card_vs_cpu,
            "f64_s": f64_s,
            "wall_s": wall}


def phase_train(torch, np, data, cfg, graph, dev, card: str,
                dataset: str) -> dict:
    """Phase 12: training on the card (no TPU kernel lies on this path)."""
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_",
                                     dir=build) as root:
        t0 = time.perf_counter()
        full = train_full_width(torch, np, dev, card, root)
        t1 = time.perf_counter()
        grads = train_reduced_grads(torch, np, dev)
        t2 = time.perf_counter()
        resume = train_resume(torch, np, dev, root)
        t3 = time.perf_counter()
        gcn = train_gcn(torch, np, data, cfg, graph, dev, card, root, dataset)
        t4 = time.perf_counter()
    seconds = {"full": t1 - t0, "grads": t2 - t1, "resume": t3 - t2,
               "gcn": t4 - t3}
    print("phase 12: seconds " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in seconds.items()))
    return {"card": card, "full": full, "grads": grads, "resume": resume,
            "gcn": gcn, "seconds": seconds}


# -- phase 13: the simulator and the examples ---------------------------------

SIM_DATASETS = ("cora", "citeseer", "pubmed")
SIM_TILE = 16
# the survey's headline: 3.78x speedup and 40.5% less energy than GROW, the
# geomean over five datasets (Cora, CiteSeer, PubMed, Reddit, Yelp)
SURVEY_SPEEDUP, SURVEY_ENERGY_SAVING = 3.78, 0.405
SIM_STATS = ("nz_block", "nz_col_rank", "nz_col", "nz_rb", "br_start",
             "br_block", "br_rnz", "b_start", "b_nnz_start", "b_nnz",
             "b_ncols", "b_nrows")
OPS_WIDTH = 64           # the aggregation's dense operand: hidden 64
EXAMPLE_SECONDS = 300
EXAMPLE_TRAIN_STEPS = 100


def simulate(torch, adj, fdim: int, dev) -> dict:
    """The simulator's path on ``dev``: label propagation, the symmetric
    permutation (host scipy), the tile statistics, Algorithm 2 and both
    simulators; each step's seconds (the device synchronized at both
    ends)."""
    from repro_torch.core.preprocessing import apply_symmetric_permutation
    from repro_torch.graphs.partition import label_propagation_permutation
    from repro_torch.sim import (GROWConfig, HWConfig, compute_block_stats,
                                 simulate_flexvector, simulate_grow)

    seconds = {}

    def timed(label, fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        return out

    perm = timed("label_propagation",
                 lambda: label_propagation_permutation(adj, device=dev))
    padj = timed("permute_host", lambda: apply_symmetric_permutation(adj, perm))
    stats = timed("block_stats",
                  lambda: compute_block_stats(padj, SIM_TILE, device=dev))
    fv = timed("flexvector",
               lambda: simulate_flexvector(padj, fdim, HWConfig(),
                                           stats=stats))
    gl = timed("grow", lambda: simulate_grow(padj, fdim, GROWConfig(m=6),
                                             stats=stats))
    return {"perm": perm, "stats": stats, "fv": fv, "gl": gl,
            "seconds": seconds}


def sim_ratios(run: dict) -> dict:
    fv, gl = run["fv"], run["gl"]
    return {"cycles_grow_over_flexvector": gl.cycles / fv.cycles,
            "energy_flexvector_over_grow": fv.energy_pj / gl.energy_pj,
            "flexvector_cycles": fv.cycles, "grow_cycles": gl.cycles,
            "flexvector_energy_pj": fv.energy_pj,
            "grow_energy_pj": gl.energy_pj}


def sim_equal(torch, np, card: dict, cpu: dict, what: str) -> int:
    """Every array and field of two simulator runs equal; returns the
    number of values compared."""
    from repro_torch.sim import HWConfig, alg2_best_k

    n = 0
    check(np.array_equal(card["perm"], cpu["perm"]),
          f"phase 13: {what}: the card's label propagation differs")
    n += len(cpu["perm"])
    cs, hs = card["stats"], cpu["stats"]
    for name in ("tile", "n_rows", "n_cols", "nnz"):
        check(getattr(cs, name) == getattr(hs, name),
              f"phase 13: {what}: BlockStats.{name} differs")
    for name in SIM_STATS:
        a, b = getattr(cs, name), getattr(hs, name)
        check(a.dtype == b.dtype and torch.equal(a.cpu(), b),
              f"phase 13: {what}: BlockStats.{name} differs ({a.dtype}, "
              f"{b.dtype})")
        n += b.numel()
    hw = HWConfig()
    for mode in ("single", "double"):
        a = alg2_best_k(cs, hw.tau, hw.vrf_depth, mode=mode)
        b = alg2_best_k(hs, hw.tau, hw.vrf_depth, mode=mode)
        check(torch.equal(a.cpu(), b), f"phase 13: {what}: Algorithm 2 "
              f"({mode}) differs")
        n += b.numel()
    for key in ("fv", "gl"):
        for f in dataclasses.fields(cpu[key]):
            a, b = getattr(card[key], f.name), getattr(cpu[key], f.name)
            same = (torch.equal(a.cpu(), b) and a.dtype == b.dtype
                    if isinstance(b, torch.Tensor) else a == b)
            check(same, f"phase 13: {what}: {card[key].name}.{f.name} "
                  f"differs: card {a!r}, CPU {b!r}")
            n += b.numel() if isinstance(b, torch.Tensor) else 1
    return n


def sim_line(name: str, ratios: dict, seconds: dict, where: str) -> str:
    return (f"phase 13: {name}: modeled GROW / FlexVector cycles "
            f"{ratios['cycles_grow_over_flexvector']:.3f}x, FlexVector energy "
            f"{ratios['energy_flexvector_over_grow']:.3f} of GROW's (the "
            f"simulator's ASIC figures, not card times); {where} seconds "
            + ", ".join(f"{k} {v:.4f}" for k, v in seconds.items()))


def sim_datasets(torch, np, dev) -> dict:
    """(a): the three small datasets on the card and on the CPU."""
    from repro_torch.graphs.datasets import load_dataset

    cpu = torch.device("cpu")
    out = {}
    for i, name in enumerate(SIM_DATASETS):
        ds = load_dataset(name, seed=SEED, with_features=False)
        fdim = ds.spec.feature_dim
        if i == 0:      # the card's first sorts and uniques, untimed
            simulate(torch, ds.adj_norm, fdim, dev)
        card = simulate(torch, ds.adj_norm, fdim, dev)
        host = simulate(torch, ds.adj_norm, fdim, cpu)
        n = sim_equal(torch, np, card, host, name)
        ratios = sim_ratios(card)
        print(sim_line(name, ratios, card["seconds"], "card"))
        print(f"phase 13: {name}: CPU seconds " + ", ".join(
            f"{k} {v:.4f}" for k, v in host["seconds"].items())
            + f"; card equal to CPU in all {n} values ({ds.adj_norm.nnz} nnz,"
            f" {card['stats'].n_blocks} tiles)")
        out[name] = dict(ratios, nnz=ds.adj_norm.nnz,
                         tiles=card["stats"].n_blocks,
                         card_s=card["seconds"], cpu_s=host["seconds"],
                         values_equal=n)
    geo = {k: math.exp(statistics.fmean(math.log(r[k]) for r in out.values()))
           for k in ("cycles_grow_over_flexvector",
                     "energy_flexvector_over_grow")}
    print(f"phase 13: geomean over {', '.join(SIM_DATASETS)}: modeled "
          f"speedup {geo['cycles_grow_over_flexvector']:.3f}x, energy "
          f"-{(1 - geo['energy_flexvector_over_grow']) * 100:.1f}% (the "
          f"survey: {SURVEY_SPEEDUP}x, -{SURVEY_ENERGY_SAVING * 100:.1f}% "
          f"over five datasets)")
    return {"datasets": out, "geomean": geo,
            "survey": {"speedup": SURVEY_SPEEDUP,
                       "energy_saving": SURVEY_ENERGY_SAVING}}


def ops_wrapper(torch, np, fv, graph, dev) -> dict:
    """(c): ``flexvector_spmm`` at the dataset's ELL, every precision and
    schedule: its launches, and its output against its kernel's plain
    version on the same operands."""
    from repro_torch.exec import SpmmOperands, SpmmPlan, quant
    from repro_torch.exec.dispatch import aggregation_args
    from repro_torch.kernels.ops import flexvector_spmm

    ell = graph.pre.ell
    gen = torch.Generator().manual_seed(SEED)
    dense = torch.randn(ell.n_dense_rows, OPS_WIDTH, generator=gen).to(dev)
    # the plain versions' operands, kept across calls: the sparse grid's
    # schedule (host planning, seconds at Reddit) is built once for them
    operands = SpmmOperands.from_ell(ell, dev)
    out = {}
    for precision in PRECISIONS:
        for skip_empty in (True, False):
            name = "spmm_ell_sparse_grid" if skip_empty else \
                "spmm_ell_dense_grid"
            if precision == "int8":
                name += "_scaled"
            want = {f"{name}@{precision}": 1}
            fv.reset_launches()
            got = flexvector_spmm(ell, dense, skip_empty=skip_empty,
                                  precision=precision, device=dev)
            torch.cuda.synchronize()
            counts = {k: n for k, n in fv.PRECISION_LAUNCHES.items() if n}
            # the plain version on the operands the wrapper built
            plan = SpmmPlan(impl="cuda_sparse" if skip_empty else "cuda",
                            precision=precision).resolve(schedulable=True)
            vals, scales = operands.values_for(precision, plan.block_rows)
            kname, args, kw, (r, f) = aggregation_args(
                plan, operands, vals, quant.cast_dense(dense, precision),
                scales)
            check(kname == name, f"phase 13: flexvector_spmm planned {kname}")
            ref = fv.PLAIN[kname](*args, **kw)[:r, :f]
            key = (kname if precision in ("f32", "int8")
                   else f"{kname}@{precision}")
            reading = agreement(torch, got, ref)
            label = f"{'sparse' if skip_empty else 'dense'}@{precision}"
            print(f"phase 13: flexvector_spmm {label}: launched {counts}; "
                  f"vs the plain version {describe(reading)} (limit "
                  f"{REL_TOL[key]})")
            check(counts == want, f"phase 13: flexvector_spmm {label} "
                  f"launched {counts}, not {want}")
            check(tuple(got.shape) == (ell.padded_rows, OPS_WIDTH)
                  and agrees(reading, REL_TOL[key]),
                  f"phase 13: flexvector_spmm {label} disagrees with its "
                  f"plain version: {describe(reading)}")
            out[label] = {"launches": counts, "vs_plain": reading,
                          "rel_tol": REL_TOL[key]}
    return out


def run_examples(root: str) -> dict:
    """(d): the two examples at Cora on the card, side by side."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    argv = {
        "torch_quickstart": ["--impl", "cuda_sparse"],
        "torch_train_gcn": ["--steps", str(EXAMPLE_TRAIN_STEPS),
                            "--inject-failure", "--fresh", "--ckpt-dir",
                            os.path.join(root, "gcn_example")],
    }
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", f"{name}.py"),
         "--dataset", "cora", *args], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, args in argv.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=EXAMPLE_SECONDS)
            lines = stdout.strip().splitlines()
            print(f"phase 13: examples/{name}.py exited {proc.returncode} "
                  f"after {time.perf_counter() - t0:.1f} s; last lines: "
                  + " | ".join(lines[-3:]))
            check(proc.returncode == 0, f"phase 13: examples/{name}.py "
                  f"exited {proc.returncode}: {stderr[-2000:]}")
            out[name] = {"returncode": proc.returncode,
                         "last_lines": lines[-3:]}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    check("restarts=1" in " ".join(out["torch_train_gcn"]["last_lines"]),
          "phase 13: the training example did not restart once")
    return out


def phase_sim(torch, np, fv, data, graph, dev, card: str,
              dataset: str, omitted=()) -> dict:
    """Phase 13: the simulator on the card (against the CPU at the small
    datasets), ``flexvector_spmm`` and the examples; ``omitted`` may name
    (a) and (d)."""
    t0 = time.perf_counter()
    small = ({"small_datasets": "omitted"} if "13 (a)" in omitted
             else sim_datasets(torch, np, dev))
    t1 = time.perf_counter()
    run = None
    if dataset not in SIM_DATASETS:
        r = simulate(torch, data.adj_norm, data.spec.feature_dim, dev)
        run = dict(sim_ratios(r), nnz=data.adj_norm.nnz,
                   tiles=r["stats"].n_blocks, card_s=r["seconds"])
        print(sim_line(dataset, run, r["seconds"], "card"))
        del r
    t2 = time.perf_counter()
    ops = ops_wrapper(torch, np, fv, graph, dev)
    t3 = time.perf_counter()
    examples = "omitted"
    if "13 (d)" not in omitted:
        build = os.path.join(ROOT, "build")
        os.makedirs(build, exist_ok=True)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_",
                                         dir=build) as root:
            examples = run_examples(root)
    t4 = time.perf_counter()
    seconds = {"small": t1 - t0, "dataset": t2 - t1, "ops": t3 - t2,
               "examples": t4 - t3}
    print("phase 13: seconds " + ", ".join(f"{k} {v:.1f}"
                                          for k, v in seconds.items()))
    return {"card": card, "dataset": dataset, **small, "run_dataset": run,
            "flexvector_spmm": ops, "examples": examples,
            "seconds": seconds}


# ---------------------------------------------------------------------------
# Phase 14: the LM under a mesh
# ---------------------------------------------------------------------------

# (a) phase 11's qwen3-8b run (its seed, batch 4 x 64 prompt) sharded over
# a (1, 2) data x model mesh of two gloo ranks on the one card; (b) one
# train step of internlm2-1.8b at the training CLI's batch 8 x seq 128 and
# its AdamW settings on the same mesh, and on a (2, 1) mesh of the same
# ranks with FSDP; (c) the dry run of three production cells on a fake
# 16 x 16 mesh, on the host; (d) three reduced archs on a (2, 2) mesh of
# four gloo ranks with FSDP.
LM_MESH_SHAPE = (1, 2)
LM_MESH_FSDP_SHAPE = (2, 1)
LM_MESH_SERVE = dict(arch="qwen3-8b", batch=4, max_seq=64, decode=8)
LM_MESH_TRAIN = dict(arch="internlm2-1.8b", batch=8, seq=128)
# The logits' bar, as a share of max|logits|: phase 11's 2e-2, or twice
# the single card's own move when only the kernels change (each sequence
# run alone against the batch of 4, measured in the same run), up to
# phase 11's full-width bar (decode vs forward, LM_DECODE_REL).  At
# qwen3-8b's full width that move alone reads 1.4e-2 on an H100 (the
# prefill; PERF.md) and the sharded decode 2.2e-2: 2e-2 sits at the floor
# of kernel choice there.
LM_MESH_REL = 2e-2
LM_MESH_LOSS_REL = 1e-2
LM_MESH_MEMORY = 0.6        # a rank's peak over the single-card run's
LM_MESH_SECONDS = 600
# (d): the reduced archs (phase 11's seed) at a batch 4 x 16 prompt, its
# first LM_MESH_SERVE["decode"] tokens decoded, and one train step on it;
# each rank's logits held to phase 11's card-vs-CPU bar of its arch
# (LM_REL), the loss to LM_MESH_LOSS_REL
LM_MESH_REDUCED_SHAPE = (2, 2)
LM_MESH_REDUCED = ("qwen3-8b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b")
LM_MESH_REDUCED_BATCH = (4, 16)
DRYRUN_CELLS = (("qwen3-8b", "train_4k"), ("qwen3-8b", "decode_32k"),
                ("deepseek-v2-lite-16b", "train_4k"))
DRYRUN_SECONDS = 600
DRYRUN_DEVICE = "cuda"      # the fake tensors' device type (no card used)


def lm_mesh_weights(torch, cfg, dev):
    """Phase 11's weights: ``init_lm`` from seed 0 drawn on the card."""
    from repro_torch.models import lm

    return lm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)


def lm_mesh_train_cfg(cfg):
    """The training CLI's config: its loss chunk cut to the sequence."""
    return dataclasses.replace(
        cfg, loss_chunk=min(cfg.loss_chunk, LM_MESH_TRAIN["seq"]))


def lm_mesh_opt():
    from repro_torch.train import AdamWConfig

    return AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=20)


def lm_mesh_inputs(np, cfg_serve, cfg_train) -> tuple:
    """The prompt (phase 11's draw) and the train batch (the CLI's
    first)."""
    from repro_torch.data.synthetic import token_batch

    s = LM_MESH_SERVE
    prompt = np.random.default_rng(SEED).integers(
        0, cfg_serve.vocab, (s["batch"], s["max_seq"]))
    t = LM_MESH_TRAIN
    batch = token_batch(cfg_train.vocab, t["batch"], t["seq"], 0, 0).numpy()
    return prompt, batch


def timed_ms(torch, fn) -> tuple:
    """(fn's result, its host ms to the card's end)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def lm_mesh_serve(torch, np, params, cfg, prompt, dev, mesh=None,
                  counter=None) -> dict:
    """Prefill of the prompt, then LM_MESH_SERVE["decode"] cached decode
    steps from an empty cache: each step's logits (whole, f32 numpy),
    the decode ms, and the peak memory of the run."""
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models import lm

    s = LM_MESH_SERVE
    whole = ((lambda t: t.full_tensor()) if mesh is not None
             else (lambda t: t))
    prefill = build_prefill_step(cfg, mesh=mesh, device=dev)
    serve = build_serve_step(cfg, mesh=mesh, device=dev)
    cache = lm.init_cache(cfg, prompt.shape[0], s["max_seq"], device=dev)
    if mesh is not None:
        from repro_torch.dist.sharding import ShardingPlan, distribute_cache
        from repro_torch.launch.mesh import dp_axes

        cache = distribute_cache(cache, ShardingPlan(mesh), dp_axes(mesh))
    torch.cuda.reset_peak_memory_stats()
    logits, prefill_ms = timed_ms(torch, lambda: prefill(params, prompt))
    out = {"prefill": whole(logits).float().cpu().numpy(), "decode": [],
           "prefill_ms": prefill_ms, "decode_ms": []}
    tokens = prompt[:, :s["decode"]]
    for t in range(s["decode"]):
        (logits, cache), ms = timed_ms(
            torch, lambda: serve(params, cache, tokens[:, t:t + 1], t))
        out["decode"].append(whole(logits).float().cpu().numpy())
        out["decode_ms"].append(ms)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    if counter is not None:
        with counter:
            serve(params, cache, tokens[:, -1:], s["decode"])
        out["decode_collectives"] = counter.summary()
        counter.reset()
        with counter:
            prefill(params, prompt)
        out["prefill_collectives"] = counter.summary()
    return out


def lm_mesh_train(torch, params, cfg, batch, dev, mesh=None) -> dict:
    """Two train steps from the given weights: the first's loss, the
    second's ms, and the peak memory of the two."""
    from repro_torch.launch.steps import build_train_step
    from repro_torch.train import adamw_init

    step = build_train_step(cfg, lm_mesh_opt(), mesh=mesh, device=dev)
    opt = adamw_init(params)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(2):
        (params, opt, metrics), ms = timed_ms(
            torch, lambda: step(params, opt, batch))
        loss = metrics["loss"]
        losses.append(float(loss.full_tensor() if mesh is not None
                            else loss))
        times.append(ms)
    return {"losses": losses, "step_ms": times,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def lm_mesh_reduced_run(torch, np, cfg, dev, mesh=None) -> dict:
    """(d) for one reduced arch: phase 11's weights (seed SEED, drawn on
    the host), under ``mesh`` placed by ``ShardingPlan(fsdp=True)``: the
    prefill logits of a LM_MESH_REDUCED_BATCH prompt, LM_MESH_SERVE
    ["decode"] cached decode steps over its first tokens and one train
    step on it (whole logits as f32 numpy, the loss, the ms of each
    part), and under a mesh the collectives of its MoE layers in the
    prefill and in the train step (each ``moe_layer`` call, the
    recomputation of the backward included: a counter around each)."""
    from repro_torch.dist.sharding import (ShardingPlan, distribute_cache,
                                           distribute_params)
    from repro_torch.launch.mesh import dp_axes
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, build_train_step)
    from repro_torch.models import layers, lm
    from repro_torch.roofline.analysis import CollectiveCounter
    from repro_torch.train import adamw_init

    tokens = np.random.default_rng(SEED).integers(
        0, cfg.vocab, LM_MESH_REDUCED_BATCH)
    params = lm_to(torch, lm.init_lm(cfg, torch.Generator().manual_seed(SEED),
                                     torch.device("cpu")), dev)
    cache = lm.init_cache(cfg, tokens.shape[0], tokens.shape[1], device=dev)
    if mesh is not None:
        plan = ShardingPlan(mesh, fsdp=True)
        params = distribute_params(params, plan)
        cache = distribute_cache(cache, plan, dp_axes(mesh))
    whole = ((lambda t: t.full_tensor()) if mesh is not None
             else (lambda t: t))
    counters = {"prefill": CollectiveCounter(), "train": CollectiveCounter()}
    current = [None]
    inner = layers.moe_layer

    def counted(p, x, moe):
        if current[0] is None:
            return inner(p, x, moe)
        with current[0]:
            return inner(p, x, moe)

    out = {"decode": [], "ms": {}}
    layers.moe_layer = counted
    try:
        current[0] = counters["prefill"] if mesh is not None else None
        logits, out["ms"]["prefill"] = timed_ms(torch, lambda: build_prefill_step(
            cfg, mesh=mesh, device=dev)(params, tokens))
        out["prefill"] = whole(logits).float().cpu().numpy()
        current[0] = None
        serve = build_serve_step(cfg, mesh=mesh, device=dev)
        t0 = time.perf_counter()
        for t in range(LM_MESH_SERVE["decode"]):
            logits, cache = serve(params, cache, tokens[:, t:t + 1], t)
            out["decode"].append(whole(logits).float().cpu().numpy())
        out["ms"]["decode"] = (time.perf_counter() - t0) * 1e3
        current[0] = counters["train"] if mesh is not None else None
        step = build_train_step(cfg, lm_mesh_opt(), mesh=mesh, device=dev)
        (_, _, metrics), out["ms"]["train"] = timed_ms(
            torch, lambda: step(params, adamw_init(params), tokens))
        out["loss"] = float(whole(metrics["loss"]))
    finally:
        layers.moe_layer = inner
    if mesh is not None and cfg.moe is not None:
        n = tokens.size
        out["moe_collectives"] = {
            k: dict(c.summary(), largest=dict(c.largest))
            for k, c in counters.items()}
        out["moe_buffer"] = (cfg.moe.n_experts * cfg.d_model
                             * layers.moe_capacity(n, cfg.moe))
    return out


def lm_mesh_reduced_rank_run(torch, np, rank: int, directory: str) -> None:
    """(d) on this rank: a LM_MESH_REDUCED_SHAPE mesh, each of
    LM_MESH_REDUCED through :func:`lm_mesh_reduced_run`; the logits and
    the record written beside the inputs."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import make_production_mesh, mesh_device

    mesh = make_production_mesh(data=LM_MESH_REDUCED_SHAPE[0],
                                model=LM_MESH_REDUCED_SHAPE[1])
    dev = mesh_device(mesh)
    record = {}
    for arch in LM_MESH_REDUCED:
        res = lm_mesh_reduced_run(torch, np, reduced(get_config(arch)), dev,
                                  mesh=mesh)
        np.savez(os.path.join(directory, f"rank{rank}_{arch}.npz"),
                 prefill=res.pop("prefill"), decode=np.stack(res.pop("decode")))
        record[arch] = res
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as fh:
        json.dump(record, fh)


def lm_mesh_rank(rank: int, world: int, directory: str,
                 run: str = "lm_mesh_run") -> None:
    """One rank of phase 14: joins the gloo group (a ``FileStore`` in
    ``directory``), runs ``run`` (:func:`lm_mesh_run` or
    :func:`lm_mesh_reduced_rank_run`) and writes its record, or its
    error."""
    import datetime
    import traceback

    try:
        import numpy as np
        import torch
        import torch.distributed as dist

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", store=dist.FileStore(os.path.join(directory, "store"),
                                         world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=LM_MESH_SECONDS))
        globals()[run](torch, np, rank, directory)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(directory, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        os._exit(1)


def lm_mesh_run(torch, np, rank: int, directory: str) -> None:
    """(a) and (b) on this rank: phase 11's weights placed on the (1, 2)
    mesh by ``ShardingPlan`` (each rank draws the full weights, keeps its
    shards and frees the rest), then internlm2's on the (2, 1) mesh with
    FSDP; its logits and record written beside the inputs."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import ShardingPlan, distribute_params
    from repro_torch.launch.mesh import make_production_mesh, mesh_device
    from repro_torch.roofline.analysis import CollectiveCounter

    mesh = make_production_mesh(data=LM_MESH_SHAPE[0], model=LM_MESH_SHAPE[1])
    dev = mesh_device(mesh)
    cfg_s = get_config(LM_MESH_SERVE["arch"])
    cfg_t = lm_mesh_train_cfg(get_config(LM_MESH_TRAIN["arch"]))
    prompt, batch = lm_mesh_inputs(np, cfg_s, cfg_t)

    def placed(cfg, on=mesh, fsdp=False):
        full = lm_mesh_weights(torch, cfg, dev)
        out = distribute_params(full, ShardingPlan(on, fsdp=fsdp))
        del full
        gc.collect()
        torch.cuda.empty_cache()
        return out

    params = placed(cfg_s)
    serve = lm_mesh_serve(torch, np, params, cfg_s, prompt, dev, mesh=mesh,
                          counter=CollectiveCounter())
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params = placed(cfg_t)
    train = lm_mesh_train(torch, params, cfg_t, batch, dev, mesh=mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    fsdp_mesh = make_production_mesh(data=LM_MESH_FSDP_SHAPE[0],
                                     model=LM_MESH_FSDP_SHAPE[1])
    params = placed(cfg_t, fsdp_mesh, fsdp=True)
    train_fsdp = lm_mesh_train(torch, params, cfg_t, batch, dev,
                               mesh=fsdp_mesh)
    del params
    np.savez(os.path.join(directory, f"rank{rank}_logits.npz"),
             prefill=serve.pop("prefill"), decode=np.stack(serve.pop("decode")))
    with open(os.path.join(directory, f"rank{rank}.json"), "w") as fh:
        json.dump({"serve": serve, "train": train, "train_fsdp": train_fsdp},
                  fh)


def start_dryrun(directory: str) -> list:
    """(c) started: each cell's ``python -m repro_torch.launch.dryrun`` in
    a process of its own, side by side: fake tensors, no tensor on the card
    (the card stays visible: autograd's backward for CUDA tensors, fake
    ones included, runs on the card's device thread)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for arch, shape in DRYRUN_CELLS:
        out = os.path.join(directory, f"{arch}__{shape}.json")
        log = open(os.path.join(directory, f"{arch}__{shape}.log"), "w")
        procs.append((arch, shape, out, log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", out, "--device",
             DRYRUN_DEVICE],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)))
    return procs


def finish_dryrun(procs, t0: float) -> dict:
    """(c) collected: every cell's record and its H100 roofline terms."""
    cells = {}
    for arch, shape, out, log, proc in procs:
        try:
            proc.wait(timeout=max(DRYRUN_SECONDS - (time.perf_counter() - t0),
                                  1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        with open(log.name) as fh:
            tail = fh.read()[-2000:]
        check(proc.returncode == 0 and os.path.exists(out),
              f"phase 14: the dry run of {arch} x {shape} failed "
              f"(exit {proc.returncode}): {tail}")
        with open(out) as fh:
            rec = json.load(fh)
        terms = rec["roofline_h100"]
        ca = rec["cost_analysis"]
        check(ca["flops_per_device"] > 0 and ca["bytes_per_device"] > 0
              and terms["bound_s"] > 0
              and all(math.isfinite(terms[k]) for k in
                      ("compute_s", "memory_s", "collective_s")),
              f"phase 14: {arch} x {shape}: empty or non-finite counts")
        cells[f"{arch}__{shape}"] = rec
    return cells


def phase_lm_mesh(torch, np, dev, card: str) -> dict:
    """Phase 14: (c) started on the host, then the single-card references
    of (a), (b) and (d), the two ranks' runs of (a) and (b) and the four
    ranks' of (d) held against them, and (c)'s records."""
    import gc

    from repro_torch.configs import get_config, reduced

    t0 = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke", "lm_mesh")
    os.makedirs(root, exist_ok=True)
    dry = start_dryrun(root)

    cfg_s = get_config(LM_MESH_SERVE["arch"])
    cfg_t = lm_mesh_train_cfg(get_config(LM_MESH_TRAIN["arch"]))
    prompt, batch = lm_mesh_inputs(np, cfg_s, cfg_t)
    params = lm_mesh_weights(torch, cfg_s, dev)
    one_s = lm_mesh_serve(torch, np, params, cfg_s, prompt, dev)
    # the control: each sequence alone (the same math, other kernels)
    alone = [lm_mesh_serve(torch, np, params, cfg_s, prompt[i:i + 1], dev)
             for i in range(prompt.shape[0])]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params = lm_mesh_weights(torch, cfg_t, dev)
    one_t = lm_mesh_train(torch, params, cfg_t, batch, dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    one_d = {arch: lm_mesh_reduced_run(torch, np, reduced(get_config(arch)),
                                       dev)
             for arch in LM_MESH_REDUCED}
    single_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="lm_mesh_") as directory:
        world = LM_MESH_SHAPE[0] * LM_MESH_SHAPE[1]
        ranks = spawn_ranks(lm_mesh_rank, world, directory, (),
                            LM_MESH_SECONDS, 14)
        logits = [np.load(os.path.join(directory, f"rank{r}_logits.npz"))
                  for r in range(world)]
        got = [{"prefill": z["prefill"], "decode": list(z["decode"])}
               for z in logits]
    mesh_s = time.perf_counter() - t0 - single_s
    with tempfile.TemporaryDirectory(prefix="lm_mesh_reduced_") as directory:
        world_d = LM_MESH_REDUCED_SHAPE[0] * LM_MESH_REDUCED_SHAPE[1]
        ranks_d = spawn_ranks(lm_mesh_rank, world_d, directory,
                              ("lm_mesh_reduced_rank_run",), LM_MESH_SECONDS,
                              14)
        got_d = [{arch: dict(np.load(os.path.join(
            directory, f"rank{r}_{arch}.npz"))) for arch in LM_MESH_REDUCED}
            for r in range(world_d)]
    reduced_s = time.perf_counter() - t0 - single_s - mesh_s

    def rel(a, b) -> float:
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    def steps_rel(run) -> list:
        return [rel(run["prefill"], one_s["prefill"])] + [
            rel(a, b) for a, b in zip(run["decode"], one_s["decode"])]

    control = steps_rel({
        "prefill": np.concatenate([a["prefill"] for a in alone]),
        "decode": [np.concatenate([a["decode"][t] for a in alone])
                   for t in range(LM_MESH_SERVE["decode"])]})
    bar = min(max(LM_MESH_REL, 2 * max(control)), LM_DECODE_REL)
    print(f"phase 14: (a) control: the single card with each sequence run "
          f"alone moves its logits by {max(control):.3e} (prefill "
          f"{control[0]:.3e}, decode {max(control[1:]):.3e}); the bar is "
          f"{bar:.3e} (2e-2, or twice that, up to {LM_DECODE_REL})")
    per_rank = []
    for r, (rk, lg) in enumerate(zip(ranks, got)):
        errs = steps_rel(lg)
        loss_rel = abs(rk["train"]["losses"][0] - one_t["losses"][0]) / abs(
            one_t["losses"][0])
        mem = {"serve": rk["serve"]["peak_bytes"] / one_s["peak_bytes"],
               "train": rk["train"]["peak_bytes"] / one_t["peak_bytes"]}
        per_rank.append({"logit_rel": errs, "loss_rel": loss_rel,
                         "memory_ratio": mem, **rk})
        decode_ms = statistics.median(rk["serve"]["decode_ms"][1:])
        coll = rk["serve"]["decode_collectives"]
        pcoll = rk["serve"]["prefill_collectives"]
        print(f"phase 14: (a) rank {r}: {LM_MESH_SERVE['arch']} on a "
              f"{LM_MESH_SHAPE[0]}x{LM_MESH_SHAPE[1]} data x model mesh "
              f"(gloo, one card): prefill {LM_MESH_SERVE['batch']} x "
              f"{LM_MESH_SERVE['max_seq']} {rk['serve']['prefill_ms']:.1f} ms"
              f" (single card {one_s['prefill_ms']:.1f}); decode median "
              f"{decode_ms:.1f} ms a token (single card "
              f"{statistics.median(one_s['decode_ms'][1:]):.1f}); logits "
              f"worst rel {max(errs):.3e} (limit {bar:.3e}); per step "
              f"{[round(e, 5) for e in errs]}; peak "
              f"{rk['serve']['peak_bytes'] / 2**30:.2f} GiB = "
              f"{mem['serve']:.3f} of the single card's "
              f"{one_s['peak_bytes'] / 2**30:.2f} GiB (limit "
              f"{LM_MESH_MEMORY}); a decode step's collectives "
              f"{coll['op_counts']} {coll['total'] / 1e6:.3f} MB, the "
              f"prefill's {pcoll['op_counts']} {pcoll['total'] / 1e6:.3f} "
              f"MB; {card}")
        print(f"phase 14: (b) rank {r}: {LM_MESH_TRAIN['arch']} train step "
              f"at {LM_MESH_TRAIN['batch']} x {LM_MESH_TRAIN['seq']}: loss "
              f"{rk['train']['losses'][0]:.5f} vs single card "
              f"{one_t['losses'][0]:.5f} (rel {loss_rel:.2e}, limit "
              f"{LM_MESH_LOSS_REL}); second step "
              f"{rk['train']['step_ms'][1]:.1f} ms (single card "
              f"{one_t['step_ms'][1]:.1f}); peak "
              f"{rk['train']['peak_bytes'] / 2**30:.2f} GiB = "
              f"{mem['train']:.3f} of the single card's "
              f"{one_t['peak_bytes'] / 2**30:.2f} GiB; {card}")
    fsdp_rank = []
    for r, rk in enumerate(ranks):
        tf = rk["train_fsdp"]
        loss_rel = abs(tf["losses"][0] - one_t["losses"][0]) / abs(
            one_t["losses"][0])
        mem = tf["peak_bytes"] / one_t["peak_bytes"]
        fsdp_rank.append({"loss_rel": loss_rel, "memory_ratio": mem})
        print(f"phase 14: (b) rank {r}: {LM_MESH_TRAIN['arch']} train step "
              f"on a {LM_MESH_FSDP_SHAPE[0]}x{LM_MESH_FSDP_SHAPE[1]} data x "
              f"model mesh with FSDP: loss {tf['losses'][0]:.5f} (rel "
              f"{loss_rel:.2e} from the single card's, limit "
              f"{LM_MESH_LOSS_REL}); second step {tf['step_ms'][1]:.1f} ms "
              f"(single card {one_t['step_ms'][1]:.1f}); peak "
              f"{tf['peak_bytes'] / 2**30:.2f} GiB = {mem:.3f} of the single "
              f"card's {one_t['peak_bytes'] / 2**30:.2f} GiB (limit "
              f"{LM_MESH_MEMORY}); {card}")
    reduced_rank = []
    for r, (rk, lg) in enumerate(zip(ranks_d, got_d)):
        rec = {}
        for arch in LM_MESH_REDUCED:
            one, res = one_d[arch], rk[arch]
            errs = [rel(lg[arch]["prefill"], one["prefill"])] + [
                rel(a, b) for a, b in zip(lg[arch]["decode"], one["decode"])]
            loss_rel = abs(res["loss"] - one["loss"]) / abs(one["loss"])
            rec[arch] = {"logit_rel": errs, "loss_rel": loss_rel,
                         "bar": LM_REL.get(arch, LM_REL_DEFAULT), **res}
            moe = res.get("moe_collectives")
            moe_text = "" if moe is None else (
                f"; its MoE layers' collectives (buffer "
                f"{res['moe_buffer']} elements): prefill "
                f"{moe['prefill']['total'] / 1e6:.4f} MB "
                f"{moe['prefill']['op_counts']}, train step (forward and "
                f"recompute) {moe['train']['total'] / 1e6:.4f} MB "
                f"{moe['train']['op_counts']}, largest result "
                f"{max(moe['train']['largest'].values())} elements")
            print(f"phase 14: (d) rank {r}: {arch} reduced on a "
                  f"{LM_MESH_REDUCED_SHAPE[0]}x{LM_MESH_REDUCED_SHAPE[1]} "
                  f"mesh with FSDP: logits worst rel {max(errs):.3e} (bar "
                  f"{rec[arch]['bar']}), per step "
                  f"{[round(e, 5) for e in errs]}; loss rel {loss_rel:.2e} "
                  f"(limit {LM_MESH_LOSS_REL}); prefill "
                  f"{res['ms']['prefill']:.1f} ms, {LM_MESH_SERVE['decode']} "
                  f"decode steps {res['ms']['decode']:.1f} ms, train step "
                  f"{res['ms']['train']:.1f} ms (single card "
                  f"{one['ms']['prefill']:.1f} / {one['ms']['decode']:.1f} / "
                  f"{one['ms']['train']:.1f}){moe_text}; {card}")
        reduced_rank.append(rec)
    for r, pr in enumerate(fsdp_rank):
        check(pr["loss_rel"] <= LM_MESH_LOSS_REL,
              f"phase 14: (b) rank {r}: FSDP loss off the single card's "
              f"({pr['loss_rel']:.3e}, limit {LM_MESH_LOSS_REL})")
        check(pr["memory_ratio"] <= LM_MESH_MEMORY,
              f"phase 14: (b) rank {r}: FSDP peak {pr['memory_ratio']:.3f} "
              f"of the single card's (limit {LM_MESH_MEMORY})")
    for r, rec in enumerate(reduced_rank):
        for arch, pr in rec.items():
            check(all(math.isfinite(e) for e in pr["logit_rel"])
                  and max(pr["logit_rel"]) <= pr["bar"],
                  f"phase 14: (d) rank {r}: {arch}: logits off the single "
                  f"card's ({max(pr['logit_rel']):.3e}, bar {pr['bar']})")
            check(pr["loss_rel"] <= LM_MESH_LOSS_REL,
                  f"phase 14: (d) rank {r}: {arch}: loss off the single "
                  f"card's ({pr['loss_rel']:.3e}, limit {LM_MESH_LOSS_REL})")
    for r, pr in enumerate(per_rank):
        errs = pr["logit_rel"]
        check(all(math.isfinite(e) for e in errs) and max(errs) <= bar,
              f"phase 14: rank {r}: sharded logits off the single card's "
              f"({max(errs):.3e}, limit {bar:.3e})")
        check(pr["loss_rel"] <= LM_MESH_LOSS_REL,
              f"phase 14: rank {r}: sharded loss off the single card's "
              f"({pr['loss_rel']:.3e}, limit {LM_MESH_LOSS_REL})")
        check(pr["memory_ratio"]["serve"] <= LM_MESH_MEMORY,
              f"phase 14: rank {r}: peak memory "
              f"{pr['memory_ratio']['serve']:.3f} of the single card's "
              f"(limit {LM_MESH_MEMORY})")

    cells = finish_dryrun(dry, t0)
    for key, rec in cells.items():
        t = rec["roofline_h100"]
        ca = rec["cost_analysis"]
        mem = rec["memory_per_device"]
        print(f"phase 14: (c) {key} on a fake {rec['mesh']} mesh "
              f"(fsdp {rec['fsdp']}, periods run {rec['periods_run']} of "
              f"{ca['scan_periods']}): per device {ca['flops_per_device']:.4g}"
              f" FLOP, {ca['bytes_per_device']:.4g} B accessed, "
              f"{ca['collective_bytes_per_device']:.4g} B of collectives "
              f"{rec['collectives']['op_counts']} (B by kind: "
              f"{ {k: v for k, v in rec['collectives'].items() if k not in ('total', 'op_counts') and v} }), peak "
              f"{mem['peak_bytes_est'] / 2**30:.1f} GiB; H100 roofline "
              f"compute {t['compute_s']:.4g} s, memory {t['memory_s']:.4g} "
              f"s, collective {t['collective_s']:.4g} s, dominant "
              f"{t['dominant']}, useful FLOPs {t['useful_flops_ratio']:.3f} "
              f"(the H100 model's peaks, not a card run); "
              f"{rec['compile_s']:.1f} s on the host")
    print(f"phase 14: single card {single_s:.1f} s, mesh {mesh_s:.1f} s, "
          f"(d) {reduced_s:.1f} s, in all {time.perf_counter() - t0:.1f} s")
    strip = lambda d: {k: v for k, v in d.items()
                       if k not in ("prefill", "decode")}
    return {"card": card, "mesh": list(LM_MESH_SHAPE), "serve": LM_MESH_SERVE,
            "control_rel": control, "logit_bar": bar,
            "train": LM_MESH_TRAIN, "single_card": {
                "serve": strip(one_s), "train": one_t,
                "reduced": {a: strip(v) for a, v in one_d.items()}},
            "per_rank": per_rank, "fsdp_mesh": list(LM_MESH_FSDP_SHAPE),
            "fsdp_per_rank": fsdp_rank,
            "reduced_mesh": list(LM_MESH_REDUCED_SHAPE),
            "reduced_per_rank": reduced_rank, "dryrun": cells}


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
    """Phases 1-14 on the card; the registry persists under ``cache_dir``."""
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
    t_synth = time.perf_counter()
    # phase 5's engines share this registry: the dataset is preprocessed
    # once, here
    # room for every subgraph phase 5 preprocesses, so the LRU never
    # drops the dataset's own artifact
    registry = ArtifactRegistry(cache_dir=cache_dir, mem_capacity=16384)
    graph = registry.get_or_build(data.adj_norm, cfg, persist=False)
    ell = graph.pre.ell
    t_pre = time.perf_counter()
    print(f"setup: {args.dataset} {spec.nodes} nodes, {data.adj_norm.nnz} "
          f"nnz, ELL {ell.padded_rows}x{ell.tau} ({ell.nnz} nnz), built in "
          f"{t_pre - t0:.1f} s: synthesis {t_synth - t0:.1f} s, "
          f"preprocessing {t_pre - t_synth:.1f} s (registry builds "
          f"{registry.stats.builds}); {card}")
    host_sizes(np, fv, ell, cfg)
    omitted = OMITTED.get(args.dataset, {})
    if omitted:
        print(f"omitted at {args.dataset}: " + "; ".join(
            f"phase {k}: {why}" for k, why in omitted.items()))
        print(f"settings at {args.dataset}: phases 5-10 at Reddit's "
              f"loads: serving {SERVE_LOAD[args.dataset]} x "
              f"{len(SERVE_ENGINES[args.dataset])} engines, planning "
              f"{PLAN_ROUNDS[args.dataset]} rounds, sharding "
              f"{SHARD_REPS[args.dataset]} reps, async "
              f"{ASYNC_LOADS[args.dataset]}, mesh {MESH_LOAD[args.dataset]}")
    params = init_params(cfg, torch.Generator().manual_seed(SEED), dev)
    feats = torch.as_tensor(data.features, device=dev)

    t2 = time.perf_counter()
    cases = main_path_cases(torch, rt, graph, cfg, params, feats, dev)
    kernels = phase_kernels(torch, np, fv, cases, dev)
    multi_slab = multi_slab_check(torch, np, fv, dev)
    small_forward_check(torch, np, rt, dev)
    public = public_dtype_check(torch, np, rt, graph, cfg, dev)
    main = phase_main_path(torch, rt, fv, graph, cfg, params, feats, dev,
                           ("f32",), 3)
    quant = phase_main_path(torch, rt, fv, graph, cfg, params, feats, dev,
                            ("bf16", "int8"), 4)
    print(f"phases 2-4: {time.perf_counter() - t2:.1f} s")
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
    t7 = time.perf_counter()
    sharding = phase_sharding(torch, np, graph, cfg, params, feats, dev,
                              args.dataset, card)
    print(f"phase 7: {time.perf_counter() - t7:.1f} s")
    t8 = time.perf_counter()
    runtime = phase_async(torch, np, registry, data, cfg, params, dev,
                          args.dataset)
    print(f"phase 8: {time.perf_counter() - t8:.1f} s")
    if "9" in omitted:
        fleet = {"omitted": omitted["9"], "launches": {}}
    else:
        t9 = time.perf_counter()
        fleet = phase_fleet(torch, np, fv, registry, data, cfg, params, dev,
                            args.dataset)
        print(f"phase 9: {time.perf_counter() - t9:.1f} s")
    t10 = time.perf_counter()
    serving_mesh = phase_serving_mesh(torch, np, registry, data, graph, cfg,
                                      params, dev, args.dataset, card)
    print(f"phase 10: {time.perf_counter() - t10:.1f} s")
    lm_phase, train_phase, lm_mesh = (
        {"omitted": omitted.get(key)} for key in ("11", "12", "14"))
    if "11" not in omitted:
        t11 = time.perf_counter()
        lm_phase = phase_lm(torch, np, dev, card)
        print(f"phase 11: {time.perf_counter() - t11:.1f} s")
    if "12" not in omitted:
        t12 = time.perf_counter()
        train_phase = phase_train(torch, np, data, cfg, graph, dev, card,
                                  args.dataset)
        print(f"phase 12: {time.perf_counter() - t12:.1f} s")
    t13 = time.perf_counter()
    sim_phase = phase_sim(torch, np, fv, data, graph, dev, card, args.dataset,
                          omitted)
    print(f"phase 13: {time.perf_counter() - t13:.1f} s")
    if "14" not in omitted:
        t14 = time.perf_counter()
        lm_mesh = phase_lm_mesh(torch, np, dev, card)
        print(f"phase 14: {time.perf_counter() - t14:.1f} s")

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
        precision = "int8" if name.endswith("_scaled") else "f32"
        line["sharding_launches"] = [
            rk["launches"][precision][name] for rk in sharding["per_rank"]]
        if name in BASE:
            line["sharding_launches_bf16"] = [
                rk["launches"]["bf16"][name] for rk in sharding["per_rank"]]
        line["serving_launches"] = {
            key: {how: {k: n for k, n in counts.items()
                        if k.split("@")[0] == name}
                  for how, counts in e["launches"].items()}
            for key, e in serving.items()}
        line["fleet_launches"] = {
            how: {k: n for k, n in counts.items() if k.split("@")[0] == name}
            for how, counts in fleet["launches"].items()}
        line["flexvector_spmm_launches"] = {
            label: n for label, e in sim_phase["flexvector_spmm"].items()
            for key, n in e["launches"].items() if key.split("@")[0] == name}
        line["serving_mesh_launches"] = {
            key: [{k: n for k, n in rk["replayed"].items()
                   if k.split("@")[0] == name} for rk in e["per_rank"]]
            for key, e in serving_mesh["engines"].items()}
        lines.append(line)
    for key in STORE_KEYS:   # launched by public_dtype_check
        line = {"name": key, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[split_key(key)[0]],
                "launches": public["launches"][key]}
        line.update(summary(key))
        lines.append(line)
    print(json.dumps({"fused_split": {
        key: [cell["split"] for cell in kernels[key]["per_layer"]]
        for key in KEYS if not is_aggregation(split_key(key)[0])}}))
    merged = {key: {**main[key], **quant[key]}
              for key in ("forward_ms", "device_busy_ms", "device_idle_share")}
    print(json.dumps({"kernels": lines, "dataset": args.dataset, **merged,
                      "multi_slab": multi_slab,
                      "public_dtype_check": public,
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
    print(json.dumps({"sharding": sharding}))
    print(json.dumps({"async": dict(runtime, dataset=args.dataset, card=card,
                                    settings=SERVE,
                                    loads=ASYNC_LOADS[args.dataset])}))
    print(json.dumps({"fleet": dict(fleet, card=card, settings=SERVE)}))
    print(json.dumps({"serving_mesh": dict(serving_mesh, settings=SERVE)}))
    print(json.dumps({"lm": lm_phase}))
    print(json.dumps({"train": train_phase}))
    print(json.dumps({"sim": sim_phase}))
    dryrun = lm_mesh.pop("dryrun", lm_mesh)
    print(json.dumps({"lm_mesh": lm_mesh}))
    print(json.dumps({"dryrun": dryrun}))
    print(json.dumps({"ok": True, "device": device}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="pubmed",
                    choices=("pubmed", "reddit", "yelp"))
    args = ap.parse_args()
    try:
        return run(args)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
